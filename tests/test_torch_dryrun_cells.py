"""The port's dry run held to ``FlopCounterMode``, to itself across
world sizes and depths, and to the reference's ``memory_analysis``.
Every cell of every architecture runs in
``test_torch_dryrun_cells_{single,multi}_*.py``; each fake world here
runs in a subprocess too (``_dryrun_cells.run_cells``), and the
reference's dry run, which sets ``XLA_FLAGS`` at import, in one of its
own.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from _dryrun_cells import REPO, TIMEOUT, run_cells
from repro_torch.configs import get_config

FLOP_MATCH = textwrap.dedent("""
    import json, logging, sys
    logging.disable(logging.WARNING)
    import dataclasses, torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_local_mesh
    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=1)
    out = {}
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = dataclasses.replace(SHAPES[name], batch=4)
        with dr._FakeWorld(1):
            mesh = make_local_mesh(1, 1, device="cpu")
            step, args, params, _, _ = dr._build_step(cfg, shape, mesh, 4)
            counted = dr._count(step, args, params)[0].flops
        step, args, _, _, _ = dr._build_step(cfg, shape, None, 4)
        with FlopCounterMode(display=False) as fc:
            step(*args)
        out[name] = [counted, fc.get_total_flops()]
    print(json.dumps(out))
""")


def test_counted_flops_on_a_one_rank_world_equal_flop_counter():
    """granite-8b at 1 layer, 4 requests of each shape's sequence, on a
    fake (1, 1) world: the counted FLOPs of the train, prefill and decode
    steps equal ``FlopCounterMode``'s count of the same step without a
    mesh (plain meta tensors)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", FLOP_MATCH], capture_output=True,
                       text=True, timeout=TIMEOUT, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for name, (counted, plain) in out.items():
        assert counted == plain > 0, name


def test_half_the_flops_a_device_on_twice_the_ranks():
    """granite-8b ``prefill_32k`` at 2 layers: the FLOPs a device at 512
    ranks are half those at 256, exactly."""
    single, multi = run_cells([
        ("granite-8b", "prefill_32k", mesh, {"n_layers": 2}, False)
        for mesh in ("single", "multi")])
    assert multi["cost"]["flops"] * 2 == single["cost"]["flops"]
    assert multi["devices"] == 512 and single["devices"] == 256


def test_probe_fit_equals_the_direct_count():
    """``probed_costs``' fit at 1 and 2 units, extrapolated to 4, against
    the direct count at 4 units: prefill and decode equal in FLOPs,
    bytes and collective seconds; train equal in FLOPs once the fit's
    analytic AdamW FLOPs are taken out (its bytes carry 40 B a parameter
    where the direct count has the eager update's)."""
    from repro_torch.launch import dryrun as dr
    cfg = get_config("granite-8b")
    recs = run_cells([("granite-8b", s, "single", {"n_layers": 4}, True)
                      for s in ("prefill_32k", "decode_32k", "train_4k")])
    for rec in recs:
        fit, probe = rec["probe"]["fit"], rec["probe"]
        assert probe["units_full"] == 4
        if rec["kind"] == "train":
            n_dev = dr._dc.replace(cfg, n_layers=4).param_count() / 256
            assert probe["microbatches"] == cfg.microbatches
            assert fit["flops"] - dr._OPT_FLOPS_PER_PARAM * n_dev == \
                pytest.approx(rec["cost"]["flops"], rel=1e-12)
            continue
        assert fit["flops"] == pytest.approx(rec["cost"]["flops"],
                                             rel=1e-12)
        assert fit["bytes_accessed"] == pytest.approx(
            rec["cost"]["bytes_accessed"], rel=1e-12)
        assert fit["collective_s"] == pytest.approx(
            rec["roofline"]["collective_s"], rel=1e-9)


def test_records_and_argument_bytes_against_the_reference(tmp_path):
    """granite-8b ``decode_32k`` and ``train_4k`` at 2 layers on the
    single-pod world, ``--no-probes``: the record's keys are the
    reference's (``hlo_lines`` read as ``local_ops``); the train step's
    argument bytes (f32 masters, AdamW's moments and step, the batch)
    equal the reference's ``argument_size_in_bytes``; the decode step's
    exceed them by 2 bytes an element of the five norm vectors (2 layers
    x 2 + the final, 4096 each, whole on every rank), which the port keeps
    in float32 to serve where the reference's dry run casts every leaf
    to bf16."""
    out = tmp_path / "ref.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--arch",
                        "granite-8b", "--shape", "decode_32k,train_4k",
                        "--mesh", "single", "--no-probes", "--set",
                        "n_layers=2", "--out", str(out)], capture_output=True,
                       text=True, timeout=TIMEOUT, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-4000:]
    ref = json.loads(out.read_text())
    recs = run_cells([("granite-8b", s, "single", {"n_layers": 2}, False)
                      for s in ("decode_32k", "train_4k")])
    for rec in recs:
        want = ref[f"granite-8b|{rec['shape']}|single"]
        assert want["ok"]
        got_keys = set(rec) - {"local_ops", "group_left_open"}
        assert got_keys | {"tag"} == set(want) - {"hlo_lines"}
        for part in ("memory", "roofline", "cost", "raw_cost", "timings"):
            assert set(rec[part]) == set(want[part]), part
        assert set(rec["collectives"]) == set(want["collectives"])
        norms = 2 * (2 * 2 + 1) * 4096 if rec["kind"] == "decode" else 0
        assert rec["memory"]["argument_bytes"] == (
            want["memory"]["argument_bytes"] + norms), rec["shape"]
