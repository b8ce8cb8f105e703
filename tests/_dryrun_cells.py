"""Helpers of the dry run's cell tests (``test_torch_dryrun_cells*.py``):
each group of cells runs in one subprocess, which opens and closes a
fake world for each cell, so that no default process group opens in the
test worker.

The useful-compute ratio (``MODEL_FLOPS`` per device over the counted
FLOPs) is positive in every cell.  ``model_flops`` counts the untied
embedding table as a product of ``2 V D`` FLOPs a token, which its
lookup does not do; at one or two scan units that table outweighs a
layer in most architectures, so the ratio is held at most 1 with the
lookup's share taken out of ``MODEL_FLOPS`` (``held_ratio``).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import get_config
from repro_torch.configs.shapes import shapes_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600

#: runs ``run_cell`` on each (arch, shape, mesh, overrides) of argv[1]
#: and prints one JSON line of the records (or the error), with whether
#: a process group was left open after each
CELLS = textwrap.dedent("""
    import json, logging, sys
    logging.disable(logging.WARNING)
    import torch.distributed as dist
    from repro_torch.launch import dryrun as dr
    out = []
    for arch, shape, mesh, ov, probes in json.loads(sys.argv[1]):
        try:
            rec = dr.run_cell(arch, shape, mesh, overrides=ov,
                              no_probes=not probes)
        except Exception as e:
            rec = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        rec["group_left_open"] = dist.is_initialized()
        out.append(rec)
    print(json.dumps(out))
""")


def unit_overrides(arch: str, units: int = 1) -> dict:
    """The config overrides of ``units`` scan units (``_scan_unit_info``,
    ``scan_layers`` aside: the port has no scan)."""
    from repro_torch.launch.dryrun import _scan_unit_info
    ov = dict(_scan_unit_info(get_config(arch))[1](units))
    ov.pop("scan_layers")
    return ov


def run_cells(cells: list) -> list:
    """The records of ``cells`` ((arch, shape, mesh, overrides, probes)),
    run in one subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", CELLS, json.dumps(cells)],
                       capture_output=True, text=True, timeout=TIMEOUT,
                       env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    recs = json.loads(r.stdout.strip().splitlines()[-1])
    for cell, rec in zip(cells, recs):
        assert rec["ok"], (cell, rec.get("error"))
        assert not rec["group_left_open"], cell
    return recs


def held_ratio(rec: dict) -> float:
    """MODEL_FLOPS per device without the untied embedding's lookup, over
    the counted FLOPs."""
    cfg = dataclasses.replace(get_config(rec["arch"]), **{
        k: int(v) for k, v in rec["overrides"].items()})
    rl = rec["roofline"]
    mult = 6.0 if rec["kind"] == "train" else 2.0
    tokens = rec["batch"] * (rec["seq"] if rec["kind"] != "decode" else 1)
    lookup = 0.0 if cfg.tie_embeddings else (
        mult * cfg.vocab_size * cfg.d_model * tokens)
    return (rl["model_flops_global"] - lookup) / rec["devices"] \
        / rec["cost"]["flops"]


def hold_cell(rec: dict, devices: int) -> None:
    """One record: the world's size, positive costs and memory, the
    roofline's terms on the H100's constants, and the useful-compute
    ratio in (0, 1] without the lookup (the module docstring)."""
    from repro_torch.launch import dryrun as dr
    assert rec["devices"] == devices
    cost, mem, rl = rec["cost"], rec["memory"], rec["roofline"]
    assert cost["flops"] > 0 and cost["bytes_accessed"] > 0
    assert rec["local_ops"] > 0
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["peak_bytes_estimate"] == (mem["argument_bytes"]
                                          + mem["temp_bytes"])
    assert rl["compute_s"] == pytest.approx(cost["flops"] / dr.PEAK_FLOPS)
    assert rl["memory_s"] == pytest.approx(
        cost["bytes_accessed"] / dr.HBM_BW)
    assert rl["collective_s"] == pytest.approx(
        dr.collective_seconds(rec["collectives"]))
    assert rl["bound_step_s"] == max(rl["compute_s"], rl["memory_s"],
                                     rl["collective_s"])
    assert rl["useful_compute_ratio"] > 0
    assert 0 < held_ratio(rec) <= 1.0, (rec["arch"], rec["shape"],
                                         held_ratio(rec))


def check_arch(arch: str, mesh: str) -> None:
    """Every cell of ``arch`` at one scan unit on the ``mesh`` world:
    each record OK, no process group left open, its costs and ratio
    held."""
    ov = unit_overrides(arch)
    recs = run_cells([(arch, s.name, mesh, ov, False)
                      for s in shapes_for(arch)])
    for rec in recs:
        hold_cell(rec, 256 if mesh == "single" else 512)
