"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``), in process on the CPU: the
arithmetic kept as the reference has it (model FLOPs, the analytic
memory floor, the scan units, the collective time), the H100's
constants, and the counting mode on plain tensors and on a hand-built
DTensor program over a fake (1, 4) world.  The cells themselves, each on
its fake 256- or 512-rank world in a subprocess, are in
``test_torch_dryrun_cells*.py``.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host devices)
before jax initializes; this file runs no jax computation.
"""

import dataclasses
import inspect
import math
import types

import pytest
import torch
import torch.distributed as dist

import repro.launch.dryrun as ref
from repro.configs import get_config as jax_config
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.configs.shapes import shapes_for
from repro_torch.launch import dryrun as dr

MESHES = ((1, 1), (2, 4), (16, 16), (2, 16, 16))


def _names(shape: tuple) -> tuple:
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _ref_mesh(shape: tuple):
    """What the reference reads of a jax mesh: ``size`` and ``shape``."""
    return types.SimpleNamespace(shape=dict(zip(_names(shape), shape)),
                                 size=math.prod(shape),
                                 axis_names=_names(shape))


def _port_mesh(shape: tuple):
    """What ``launch.mesh.mesh_shape`` reads of a ``DeviceMesh``."""
    return types.SimpleNamespace(mesh_dim_names=_names(shape), shape=shape)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arithmetic_equals_the_reference(arch):
    """``model_flops``, ``analytic_memory_bytes`` (each package's own
    mesh) and ``_scan_unit_info`` equal the reference's for every shape
    of the arch."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    for sh in shapes_for(arch):
        assert dr.model_flops(cfg, sh.kind, sh.batch, sh.seq) == \
            ref.model_flops(jcfg, sh.kind, sh.batch, sh.seq)
        for shape in MESHES:
            assert dr.analytic_memory_bytes(
                cfg, sh.kind, sh.batch, sh.seq, _port_mesh(shape)) == \
                ref.analytic_memory_bytes(jcfg, sh.kind, sh.batch, sh.seq,
                                          _ref_mesh(shape)), (sh.name, shape)
    units, ov = dr._scan_unit_info(cfg)
    ref_units, ref_ov = ref._scan_unit_info(jcfg)
    assert units == ref_units
    for u in (1, 2, units):
        assert ov(u) == ref_ov(u)
        dataclasses.replace(cfg, **ov(u))      # every override is a field


def test_constants_are_the_h100s():
    """Dense bf16 989 TFLOP/s, HBM3 3.35 TB/s, 50 GB/s a GPU across hosts;
    no v5e figure left in the module; the reference's collective kinds and
    weights; ``collective_seconds`` the reference's times the ratio of
    the two link rates."""
    assert (dr.PEAK_FLOPS, dr.HBM_BW, dr.LINK_BW) == (989e12, 3.35e12, 50e9)
    src = inspect.getsource(dr)
    for v5e in ("197e12", "819e9", "v5e", "TPU v"):
        assert v5e not in src
    assert dr._COLLECTIVES == ref._COLLECTIVES
    assert dr._COLLECTIVE_WEIGHT == ref._COLLECTIVE_WEIGHT
    coll = {c: {"count": i + 1, "bytes": (i + 1) * 12345678}
            for i, c in enumerate(ref._COLLECTIVES)}
    assert dr.collective_seconds(coll) == pytest.approx(
        ref.collective_seconds(coll) * ref.LINK_BW / dr.LINK_BW, rel=1e-12)


def test_collective_kinds():
    """The functional, autograd and c10d collectives map to the
    reference's kinds; ``wait_tensor`` and ``_wrap_tensor_autograd`` are
    collective-namespace ops that count as nothing; aten ops are local."""
    import torch.distributed._functional_collectives  # noqa: F401 (its ops)
    ops = torch.ops
    f = ops._c10d_functional
    assert dr._collective_kind(f.all_gather_into_tensor.default) == \
        "all-gather"
    assert dr._collective_kind(f.all_reduce.default) == "all-reduce"
    assert dr._collective_kind(f.reduce_scatter_tensor.default) == \
        "reduce-scatter"
    assert dr._collective_kind(f.all_to_all_single.default) == "all-to-all"
    assert dr._collective_kind(
        ops._c10d_functional_autograd.all_to_all_single.default) == \
        "all-to-all"
    assert dr._collective_kind(ops.c10d.allreduce_.default) == "all-reduce"
    assert dr._collective_kind(f.wait_tensor.default) == ""
    assert dr._collective_kind(f._wrap_tensor_autograd.default) == ""
    assert dr._collective_kind(torch.ops.aten.mm.default) is None


def test_counter_on_plain_tensors():
    """On plain CPU tensors the mode counts every op: the FLOPs of a smoke
    model's prefill equal ``FlopCounterMode``'s; bytes are each op's
    inputs and outputs; the peak follows storages as they are freed."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.sharding import ModelContext
    from repro_torch.models.zoo import build_model
    cfg = get_smoke_config("granite-8b")
    model = build_model(cfg, "cpu").init_params(
        torch.Generator().manual_seed(0))
    step = build_prefill_step(model, ModelContext())
    toks = torch.randint(0, cfg.vocab_size, (2, 32))
    with FlopCounterMode(display=False) as fc:
        want = step(toks)
    counter = dr.CostCounter()
    with counter:
        got = step(toks)
    assert counter.flops == fc.get_total_flops() > 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert counter.collectives == {c: {"count": 0, "bytes": 0}
                                   for c in dr._COLLECTIVES}

    counter = dr.CostCounter()
    with counter:
        a = torch.ones(1000)              # 4000 B live
        b = a * 2                          # 8000
        del a                              # 4000
        d = (b + 1).view(10, 100)          # 8000
        del b                              # 4000
        e = d * 3                          # 8000: 16000 made in all
    assert counter.peak_bytes == 8000 and counter.live_bytes == 8000
    # ones writes 4000; mul reads 4000, writes 4000; add 8000; the view
    # moves nothing; the last mul 8000
    assert counter.bytes_accessed == 4000 + 8000 + 8000 + 8000
    assert counter.local_ops == 5 and counter.ops["aten::view"] == 1
    assert e.shape == (10, 100)


def test_counter_on_a_dtensor_program():
    """A hand-built DTensor program on a fake (1, 4) world of meta
    tensors: rank 0's local ops only; each collective's count and result
    bytes exact (a Shard-to-Shard move on a CPU mesh is DTensor's
    all-gather, not an all-to-all); all-reduce weighted 2x in the
    collective time;
    ``_wrap_tensor_autograd`` seen and not counted; the world closed."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    R = Replicate()
    with dr._FakeWorld(4):
        mesh = init_device_mesh("cpu", (1, 4),
                                mesh_dim_names=("data", "model"))

        def dt(shape, place, grad=False):
            t = torch.empty(shape, device="meta", requires_grad=grad)
            return DTensor.from_local(t, mesh, place, run_check=False)
        x = dt((8, 16), (R, R), grad=True)
        p = dt((8, 16), (R, Partial()))
        counter = dr.CostCounter()
        with counter:
            a = x.redistribute(mesh, (R, Shard(0)))     # a local chunk
            w = a @ dt((16, 4), (R, R))                 # (2, 4) a rank
            b = a.redistribute(mesh, (R, R))            # all-gather
            c = p.redistribute(mesh, (R, R))            # all-reduce
            d = p.redistribute(mesh, (R, Shard(0)))     # reduce-scatter
            # Shard(0) -> Shard(1): DTensor gathers on a CPU mesh
            e = a.redistribute(mesh, (R, Shard(1)))
            f = funcol.all_to_all_single(x.to_local(), [2] * 4, [2] * 4,
                                         mesh.get_group(1))
        assert dist.is_initialized()
    assert not dist.is_initialized()
    assert b.to_local().shape == (8, 16) and d.to_local().shape == (2, 16)
    assert e.to_local().shape == (8, 4) and w.to_local().shape == (2, 4)
    assert c.to_local().shape == (8, 16)
    got = {k: (v["count"], v["bytes"]) for k, v in
           counter.collectives.items()}
    assert f.shape == (8, 16)
    assert got == {"all-gather": (2, 2 * 8 * 16 * 4),
                   "all-reduce": (1, 8 * 16 * 4),
                   "reduce-scatter": (1, 2 * 16 * 4),
                   "all-to-all": (1, 8 * 16 * 4),
                   "collective-permute": (0, 0)}
    assert counter.ops["_c10d_functional::_wrap_tensor_autograd"] >= 1
    assert counter.flops == 2 * 2 * 16 * 4
    assert counter.costs()["collective_s"] == pytest.approx(
        (1024 + 2 * 512 + 128 + 512) / dr.LINK_BW, rel=1e-12)


def test_run_cell_needs_the_process_to_itself():
    """``run_cell`` raises while a process group is open, and leaves none
    open after it returns or raises."""
    dist.init_process_group(
        "fake", store=__import__(
            "torch.testing._internal.distributed.fake_pg",
            fromlist=["FakeStore"]).FakeStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already open"):
            dr.run_cell("granite-3-8b", "decode_32k", "single",
                        overrides={"n_layers": 1}, no_probes=True)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="even layer count"):
        dr.run_cell("gemma2-9b", "decode_32k", "single",
                    overrides={"n_layers": 3}, no_probes=True)
    assert not dist.is_initialized()
    rec = dr.run_cell("granite-3-8b", "decode_32k", "single",
                      overrides={"n_layers": 1}, no_probes=True)
    assert not dist.is_initialized()
    assert rec["ok"] and rec["devices"] == 256 and rec["local_ops"] > 0
    assert rec["memory"]["peak_bytes_estimate"] == (
        rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"])
