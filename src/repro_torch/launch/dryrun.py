"""Multi-pod dry run of the port, the counterpart of the reference's
``repro.launch.dryrun``: run every (architecture x input-shape x mesh)
cell once on a fake world of 256 (``single``) or 512 (``multi``) ranks,
proving the distribution config is coherent, and read the roofline terms
from what rank 0 ran.

The reference lowers and compiles each cell for 512 placeholder TPU
devices and reads XLA's artifact (``memory_analysis``, ``cost_analysis``,
the collectives in the HLO text).  The port has no compiler to ask, so
it runs the step itself, on nothing:

  * the world is ``torch.distributed``'s fake process group (every
    collective returns at once, with the right shapes), opened by
    :func:`run_cell` at the mesh's size and closed before it returns;
  * the model, its batch and its cache live on the ``meta`` device
    (shapes and dtypes, no storage), placed on the production mesh by
    ``launch.shardings.assemble`` and ``place``, so a cell allocates
    nothing at its size, on the card or on the host;
  * :class:`CostCounter`, a dispatch mode, sees the local ops that
    DTensor runs on rank 0's shards (the reference's "per device") and
    counts their FLOPs, bytes and collectives, and the live bytes of the
    storages they make.

Per cell this records into a resumable JSON artifact:
  * memory: rank 0's argument, output and temporary bytes (peak of the
    storages the step holds at once)
  * cost: rank 0's FLOPs of every product (``flop_registry``; XLA also
    counts elementwise ops, this count does not) and the bytes each
    local op reads and writes (an unfused eager count)
  * collective result bytes by kind, from the collective ops dispatched
  * the three roofline terms on the H100's constants, the dominant term,
    MODEL_FLOPS and the useful-compute ratio.

No kernel of ``repro_torch.kernels`` runs here: every cell runs
``attention_impl="auto"``, the plain attention, as the reference lowers
it; :func:`analytic_memory_bytes` assumes the kernels.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k --mesh single --out results/dryrun_torch.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import collections
import dataclasses as _dc
import json
import logging
import math
import os
import sys
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_NAMES, get_config, shapes_for
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.mesh import make_production_mesh, mesh_shape

# ---- NVIDIA H100 SXM constants (roofline) ----------------------------------
PEAK_FLOPS = 989e12        # dense bf16 per GPU (tensor cores)
HBM_BW = 3.35e12           # bytes/s per GPU (HBM3)
# bytes/s per GPU across hosts: one 400 Gb/s NDR InfiniBand port a GPU.
# Every production mesh axis of 16 ranks spans two 8-GPU hosts, so its
# rings cross the network; NVLink's 450 GB/s each way inside a host is
# not used by this one figure (the reference likewise uses one ICI rate).
LINK_BW = 50e9

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# weight: bytes moved per result byte on a ring (all-reduce moves ~2x)
_COLLECTIVE_WEIGHT = {"all-reduce": 2.0}

#: namespaces of the collective ops (functional, their autograd forms,
#: and c10d's in-place ones, which the ``dist.*`` calls dispatch)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d")
#: op name (without namespace and overload) -> collective kind; every
#: other op of those namespaces (``wait_tensor``,
#: ``_wrap_tensor_autograd``, ...) is not a collective
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",     # DTensor, funcol
    "_allgather_base_": "all-gather",           # dist.all_gather_into_tensor
    "all_reduce": "all-reduce",
    "allreduce_": "all-reduce",                 # dist.all_reduce
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _collective_kind(func) -> Optional[str]:
    """The collective kind of ``func``, None for a local op; a
    non-collective op of a collective namespace is ``""``."""
    ns, _, name = func.name().partition("::")
    if ns not in _COLLECTIVE_NAMESPACES:
        return None
    return _COLLECTIVE_OPS.get(name, "")


#: functions of DTensor's sharding propagation and redistribution
#: planner: the ops they run size shards, they move no data
_PLANNING = frozenset({
    "propagate", "propagate_op_sharding", "propagate_op_sharding_non_cached",
    "redistribute_cost", "_gen_transform_infos",
    "_gen_transform_infos_non_cached"})


def _planning(frame) -> bool:
    """Whether the op dispatched below ``frame`` runs inside DTensor's
    planning (up to the first frame of this package)."""
    while frame is not None:
        code = frame.f_code
        if code.co_name in _PLANNING and "distributed" in code.co_filename:
            return True
        if "repro_torch" in code.co_filename:
            return False
        frame = frame.f_back
    return False


def _tensors(tree, out: Optional[list] = None) -> list:
    """The tensors in a tree of lists, tuples and dicts."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts the local ops of one rank (the fake world's rank 0), the
    port's ``cost_analysis`` and ``memory_analysis``.

    DTensor ops are let through (``NotImplemented``), so DTensor runs
    them as ops on its local shards, which this mode then sees; ops run
    under a fake tensor mode or inside DTensor's planning (sharding
    propagation, redistribution costs, which size shards on meta tensors)
    are not counted.  On plain tensors, on any device, every op is counted.

    * ``flops``: ``torch.utils.flop_counter.flop_registry`` on each op:
      matmuls, attention and convolutions only, where XLA's count also
      takes elementwise ops;
    * ``bytes_accessed``: the bytes of every tensor an op reads plus every
      tensor it writes, views and collectives excepted: an unfused eager
      count, each op reading its inputs from memory;
    * ``collectives``: the reference's five kinds, ``{count, bytes}`` of
      result bytes a kind;
    * ``local_ops``: ops dispatched, ``ops`` by name;
    * ``peak_bytes``: the most bytes of live storages at once, the
      storages :meth:`hold` was given (the step's arguments) and every
      storage an op made, each until it is freed."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.local_ops = 0
        self.ops: collections.Counter = collections.Counter()
        self.collectives = {c: {"count": 0, "bytes": 0}
                            for c in _COLLECTIVES}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: dict = {}

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (DTensors by their
        local shards) as live; returns their bytes."""
        from repro_torch.dtensor import local
        before = self.live_bytes
        for t in _tensors(tree):
            self._track(local(t))
        return self.live_bytes - before

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not None or _planning(sys._getframe(1)):
            return out
        self.local_ops += 1
        self.ops[func.name()] += 1
        kind = _collective_kind(func)
        outs = _tensors(out)
        if kind:
            rec = self.collectives[kind]
            rec["count"] += 1
            rec["bytes"] += sum(_nbytes(t) for t in outs)
        elif kind is None:
            fn = self._flop_registry.get(func._overloadpacket)
            if fn is not None:
                self.flops += int(fn(*args, **kwargs, out_val=out))
            if not func.is_view:
                self.bytes_accessed += sum(
                    _nbytes(t) for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t)
        return out

    def costs(self) -> dict:
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes_accessed),
                "collective_s": collective_seconds(self.collectives),
                "collectives": {k: dict(v)
                                for k, v in self.collectives.items()}}


def collective_seconds(coll: dict) -> float:
    t = 0.0
    for op, rec in coll.items():
        w = _COLLECTIVE_WEIGHT.get(op, 1.0)
        t += w * rec["bytes"] / LINK_BW
    return t


def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """6*N*D (train) / 2*N*D (prefill) / 2*N*B (decode), N = active params."""
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch          # decode: per emitted token


# ---------------------------------------------------------------------------
# Cost probes.  The reference compiles each cell again at 1 and 2 "scan
# units" (a unit = one layer, one local/global pair, or one zamba
# macro-block), because XLA counts a scan body once, fits cost = fixed +
# per_unit * U and scales to the full depth x microbatches.  The port's
# count runs every layer, so it needs no correction; the probe is kept,
# the same fit on the same units, so that its records carry ``probe``
# beside the direct count.
# ---------------------------------------------------------------------------

# analytic AdamW update terms (per parameter, per device after sharding):
# m/v/master read+write fp32 (24B) + grad read fp32 (4B) + casts ~= 40B,
# ~12 flops. Tiny vs the matmul terms; folded in analytically because the
# probe measures value_and_grad only (so microbatch scaling stays exact).
_OPT_BYTES_PER_PARAM = 40.0
_OPT_FLOPS_PER_PARAM = 12.0


def _mesh_dims(mesh) -> tuple:
    """(devices, model-axis size) of any mesh :func:`mesh_shape` reads."""
    shape = mesh_shape(mesh)
    return math.prod(shape.values()), shape["model"]


def analytic_memory_bytes(cfg, kind: str, batch: int, seq: int,
                          mesh) -> float:
    """First-principles per-device HBM-traffic floor, assuming the
    attention/SSM kernels (no score materialization) and full fusion:

      train:   M * L * [4 * P_layer(bf16)/dev + 10 * resid] + head + opt
      prefill: L * [P_layer(bf16)/TP + 6 * resid] + cache write
      decode:  all params once + full cache read/write + small vectors

    resid = one (B_mb, S, D) bf16 pass per device. Reported alongside the
    measured (plain-attention) bytes so both bounds are visible.
    """
    dev, tp = _mesh_dims(mesh)
    dp = dev // tp
    P = cfg.param_count() * 2.0                     # bf16 bytes
    L = max(cfg.n_layers, 1)
    P_layer = P / L
    if kind == "train":
        M = max(cfg.microbatches, 1)
        b_loc = max(batch // M // dp, 1)
        resid = b_loc * seq * cfg.d_model * 2.0
        per_layer = 4.0 * P_layer / dev * tp + 10.0 * resid
        head = 3.0 * (cfg.vocab_size * cfg.d_model * 2.0) / tp \
            + 2.0 * b_loc * seq * (cfg.vocab_size / tp) * 2.0
        opt = _OPT_BYTES_PER_PARAM * cfg.param_count() / dev
        return M * (L * per_layer + head) + opt
    if kind == "prefill":
        b_loc = max(batch // dp, 1)
        resid = b_loc * seq * cfg.d_model * 2.0
        kv_write = (2.0 * b_loc * seq * cfg.n_kv_heads * cfg.hd * 2.0)
        return L * (P_layer / tp + 6.0 * resid + kv_write) \
            + (cfg.vocab_size * cfg.d_model * 2.0) / tp
    # decode
    b_loc = max(batch // dp, 1) if batch >= dp else batch
    cache = 2.0 * L * b_loc * (seq / tp) * cfg.n_kv_heads * cfg.hd * 2.0
    return P / tp + cache


def _scan_unit_info(cfg):
    """(full_units, override_fn(units) -> cfg overrides) for the probe."""
    if cfg.family == "hybrid":
        def ov(u):
            return {"n_macro_blocks": u,
                    "n_layers": u * cfg.mamba_per_block
                    + cfg.tail_mamba_layers,
                    "scan_layers": False}
        return cfg.n_macro_blocks, ov
    if cfg.attn_pattern == "local_global":
        def ov(u):
            return {"n_layers": 2 * u, "scan_layers": False}
        return cfg.n_layers // 2, ov

    def ov(u):
        return {"n_layers": u, "scan_layers": False}
    return cfg.n_layers, ov


# ---------------------------------------------------------------------------
# one step on meta tensors
# ---------------------------------------------------------------------------


def _meta_batch(cfg, batch: int, seq: int, train: bool) -> dict:
    """The batch on the meta device; to serve, without the labels, which
    only the loss reads (jit drops the reference's unused arguments)."""
    from repro_torch.models import zoo
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in zoo.batch_shapes(cfg, batch, seq).items()
            if train or k != "labels"}


def _build_step(cfg, shape, mesh, batch: int, parallelism: str = "tp",
                prefill_lastonly: bool = False, grad_only: bool = False):
    """Build the cell's model on the meta device and place it on ``mesh``
    (with ``mesh`` None, plain meta tensors under ``ModelContext()``).
    Returns (step, args, params, ctx, donated): ``step(*args)`` runs the
    cell's step once on the model's placed ``params`` (by name);
    ``donated`` are the arguments it updates in place (the reference
    donates them)."""
    from repro_torch.launch.shardings import (
        assemble, opt_state_shardings, place)
    from repro_torch.launch.steps import (
        build_loss_fn, build_prefill_step, build_serve_step,
        build_train_step)
    from repro_torch.models.sharding import ModelContext, mesh_scope
    from repro_torch.models.zoo import build_model
    from repro_torch.optim.adamw import AdamW
    train = shape.kind == "train"
    model = build_model(cfg, "meta", trainable=train)
    if mesh is None:
        ctx, sh = ModelContext(), None

        def put(obj, key):
            return obj
    else:
        ctx, sh = assemble(model, mesh, shape.kind, batch, shape.seq,
                           parallelism=parallelism)

        def put(obj, key):
            return place(obj, key if isinstance(key, dict) else sh[key],
                         mesh)
    compute = sh and sh["params"]
    data = put(_meta_batch(cfg, batch, shape.seq, train), "batch")
    if train:
        optimizer = AdamW(decayed=model.decayed())
        state = optimizer.init(dict(model.named_parameters()))
        put(model, "opt_params")
        state = put(state, sh and opt_state_shardings(sh["opt_params"],
                                                      mesh))
        params = dict(model.named_parameters())
        if grad_only:
            # the reference's probe: value_and_grad of one microbatch
            loss_fn = build_loss_fn(model, ctx, compute)

            def step(b):
                loss = loss_fn(b)
                with mesh_scope(ctx):
                    loss.backward()
                return loss.detach(), [p.grad for p in params.values()]
            return step, (data,), params, ctx, ()
        step = build_train_step(model, optimizer, ctx, compute=compute)
        return step, (state, data), params, ctx, (params, state)
    put(model, "params")
    params = dict(model.named_parameters())
    if shape.kind == "prefill":
        step = build_prefill_step(model, ctx, last_only=prefill_lastonly)
        return step, (data,), params, ctx, ()
    cache = put(model.init_cache(batch, shape.seq), "cache")
    toks, pos = (put(torch.empty(batch, dtype=torch.int32, device="meta"),
                     "tokens") for _ in range(2))
    return build_serve_step(model, ctx), (cache, toks, pos), params, ctx, \
        (cache,)


def _count(step, args, params) -> tuple:
    """Run ``step(*args)`` under a :class:`CostCounter` holding ``args``
    and ``params`` as live.  Returns (counter, outputs, argument bytes)."""
    counter = CostCounter()
    arg_bytes = counter.hold([params, list(args)])
    with counter:
        out = step(*args)
    return counter, out, arg_bytes


def _probe_count(cfg_p, shape, mesh, batch: int, parallelism: str = "tp",
                 prefill_lastonly: bool = False):
    """Count one probe variant; returns (flops, bytes, coll_s, coll)."""
    step, args, params, _, _ = _build_step(
        cfg_p, shape, mesh, batch, parallelism, prefill_lastonly,
        grad_only=True)
    c = _count(step, args, params)[0].costs()
    return c["flops"], c["bytes_accessed"], c["collective_s"], \
        c["collectives"]


def probed_costs(cfg, shape, mesh, parallelism: str = "tp",
                 prefill_lastonly: bool = False) -> "dict | None":
    """Per-device (flops, bytes, collective_s) fitted at 1 and 2 units and
    scaled to the full depth x microbatches, the reference's fit."""
    if cfg.family == "ssm":
        return None            # xlstm is python-unrolled: raw costs exact
    units_full, ov = _scan_unit_info(cfg)
    M = cfg.microbatches if shape.kind == "train" else 1
    batch = shape.batch // M if shape.kind == "train" else shape.batch
    vals = []
    for u in (1, 2):
        cfg_p = _dc.replace(cfg, **ov(u))
        vals.append(_probe_count(cfg_p, shape, mesh, batch, parallelism,
                                 prefill_lastonly))
    (f1, b1, c1, _), (f2, b2, c2, coll2) = vals
    per = (f2 - f1, b2 - b1, c2 - c1)
    fixed = (f1 - per[0], b1 - per[1], c1 - per[2])
    flops = M * (fixed[0] + per[0] * units_full)
    bytes_ = M * (fixed[1] + per[1] * units_full)
    coll_s = M * (fixed[2] + per[2] * units_full)
    if shape.kind == "train":
        n_dev_params = cfg.param_count() / _mesh_dims(mesh)[0]
        flops += _OPT_FLOPS_PER_PARAM * n_dev_params
        bytes_ += _OPT_BYTES_PER_PARAM * n_dev_params
    return {"flops": flops, "bytes_accessed": bytes_,
            "collective_s": coll_s,
            "probe_points": {"u1": {"flops": f1, "bytes": b1, "coll_s": c1},
                             "u2": {"flops": f2, "bytes": b2, "coll_s": c2}},
            "units_full": units_full, "microbatches": M}


class _FakeWorld:
    """A fake process group of ``size`` ranks, this process rank 0, open
    for the ``with`` block and destroyed after it (also on error)."""

    def __init__(self, size: int):
        self.size = size

    def __enter__(self):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        if dist.is_initialized():
            raise RuntimeError(
                "the dry run opens its own fake world; a process group is "
                "already open in this process")
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=self.size)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
        return False


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             overrides: "dict | None" = None,
             parallelism: str = "tp", no_probes: bool = False,
             prefill_lastonly: bool = False) -> dict:
    """One cell on a fake world of 256 (``single``) or 512 (``multi``)
    ranks, on meta tensors; the reference's record, with ``hlo_lines``
    replaced by ``local_ops``.  Raises when a process group is already
    open (the fake world needs the process to itself)."""
    t0 = time.time()
    cfg = get_config(arch)
    if overrides:
        cfg = _dc.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    multi = mesh_kind == "multi"
    with _FakeWorld(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        devices, _ = _mesh_dims(mesh)
        step, args, params, ctx, donated = _build_step(
            cfg, shape, mesh, shape.batch, parallelism, prefill_lastonly)
        record = {
            "arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "kind": shape.kind, "batch": shape.batch, "seq": shape.seq,
            "devices": int(devices), "parallelism": parallelism,
            "overrides": {k: str(v) for k, v in (overrides or {}).items()},
            "rules": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in ctx.rules.items()},
        }
        t_lower = time.time() - t0
        counter, out, arg_bytes = _count(step, args, params)
        t_compile = time.time() - t0 - t_lower

        # ---- memory ----
        # outputs: what the step returns, and what it updates in place
        # where the reference donates (the train step's weights and
        # AdamW state, the decode cache): the reference's aliased outputs
        from repro_torch.dtensor import local
        seen, out_bytes = set(), 0
        for t in _tensors([out, list(donated)]):
            if id(t) not in seen:
                seen.add(id(t))
                out_bytes += _nbytes(local(t))
        temp = max(counter.peak_bytes - arg_bytes, 0)
        record["memory"] = {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(temp),
            "peak_bytes_estimate": int(arg_bytes + temp),
        }
        costs = counter.costs()
        flops = costs["flops"]
        bytes_acc = costs["bytes_accessed"]
        coll = costs["collectives"]
        record["cost"] = {"flops": flops, "bytes_accessed": bytes_acc}
        record["collectives"] = coll
        record["local_ops"] = counter.local_ops

        raw_coll_s = collective_seconds(coll)
        record["raw_cost"] = {"flops": flops, "bytes_accessed": bytes_acc,
                              "collective_s": raw_coll_s}
        del step, args, params, out, donated, counter
        corrected = None
        if mesh_kind == "single" and not no_probes:
            corrected = probed_costs(cfg, shape, mesh, parallelism,
                                     prefill_lastonly)
        if corrected is not None:
            record["probe"] = {k: corrected[k] for k in
                               ("probe_points", "units_full",
                                "microbatches")}
            record["probe"]["fit"] = {
                k: corrected[k]
                for k in ("flops", "bytes_accessed", "collective_s")}
        coll_s = raw_coll_s
        comp_s = flops / PEAK_FLOPS
        mem_s = bytes_acc / HBM_BW
        mem_floor_s = analytic_memory_bytes(
            cfg, shape.kind, shape.batch, shape.seq, mesh) / HBM_BW
        mf = model_flops(cfg, shape.kind, shape.batch, shape.seq)
        per_dev_mf = mf / devices
        terms = {"compute_s": comp_s, "memory_s": mem_s,
                 "collective_s": coll_s}
        dominant = max(terms, key=terms.get)
        record["roofline"] = {
            **terms,
            "memory_floor_s": mem_floor_s,
            "dominant": dominant,
            "model_flops_global": mf,
            "model_flops_per_device": per_dev_mf,
            "useful_compute_ratio": (per_dev_mf / flops) if flops else 0.0,
            "bound_step_s": max(terms.values()),
            "roofline_fraction": (per_dev_mf / PEAK_FLOPS)
            / max(max(terms.values()), 1e-30),
        }
    record["timings"] = {"lower_s": round(t_lower, 1),
                         "compile_s": round(t_compile, 1),
                         "total_s": round(time.time() - t0, 1)}
    record["ok"] = True
    return record


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--parallelism", default="tp",
                    choices=["tp", "tp-sp", "fsdp", "vtp", "dp", "ring"])
    ap.add_argument("--set", default="", dest="overrides",
                    help="cfg overrides, e.g. microbatches=8,remat_policy=dots")
    ap.add_argument("--tag", default="",
                    help="suffix for the result key (perf iterations)")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip cost probes (memory-only iterations)")
    ap.add_argument("--prefill-lastonly", action="store_true",
                    help="prefill computes the vocab head on the last "
                         "position only (perf lever)")
    args = ap.parse_args()
    # DTensor's advice on sequential all-reduces and the CPU mesh's
    # all-to-all fallback, once a cell: the records carry what they cost
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    logging.getLogger("torch._logging").setLevel(logging.ERROR)

    overrides: dict = {}
    for kv in filter(None, args.overrides.split(",")):
        k, v = kv.split("=")
        overrides[k] = (int(v) if v.lstrip("-").isdigit()
                        else (v == "True" if v in ("True", "False") else v))

    archs = list(ARCH_NAMES) if (args.arch == "all" or args.all) \
        else args.arch.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for arch in archs:
        shapes = [s.name for s in shapes_for(arch)]
        if args.shape != "all":
            shapes = [s for s in args.shape.split(",") if s in shapes]
        for shape_name in shapes:
            for mesh_kind in meshes:
                key = f"{arch}|{shape_name}|{mesh_kind}"
                if args.tag:
                    key += f"#{args.tag}"
                if key in results and results[key].get("ok") \
                        and not args.force:
                    print(f"[skip] {key}")
                    continue
                print(f"[run ] {key} ...", flush=True)
                try:
                    rec = run_cell(arch, shape_name, mesh_kind,
                                   overrides=overrides or None,
                                   parallelism=args.parallelism,
                                   no_probes=args.no_probes,
                                   prefill_lastonly=args.prefill_lastonly)
                    rec["tag"] = args.tag
                    rl = rec["roofline"]
                    print(f"[ ok ] {key}: dominant={rl['dominant']} "
                          f"compute={rl['compute_s']:.4f}s "
                          f"memory={rl['memory_s']:.4f}s "
                          f"collective={rl['collective_s']:.4f}s "
                          f"frac={rl['roofline_fraction']:.3f} "
                          f"(compile {rec['timings']['compile_s']}s)",
                          flush=True)
                except Exception as e:                     # noqa: BLE001
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "ok": False,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[FAIL] {key}: {rec['error']}", flush=True)
                results[key] = rec
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"dry-run complete: {n_ok}/{len(results)} cells OK")


if __name__ == "__main__":
    main()
