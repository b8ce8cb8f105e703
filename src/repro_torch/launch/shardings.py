"""Per-(arch x shape x mesh) sharding assembly of the port, the
counterpart of the reference's ``repro.launch.shardings``, function for
function.

Three rule tables (logical axis -> mesh axes) drive everything:

* **activation rules** — threaded through model code via ModelContext;
* **parameter rules** — how the model weights land (megatron TP layout);
* **optimizer rules** — ZeRO-style: parameter rules *plus* ``d_model`` over
  the ``data`` axis, so the f32 master params and the Adam moments are
  sharded over the whole mesh.

Divisibility fallbacks are computed here (e.g. long_500k's batch=1 cannot
shard over ``data`` — the KV cache seq dim takes every mesh axis instead;
xlstm's 4 heads cannot TP-shard — training batch spreads over
``data x model``).

Where the reference returns ``NamedSharding``s, the port returns DTensor
placements (one a mesh dim, :func:`repro_torch.models.sharding.placements`)
keyed like the port's tensors: a model's parameters by their
``named_parameters()`` names, a batch by its keys, a cache in its own
layout.  :func:`place` puts a model's parameters, a batch or a cache onto
the mesh by them, the counterpart of jit's ``in_shardings``.  The
reference's ``unroll_scans`` (a cost-probe switch of XLA) has no
counterpart.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.distributed.tensor import Replicate

from repro_torch.configs.base import ArchConfig
from repro_torch.dtensor import distribute, is_dtensor
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models import zoo
from repro_torch.models.sharding import (
    ModelContext, default_rules, placements, resolve_spec)


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in axes)


def _divisible_prefix(mesh, candidates: tuple, size: int) -> tuple:
    """Longest prefix of candidate axes whose product divides ``size``."""
    out = []
    for a in candidates:
        trial = out + [a]
        if size % _axes_size(mesh, tuple(trial)) == 0:
            out = trial
        else:
            break
    return tuple(out)


def make_rules(cfg: ArchConfig, mesh, kind: str, batch: int,
               seq_parallel: bool = False,
               parallelism: str = "tp") -> dict:
    """parallelism:
      "tp"    - megatron TP over `model` + DP over `pod`x`data` (baseline)
      "tp-sp" - TP + sequence-parallel residuals
      "fsdp"  - pure data parallelism over EVERY axis + fully-sharded
                params
      "dp"    - pure data parallelism, the model axis replicated
      "ring"  - sequence parallelism for SSM/xLSTM: S over `model`
      "vtp"   - mLSTM value-dim TP: q/k replicated, v sharded over
                `model`
    """
    if parallelism == "tp-sp":
        seq_parallel = True
    names = tuple(mesh.mesh_dim_names)
    n_model = mesh_shape(mesh)["model"]
    multi_pod = "pod" in names
    rules = default_rules(multi_pod=multi_pod, seq_parallel=seq_parallel)
    dp_candidates = ("pod", "data") if multi_pod else ("data",)
    if parallelism == "fsdp" or (cfg.family == "ssm" and kind == "train"):
        # fsdp: batch over the model axis too; xlstm: 4 heads can't
        # TP-shard regardless
        dp_candidates = dp_candidates + ("model",)
    batch_axes = _divisible_prefix(mesh, dp_candidates, batch)
    rules["batch"] = batch_axes if batch_axes else None
    # heads: only shard if divisible
    if cfg.n_heads % n_model != 0 or "model" in (batch_axes or ()):
        rules["heads"] = None
    if kind == "decode":
        # KV-cache seq dim takes every mesh axis the batch doesn't use
        leftover = tuple(a for a in names if a not in (batch_axes or ()))
        rules["kv_seq"] = leftover if leftover else None
    # ssm heads shardable?
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // max(cfg.ssm_head_dim, 1) if cfg.ssm_head_dim else 0
    if cfg.family == "ssm":
        nh = cfg.n_heads
    if nh and nh % n_model != 0:
        rules["ssm_heads"] = None
    if "model" in (batch_axes or ()):
        rules["ssm_heads"] = None
        rules["d_ff"] = None
        rules["vocab"] = None
        rules["heads"] = None
    if parallelism == "dp":
        rules["d_ff"] = None
        rules["heads"] = None
        rules["ssm_heads"] = None
        rules["vocab"] = None
    if parallelism == "ring":
        # S over `model`; projections are position-wise (no comm); the
        # mLSTM inter-chunk state crosses ranks by one all_gather of
        # per-rank affine maps
        rules["seq"] = "model"
        rules["d_ff"] = None
        rules["ssm_heads"] = None
        rules["heads"] = None
        rules["vocab"] = None
    if parallelism == "vtp":
        # mLSTM value-dim TP: only down_proj all-reduces
        rules["xlstm_hd"] = "model"
        rules["d_ff"] = None
        rules["ssm_heads"] = None
    rules["_parallelism"] = parallelism
    return rules


def zero_rules(rules: dict) -> dict:
    """Optimizer-state / master-param rules: fully shard the largest
    remaining dim.  Under TP: d_model over `data` (params: TP x
    ZeRO-data).  Under FSDP: d_model over (data, model)."""
    out = dict(rules)
    if rules.get("_parallelism") == "fsdp":
        out["d_model"] = ("data", "model")
    else:
        out["d_model"] = "data"
    return out


def _spec_from_names(names, rules: dict) -> tuple:
    """Logical names to a spec, de-duplicating mesh axes (earlier dims
    win): the entries of the reference's ``PartitionSpec``."""
    return resolve_spec(names, rules)


def _is_names(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _tree_map(fn, tree, is_leaf):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, is_leaf) for v in tree)
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def tree_shardings(spec_names_tree, rules: dict, mesh):
    """Map a tree (dicts, lists, tuples) of logical-axis-name tuples to
    placements on ``mesh``."""
    return _tree_map(
        lambda names: placements(_spec_from_names(names, rules), mesh),
        spec_names_tree, _is_names)


def assemble(model, mesh, kind: str, batch: int, seq: int,
             seq_parallel: bool = False, attention_impl: str = "auto",
             moe_impl: str = "auto", parallelism: str = "tp",
             rules: Optional[dict] = None):
    """Returns (ctx, placements dict) for one launch cell: ``params``
    and ``opt_params`` (ZeRO) keyed by parameter name, ``batch`` by the
    batch's keys and, for ``decode``, ``cache`` in the cache's layout and
    ``tokens`` (the decode step's ids and positions)."""
    cfg = model.cfg
    rules = rules or make_rules(cfg, mesh, kind, batch, seq_parallel,
                                parallelism)
    ctx = ModelContext(mesh=mesh, rules=rules,
                       attention_impl=attention_impl, moe_impl=moe_impl)
    specs = zoo.param_specs(model)
    out = {"params": tree_shardings(specs, rules, mesh),
           "opt_params": tree_shardings(specs, zero_rules(rules), mesh),
           "batch": tree_shardings(zoo.batch_logical_axes(cfg), rules,
                                   mesh)}
    if kind == "decode":
        out["cache"] = tree_shardings(zoo.cache_specs(cfg), rules, mesh)
        out["tokens"] = placements(_spec_from_names(("batch",), rules), mesh)
    return ctx, out


def opt_state_shardings(opt_param_sh, mesh) -> dict:
    """AdamW state placements: moments follow the (ZeRO) param
    placements; the step is replicated."""
    return {"m": opt_param_sh, "v": opt_param_sh,
            "step": (Replicate(),) * mesh.ndim}


def _owner(model: nn.Module, name: str) -> tuple:
    *path, leaf = name.split(".")
    mod = model
    for part in path:
        mod = getattr(mod, part)
    return mod, leaf


@torch.no_grad()
def place(obj, shardings, mesh):
    """Put ``obj`` onto ``mesh`` by ``shardings`` (from :func:`assemble`),
    the counterpart of jit's ``in_shardings``.  ``obj`` is a model (each
    parameter replaced in place by a DTensor parameter of its placements,
    ``requires_grad`` kept; the model is returned), a batch dict, a
    cache, an optimizer state or a tensor (returned as DTensors).  Every
    rank holds a plain tensor whole and keeps its shard, with no
    communication; a DTensor parameter is redistributed."""
    if isinstance(obj, nn.Module):
        for name, p in list(obj.named_parameters()):
            mod, leaf = _owner(obj, name)
            sh = tuple(shardings[name])
            t = (p.detach().redistribute(mesh, sh) if is_dtensor(p)
                 else distribute(p.detach(), mesh, sh))
            setattr(mod, leaf, nn.Parameter(t, requires_grad=p.requires_grad))
        return obj
    if isinstance(obj, torch.Tensor):
        return distribute(obj, mesh, shardings)
    if isinstance(obj, dict):
        return {k: place(v, shardings[k], mesh) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(place(v, s, mesh) for v, s in zip(obj, shardings))
    raise TypeError(f"place: cannot place a {type(obj).__name__}")


@torch.no_grad()
def gather(obj):
    """The inverse of :func:`place`: each DTensor made whole on every
    rank (a model's parameters replaced in place; the model returned)."""
    if isinstance(obj, nn.Module):
        for name, p in list(obj.named_parameters()):
            if is_dtensor(p):
                mod, leaf = _owner(obj, name)
                setattr(mod, leaf, nn.Parameter(
                    p.full_tensor(), requires_grad=p.requires_grad))
        return obj
    if is_dtensor(obj):
        return obj.full_tensor()
    if isinstance(obj, dict):
        return {k: gather(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(gather(v) for v in obj)
    return obj
