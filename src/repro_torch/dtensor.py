"""DTensor helpers shared by the port's kernels, models, optimizer and
launch code: what a rank holds of a tensor placed on a
``torch.distributed`` ``DeviceMesh``, and the scope in which plain
tensors count as replicated beside DTensors.

Every helper takes plain tensors too (a rank then holds the whole), so
the single-device path calls them unchanged.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)
from torch.distributed.tensor.experimental import implicit_replication

__all__ = ["DTensor", "is_dtensor", "distribute", "on_mesh", "whole",
           "local", "spread_over", "local_span", "keep_shards",
           "splittable", "cumsum", "matmul", "replicated_scope"]


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def distribute(x: torch.Tensor, mesh, place: Sequence) -> torch.Tensor:
    """A DTensor of ``x`` (the whole tensor, equal on every rank) on
    ``mesh`` with placements ``place``: each rank keeps its shard, with
    no communication (a view where a rank keeps the whole)."""
    whole_t = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    return whole_t.redistribute(mesh, tuple(place))


def on_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as a DTensor on ``mesh``: a plain tensor (every rank's the
    same) counts as replicated."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def whole(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor on every rank, or ``t``."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (a view: writes go through), or
    ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def spread_over(t: torch.Tensor, dim: int) -> list:
    """The mesh dims of more than one rank over which the DTensor ``t``
    shards its dim ``dim`` (empty for a plain tensor)."""
    if not isinstance(t, DTensor):
        return []
    dim %= t.ndim
    return [i for i, p in enumerate(t.placements)
            if p.is_shard(dim) and t.device_mesh.size(i) > 1]


def local_span(t: torch.Tensor, dim: int) -> tuple:
    """(start, length) of this rank's shard of the DTensor ``t`` along
    ``dim``, in the global index space."""
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    dim %= t.ndim
    return offset[dim], shape[dim]


def keep_shards(t, dims: dict) -> tuple:
    """Placements of the DTensor ``t`` with only the shards of its dims
    ``dims`` kept, each renumbered ``{old dim: new dim}``; every other
    mesh dim ``Replicate()``.  A shard over a one-rank mesh dim is kept
    as it is (it holds the whole dim, and keeping it moves nothing)."""
    mesh = t.device_mesh
    out = []
    for i, p in enumerate(t.placements):
        if p.is_shard() and p.dim in dims:
            out.append(Shard(dims[p.dim]))
        elif p.is_shard() and mesh.size(i) == 1:
            out.append(p)
        else:
            out.append(Replicate())
    return tuple(out)


def splittable(t: torch.Tensor, dim: int, lead: int) -> torch.Tensor:
    """``t`` placed so that its dim ``dim`` can be split into (``lead``,
    rest) by a reshape: DTensor puts a split dim's shards on ``lead``, and
    refuses the split unless their rank count divides it.  Each mesh dim
    whose shard of ``dim`` would not divide (counted in mesh order, as
    DTensor nests them) becomes ``Replicate()``, an all-gather; ``t`` is
    returned as it is when the shards divide (GSPMD pads instead), or
    when ``lead`` is 1 (DTensor then shards the rest)."""
    if not isinstance(t, DTensor) or lead == 1:
        return t
    dim %= t.ndim
    mesh = t.device_mesh
    out, n = list(t.placements), 1
    for i, p in enumerate(t.placements):
        if p.is_shard(dim) and mesh.size(i) > 1:
            if lead % (n * mesh.size(i)):
                out[i] = Replicate()
            else:
                n *= mesh.size(i)
    if out == list(t.placements):
        return t
    return t.redistribute(mesh, tuple(out))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of activations x (..., K) and a weight w (K, N).  On
    DTensors, per rank under ``local_map`` with the placements GSPMD gives
    the reference's dot, where they follow from the operands' on every
    mesh dim: x's shards of its leading dims kept, w's shard of N on the
    last dim, a partial sum where either shards K (the other operand is
    then split along K where it is whole, a local slice); the gradients'
    placements follow (x's partial where w splits N, w's partial where x
    splits the rows).  Otherwise (a partial operand, shards that clash)
    DTensor's own product, whose strategy search is slow on a 3-D mesh
    and may pick another layout."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)) or w.ndim != 2:
        return x @ w
    mesh, last = w.device_mesh, x.ndim - 1
    R = Replicate()
    # per mesh dim: (x's, w's, the output's, x's grad's, w's grad's)
    dims = []
    for i, (px, pw) in enumerate(zip(x.placements, w.placements)):
        if mesh.size(i) == 1:
            px = pw = R
        if px.is_shard() and px.dim < last and pw.is_replicate():
            dims.append((px, pw, px, px, Partial()))
        elif px.is_replicate() and pw.is_shard(1):
            dims.append((px, pw, Shard(last), Partial(), pw))
        elif px.is_shard(last) and pw.is_shard(0):
            dims.append((px, pw, Partial(), px, pw))
        elif px.is_shard(last) and pw.is_replicate():
            # w split along K where x is: a local slice of it
            dims.append((px, Shard(0), Partial(), px, Shard(0)))
        elif px.is_replicate() and pw.is_shard(0):
            dims.append((Shard(last), pw, Partial(), Shard(last), pw))
        elif px.is_replicate() and pw.is_replicate():
            dims.append((R, R, R, R, R))
        else:
            return x @ w
    from torch.distributed.tensor.experimental import local_map
    px, pw, out, gx, gw = (tuple(col) for col in zip(*dims))
    return local_map(torch.matmul, out_placements=list(out),
                     in_placements=(px, pw), in_grad_placements=(gx, gw),
                     device_mesh=mesh, redistribute_inputs=True)(x, w)


def cumsum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t.cumsum(dim)``; on a DTensor per shard under ``local_map`` (the
    dim gathered first where it is sharded), since some DTensor versions
    have no rule for ``flip``, which its backward runs."""
    if not isinstance(t, DTensor):
        return t.cumsum(dim)
    from torch.distributed.tensor.experimental import local_map
    dim %= t.ndim
    p = tuple(Replicate() if q.is_shard(dim) or q.is_partial() else q
              for q in t.placements)
    return local_map(lambda x: x.cumsum(dim), out_placements=list(p),
                     in_placements=(p,), in_grad_placements=(p,),
                     device_mesh=t.device_mesh,
                     redistribute_inputs=True)(t)


def replicated_scope():
    """``implicit_replication``, re-entrant: plain tensors made inside
    (positions, masks, zero states) count as replicated beside DTensors.
    The flag is thread-local state that autograd hands to its worker
    threads, so a ``backward`` run inside sees it too."""
    if torch._C._get_dtensor_allow_implicit_replication():
        return contextlib.nullcontext()
    return implicit_replication()
