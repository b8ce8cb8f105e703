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
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)
from torch.distributed.tensor.experimental import implicit_replication

__all__ = ["DTensor", "is_dtensor", "distribute", "on_mesh", "whole",
           "local", "spread_over", "local_span", "keep_shards",
           "replicated_scope"]


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


def replicated_scope():
    """``implicit_replication``, re-entrant: plain tensors made inside
    (positions, masks, zero states) count as replicated beside DTensors.
    The flag is thread-local state that autograd hands to its worker
    threads, so a ``backward`` run inside sees it too."""
    if torch._C._get_dtensor_allow_implicit_replication():
        return contextlib.nullcontext()
    return implicit_replication()
