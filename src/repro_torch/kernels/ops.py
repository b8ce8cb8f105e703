"""Public entry points of the port's kernels, as the reference's
``repro.kernels.ops`` has them for its Pallas kernels.

The reference's ``block_q``/``block_k``/``block_rows`` (TPU tile sizes)
and ``interpret`` (Pallas on the CPU) have no counterpart: each kernel
picks its own tiles, and a CPU tensor runs the plain PyTorch version.

Under a device mesh (DTensor inputs) each kernel runs on every rank's
local shard through ``local_map``, which is exact: attention is per
request and per head, RMSNorm per row (``d_model`` is never sharded; a
row split over ranks, as a Mamba2 ``out_norm`` over head-sharded
channels, is gathered first), the SSD scan per request and per SSM
head.  The inputs are
first redistributed to keep only those shards.  With the query heads
sharded and the KV heads replicated, each rank's attention reads the KV
heads its own query heads read (one, at granite-34b's single KV head).
Flash decode wants each rank to hold the whole cache; a cache sharded
along its sequence over more than one rank runs the grouped einsum
instead (:func:`repro_torch.models.layers.decode_attention`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.dtensor import (
    is_dtensor, keep_shards, local_span, on_mesh, spread_over, whole)
from repro_torch.kernels.decode_attention import flash_decode as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm
from repro_torch.kernels.ssm_scan import ssd_state_scan as _scan


def _like_batch(place: tuple) -> tuple:
    """The placements of a tensor that follows ``place``'s shards of dim 0
    (the batch) and is replicated otherwise."""
    return tuple(Shard(0) if p.is_shard(0) else Replicate() for p in place)


def _kv_heads(q: torch.Tensor, hdim: int, n_kv: int) -> tuple:
    """[lo, hi) of the KV heads that this rank's query heads (dim
    ``hdim`` of the DTensor ``q``) read, query head h reading KV head
    h // (H / KV)."""
    H = q.shape[hdim]
    G = H // n_kv
    h0, hl = local_span(q, hdim)
    lo, hi = h0 // G, (h0 + hl - 1) // G + 1
    if not ((hi - lo) * G == hl or (hi - lo == 1 and G % hl == 0)):
        raise ValueError(f"query heads [{h0}, {h0 + hl}) of {H} do not "
                         f"cover whole groups of {G} or lie in one")
    return lo, hi


def _local_map(fn, out_place, in_place, mesh, grads=None):
    return local_map(fn, out_placements=out_place, in_placements=in_place,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,H,hd); k, v: (B,T,KV,hd); positions (S,)/(T,).  Returns
    (B,S,H,hd) in q's dtype."""
    kw = dict(causal=causal, window=window, logit_cap=logit_cap, scale=scale)
    if not is_dtensor(q):
        return _flash(q, k, v, q_pos, k_pos, **kw)
    return attention_on_shards(_flash, q, k, v, q_pos, k_pos, **kw)


def attention_on_shards(fn, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, q_pos: torch.Tensor,
                        k_pos: torch.Tensor, **kw) -> torch.Tensor:
    """``fn(q, k, v, q_pos, k_pos, **kw)`` (an attention of
    :func:`flash_attention`'s signature) on each rank's requests and query
    heads of the DTensor ``q``, with the KV heads they read; the sequence
    and the head dim whole on every rank."""
    mesh = q.device_mesh
    pq = keep_shards(q, {0: 0, 2: 2})
    pkv = _like_batch(pq)
    # k's and v's gradients: where the query heads are split over ranks,
    # each rank's holds its heads' part (zero outside its KV heads)
    gkv = tuple(Partial() if p.is_shard(2) and mesh.size(i) > 1 else g
                for i, (p, g) in enumerate(zip(pq, pkv)))
    q = q.redistribute(mesh, pq)
    lo, hi = _kv_heads(q, 2, k.shape[2])
    q_pos, k_pos = whole(q_pos), whole(k_pos)

    def local(q_l, k_l, v_l):
        return fn(q_l, k_l[:, :, lo:hi], v_l[:, :, lo:hi], q_pos, k_pos, **kw)
    return _local_map(local, list(pq), (pq, pkv, pkv), mesh,
                      grads=(pq, gkv, gkv))(
        q, on_mesh(k, mesh), on_mesh(v, mesh))


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: torch.Tensor, *,
                 window: int = 0, logit_cap: float = 0.0,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,hd); caches: (B,T,KV,hd); pos: (B,).  Returns (B,H,hd) in
    q's dtype.  Under a mesh every rank must hold its requests' whole
    cache."""
    kw = dict(window=window, logit_cap=logit_cap, scale=scale)
    if not is_dtensor(q):
        return _decode(q, k_cache, v_cache, pos, **kw)
    mesh = q.device_mesh
    if spread_over(k_cache, 1) or spread_over(v_cache, 1):
        raise ValueError("flash_decode: the cache's sequence is sharded over "
                         "more than one rank; each rank must hold it whole")
    pq = keep_shards(q, {0: 0, 1: 1})
    pb = _like_batch(pq)
    q = q.redistribute(mesh, pq)
    lo, hi = _kv_heads(q, 1, k_cache.shape[2])

    def local(q_l, k_l, v_l, p_l):
        return _decode(q_l, k_l[:, :, lo:hi], v_l[:, :, lo:hi], p_l, **kw)
    return _local_map(local, list(pq), (pq, pb, pb, pb), mesh)(
        q, on_mesh(k_cache, mesh), on_mesh(v_cache, mesh),
        on_mesh(pos, mesh))


def ssd_state_scan(states: torch.Tensor, totals: torch.Tensor,
                   C: torch.Tensor, cum: torch.Tensor):
    """states: (B,nc,nh,hd,N); totals: (B,nc,nh); C: (B,nc,Q,N); cum:
    (B,nc,Q,nh).  Returns (y_inter (B,nc,Q,nh,hd), final_state
    (B,nh,hd,N)).  Plain tensors: on a mesh the whole chunked SSD runs per
    shard (``mamba2._ssd_on_shards``)."""
    return _scan(states, totals, C, cum)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """x: (..., D); w: (D,).  Fused RMSNorm in x's dtype."""
    if not is_dtensor(x):
        return _rmsnorm(x, whole(w), eps=eps)
    # rows whole on every rank: a row split over ranks (a Mamba2
    # out_norm over head-sharded channels) is gathered first
    mesh = x.device_mesh
    px = keep_shards(x, {d: d for d in range(x.ndim - 1)})
    w = whole(w)
    return _local_map(lambda x_l: _rmsnorm(x_l, w, eps=eps), list(px),
                      (px,), mesh)(x)
