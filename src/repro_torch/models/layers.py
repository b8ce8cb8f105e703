"""Shared neural layers of the port: RMSNorm, RoPE, GQA attention (three
implementations), SwiGLU MLP, embeddings, loss.  The counterpart of the
reference's ``repro.models.layers``, function for function.

Attention implementations (``ModelContext.attention_impl``):

* ``reference`` — materializes the full (S, T) score matrix; the oracle
  and the small-sequence default.
* ``blocked``   — online softmax over KV blocks in plain PyTorch; O(S*block)
  memory.
* ``pallas``    — the hand-written kernels (on CPU tensors their plain
  versions): flash attention for train/prefill, flash decode for
  :func:`decode_attention`, and the fused RMSNorm for :func:`rmsnorm`.
  The name is the reference's switch for its Pallas kernels, whose oracles
  are these layers (``repro.kernels.ref``).

K/V are expanded to the full head count for train/prefill attention;
decode attends with a grouped einsum against the KV cache, or the flash
decode kernel.

Under a mesh (``ModelContext.distributed``) the tensors are DTensors and
the layers the same code: the kernels run per shard
(:mod:`repro_torch.kernels.ops`), and decode against a cache sharded
along its sequence over more than one rank takes the grouped einsum on
each rank's slice, combined by log-sum-exp, under every
``attention_impl``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.dtensor import (
    is_dtensor, local_span, matmul, on_mesh, spread_over, whole)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.decode_attention import flash_decode_ref
from repro_torch.kernels.flash_attention import (
    NEG_INF, _expand_kv, _mask_bias, flash_attention_ref, softcap)
from repro_torch.kernels.rmsnorm import rmsnorm_ref
from repro_torch.models.remat import mlp_output
from repro_torch.models.sharding import ModelContext

__all__ = ["NEG_INF", "rmsnorm", "softcap", "rope", "attention_reference",
           "attention_blocked", "attention", "decode_attention", "swiglu",
           "embed", "unembed", "cross_entropy"]


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            ctx: Optional[ModelContext] = None) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` with float32 statistics,
    cast back to x's dtype; the fused kernel under ``pallas``."""
    if ctx is not None and ctx.attention_impl == "pallas":
        return kops.rmsnorm(x, w, eps=eps)
    return rmsnorm_ref(x, w, eps)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, n, hd); positions: broadcastable to (..., S).  Half-split
    rotation with float32 angles, cast back to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def attention_reference(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                        logit_cap=0.0, scale=None,
                        ctx: Optional[ModelContext] = None) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,T,KV,hd) -> (B,S,H,hd). Full score matrix."""
    return flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                               window=window, logit_cap=logit_cap,
                               scale=scale)


def attention_blocked(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                      logit_cap=0.0, scale=None, block=1024,
                      ctx: Optional[ModelContext] = None) -> torch.Tensor:
    """Online softmax over KV blocks (the flash-attention recurrence in
    plain PyTorch): memory O(S*block) instead of O(S*T), the same math as
    ``attention_reference``.

    The last block is simply shorter when ``block`` does not divide T.
    (The reference pads T for its ``lax.scan`` with zero keys at position
    -1e9, which a causal mask without a window leaves visible, so there
    its result departs from ``attention_reference``; the port does not
    pad.)"""
    B, S, H, hd = q.shape
    T = k.shape[1]
    scale = (hd ** -0.5) if scale is None else scale
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    qf = q.float() * scale
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, hd), dtype=torch.float32, device=q.device)
    for j in range(0, T, block):
        k_j = k[:, j:j + block].float()
        v_j = v[:, j:j + block].float()
        s = torch.einsum("bshd,bthd->bhst", qf, k_j)
        if logit_cap > 0:
            s = softcap(s, logit_cap)
        s = s + _mask_bias(q_pos, k_pos[j:j + block], causal, window)[None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bthd->bhsd", p, v_j)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention(q, k, v, q_pos, k_pos, *, causal=True, window=0,
              logit_cap=0.0, scale=None,
              ctx: Optional[ModelContext] = None) -> torch.Tensor:
    """Dispatch by ctx.attention_impl (auto: blocked beyond threshold)."""
    impl = ctx.attention_impl if ctx is not None else "auto"
    if impl == "pallas":
        return kops.flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                                    window=window, logit_cap=logit_cap,
                                    scale=scale)
    if impl == "auto":
        thresh = ctx.blocked_threshold if ctx is not None else 2048
        impl = "blocked" if q.shape[1] > thresh else "reference"
    fn = attention_blocked if impl == "blocked" else attention_reference
    kw = dict(causal=causal, window=window, logit_cap=logit_cap, scale=scale)
    if is_dtensor(q):
        # per request and per head, on each rank's shard
        return kops.attention_on_shards(fn, q, k, v, q_pos, k_pos, **kw)
    return fn(q, k, v, q_pos, k_pos, ctx=ctx, **kw)


def decode_attention(q, k_cache, v_cache, pos, *, window=0, logit_cap=0.0,
                     scale=None, ctx: Optional[ModelContext] = None
                     ) -> torch.Tensor:
    """One-token attention against the KV cache.

    q: (B, H, hd); k_cache/v_cache: (B, T, KV, hd); pos: (B,) index of the
    current token (already written into the cache).  Grouped einsum, no
    KV expansion (the flash decode kernel under ``pallas``, unless the
    cache's sequence is sharded over more than one rank: then
    :func:`_decode_on_shards` under every impl); keys past ``pos`` (and
    outside the window) are masked.
    """
    kw = dict(window=window, logit_cap=logit_cap, scale=scale)
    if spread_over(k_cache, 1):
        return _decode_on_shards(q, k_cache, v_cache, pos, **kw)
    fn = (kops.flash_decode
          if ctx is not None and ctx.attention_impl == "pallas"
          else flash_decode_ref)
    return fn(q, k_cache, v_cache, pos, **kw)


def _partial_decode(q, k, v, pos, t0: int, *, window, logit_cap, scale):
    """The grouped einsum of :func:`flash_decode_ref` over the cache's
    positions t0.. t0 + T - 1 only: the max score m, the sum l of
    exp(s - m) and the unnormalized output o (f32), each (B, KV, G[, hd])."""
    B, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    scale = (hd ** -0.5) if scale is None else scale
    qg = q.reshape(B, KV, H // KV, hd).float() * scale
    s = torch.einsum("bkgh,btkh->bkgt", qg, k.float())
    if logit_cap > 0:
        s = softcap(s, logit_cap)
    t_idx = torch.arange(t0, t0 + T, device=q.device)
    ok = t_idx[None, :] <= pos[:, None]
    if window > 0:
        ok &= (pos[:, None] - t_idx[None, :]) < window
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(dim=-1), torch.einsum("bkgt,btkh->bkgh", p, v.float())


def _decode_on_shards(q, k_cache, v_cache, pos, **kw) -> torch.Tensor:
    """Decode attention against a cache sharded along its sequence (a
    DTensor, ``kv_seq`` over more than one rank), per rank under
    ``local_map``: each rank attends over its slice of the positions
    (:func:`_partial_decode`) with every query head of its requests, and
    the slices combine by their log-sum-exp, one all-reduce of the maxima
    and one of the rescaled sums and outputs over the ranks that split the
    sequence.  Under every ``attention_impl``: the kernel normalizes
    within its slice."""
    import torch.distributed as dist
    mesh = k_cache.device_mesh
    pc = tuple(p if p.is_shard() and p.dim in (0, 1) else Replicate()
               for p in k_cache.placements)
    pb = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pc)
    k_cache = k_cache.redistribute(mesh, pc)
    v_cache = v_cache.redistribute(mesh, pc)
    t0, _ = local_span(k_cache, 1)
    groups = [mesh.get_group(i) for i in spread_over(k_cache, 1)]

    def local(ql, kl, vl, pl):
        m, l, o = _partial_decode(ql, kl, vl, pl, t0, **kw)
        top = m.clone()
        for g in groups:
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
        f = torch.exp(m - top)
        lo = torch.cat([o * f[..., None], (l * f)[..., None]], dim=-1)
        for g in groups:
            dist.all_reduce(lo, group=g)
        out = lo[..., :-1] / lo[..., -1:]
        return out.reshape(ql.shape).to(ql.dtype)
    return local_map(local, out_placements=list(pb),
                     in_placements=(pb, pc, pc, pb), device_mesh=mesh,
                     redistribute_inputs=True)(
        on_mesh(q, mesh), k_cache, v_cache, on_mesh(pos, mesh))


# --------------------------------------------------------------------------
# MLP / embeddings / loss
# --------------------------------------------------------------------------


def swiglu(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
           ctx: Optional[ModelContext] = None) -> torch.Tensor:
    """wi: (D, 2F) fused gate+up; wo: (F, D).  The output product runs
    through :func:`~repro_torch.models.remat.mlp_output`, which tells the
    dots remat policy whether backward reads it."""
    h = matmul(x, wi.to(x.dtype))
    gate, up = _halves(h)
    h = F.silu(gate) * up
    if ctx is not None and x.ndim == 3:
        h = ctx.shard(h, "batch", "attn_seq", "d_ff")
    return mlp_output(h, wo.to(x.dtype))


def _halves(h: torch.Tensor) -> tuple:
    """``h.chunk(2, dim=-1)``: the gate and the up projection.  Where the
    fused columns are sharded over one mesh dim of an even n ranks (``d_ff``
    over ``model``), ranks 0..n/2-1 hold the gate's columns and the rest
    the up projection's; one ``all_to_all`` gives each rank its column
    block of both halves (half its shard moves, GSPMD's
    collective-permute), where DTensor would gather ``h`` whole."""
    dims = spread_over(h, -1)
    if len(dims) != 1 or any(p.is_partial() for p in h.placements):
        return h.chunk(2, dim=-1)
    import torch.distributed._functional_collectives as funcol
    mesh, i = h.device_mesh, dims[0]
    n = mesh.size(i)
    if n % 2 or h.shape[-1] % (2 * n):
        return h.chunk(2, dim=-1)
    r, group, half = mesh.get_local_rank(i), mesh.get_group(i), n // 2

    def local(hl):
        lead, w = hl.shape[:-1], hl.shape[-1] // 2
        rows = hl.numel() // (2 * w)
        # rank r's two column blocks go to ranks 2 (r mod n/2) and the
        # next; its gate block comes from rank r // 2, its up block from
        # rank n/2 + r // 2
        send, recv = [0] * n, [0] * n
        send[2 * (r % half)] = send[2 * (r % half) + 1] = rows
        recv[r // 2] = recv[half + r // 2] = rows
        blocks = hl.reshape(rows, 2, w).transpose(0, 1).reshape(2 * rows, w)
        got = funcol.all_to_all_single_autograd(blocks.contiguous(), recv,
                                                send, group)
        gate, up = got.reshape(2, *lead, w).unbind(0)
        return gate, up
    p = list(h.placements)
    return local_map(local, out_placements=(p, p), in_placements=(p,),
                     in_grad_placements=(p,), device_mesh=mesh)(h)


def embed(tokens: torch.Tensor, table: torch.Tensor,
          ctx: Optional[ModelContext] = None) -> torch.Tensor:
    out = (_embed_on_shards(tokens, table) if is_dtensor(table)
           else table[whole(tokens)])
    if ctx is not None and out.ndim == 3:
        out = ctx.shard(out, "batch", "seq", "d_model")
    return out


def _embed_on_shards(tokens: torch.Tensor, table: torch.Tensor
                     ) -> torch.Tensor:
    """The lookup of a vocab-sharded table (a DTensor), per rank under
    ``local_map``: each rank looks up the tokens of its rows that fall in
    its rows of the vocab (zero for the rest), so the result is partial
    over the mesh dims that split the vocab.  A table sharded along
    d_model (the ZeRO layout) is gathered along it first."""
    mesh = table.device_mesh
    tokens = on_mesh(tokens, mesh)
    pt = tuple(Shard(0) if p.is_shard(0) and tokens.ndim > 0 else Replicate()
               for p in tokens.placements)
    ptab = tuple(Shard(0) if p.is_shard(0) and mesh.size(i) > 1
                 else Replicate() for i, p in enumerate(table.placements))
    table = table.redistribute(mesh, ptab)
    v0, vl = local_span(table, 0)
    split = [t.is_shard() and v.is_shard() and mesh.size(i) > 1
             for i, (t, v) in enumerate(zip(pt, ptab))]
    if any(split):
        raise ValueError("embed: the batch and the vocab split over one "
                         "mesh dim")
    out_p = [Partial() if v.is_shard() else t for t, v in zip(pt, ptab)]
    g_tab = tuple(v if v.is_shard() else
                  Partial() if t.is_shard() and mesh.size(i) > 1
                  else Replicate() for i, (t, v) in enumerate(zip(pt, ptab)))

    def local(tok, tab):
        ok = (tok >= v0) & (tok < v0 + vl)
        rows = tab[(tok.long() - v0).clamp(0, vl - 1)]
        return torch.where(ok[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
    return local_map(local, out_placements=out_p, in_placements=(pt, ptab),
                     in_grad_placements=(pt, g_tab), device_mesh=mesh,
                     redistribute_inputs=True)(tokens, table)


def unembed(x: torch.Tensor, w: torch.Tensor, final_cap: float = 0.0
            ) -> torch.Tensor:
    """x: (..., D) @ w: (D, V) -> logits, optional final softcap (gemma2)
    in float32."""
    logits = matmul(x, w.to(x.dtype))
    if final_cap > 0:
        logits = softcap(logits.float(), final_cap)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE. logits (B,S,V), labels (B,S).  Vocab-sharded
    logits (a DTensor) stay sharded (:func:`_nll_on_shards`)."""
    if is_dtensor(logits) and spread_over(logits, -1):
        nll = _nll_on_shards(logits, labels)
    else:
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = lse - gold
    if mask is not None:
        total = torch.clamp(mask.sum(), min=1)
        return (nll * mask).sum() / total
    return nll.mean()


class _VocabNLL(torch.autograd.Function):
    """lse - gold of one rank's vocab shard (..., V_loc) of the logits,
    the max, the sum of exponentials and the gold logit each all-reduced
    over ``groups`` (the ranks that split the vocab), in float32.  The
    gradient, softmax minus the one-hot, needs no communication."""

    @staticmethod
    def forward(ctx, logits, labels, v0, groups):
        import torch.distributed as dist
        x = logits.float()
        m = x.amax(dim=-1)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        se = torch.exp(x - m[..., None]).sum(dim=-1)
        idx = labels.long() - v0
        ok = (idx >= 0) & (idx < x.shape[-1])
        idx = idx.clamp(0, x.shape[-1] - 1)
        gold = torch.where(ok, torch.gather(x, -1, idx[..., None])[..., 0],
                           torch.zeros((), device=x.device))
        for g in groups:
            dist.all_reduce(se, group=g)
            dist.all_reduce(gold, group=g)
        lse = m + torch.log(se)
        ctx.save_for_backward(logits, lse, idx, ok)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, ok = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None])
        p.scatter_add_(-1, idx[..., None], -ok[..., None].to(p.dtype))
        return (p * g[..., None]).to(logits.dtype), None, None, None


def _nll_on_shards(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """lse - gold (B, S) of vocab-sharded logits (a DTensor), per rank
    under ``local_map`` (:class:`_VocabNLL`): each rank reads its own
    shard of the vocab, as GSPMD reduces the reference's, where gathering
    the vocab would hold every rank's (B, S, V) in float32."""
    mesh = logits.device_mesh
    v = logits.ndim - 1
    pl = tuple(Replicate() if p.is_partial() else p
               for p in logits.placements)
    plab = tuple(p if p.is_shard() and p.dim < v else Replicate()
                 for p in pl)
    logits = logits.redistribute(mesh, pl)
    v0, _ = local_span(logits, v)
    groups = [mesh.get_group(i) for i in spread_over(logits, v)]
    return local_map(lambda x, y: _VocabNLL.apply(x, y, v0, groups),
                     out_placements=list(plab), in_placements=(pl, plab),
                     in_grad_placements=(pl, plab), device_mesh=mesh,
                     redistribute_inputs=True)(logits, on_mesh(labels, mesh))
