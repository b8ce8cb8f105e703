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
along its sequence over more than one rank takes the grouped einsum
under every ``attention_impl``, as the reference's does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.dtensor import (
    is_dtensor, local_span, on_mesh, spread_over, whole)
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
    cache's sequence is sharded over more than one rank: the einsum then
    runs on DTensors, as the reference's does under every impl); keys
    past ``pos`` (and outside the window) are masked.
    """
    fn = (kops.flash_decode
          if ctx is not None and ctx.attention_impl == "pallas"
          and not spread_over(k_cache, 1) else flash_decode_ref)
    return fn(q, k_cache, v_cache, pos, window=window, logit_cap=logit_cap,
              scale=scale)


# --------------------------------------------------------------------------
# MLP / embeddings / loss
# --------------------------------------------------------------------------


def swiglu(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
           ctx: Optional[ModelContext] = None) -> torch.Tensor:
    """wi: (D, 2F) fused gate+up; wo: (F, D).  The output product runs
    through :func:`~repro_torch.models.remat.mlp_output`, which tells the
    dots remat policy whether backward reads it."""
    h = x @ wi.to(x.dtype)
    gate, up = h.chunk(2, dim=-1)
    h = F.silu(gate) * up
    if ctx is not None and x.ndim == 3:
        h = ctx.shard(h, "batch", "attn_seq", "d_ff")
    return mlp_output(h, wo.to(x.dtype))


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
    logits = x @ w.to(x.dtype)
    if final_cap > 0:
        logits = softcap(logits.float(), final_cap)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE. logits (B,S,V), labels (B,S).  Vocab-sharded
    logits (a DTensor) are gathered along the vocab first."""
    if is_dtensor(logits) and spread_over(logits, -1):
        v = logits.ndim - 1
        logits = logits.redistribute(logits.device_mesh, tuple(
            Replicate() if p.is_shard(v) else p for p in logits.placements))
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        total = torch.clamp(mask.sum(), min=1)
        return (nll * mask).sum() / total
    return nll.mean()
