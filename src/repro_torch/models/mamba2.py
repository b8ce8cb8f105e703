"""Mamba2 (State Space Duality) mixer, the SSM layer of zamba2: the port's
counterpart of the reference's ``repro.models.mamba2``, function for
function.

Layer structure (simplified Mamba2 block)::

  in_proj: D -> [z (d_in), x (d_in), B (N), C (N), dt (nh)]
  causal depthwise conv(k=4) on [x|B|C]; SiLU
  y = SSD(x, dt, A, B, C)  (chunked scan, heads = d_in / head_dim)
  out = out_proj( rmsnorm(y) * silu(z) )

Prefill runs the chunked SSD dual form: batched (chunk x chunk) products
inside each chunk, and the sequential inter-chunk state recurrence, which
under ``attention_impl="pallas"`` is the hand-written SSD state scan
kernel (:func:`repro_torch.kernels.ops.ssd_state_scan`) and otherwise its
plain version.  Decode updates the state one token at a time.

dtypes follow the reference: the projections and the conv in the
activation dtype (bf16 in the model), the SSD in f32, the dt softplus in
f32, the decode state's conv carry in bf16 and its SSM state in f32.
The decode state is updated in place (the reference returns a new one).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig
from repro_torch.dtensor import (
    cumsum, is_dtensor, keep_shards, matmul, on_mesh)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssm_scan import ssd_state_scan_ref
from repro_torch.models import layers as L
from repro_torch.models.sharding import ModelContext
from repro_torch.models.transformer import _weight, weight_kinds

CHUNK = 256


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 carry: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B, S, C); w: (K, C).  Returns (y,
    new_carry) where the carry holds the last K-1 inputs (decode state)."""
    K = w.shape[0]
    if carry is None:
        carry = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([carry, x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    return y, xp[:, -(K - 1):, :]


def ssd_chunk_terms(x, dt, A, B, C, chunk: int = CHUNK):
    """The parallel part of :func:`ssd_chunked`: the intra-chunk output and
    what the inter-chunk scan takes.  Returns (y_intra (Bb, nc, Q, nh, hd),
    states (Bb, nc, nh, hd, N), total (Bb, nc, nh), Cc (Bb, nc, Q, N),
    cum (Bb, nc, Q, nh)).

    The (Q, Q) decay matrix is built in (Bb, nc, nh, Q, Q) layout, so the
    intra-chunk product is one batched matmul with no copy of it; each
    element is the reference's.  The exponent is masked before ``exp``,
    as there.  When autograd records (grad enabled and an input requires
    grad) the matrix is built out of place, which autograd needs;
    otherwise in place, which keeps prefill's memory at one matrix."""
    Bb, S, nh, hd = x.shape
    N = B.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_chunked: sequence {S} not a multiple of the "
                         f"chunk {chunk}")
    nc = S // chunk
    xc = x.reshape(Bb, nc, chunk, nh, hd)
    dtc = dt.reshape(Bb, nc, chunk, nh)
    Bc = B.reshape(Bb, nc, chunk, N)
    Cc = C.reshape(Bb, nc, chunk, N)

    dA = dtc * A[None, None, None, :]                    # (Bb,nc,Q,nh) <= 0
    cum = cumsum(dA, 2)                                  # within-chunk cumsum
    total = cum[:, :, -1]                                # (Bb,nc,nh)

    # ---- intra-chunk (dual / attention-like form) ----
    # M[h, i, j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0
    cum_h = cum.transpose(2, 3)                          # (Bb,nc,nh,Q)
    M = cum_h[..., :, None] - cum_h[..., None, :]        # (Bb,nc,nh,Q,Q)
    upper = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=x.device).triu(1)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)     # (Bb,nc,Q,Q)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        M = torch.exp(M.masked_fill(upper, -1e30)) * scores[:, :, None]
    else:
        M.masked_fill_(upper, -1e30).exp_()
        M.mul_(scores[:, :, None])
    xdt = xc * dtc[..., None]                            # (Bb,nc,Q,nh,hd)
    y_intra = torch.matmul(M, xdt.transpose(2, 3)).transpose(2, 3)
    del M

    # ---- chunk states ----
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # (Bb,nc,Q,nh)
    states = torch.einsum("bcjn,bcjhd->bchdn", Bc,
                          (dtc * decay_to_end)[..., None] * xc)
    return y_intra, states, total, Cc, cum


def ssd_chunked(x, dt, A, B, C, chunk: int = CHUNK,
                init_state: Optional[torch.Tensor] = None,
                ctx: Optional[ModelContext] = None):
    """Chunked SSD scan.

    x:  (Bb, S, nh, hd)    values
    dt: (Bb, S, nh)        softplus'd step sizes (>0)
    A:  (nh,)              negative decay rates
    B:  (Bb, S, N)         input maps   (single group, shared across heads)
    C:  (Bb, S, N)         output maps
    Returns (y (Bb,S,nh,hd), final_state (Bb,nh,hd,N)).

    The inter-chunk recurrence is the SSD state scan kernel under
    ``pallas``, which starts from a zero state: ``init_state`` must then
    be None (it always is in prefill).  On a DTensor ``x`` it runs per
    shard (:func:`_ssd_on_shards`)."""
    if is_dtensor(x):
        return _ssd_on_shards(x, dt, A, B, C, chunk, init_state, ctx)
    Bb, S, nh, hd = x.shape
    y_intra, states, total, Cc, cum = ssd_chunk_terms(x, dt, A, B, C, chunk)
    if ctx is not None and ctx.attention_impl == "pallas":
        if init_state is not None:
            raise ValueError("ssd_chunked: the SSD state scan kernel starts "
                             "from a zero state; init_state must be None")
        y_inter, final = kops.ssd_state_scan(states, total, Cc, cum)
    else:
        y_inter, final = ssd_state_scan_ref(states, total, Cc, cum,
                                            init_state)
    y = (y_intra + y_inter).reshape(Bb, S, nh, hd)
    return y, final


def _ssd_on_shards(x, dt, A, B, C, chunk, init_state, ctx):
    """:func:`ssd_chunked` of a DTensor ``x`` per rank under
    ``local_map``: each rank scans its requests and its heads (the
    sequence whole), as GSPMD keeps the reference's scan local.  The
    gradients of ``A`` (per head) and of ``B``/``C`` (shared by the heads)
    are each rank's part, summed over the ranks that split the requests
    or the heads."""
    mesh = x.device_mesh
    px = keep_shards(x, {0: 0, 2: 2})
    n = range(mesh.ndim)

    def place(dims: dict, partial_on=()):
        out = []
        for i, p in zip(n, px):
            if p.is_shard() and p.dim in dims:
                out.append(Shard(dims[p.dim]))
            elif p.is_shard() and p.dim in partial_on and mesh.size(i) > 1:
                out.append(Partial())
            else:
                out.append(Replicate())
        return tuple(out)
    pdt, pA, pBC = place({0: 0, 2: 2}), place({2: 0}), place({0: 0})
    pst = place({0: 0, 2: 1})
    g_A, g_BC = place({2: 0}, (0,)), place({0: 0}, (2,))
    args = [x, on_mesh(dt, mesh), on_mesh(A, mesh), on_mesh(B, mesh),
            on_mesh(C, mesh)]
    in_p, in_g = [px, pdt, pA, pBC, pBC], [px, pdt, g_A, g_BC, g_BC]
    if init_state is not None:
        args.append(on_mesh(init_state, mesh))
        in_p.append(pst)
        in_g.append(pst)

    def local(*t):
        return ssd_chunked(*t[:5], chunk=chunk,
                           init_state=t[5] if len(t) > 5 else None, ctx=ctx)
    return local_map(local, out_placements=(list(px), list(pst)),
                     in_placements=tuple(in_p),
                     in_grad_placements=tuple(in_g), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def ssd_decode_step(x, dt, A, B, C, state):
    """Single-token SSD update.
    x: (Bb, nh, hd); dt: (Bb, nh); B, C: (Bb, N); state: (Bb, nh, hd, N)
    float32, updated in place.  Returns (y (Bb,nh,hd), state)."""
    dA = torch.exp(dt * A[None, :])                        # (Bb, nh)
    state.mul_(dA[:, :, None, None])
    state.addcmul_((dt[:, :, None] * x)[..., None], B[:, None, None, :])
    y = torch.einsum("bn,bhdn->bhd", C, state)
    return y, state


class Mamba2(nn.Module):
    """One Mamba2 mixer (the reference's ``mamba2_mixer`` and its
    ``init_mamba2_params``); parameter names are the reference's keys.
    ``in_proj``, ``conv`` and ``out_proj`` are stored in bf16 to serve
    (the reference's cast at use) or as f32 masters to train
    (``trainable``), and cast to the activation dtype at use; the norms,
    ``A_log``, ``D`` and ``dt_bias`` are f32."""

    def __init__(self, cfg: ArchConfig, device, trainable: bool = False):
        super().__init__()
        D, N, K = cfg.d_model, cfg.ssm_state, cfg.conv_kernel
        self.cfg = cfg
        self.d_in = cfg.ssm_expand * D
        self.nh = self.d_in // cfg.ssm_head_dim
        mm, vec = weight_kinds(device, trainable)
        self.norm = _weight(D, **vec)
        self.in_proj = _weight(D, 2 * self.d_in + 2 * N + self.nh, **mm)
        self.conv = _weight(K, self.d_in + 2 * N, **mm)
        self.A_log = _weight(self.nh, **vec)
        self.D = _weight(self.nh, **vec)
        self.dt_bias = _weight(self.nh, **vec)
        self.out_norm = _weight(self.d_in, **vec)
        self.out_proj = _weight(self.d_in, D, **mm)

    @torch.no_grad()
    def reset_ssm_params(self) -> None:
        """The reference's ``A_log = log(linspace(1, 16, nh))`` and
        ``D = 1``."""
        self.A_log.copy_(torch.log(torch.linspace(
            1.0, 16.0, self.nh, dtype=torch.float32, device=self.A_log.device)))
        self.D.fill_(1.0)

    def ssd_inputs(self, x: torch.Tensor, ctx: ModelContext,
                   carry: Optional[torch.Tensor] = None):
        """Norm, in_proj and conv: x (Bb, S, D) -> (z (Bb,S,d_in), xh
        (Bb,S,nh,hd), dt (Bb,S,nh) f32, A (nh,) f32, B and C (Bb,S,N),
        new conv carry)."""
        Bb, S, _ = x.shape
        N, hd = self.cfg.ssm_state, self.cfg.ssm_head_dim
        h = L.rmsnorm(x, self.norm, ctx=ctx)
        w, cw = self.in_proj.to(h.dtype), self.conv.to(h.dtype)
        if carry is None and is_dtensor(h) and ctx is not None \
                and ctx.distributed:
            z, xs, Bm, Cm, dt = self._proj_by_heads(h, w, cw, ctx)
            new_carry = None
        else:
            z, xs, Bm, Cm, dt = matmul(h, w).split(
                [self.d_in, self.d_in, N, N, self.nh], dim=-1)
            conv_out, new_carry = _causal_conv(
                torch.cat([xs, Bm, Cm], dim=-1), cw, carry)
            xs, Bm, Cm = F.silu(conv_out).split([self.d_in, N, N], dim=-1)
        if ctx is not None:
            # heads placed as dt_bias is (a local slice where dt is whole)
            dt = ctx.shard(dt, "batch", "seq", "ssm_heads")
        dt = F.softplus(dt.float() + self.dt_bias[None, None, :])
        A = -torch.exp(self.A_log)
        return z, xs.reshape(Bb, S, self.nh, hd), dt, A, Bm, Cm, new_carry

    def _proj_by_heads(self, h, w, cw, ctx: ModelContext) -> tuple:
        """``ssd_inputs``' in_proj and conv on DTensors, from a zero conv
        carry: the per-head column groups (z, xs, dt) each by its own
        product with its slice of ``in_proj`` placed by ``ssm_heads`` (a
        local slice of the replicated weight), so each rank computes its
        heads' columns only, as GSPMD propagates the reference's head
        sharding into its product; B and C (shared by the heads) whole.
        xs and B, C pass the depthwise conv apart."""
        d, N = self.d_in, self.cfg.ssm_state
        mesh = ctx.mesh
        heads = ctx.spec(None, "ssm_heads")
        edges = (0, d, 2 * d, 2 * d + N, 2 * d + 2 * N, 2 * d + 2 * N + self.nh)
        z, xs, Bm, Cm, dt = (
            matmul(h, w[:, a:b].redistribute(mesh, heads) if i in (0, 1, 4)
                   else w[:, a:b])
            for i, (a, b) in enumerate(zip(edges, edges[1:])))
        xs, _ = _causal_conv(xs, cw[:, :d].redistribute(mesh, heads))
        bc, _ = _causal_conv(torch.cat([Bm, Cm], dim=-1), cw[:, d:])
        Bm, Cm = F.silu(bc).split([N, N], dim=-1)
        return z, F.silu(xs), Bm, Cm, dt

    def forward(self, x: torch.Tensor, ctx: ModelContext,
                state: Optional[dict] = None) -> torch.Tensor:
        """x: (Bb, S, D) -> the mixer's output (Bb, S, D), without the
        residual.  ``state`` None: prefill (the chunked scan; S a multiple
        of the chunk, or shorter than it).  Otherwise one decode token
        (S = 1) against ``state`` = {"conv": (Bb, K-1, d_in+2N) bf16,
        "ssm": (Bb, nh, hd, N) f32}, both updated in place."""
        Bb, S, _ = x.shape
        carry = state["conv"] if state is not None else None
        z, xh, dt, A, Bm, Cm, new_carry = self.ssd_inputs(x, ctx, carry)
        if ctx is not None:
            xh = ctx.shard(xh, "batch", "seq", "ssm_heads", "head_dim")
        if state is None:
            y, _ = ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(),
                               chunk=min(CHUNK, S), ctx=ctx)
        else:
            y1, _ = ssd_decode_step(xh[:, 0].float(), dt[:, 0], A,
                                    Bm[:, 0].float(), Cm[:, 0].float(),
                                    state["ssm"])
            state["conv"].copy_(new_carry)
            y = y1[:, None]
        y = y + xh.float() * self.D[None, None, :, None]
        y = y.reshape(Bb, S, self.d_in).to(x.dtype)
        y = L.rmsnorm(y, self.out_norm, ctx=ctx) * F.silu(z)
        out = matmul(y, self.out_proj.to(y.dtype))
        if ctx is not None:
            # placed before the residual add, as the transformer's blocks
            # place theirs
            out = ctx.shard(out, "batch", "seq", "d_model")
        return out


def init_mamba2_state(batch: int, cfg: ArchConfig, d_model: int,
                      device) -> dict:
    d_in = cfg.ssm_expand * d_model
    nh = d_in // cfg.ssm_head_dim
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1,
                             d_in + 2 * cfg.ssm_state), dtype=torch.bfloat16,
                            device=device),
        "ssm": torch.zeros((batch, nh, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }
