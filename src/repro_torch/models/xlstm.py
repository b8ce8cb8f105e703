"""xLSTM LM of the port (the ``ssm`` family, xlstm-1.3b): chunkwise
mLSTM and recurrent sLSTM blocks, the counterpart of the reference's
``repro.models.xlstm``, function for function.

The mLSTM's matrix memory is a gated linear attention, computed in the
reference's chunked dual form in float32: batched (chunk x chunk)
products inside each chunk, and the inter-chunk state recurrence, which
the reference scans with ``lax.scan``, as a loop over the chunks.  Every
product has two operands (``@`` or a two-operand einsum), so that no
intermediate exceeds the largest operand.  The matrix memory (C) and the
normalizer (n) are separate states.  As in the reference, the input-gate
logits are clamped (``IGATE_CLAMP``) instead of carrying the paper's
max-stabilizer, and the sLSTM's recurrence is diagonal (per channel); it
runs as a loop over the positions.

Every block holds the reference's nine parameters (both kinds' leaves,
as its stacked tree has them), with its names and init.  The projections
are stored in bf16 to serve or as f32 masters to train (``trainable``),
and cast to the activation dtype at use; the norms, ``gate_bias`` and
``r_diag`` are f32.  Activations are bf16; the gates, the mLSTM and the
sLSTM's pre-activations and state are f32, cast back where the
reference casts.  Under ``attention_impl="pallas"`` every norm (``norm``
and ``out_norm`` of each block, ``final_norm``) runs the RMSNorm kernel,
2 x n_layers + 1 launches a prefill or a decode step.  Under grad,
``cfg.remat`` recomputes each block in backward, the reference's
checkpoint unit, whole whatever ``cfg.remat_policy`` says, as the
reference's.

The decode cache is the reference's list of per-block states, f32:
``(C (B, nh, hd, hd), n (B, nh, hd))`` for an mLSTM block and ``(c, n,
h)``, each (B, d_in), for an sLSTM block; a decode step updates it in
place (the reference returns a new one).

The reference's mesh paths, selected by ``ctx.rules``
(``launch.shardings.make_rules``): under ``parallelism="vtp"`` an mLSTM
block folds ``up_proj``'s x half into ``qkv`` and ``gates`` (merged
weights: every projection reads the normed input once) and shards the
value dim; under ``"ring"`` (the sequence over ``model``) the sLSTM's
pre-activations are gathered to whole sequences for its scan and its
output re-sharded, and the mLSTM runs on each rank's slice of the
sequence with its incoming state from one all_gather of every rank's
affine state map (:func:`mlstm_seq_parallel`).  On DTensors the sLSTM
scan (and, under grad, its written-out backward) runs on each rank's
requests through ``local_map``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig
from repro_torch.dtensor import (
    cumsum, is_dtensor, keep_shards, matmul, on_mesh, splittable)
from repro_torch.models import layers as L
from repro_torch.models.remat import checkpointed
from repro_torch.models.sharding import ModelContext, mesh_scope, placements
from repro_torch.models.transformer import (
    ACT_DTYPE, INIT_SCALE, _host, _numpy, _weight, decayed_names,
    weight_kinds)

MLSTM_CHUNK = 256
IGATE_CLAMP = 8.0
#: standard deviation of the init of ``gates``, ``r_diag`` and ``o_proj``
#: (the reference's ``dense_init(..., scale=0.01)``)
SMALL_INIT_SCALE = 0.01
#: the exponent that masked (future) positions take before ``exp``
_MASKED = -1e30


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------


def _gates(i_gate: torch.Tensor, f_gate: torch.Tensor) -> tuple:
    """(log forget gate <= 0, clamped input-gate logit), both f32.  On a
    DTensor the log-sigmoid runs per shard (DTensor has no rule for its
    backward)."""
    f = f_gate.float()
    if is_dtensor(f):
        pf = keep_shards(f, {d: d for d in range(f.ndim)})
        lf = local_map(F.logsigmoid, out_placements=list(pf),
                       in_placements=(pf,), device_mesh=f.device_mesh,
                       redistribute_inputs=True)(f)
    else:
        lf = F.logsigmoid(f)
    return lf, i_gate.float().clamp(-IGATE_CLAMP, IGATE_CLAMP)


def mlstm_chunked(q, k, v, i_gate, f_gate, chunk: int = MLSTM_CHUNK,
                  init_state=None):
    """Chunkwise mLSTM.

    q, k, v: (B, S, nh, hd); i_gate, f_gate: (B, S, nh) raw logits.
    Returns (h (B, S, nh, hd) in q's dtype, state) with state = (C (B, nh,
    hd_k, hd_v), n (B, nh, hd_k)), f32.  When S is not a multiple of
    ``chunk`` the whole sequence is one chunk, as in the reference.

    Dual form per chunk: weight(i <- j) = exp(cumlf_i - cumlf_j + i_j),
    h_i = sum_j w_ij (q_i . k_j) v_j / max(|den_i|, 1).  Inside, the heads
    lead the chunk positions ((B, nc, nh, Q, ...)), so that each product
    is one batched matmul.
    """
    B, S, nh, hd = q.shape
    if S % chunk != 0:
        chunk = S
    nc = S // chunk
    lf, ig = _gates(i_gate, f_gate)

    def heads(t):                           # (B,S,nh,...) -> (B,nc,nh,Q,...)
        return t.float().reshape(B, nc, chunk, nh, *t.shape[3:]).transpose(
            2, 3)

    qc, kc, vc = heads(q) * hd ** -0.5, heads(k), heads(v)
    lfc, igc = heads(lf), heads(ig)                     # (B,nc,nh,Q)
    cum = cumsum(lfc, -1)
    total = cum[..., -1]                                # (B,nc,nh)

    # intra-chunk (mask the exponent BEFORE exp: masked entries would
    # overflow and poison gradients through where)
    diff = cum[..., :, None] - cum[..., None, :] + igc[..., None, :]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=q.device).tril()
    W = torch.exp(diff.masked_fill(~causal, _MASKED))   # (B,nc,nh,Q,Q)
    WS = W * (qc @ kc.transpose(-1, -2))
    h_intra = WS @ vc                                   # (B,nc,nh,Q,hd)
    den_intra = WS.sum(-1)                              # (B,nc,nh,Q)

    # chunk states: C_c = sum_j w_j k_j v_j^T ; n_c = sum_j w_j k_j
    kw = kc * torch.exp(total[..., None] - cum + igc)[..., None]
    states = kw.transpose(-1, -2) @ vc                  # (B,nc,nh,hd,hd)
    nstates = kw.sum(-2)                                # (B,nc,nh,hd)

    if init_state is None:
        sC = torch.zeros((B, nh, hd, hd), dtype=torch.float32,
                         device=q.device)
        sn = torch.zeros((B, nh, hd), dtype=torch.float32, device=q.device)
    else:
        sC, sn = init_state
    # inter-chunk: each chunk reads the state before it, then adds its own
    # (the chunks are unbound, not indexed: the gradient of an index is a
    # zero tensor of the whole input, one a chunk)
    qe = qc * torch.exp(cum)[..., None]                 # (B,nc,nh,Q,hd)
    h_inter, den_inter = [], []
    for qe_c, st_c, nst_c, d in zip(qe.unbind(1), states.unbind(1),
                                    nstates.unbind(1),
                                    torch.exp(total).unbind(1)):
        h_inter.append(qe_c @ sC)                       # (B,nh,Q,hd)
        den_inter.append(qe_c @ sn[..., None])          # (B,nh,Q,1)
        sC = sC * d[..., None, None] + st_c
        sn = sn * d[..., None] + nst_c
    num = h_intra + torch.stack(h_inter, 1)
    den = den_intra + torch.stack(den_inter, 1)[..., 0]
    out = num / torch.clamp(den.abs(), min=1.0)[..., None]
    out = out.transpose(2, 3).reshape(B, S, nh, hd)
    return out.to(q.dtype), (sC, sn)


def mlstm_decode_step(q, k, v, i_gate, f_gate, state):
    """Single step. q, k, v: (B, nh, hd); gates (B, nh); state = (C (B, nh,
    hd, hd), n (B, nh, hd)), f32, updated in place.  Returns (h (B, nh, hd)
    in q's dtype, state)."""
    hd = q.shape[-1]
    C, n = state
    qf = q.float() * hd ** -0.5
    kf, vf = k.float(), v.float()
    lf, ig = _gates(i_gate, f_gate)
    d = torch.exp(lf)
    wk = torch.exp(ig)[..., None] * kf
    C.mul_(d[..., None, None]).addcmul_(wk[..., :, None], vf[..., None, :])
    n.mul_(d[..., None]).add_(wk)
    num = (qf[..., None, :] @ C)[..., 0, :]
    den = (qf * n).sum(-1)
    out = num / torch.clamp(den.abs(), min=1.0)[..., None]
    return out.to(q.dtype), (C, n)


# --------------------------------------------------------------------------
# sequence-parallel mLSTM (ring mode): affine state exchange
# --------------------------------------------------------------------------
#
# Under sequence sharding (S over `model`), every projection and norm is
# position-wise (no comm); only the inter-chunk state recurrence crosses
# ranks.  That recurrence is an AFFINE map per rank r:
#     s_out = s_in * D_r + F_r
# (D_r = the product of the rank's chunk decays, F_r = its final local
# state from a zero start), and affine maps compose associatively: each
# rank all-gathers every (D_r, F_r) once and computes its incoming state
# in closed form,
#     s_in(r) = sum_{r'<r} F_{r'} * prod_{r'<r''<r} D_{r''}.


def _mlstm_rank_summary(k, v, i_gate, f_gate, chunk: int) -> tuple:
    """This rank's (log-decay total (B, nh), final C (B, nh, hd, hd),
    final n (B, nh, hd)) from a zero state: the affine map (D_r, F_r) of
    its slice of the sequence, f32."""
    B, S, nh, hd = k.shape
    nc = max(S // chunk, 1)
    Q = S // nc
    lf, ig = _gates(i_gate, f_gate)

    def heads(t):                           # (B,S,nh,...) -> (B,nc,nh,Q,...)
        return t.float().reshape(B, nc, Q, nh, *t.shape[3:]).transpose(2, 3)

    kc, vc, lfc, igc = heads(k), heads(v), heads(lf), heads(ig)
    cum = cumsum(lfc, -1)
    total = cum[..., -1]                                # (B,nc,nh)
    kw = kc * torch.exp(total[..., None] - cum + igc)[..., None]
    states = kw.transpose(-1, -2) @ vc                  # (B,nc,nh,hd,hd)
    nstates = kw.sum(-2)                                # (B,nc,nh,hd)
    sC = torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=k.device)
    sn = torch.zeros((B, nh, hd), dtype=torch.float32, device=k.device)
    for st_c, nst_c, d in zip(states.unbind(1), nstates.unbind(1),
                              torch.exp(total).unbind(1)):
        sC = sC * d[..., None, None] + st_c
        sn = sn * d[..., None] + nst_c
    return total.sum(1), sC, sn


def mlstm_seq_parallel(q, k, v, i_gate, f_gate, *, mesh, batch_axes,
                       chunk: int = MLSTM_CHUNK):
    """mLSTM with the sequence dim sharded over ``model``, each rank's
    slice under ``local_map``.  q, k, v: (B, S, nh, hd); gates (B, S,
    nh); global shapes, S sharded over ``model``.  Returns h (B, S, nh,
    hd) in q's dtype, sharded likewise."""
    n_model = mesh["model"].size()
    group = mesh.get_group("model")
    rank = mesh.get_local_rank("model")
    io = placements((batch_axes, "model", None, None), mesh)
    gp = placements((batch_axes, "model", None), mesh)

    def body(q_l, k_l, v_l, ig_l, fg_l):
        logD, fC, fN = _mlstm_rank_summary(k_l, v_l, ig_l, fg_l, chunk)
        # every rank's affine map: (n, B, nh, ...)
        logDs = funcol.all_gather_tensor_autograd(logD[None], 0, group)
        fCs = funcol.all_gather_tensor_autograd(fC[None], 0, group)
        fNs = funcol.all_gather_tensor_autograd(fN[None], 0, group)
        # incoming state: sum_{r<rank} F_r * exp(decay between r and rank)
        csum = logDs.cumsum(0)                            # inclusive prefix
        upto = csum[rank - 1] if rank > 0 else torch.zeros_like(csum[0])
        before = (torch.arange(n_model, device=q_l.device)
                  < rank)[:, None, None]
        wgt = torch.where(before, torch.exp(
            torch.where(before, upto[None] - csum, 0.0)), 0.0)  # (n,B,nh)
        inC = (wgt[..., None, None] * fCs).sum(0)
        inN = (wgt[..., None] * fNs).sum(0)
        out, _ = mlstm_chunked(q_l, k_l, v_l, ig_l, fg_l, chunk=chunk,
                               init_state=(inC, inN))
        return out

    return local_map(body, out_placements=list(io),
                     in_placements=(io, io, io, gp, gp), device_mesh=mesh,
                     redistribute_inputs=True)(
        *(on_mesh(t, mesh) for t in (q, k, v, i_gate, f_gate)))


# --------------------------------------------------------------------------
# sLSTM (sequential scalar memory)
# --------------------------------------------------------------------------


def _slstm_step(x_t: torch.Tensor, r_diag: torch.Tensor, state) -> tuple:
    """One position: x_t (B, 4, d_in) f32 pre-activations for z, i, f, o;
    returns the gates (z, i, f, o, the input gate's logit) and the new
    state (c, n, h), each (B, d_in) f32."""
    c, n, h_prev = state
    z, i_pre, f, o = torch.addcmul(x_t, r_diag,
                                   h_prev[:, None, :]).unbind(1)
    z = torch.tanh(z)
    i = torch.exp(i_pre.clamp(-IGATE_CLAMP, IGATE_CLAMP))
    f, o = torch.sigmoid(f), torch.sigmoid(o)
    c = torch.addcmul(f * c, i, z)
    n = torch.addcmul(i, f, n)
    return (z, i, f, o, i_pre), (c, n, o * c / torch.clamp(n, min=1.0))


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM scan under grad, with its backward written out: autograd
    over the position loop would record every operation of every position
    and run their backward one node at a time.  The forward keeps each
    position's gates and state (stacked, (B, S, d_in) each); the backward
    computes every factor that does not depend on the carried gradients
    over all positions at once, then runs the carries (dc, dn, dh) back
    through the positions, 16 operations a position.  Inputs: x (B, S, 4,
    d_in), r_diag (4, d_in), c0, n0, h0 (B, d_in); outputs: h (B, S,
    d_in) and the final (c, n, h)."""

    @staticmethod
    def forward(ctx, x, r, c0, n0, h0):
        keep = [[] for _ in range(8)]           # z, i, f, o, i_pre, c, n, h
        state = (c0, n0, h0)
        for x_t in x.unbind(1):
            gates, state = _slstm_step(x_t, r, state)
            for lst, v in zip(keep, gates + state):
                lst.append(v)
        keep = [torch.stack(lst, 1) for lst in keep]
        ctx.save_for_backward(r, c0, n0, h0, *keep)
        return (keep[7], *state)

    @staticmethod
    def backward(ctx, g_hs, g_c, g_n, g_h):
        r, c0, n0, h0, Z, I, Fg, O, I_pre, C, N, H = ctx.saved_tensors

        def prev(T, t0):                        # T at the position before
            return torch.cat([t0[:, None], T[:, :-1]], 1)

        C_prev, N_prev, H_prev = prev(C, c0), prev(N, n0), prev(H, h0)
        M = N.clamp(min=1.0)
        # h = o c / m, m = max(n, 1); c = f c' + i z; n = f n' + i
        A = O / M                                       # dh -> dc
        E = -(A * C / M) * (N >= 1.0)                   # dh -> dn
        P = I * (1.0 - Z * Z)                           # dc -> d z_pre
        Q = I * ((I_pre >= -IGATE_CLAMP) & (I_pre <= IGATE_CLAMP))
        R = Fg * (1.0 - Fg)
        So = (C / M) * O * (1.0 - O)                    # dh -> d o_pre
        r_z, r_i, r_f, r_o = r.unbind(0)
        g_pre = [[] for _ in range(4)]
        gc, gn, gh_carry = g_c, g_n, g_h
        steps = zip(*(T.unbind(1) for T in (
            g_hs, A, E, P, Q, R, So, Z, C_prev, N_prev, Fg)))
        for gH, a, e, p, q, rf, so, z, c_prev, n_prev, f in reversed(
                list(steps)):
            gh = gH + gh_carry
            gc = torch.addcmul(gc, a, gh)
            gn = torch.addcmul(gn, e, gh)
            gz = gc * p
            gi = torch.addcmul(gn, gc, z) * q
            gf = torch.addcmul(gc * c_prev, gn, n_prev) * rf
            go = gh * so
            gh_carry = torch.addcmul(torch.addcmul(torch.addcmul(
                r_z * gz, r_i, gi), r_f, gf), r_o, go)
            gc, gn = gc * f, gn * f
            for lst, v in zip(g_pre, (gz, gi, gf, go)):
                lst.append(v)
        g_pre = [torch.stack(lst[::-1], 1) for lst in g_pre]  # (B, S, d)
        g_r = torch.stack([(g * H_prev).sum((0, 1)) for g in g_pre])
        return torch.stack(g_pre, 2), g_r, gc, gn, gh_carry


def _slstm_zero_state(B: int, d_in: int, device) -> tuple:
    z = torch.zeros((B, d_in), dtype=torch.float32, device=device)
    return z, torch.ones_like(z), z.clone()


def slstm_scan(zifo, r_diag, n_heads: int, init_state=None):
    """zifo: (B, S, 4, d_in) pre-activations for z, i, f, o; r_diag: (4,
    d_in) diagonal recurrent weights.  Returns (h (B, S, d_in) f32, state
    (c, n, h)).  Under grad it runs :class:`_SLSTMScan`.  On a DTensor
    ``zifo`` (from a zero state) each rank scans its requests, the
    sequence and channels whole, through ``local_map``."""
    if is_dtensor(zifo):
        if init_state is not None:
            raise ValueError("slstm_scan: a DTensor scan starts from zero")
        mesh = zifo.device_mesh
        pz = keep_shards(zifo, {0: 0})
        pb = [Shard(0) if p.is_shard(0) else Replicate() for p in pz]
        # r_diag's gradient: each rank's part, from its own requests
        g_r = tuple(Partial() if p.is_shard(0) and mesh.size(i) > 1
                    else Replicate() for i, p in enumerate(pz))
        return local_map(lambda z, r: slstm_scan(z, r, n_heads),
                         out_placements=(pb, pb, pb, pb),
                         in_placements=(pz, (Replicate(),) * mesh.ndim),
                         in_grad_placements=(pz, g_r), device_mesh=mesh,
                         redistribute_inputs=True)(zifo, r_diag)
    B, _, _, d_in = zifo.shape
    state = (_slstm_zero_state(B, d_in, zifo.device) if init_state is None
             else init_state)
    x, r = zifo.float(), r_diag.float()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, r, *state)):
        hs, *state = _SLSTMScan.apply(x, r, *state)
        return hs, tuple(state)
    hs = []
    for x_t in x.unbind(1):
        state = _slstm_step(x_t, r, state)[1]
        hs.append(state[2])
    return torch.stack(hs, 1), state


def slstm_decode_step(zifo, r_diag, state):
    """zifo: (B, 4, d_in); one step of the scan above.  Returns (h, state)
    with the state's tensors (c, n, h) updated in place."""
    new = _slstm_step(zifo.float(), r_diag.float(), state)[1]
    for s, t in zip(state, new):
        s.copy_(t)
    return state[2], state


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------


class XLSTMBlock(nn.Module):
    """One residual xLSTM block (pre-norm, 2x up/down projection), the
    reference's ``xlstm_block`` with the parameters of its
    ``init_xlstm_params``: ``norm`` (D,), ``up_proj`` (D, 2 d_in) for
    [x | z-gate], ``qkv`` (d_in, 3 d_in), ``gates`` (d_in, 2 nh),
    ``gate_bias`` (2 nh,), ``r_diag`` (4, d_in), ``o_proj`` (d_in, d_in),
    ``out_norm`` (d_in,), ``down_proj`` (d_in, D).  An sLSTM block maps
    ``qkv`` and ``o_proj`` onto its z, i, f, o pre-activations; an mLSTM
    block leaves ``r_diag`` and ``o_proj`` unused."""

    def __init__(self, cfg: ArchConfig, is_slstm: bool, device,
                 trainable: bool = False, expand: int = 2):
        super().__init__()
        D, nh = cfg.d_model, cfg.n_heads
        self.d_in = d_in = expand * D
        self.n_heads = nh
        self.is_slstm = is_slstm
        mm, vec = weight_kinds(device, trainable)
        self.norm = _weight(D, **vec)
        self.up_proj = _weight(D, 2 * d_in, **mm)
        self.qkv = _weight(d_in, 3 * d_in, **mm)
        self.gates = _weight(d_in, 2 * nh, **mm)
        self.gate_bias = _weight(2 * nh, **vec)
        self.r_diag = _weight(4, d_in, **vec)
        self.o_proj = _weight(d_in, d_in, **mm)
        self.out_norm = _weight(d_in, **vec)
        self.down_proj = _weight(d_in, D, **mm)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """The reference's init: ``up_proj``, ``qkv`` and ``down_proj``
        N(0, 0.02^2), ``gates``, ``r_diag`` and ``o_proj`` N(0, 0.01^2),
        each drawn in place in its storage dtype; norms 0; ``gate_bias``
        0 for the input gates, ``linspace(3, 6, nh)`` for the forget
        gates."""
        for p in (self.up_proj, self.qkv, self.down_proj):
            p.normal_(0.0, INIT_SCALE, generator=generator)
        for p in (self.gates, self.r_diag, self.o_proj):
            p.normal_(0.0, SMALL_INIT_SCALE, generator=generator)
        self.norm.zero_()
        self.out_norm.zero_()
        nh = self.n_heads
        self.gate_bias[:nh] = 0.0
        self.gate_bias[nh:] = torch.linspace(3.0, 6.0, nh,
                                             dtype=torch.float32)

    def forward(self, x: torch.Tensor, ctx: ModelContext,
                state: Optional[tuple] = None) -> torch.Tensor:
        """x: (B, S, D) -> x + the block's output.  ``state`` None:
        prefill (the chunked mLSTM, or the sLSTM scan from zero).
        Otherwise one decode token (S = 1) against this block's decode
        state, updated in place."""
        B, S, _ = x.shape
        d_in = self.d_in
        ctx = ctx or ModelContext()
        rules = ctx.rules or {}
        ring = rules.get("_parallelism") == "ring" and state is None
        h = L.rmsnorm(x, self.norm, ctx=ctx)
        vtp = bool(rules.get("xlstm_hd")) and not self.is_slstm
        if vtp:
            # merged column-parallel projections: qkv and the gates read
            # up_proj's x half linearly, so (up_x @ qkv) and (up_x @
            # gates) fold into single D -> out weights (products of the
            # f32 weights, cast to the activation dtype, as the reference)
            up_x, up_z = self.up_proj[:, :d_in], self.up_proj[:, d_in:]
            w_qkv = (up_x.float() @ self.qkv.float()).to(h.dtype)
            w_gates = (up_x.float() @ self.gates.float()).to(h.dtype)
            z = matmul(h, up_z.to(h.dtype))
            xin = h
        else:
            xin, z = matmul(h, self.up_proj.to(h.dtype)).chunk(2, dim=-1)
            w_qkv, w_gates = self.qkv.to(xin.dtype), self.gates.to(xin.dtype)
        if self.is_slstm:
            # the qkv projection (3 d_in) and o_proj (d_in) give the four
            # gates' pre-activations
            zifo = torch.cat([matmul(xin, w_qkv),
                              matmul(xin, self.o_proj.to(xin.dtype))],
                             dim=-1).reshape(B, S, 4, d_in)
            if state is None:
                if ring:
                    # the h_{t-1} recurrence does not compose as an affine
                    # map: gather the (scalar-memory) scan's whole sequence
                    zifo = ctx.shard(zifo, "batch", "attn_seq", None, None)
                hseq, _ = slstm_scan(zifo, self.r_diag, self.n_heads)
                if rules.get("_parallelism") == "ring":
                    hseq = ctx.shard(hseq, "batch", "seq", None)
            else:
                h1, _ = slstm_decode_step(zifo[:, 0], self.r_diag, state)
                hseq = h1[:, None]
            inner = hseq.to(x.dtype)
        else:
            nh = self.n_heads
            hd = d_in // nh
            q, k, v = splittable(matmul(xin, w_qkv), -1, 3).reshape(
                B, S, 3, nh, hd).unbind(2)
            if rules.get("xlstm_hd"):
                # head-dim TP: q, k, v sharded on hd over ``model``
                q = ctx.shard(q, "batch", "seq", "ssm_heads", "xlstm_hd")
                k = ctx.shard(k, "batch", "seq", "ssm_heads", "xlstm_hd")
                v = ctx.shard(v, "batch", "seq", "ssm_heads", "xlstm_hd")
            gates = matmul(xin, w_gates).float() + self.gate_bias
            ig, fg = gates.chunk(2, dim=-1)
            if ring and ctx.mesh is not None:
                n_model = ctx.mesh["model"].size()
                hseq = mlstm_seq_parallel(
                    q, k, v, ig, fg, mesh=ctx.mesh, batch_axes=rules["batch"],
                    chunk=min(MLSTM_CHUNK, max(S // n_model, 1)))
            elif state is None:
                hseq, _ = mlstm_chunked(q, k, v, ig, fg,
                                        chunk=min(MLSTM_CHUNK, S))
            else:
                h1, _ = mlstm_decode_step(q[:, 0], k[:, 0], v[:, 0],
                                          ig[:, 0], fg[:, 0], state)
                hseq = h1[:, None]
            inner = hseq.reshape(B, S, d_in).to(x.dtype)
        inner = L.rmsnorm(inner, self.out_norm, ctx=ctx) * F.silu(z)
        return x + matmul(inner, self.down_proj.to(inner.dtype))


def init_xlstm_state(batch: int, d_model: int, n_heads: int,
                     is_slstm: bool, device, expand: int = 2) -> tuple:
    """One block's decode state, f32: sLSTM (c 0, n 1, h 0), each (B,
    d_in); mLSTM (C (B, nh, hd, hd), n (B, nh, hd)), zero."""
    d_in = expand * d_model
    if is_slstm:
        return _slstm_zero_state(batch, d_in, device)
    hd = d_in // n_heads
    return (torch.zeros((batch, n_heads, hd, hd), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, n_heads, hd), dtype=torch.float32,
                        device=device))


# --------------------------------------------------------------------------
# model level (xlstm-1.3b): heterogeneous blocks in a Python loop
# --------------------------------------------------------------------------


def slstm_flags(cfg: ArchConfig) -> list[bool]:
    """Whether each block is an sLSTM block: every ``slstm_every``-th."""
    if cfg.slstm_every <= 0:
        return [False] * cfg.n_layers
    return [(i + 1) % cfg.slstm_every == 0 for i in range(cfg.n_layers)]


class XLSTMLM(nn.Module):
    """xLSTM LM: embedding, ``n_layers`` :class:`XLSTMBlock` (every
    ``slstm_every``-th an sLSTM block), final norm, vocab head.  Weights
    start at zero: fill them with :meth:`init_params` or
    :func:`params_from_jax`.  ``trainable`` as
    :class:`~repro_torch.models.transformer.TransformerLM`'s."""

    #: parameter-name prefixes of the layers the reference stacks
    STACKED = ("blocks.",)

    def __init__(self, cfg: ArchConfig, device: "torch.device | str",
                 trainable: bool = False):
        super().__init__()
        if cfg.family != "ssm":
            raise NotImplementedError(f"{cfg.name}: not an xLSTM ('ssm') "
                                      f"config")
        device = torch.device(device)
        self.cfg = cfg
        self.device = device
        mm, norm = weight_kinds(device, trainable)
        self.embed = _weight(cfg.vocab_size, cfg.d_model, **mm)
        self.blocks = nn.ModuleList(XLSTMBlock(cfg, flag, device, trainable)
                                    for flag in slstm_flags(cfg))
        self.final_norm = _weight(cfg.d_model, **norm)
        self.lm_head = _weight(cfg.d_model, cfg.vocab_size, **mm)

    def decayed(self) -> frozenset:
        """Names of the parameters AdamW decays, by the reference's rule in
        its layout (:func:`~repro_torch.models.transformer.decayed_names`):
        every block parameter (the norms and ``gate_bias`` too: the
        reference stacks them), the embedding and ``lm_head``; not
        ``final_norm``."""
        return decayed_names(self, self.STACKED)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "XLSTMLM":
        """Random weights on the model's device, the reference's init
        (:meth:`XLSTMBlock.init_params`; the embedding and ``lm_head``
        N(0, 0.02^2), ``final_norm`` 0), drawn from ``generator`` (on the
        same device)."""
        self.embed.normal_(0.0, INIT_SCALE, generator=generator)
        for blk in self.blocks:
            blk.init_params(generator)
        self.final_norm.zero_()
        self.lm_head.normal_(0.0, INIT_SCALE, generator=generator)
        return self

    def forward(self, tokens: "torch.Tensor | Mapping",
                ctx: Optional[ModelContext] = None,
                last_only: bool = False) -> torch.Tensor:
        """tokens (B, S), or a batch dict holding them under ``"tokens"``
        -> logits (B, S, V), or (B, 1, V) when ``last_only``."""
        ctx = ctx or ModelContext()
        if isinstance(tokens, Mapping):
            tokens = tokens["tokens"]
        with mesh_scope(ctx):
            x = L.embed(tokens, self.embed.to(ACT_DTYPE), ctx)
            for blk in self.blocks:
                x = checkpointed(self.cfg, blk, x, ctx)
            if last_only:
                x = x[:, -1:]
            x = L.rmsnorm(x, self.final_norm, ctx=ctx)
            return ctx.shard(L.unembed(x, self.lm_head), "batch", "seq",
                             "vocab")

    def prefill(self, tokens: "torch.Tensor | Mapping",
                ctx: Optional[ModelContext] = None) -> torch.Tensor:
        """Full forward returning last-position logits (B, V)."""
        return self.forward(tokens, ctx)[:, -1]

    def init_cache(self, batch: int, max_len: int = 0) -> list:
        """The reference's decode cache: one state a block
        (:func:`init_xlstm_state`); ``max_len`` is unused, since the state
        does not grow."""
        cfg = self.cfg
        return [init_xlstm_state(batch, cfg.d_model, cfg.n_heads, flag,
                                 self.device) for flag in slstm_flags(cfg)]

    def decode_step(self, cache: list, tokens: torch.Tensor,
                    pos: torch.Tensor, ctx: Optional[ModelContext] = None):
        """One decode step.  tokens: (B,) ids; ``pos`` is unused (the
        recurrent state carries the position).  Returns (logits (B, V),
        cache); the cache is updated in place (the reference returns a new
        one)."""
        ctx = ctx or ModelContext()
        with mesh_scope(ctx):
            x = L.embed(tokens[:, None], self.embed.to(ACT_DTYPE))
            for blk, state in zip(self.blocks, cache):
                x = blk(x, ctx, state)
            x = L.rmsnorm(x[:, 0], self.final_norm, ctx=ctx)
            return L.unembed(x, self.lm_head), cache


@torch.no_grad()
def params_from_jax(tree: Mapping, cfg: ArchConfig,
                    device: "torch.device | str" = "cuda",
                    trainable: bool = False) -> XLSTMLM:
    """An :class:`XLSTMLM` holding the reference's parameters.

    ``tree`` is the reference's xLSTM params pytree as numpy arrays:
    ``embed`` (V, D), ``blocks`` with each of the nine entries stacked
    over the blocks (L, ...), ``final_norm`` (D,) and ``lm_head`` (D, V).
    To serve, the projections and the embedding are rounded to bf16
    (round to nearest even, the reference's on-the-fly cast);
    ``trainable`` copies the reference's f32 masters exactly.  The rest is
    kept in f32."""
    model = XLSTMLM(cfg, device, trainable)
    blocks = tree["blocks"]
    want = {name for name, _ in model.blocks[0].named_parameters()}
    if set(blocks) != want:
        raise KeyError(f"params_from_jax: block parameters {sorted(blocks)} "
                       f"!= {sorted(want)}")
    for name, stacked in blocks.items():
        stacked = _host(stacked)
        for i, blk in enumerate(model.blocks):
            getattr(blk, name).copy_(stacked[i])
    model.embed.copy_(_host(tree["embed"]))
    model.final_norm.copy_(_host(tree["final_norm"]))
    model.lm_head.copy_(_host(tree["lm_head"]))
    return model


def params_to_numpy(model: XLSTMLM) -> dict:
    """The inverse of :func:`params_from_jax`: the model's weights as
    float32 numpy arrays in the reference's tree, each block parameter
    stacked on the block axis."""
    return {"embed": _numpy(model.embed),
            "blocks": {name: np.stack([_numpy(getattr(b, name))
                                       for b in model.blocks])
                       for name, _ in model.blocks[0].named_parameters()},
            "final_norm": _numpy(model.final_norm),
            "lm_head": _numpy(model.lm_head)}
