"""Mixture-of-Experts layer of the port, the counterpart of the
reference's ``repro.models.moe``, function for function.

* ``dense`` — every expert computed for every token, combined by gate
  weights (:func:`moe_dense`): O(E) FLOPs, the reference's numerical
  oracle, and what its ``moe_block`` runs without a mesh.
* ``ep`` — expert parallelism over the mesh's ``model`` axis
  (:func:`moe_ep`, :func:`_ep_local`): each rank holds E / n_model
  experts; tokens are sorted by expert into fixed-capacity slots, sent
  to the experts' ranks with one ``all_to_all``, run through the expert
  FFNs as batched products, sent back with a second ``all_to_all`` and
  combined by gate weight in float32.  Pairs past an expert's capacity
  are dropped (Switch-style; ``capacity_factor`` sets the slack), their
  residual passing through untouched.  The reference runs it under
  ``shard_map``; the port under ``local_map`` with
  ``torch.distributed``'s functional collectives, which carry autograd.
  It needs a mesh (``ModelContext(mesh=..., rules=...)``) and raises
  without one.

Weights layout (one layer; the reference stacks them on a layer axis):
  router: (D, E)      the router runs in float32
  wi:     (E, D, 2F)  fused gate+up (SwiGLU experts)
  wo:     (E, F, D)
  shared experts (n_s >= 1, e.g. Moonlight): wi_s (D, 2*F*n_s),
  wo_s (F*n_s, D)

The products are the reference's ``jnp.einsum`` calls, as ``torch.matmul``
and ``torch.einsum``, in the activation dtype (the weights cast to it, as
the reference casts them).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.dtensor import on_mesh
from repro_torch.models.layers import swiglu
from repro_torch.models.sharding import ModelContext, placements

__all__ = ["router_probs", "load_balancing_loss", "moe_dense", "capacity",
           "dispatch_slots", "moe_ep", "moe_block"]


def router_probs(x: torch.Tensor, w_router: torch.Tensor, k: int):
    """Top-k routing with renormalized softmax gates (float32 router).
    x: (T, D).  Returns gates (T, k) f32, idx (T, k) and probs (T, E) f32."""
    logits = x.float() @ w_router.float()                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)                   # (T, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def load_balancing_loss(probs: torch.Tensor, idx: torch.Tensor,
                        n_experts: int) -> torch.Tensor:
    """Switch-transformer aux loss: E * sum_e f_e * p_e."""
    counts = torch.bincount(idx.reshape(-1), minlength=n_experts).float()
    f = counts / max(idx.numel(), 1)
    p = probs.mean(dim=0)
    return n_experts * torch.sum(f * p)


def _expert_ffn(xs: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor
                ) -> torch.Tensor:
    """xs: (E, C, D), wi: (E, D, 2F), wo: (E, F, D) -> (E, C, D)."""
    h = torch.bmm(xs, wi.to(xs.dtype))                      # ecd,edf->ecf
    gate, up = h.chunk(2, dim=-1)
    return torch.bmm(F.silu(gate) * up, wo.to(xs.dtype))    # ecf,efd->ecd


def moe_dense(x: torch.Tensor, params: dict, k: int,
              ctx: Optional[ModelContext] = None) -> torch.Tensor:
    """x: (B, S, D).  Computes all experts densely; exact combine."""
    B, S, D = x.shape
    E = params["router"].shape[1]
    xt = x.reshape(B * S, D)
    gates, idx, _ = router_probs(xt, params["router"], k)
    # (E, T, D) all-experts compute
    h = torch.matmul(xt, params["wi"].to(xt.dtype))          # td,edf->etf
    gate, up = h.chunk(2, dim=-1)
    h = F.silu(gate) * up
    ye = torch.matmul(h, params["wo"].to(xt.dtype))          # etf,efd->etd
    onehot = F.one_hot(idx, E).to(ye.dtype)                  # (T, k, E)
    combine = torch.einsum("tke,tk->te", onehot, gates.to(ye.dtype))
    out = torch.einsum("te,etd->td", combine, ye)
    return out.reshape(B, S, D)


# --------------------------------------------------------------------------
# expert-parallel path
# --------------------------------------------------------------------------


def capacity(T: int, k: int, capacity_factor: float, n_experts: int) -> int:
    """Each expert's slots for ``T`` tokens of ``k`` choices: the
    reference's ``max(1, int(T * k * cf) // E)``."""
    return max(1, int(T * k * capacity_factor) // n_experts)


def dispatch_slots(idx: torch.Tensor, n_experts: int, C: int) -> tuple:
    """The fixed-capacity dispatch of ``idx`` (T, k) expert choices, as
    the reference's ``_ep_local`` builds it: the (token, choice) pairs
    sorted by expert (stable, so tokens keep their order within an
    expert), each pair's position within its expert's run, and the pairs
    past ``C`` dropped.  Returns (order, slot_e, slot_c, keep), each
    (T*k,) in sorted order: ``order`` indexes the flattened pairs; a
    dropped pair has slot (0, 0) and ``keep`` False."""
    T, k = idx.shape
    flat_e = idx.reshape(-1)
    se, order = torch.sort(flat_e, stable=True)
    start = torch.searchsorted(
        se, torch.arange(n_experts, device=idx.device, dtype=se.dtype),
        side="left")
    pos = torch.arange(T * k, device=idx.device) - start[se]
    keep = pos < C
    zero = torch.zeros((), dtype=se.dtype, device=idx.device)
    return (order, torch.where(keep, se, zero), torch.where(keep, pos, 0),
            keep)


def _ep_local(xt_full: torch.Tensor, router: torch.Tensor,
              wi: torch.Tensor, wo: torch.Tensor, *, k: int, n_experts: int,
              capacity_factor: float, group, rank: int, n_model: int,
              tokens_replicated: bool) -> torch.Tensor:
    """Per-rank body.  xt_full: (T_full, D) local tokens; wi/wo hold this
    rank's E_loc experts (experts ``rank * E_loc ...``); router replicated.

    When the batch shards over data only (megatron TP), tokens are
    replicated across the EP (``model``) axis: each EP rank dispatches
    only its 1/n_model token slice, and the outputs are re-assembled with
    one all_gather.  When the batch shards over ``model`` too (FSDP) every
    rank already owns distinct tokens: no slice, no gather."""
    T_full, D = xt_full.shape
    E = n_experts
    E_loc = wi.shape[0]
    if tokens_replicated and n_model > 1 and T_full % n_model == 0:
        T = T_full // n_model
        xt = xt_full[rank * T:(rank + 1) * T]
    else:
        T = T_full
        xt = xt_full
    gates, idx, _ = router_probs(xt, router, k)

    # ---- fixed-capacity send buffer (E, C, D) ----
    C = capacity(T, k, capacity_factor, E)
    order, slot_e, slot_c, keep = dispatch_slots(idx, E, C)
    st = order // k                                  # each pair's token
    sg = gates.reshape(-1)[order]
    rows = torch.where(keep[:, None], xt[st], torch.zeros((), dtype=xt.dtype,
                                                          device=xt.device))
    # each slot takes one kept row, and slot (0, 0) also the dropped
    # pairs' zero rows: a scatter-add whose sums are exact in any order
    send = torch.zeros((E * C, D), dtype=xt.dtype, device=xt.device)
    send = send.index_add(0, slot_e * C + slot_c, rows).view(E, C, D)

    # ---- all_to_all to the experts' ranks: out[j*E_loc + e] is rank j's
    # buffer for this rank's expert e (split == concat along dim 0, so the
    # exchange is its own transpose, in backward too) ----
    out = funcol.all_to_all_single_autograd(send, None, None, group)
    recv = out.reshape(n_model, E_loc, C, D).transpose(0, 1).reshape(
        E_loc, n_model * C, D)

    # ---- expert FFNs ----
    y = _expert_ffn(recv, wi, wo)

    # ---- all_to_all back: chunk j holds rank j's outputs ----
    y = y.reshape(E_loc, n_model, C, D).transpose(0, 1).reshape(E, C, D)
    back = funcol.all_to_all_single_autograd(y.contiguous(), None, None,
                                             group)

    # ---- weighted combine, in float32 ----
    contrib = back[slot_e, slot_c]                   # (T*k, D)
    contrib = torch.where(keep[:, None], contrib.float(),
                          torch.zeros((), device=xt.device))
    out = torch.zeros((T, D), dtype=torch.float32, device=xt.device)
    out = out.index_add(0, st, contrib * sg[:, None])
    out = out.to(xt_full.dtype)
    if T != T_full:
        # every rank's token slice back into the whole (replicated)
        # activation; the slices are contiguous
        out = _GatherSlices.apply(out, group, rank)
    return out


class _GatherSlices(torch.autograd.Function):
    """All-gather of each rank's token slice into the whole activation,
    which every rank then holds (replicated).  Its gradient arrives
    replicated too, so backward keeps this rank's slice of it (where an
    all-gather's usual backward, a reduce-scatter, would add n_model
    copies); ``moe_ep`` declares the input's gradient partial over
    ``model``."""

    @staticmethod
    def forward(ctx, t, group, rank: int):
        n = dist.get_world_size(group)
        out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
        ctx.slice = (rank * t.shape[0], (rank + 1) * t.shape[0])
        return out

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.slice
        return g[lo:hi], None, None


def moe_ep(x: torch.Tensor, params: dict, k: int, n_experts: int,
           capacity_factor: float, ctx: ModelContext) -> torch.Tensor:
    """Expert-parallel MoE over the mesh's ``model`` axis, each rank's
    :func:`_ep_local` under ``local_map``: x (B, S, D) as the rules place
    its batch, the router replicated, the experts' ``wi``/``wo`` sharded
    over ``model``.  Raises without a mesh.  The pairs a rank drops are
    those :func:`dispatch_slots` keeps out of its tokens' routing
    (:func:`router_probs`)."""
    if ctx is None or not ctx.distributed:
        raise ValueError("moe_ep: expert parallelism needs a device mesh "
                         "(ModelContext(mesh=..., rules=...))")
    mesh = ctx.mesh
    n_model = mesh["model"].size()
    B, S, D = x.shape
    batch_axes = ctx.rules["batch"]
    axes = (batch_axes,) if isinstance(batch_axes, str) else (batch_axes
                                                               or ())
    replicated = "model" not in axes
    x_place = placements((batch_axes, None, None), mesh)
    rep = (Replicate(),) * mesh.ndim
    w_place = placements(("model", None, None), mesh)
    group = mesh.get_group("model")
    rank = mesh.get_local_rank("model")
    m_dim = mesh.mesh_dim_names.index("model")
    sliced = replicated and n_model > 1 and (B * S) % n_model == 0
    # the gradients' placements: a weight's gradient is partial over the
    # mesh dims whose ranks see different tokens (the batch's shards, and
    # ``model`` when each EP rank dispatches its own slice); x's is
    # partial over ``model`` when sliced (each rank's slice, zero
    # elsewhere)
    own = [p.is_shard(0) and mesh.size(i) > 1 or (i == m_dim and sliced)
           for i, p in enumerate(x_place)]
    g_router = tuple(Partial() if o else Replicate() for o in own)
    g_w = tuple(w if i == m_dim else (Partial() if o else Replicate())
                for i, (w, o) in enumerate(zip(w_place, own)))
    g_x = tuple(Partial() if i == m_dim and sliced else p
                for i, p in enumerate(x_place))

    def body(xb, router, wi, wo):
        out = _ep_local(xb.reshape(-1, D), router, wi, wo, k=k,
                        n_experts=n_experts, capacity_factor=capacity_factor,
                        group=group, rank=rank, n_model=n_model,
                        tokens_replicated=replicated)
        return out.reshape(xb.shape)

    fn = local_map(body, out_placements=list(x_place),
                   in_placements=(x_place, rep, w_place, w_place),
                   in_grad_placements=(g_x, g_router, g_w, g_w),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(*(on_mesh(t, mesh) for t in (x, params["router"], params["wi"],
                                            params["wo"])))


def moe_block(x: torch.Tensor, params: dict, *, k: int, n_experts: int,
              n_shared: int, capacity_factor: float,
              ctx: Optional[ModelContext] = None) -> torch.Tensor:
    """Routed experts + optional shared experts (Moonlight-style).
    ``ctx.moe_impl`` ``"auto"`` is ``"ep"`` under a mesh and ``"dense"``
    without one, as the reference resolves it; ``"ep"`` without a mesh
    raises in :func:`moe_ep`."""
    impl = ctx.moe_impl if ctx is not None else "dense"
    if impl == "auto":
        impl = "ep" if (ctx is not None and ctx.distributed) else "dense"
    if impl == "ep":
        y = moe_ep(x, params, k, n_experts, capacity_factor, ctx)
    else:
        y = moe_dense(x, params, k, ctx)
    if n_shared > 0:
        y = y + swiglu(x, params["wi_s"], params["wo_s"], ctx)
    return y
