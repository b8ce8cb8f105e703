"""Mixture-of-Experts layer of the port, the counterpart of the
reference's ``repro.models.moe``, function for function.

* ``dense`` — every expert computed for every token, combined by gate
  weights (:func:`moe_dense`): O(E) FLOPs, the reference's numerical
  oracle, and what its ``moe_block`` runs without a mesh.  The port runs
  on one card, so this is its MoE path.
* ``ep`` — the reference's expert parallelism over a mesh (``moe_ep``,
  ``_ep_local``: ``shard_map`` and ``all_to_all``) is not ported yet: it
  needs the mesh of ROADMAP §1 item 5, and ``ModelContext`` refuses
  ``moe_impl="ep"``.

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
import torch.nn.functional as F

from repro_torch.models.layers import swiglu
from repro_torch.models.sharding import ModelContext

__all__ = ["router_probs", "load_balancing_loss", "moe_dense", "moe_block"]


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


def moe_block(x: torch.Tensor, params: dict, *, k: int, n_experts: int,
              n_shared: int, capacity_factor: float,
              ctx: Optional[ModelContext] = None) -> torch.Tensor:
    """Routed experts + optional shared experts (Moonlight-style).

    Runs :func:`moe_dense` whatever ``ctx.moe_impl`` says: ``"auto"`` is
    ``"dense"`` without a mesh, and ``ModelContext`` refuses ``"ep"``;
    ``n_experts`` and ``capacity_factor`` are the reference's arguments
    of its expert-parallel path and unused here."""
    y = moe_dense(x, params, k, ctx)
    if n_shared > 0:
        y = y + swiglu(x, params["wi_s"], params["wo_s"])
    return y
