"""Public entry points of the port's kernels, as the reference's
``repro.kernels.ops`` has them for its Pallas kernels.

The reference's ``block_q``/``block_k``/``block_rows`` (TPU tile sizes)
and ``interpret`` (Pallas on the CPU) have no counterpart: each kernel
picks its own tiles, and a CPU tensor runs the plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import flash_decode as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm
from repro_torch.kernels.ssm_scan import ssd_state_scan as _scan


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,H,hd); k, v: (B,T,KV,hd); positions (S,)/(T,).  Returns
    (B,S,H,hd) in q's dtype."""
    return _flash(q, k, v, q_pos, k_pos, causal=causal, window=window,
                  logit_cap=logit_cap, scale=scale)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: torch.Tensor, *,
                 window: int = 0, logit_cap: float = 0.0,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,hd); caches: (B,T,KV,hd); pos: (B,).  Returns (B,H,hd) in
    q's dtype."""
    return _decode(q, k_cache, v_cache, pos, window=window,
                   logit_cap=logit_cap, scale=scale)


def ssd_state_scan(states: torch.Tensor, totals: torch.Tensor,
                   C: torch.Tensor, cum: torch.Tensor):
    """states: (B,nc,nh,hd,N); totals: (B,nc,nh); C: (B,nc,Q,N); cum:
    (B,nc,Q,nh).  Returns (y_inter (B,nc,Q,nh,hd), final_state
    (B,nh,hd,N))."""
    return _scan(states, totals, C, cum)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """x: (..., D); w: (D,).  Fused RMSNorm in x's dtype."""
    return _rmsnorm(x, w, eps=eps)
