"""Public entry points of the port's kernels, as the reference's
``repro.kernels.ops`` has them for its Pallas kernels.

The reference's ``block_q``/``block_k`` (TPU tile sizes) and
``interpret`` (Pallas on the CPU) have no counterpart: the kernel picks
its own tiles, and a CPU tensor runs the plain PyTorch version.  The
reference's ``flash_decode``, ``ssd_state_scan`` and ``rmsnorm`` are
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention as _flash


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,H,hd); k, v: (B,T,KV,hd); positions (S,)/(T,).  Returns
    (B,S,H,hd) in q's dtype."""
    return _flash(q, k, v, q_pos, k_pos, causal=causal, window=window,
                  logit_cap=logit_cap, scale=scale)
