"""The model kernels' forward-only rule.

The hand-written kernels write their outputs through ``ctypes`` into
tensors made with ``torch.empty``: those carry no ``grad_fn``, so a
``backward`` through them would give their inputs no gradient, and
nothing would warn.  The reference's Pallas kernels are forward-only too
(it defines no ``custom_vjp``), and it trains through its plain paths.
"""

from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``RuntimeError`` when grad is enabled and any of ``tensors``
    requires grad: kernel ``name`` cannot carry a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the hand-written kernels are forward-only, as the "
            "reference's Pallas kernels are, and an input requires grad; "
            "train under any ModelContext attention_impl but 'pallas' (the "
            "plain paths), or call the kernel under torch.no_grad()")
