"""Execution context threaded through the port's model code.

The counterpart of the reference's ``repro.models.sharding``.  The port
runs on one card, so the mesh, the logical-axis rules and the sharding
constraints have no counterpart here, and neither has Pallas's
interpret mode or the cost-probe scan unrolling.  What is left selects
the attention implementation.
"""

from __future__ import annotations

import dataclasses

ATTENTION_IMPLS = ("auto", "reference", "blocked", "pallas")


@dataclasses.dataclass
class ModelContext:
    """``attention_impl``: ``reference`` (full score matrix), ``blocked``
    (online softmax over KV blocks in plain PyTorch), ``pallas`` (the
    hand-written flash-attention kernel, :func:`repro_torch.kernels.ops.
    flash_attention`; the name is the reference's), or ``auto``
    (``blocked`` for sequences longer than ``blocked_threshold``, else
    ``reference``)."""

    attention_impl: str = "auto"
    blocked_threshold: int = 2048

    def __post_init__(self) -> None:
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {self.attention_impl!r} not in "
                             f"{ATTENTION_IMPLS}")
