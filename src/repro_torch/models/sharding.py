"""Execution context threaded through the port's model code.

The counterpart of the reference's ``repro.models.sharding``.  The port
runs on one card, so the mesh, the logical-axis rules and the sharding
constraints have no counterpart here, and neither has Pallas's
interpret mode or the cost-probe scan unrolling.  What is left selects
the attention implementation, and with ``"pallas"`` the hand-written
kernels: flash attention (prefill), flash decode (decode attention), the
fused RMSNorm (every norm) and the SSD state scan (the inter-chunk step
of every Mamba2 prefill).  On CPU tensors each runs its plain version.
It also selects the MoE implementation, of which one card runs one.
"""

from __future__ import annotations

import dataclasses

ATTENTION_IMPLS = ("auto", "reference", "blocked", "pallas")
MOE_IMPLS = ("auto", "dense", "ep")


@dataclasses.dataclass
class ModelContext:
    """``attention_impl``: ``reference`` (full score matrix), ``blocked``
    (online softmax over KV blocks in plain PyTorch), ``pallas`` (the
    hand-written kernels of :mod:`repro_torch.kernels.ops`: flash
    attention, flash decode, RMSNorm and the SSD state scan; the name is
    the reference's), or ``auto`` (``blocked`` for sequences longer than
    ``blocked_threshold``, else ``reference``).  Every mode but
    ``pallas`` runs norms, decode attention and the SSD scan in plain
    PyTorch.

    ``moe_impl``: ``dense`` (every expert for every token,
    :func:`repro_torch.models.moe.moe_dense`) or ``auto``, which is
    ``dense`` without a mesh, as the reference's ``moe_block`` resolves
    it.  ``ep`` (expert parallelism over a mesh) is not ported: the
    reference's ``moe_ep`` needs a mesh, which the port has not yet
    (ROADMAP §1 item 5)."""

    attention_impl: str = "auto"
    blocked_threshold: int = 2048
    moe_impl: str = "auto"

    def __post_init__(self) -> None:
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {self.attention_impl!r} not in "
                             f"{ATTENTION_IMPLS}")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl {self.moe_impl!r} not in {MOE_IMPLS}")
        if self.moe_impl == "ep":
            raise NotImplementedError(
                "moe_impl='ep' needs a device mesh, which the port does not "
                "have yet (ROADMAP §1 item 5); use 'dense' or 'auto'")
