"""Logical-axis sharding of the port's model code, the counterpart of the
reference's ``repro.models.sharding``: DTensor on a
``torch.distributed`` ``DeviceMesh`` where the reference has GSPMD.

Model code names each tensor's dims by *logical* axis; a rule table maps
them to mesh axes (the reference's megatron layout):

* batch        -> ("pod", "data")   pure DP across pods + data axis
* heads/d_ff/
  vocab/experts-> "model"           tensor/expert parallelism
* kv_seq       -> "model"           decode: sequence-sharded KV cache
* seq          -> None (or "model" under sequence parallelism)

A resolved spec (one entry a tensor dim: ``None``, a mesh axis, or a
tuple of mesh axes, as the reference's ``PartitionSpec``) becomes DTensor
placements, one a mesh dim: ``Shard(d)`` where that mesh axis appears in
tensor dim ``d``'s entry, else ``Replicate()``.  DTensor nests the shards
of one tensor dim in mesh order, so an entry must list its mesh axes in
the mesh's order (every rule the reference builds does).
``ModelContext.shard`` is the reference's ``with_sharding_constraint``: a
``redistribute`` of a DTensor, and of a plain tensor (which every rank
holds whole) a local split.

Beside the mesh, the context selects the attention implementation, and
with ``"pallas"`` the hand-written kernels (flash attention, flash
decode, RMSNorm, the SSD state scan; on CPU tensors their plain
versions), and the MoE implementation.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.dtensor import distribute, is_dtensor, replicated_scope

ATTENTION_IMPLS = ("auto", "reference", "blocked", "pallas")
MOE_IMPLS = ("auto", "dense", "ep")


def default_rules(multi_pod: bool = False, seq_parallel: bool = False,
                  decode_cache_axis: str = "model") -> dict:
    """The reference's rule table, logical axis -> mesh axes."""
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "seq": "model" if seq_parallel else None,
        # seq dim INSIDE attention/MLP (Megatron-SP keeps it unsharded
        # there; the residual boundary re-shards)
        "attn_seq": None,
        "kv_seq": decode_cache_axis,      # decode-time KV cache sharding
        "d_model": None,
        "heads": "model",
        "kv_heads": None,                 # GQA: few KV heads -> replicate
        "head_dim": None,
        "d_ff": "model",
        "vocab": "model",
        "experts": "model",
        "capacity": None,
        "layers": None,
        "ssm_heads": "model",
        "state": None,
        "conv": None,
        "xlstm_hd": None,      # mLSTM value-dim TP (perf lever)
    }


def resolve_spec(names: Sequence[Optional[str]], rules: dict) -> tuple:
    """Logical names to a spec (one entry a dim: None, a mesh axis, or a
    tuple of them), de-duplicating mesh axes: earlier dims win (under
    sequence parallelism a (batch, seq, vocab) spec keeps ``model`` on
    seq and sheds it from vocab; a ZeRO ``d_model`` entry after an
    expert-sharded dim sheds ``model`` and keeps ``data``)."""
    used: set = set()
    out = []
    for n in names:
        r = rules.get(n) if n is not None else None
        if r is None:
            out.append(None)
            continue
        axes = (r,) if isinstance(r, str) else tuple(r)
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return tuple(out)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` (:func:`resolve_spec`'s form) on
    ``mesh``: ``Shard(d)`` on each mesh dim named in tensor dim ``d``'s
    entry, ``Replicate()`` on the rest.  A mesh dim of one rank is
    ``Replicate()`` whatever the spec names: its one shard is the whole
    dim, and DTensor's view rules refuse some reshapes of a dim sharded
    over it beside another.  Raises when an entry names its mesh axes
    out of the mesh's order, or an axis the mesh lacks."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {tuple(spec)}: mesh axes {missing} not "
                             f"on the mesh {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: dim {d} lists {axes} out "
                             f"of the mesh's order {names}; DTensor nests "
                             f"shards in mesh order")
        for i in idx:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass
class ModelContext:
    """Execution context threaded through the port's model code.

    ``mesh``/``rules``: the device mesh and the logical-axis rule table;
    with both set the context is ``distributed`` and ``shard`` places
    tensors on the mesh.  ``rules`` alone (no mesh) selects the rule-driven
    arithmetic (xLSTM's ``vtp`` merged weights) with every ``shard`` a
    no-op, as in the reference.

    ``attention_impl``: ``reference`` (full score matrix), ``blocked``
    (online softmax over KV blocks in plain PyTorch), ``pallas`` (the
    hand-written kernels of :mod:`repro_torch.kernels.ops`: flash
    attention, flash decode, RMSNorm and the SSD state scan; the name is
    the reference's), or ``auto`` (``blocked`` for sequences longer than
    ``blocked_threshold``, else ``reference``).  Every mode but
    ``pallas`` runs norms, decode attention and the SSD scan in plain
    PyTorch.  Under a mesh the kernels run on each rank's shard
    (``torch.distributed.tensor.experimental.local_map``).

    ``moe_impl``: ``dense`` (every expert for every token,
    :func:`repro_torch.models.moe.moe_dense`), ``ep`` (expert
    parallelism over the mesh's ``model`` axis,
    :func:`repro_torch.models.moe.moe_ep`, which raises without a mesh),
    or ``auto``: ``ep`` under a mesh, else ``dense``, as the reference's
    ``moe_block`` resolves it."""

    mesh: Optional[object] = None
    rules: Optional[dict] = None
    attention_impl: str = "auto"
    blocked_threshold: int = 2048
    moe_impl: str = "auto"

    def __post_init__(self) -> None:
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {self.attention_impl!r} not in "
                             f"{ATTENTION_IMPLS}")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl {self.moe_impl!r} not in {MOE_IMPLS}")

    @property
    def distributed(self) -> bool:
        return self.mesh is not None and self.rules is not None

    def entries(self, *logical_axes: Optional[str]) -> tuple:
        """The resolved spec of ``logical_axes`` (:func:`resolve_spec`)."""
        assert self.rules is not None
        return resolve_spec(logical_axes, self.rules)

    def spec(self, *logical_axes: Optional[str]) -> tuple:
        """The placements of ``logical_axes`` on the mesh, mesh axes
        de-duplicated with earlier dims winning."""
        assert self.distributed
        return placements(self.entries(*logical_axes), self.mesh)

    def shard(self, x: torch.Tensor, *logical_axes: Optional[str]
              ) -> torch.Tensor:
        """Place ``x`` by logical axis names (a no-op without a mesh, e.g.
        on one device without ``assemble``)."""
        if not self.distributed:
            return x
        assert x.ndim == len(logical_axes), (tuple(x.shape), logical_axes)
        place = self.spec(*logical_axes)
        if is_dtensor(x):
            return x.redistribute(self.mesh, place)
        return distribute(x, self.mesh, place)

    def named_sharding(self, *logical_axes: Optional[str]
                       ) -> Optional[tuple]:
        if not self.distributed:
            return None
        return self.spec(*logical_axes)



def mesh_scope(ctx: "Optional[ModelContext]"):
    """:func:`replicated_scope` when ``ctx`` has a mesh, else nothing: the
    scope of model code, and of its backward, on a mesh."""
    if ctx is None or not ctx.distributed:
        return contextlib.nullcontext()
    return replicated_scope()
