"""Remat of the port: the reference's ``jax.checkpoint`` units recomputed
in backward with ``torch.utils.checkpoint`` (non-reentrant).

The reference wraps each unit of its models in ``jax.checkpoint`` when
``cfg.remat`` is set: a transformer layer (or a gemma2 local/global
pair), a hybrid macro-block, an xLSTM block.  Only the transformer reads
``cfg.remat_policy``: ``"dots"`` there is
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``, and the
hybrid and xLSTM units recompute everything whatever the policy says
(``repro.models.transformer`` ``lm_forward``, ``hybrid`` ``hybrid_forward``,
``xlstm`` ``xlstm_forward``).

Under ``"dots"`` JAX keeps, of the values its backward reads, the outputs
of the products with no batch dimensions (each projection ``x @ w``, the
router's logits, the MoE's ``einsum("td,edf->etf")``) and recomputes the
rest.  The port's policy (:func:`dots_policy`, through
``create_selective_checkpoint_contexts``) saves the same products: an
``mm``, or a ``bmm`` one of whose operands is the same matrix for every
batch entry (stride 0 on its batch dimension, as ``torch.matmul``
broadcasts a 2-D operand).  A batched product (attention's scores and
values, the experts' second product, the MoE combine) is recomputed.

JAX also never keeps a product whose output its backward does not read.
One product of a unit is such: the MLP's output product of a unit's last
layer when no norm follows it, since only the unit's closing residual add
reads it.  A selective checkpoint cannot see that, so the model marks that
MLP (:func:`output_unread`) and its output product runs through
:func:`mlp_output`, which the policy leaves to recompute.  Values do not
change under any policy; only memory and time do.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Callable

import torch
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.dtensor import matmul

__all__ = ["checkpointed", "dots_policy", "no_batch_dims", "output_unread",
           "mlp_output"]

_aten = torch.ops.aten
#: set while a unit computes an MLP whose output only its residual add reads
_OUTPUT_UNREAD = contextvars.ContextVar("remat_output_unread", default=False)
#: set while that MLP's output product runs: the dots policy skips it
_SKIP = contextvars.ContextVar("remat_skip_product", default=False)


def no_batch_dims(func, args) -> bool:
    """Whether the op ``func(*args)`` is a product with no batch
    dimensions, in JAX's terms: an ``mm``/``addmm``, or a ``bmm``/
    ``baddbmm`` whose batch dimension is a broadcast (an operand with
    stride 0 on it)."""
    if func in (_aten.mm.default, _aten.addmm.default):
        return True
    if func in (_aten.bmm.default, _aten.baddbmm.default):
        return any(a.stride(0) == 0 for a in args[-2:])
    return False


def dots_policy(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """The port's ``dots_with_no_batch_dims_saveable``: save the output of
    each product with no batch dimensions (:func:`no_batch_dims`) but one
    run by :func:`mlp_output` under :func:`output_unread`; recompute
    every other op."""
    if no_batch_dims(func, args) and not _SKIP.get():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def output_unread(unread: bool):
    """Mark an MLP run inside as one whose output only the unit's closing
    residual add reads (``unread``), so that its output product
    (:func:`mlp_output`) is not saved under ``"dots"``."""
    token = _OUTPUT_UNREAD.set(unread)
    try:
        yield
    finally:
        _OUTPUT_UNREAD.reset(token)


def mlp_output(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``g @ w``, an MLP's output product: under :func:`output_unread`,
    one that :func:`dots_policy` leaves to recompute."""
    if not _OUTPUT_UNREAD.get():
        return matmul(g, w)
    token = _SKIP.set(True)
    try:
        return matmul(g, w)
    finally:
        _SKIP.reset(token)


def checkpointed(cfg: ArchConfig, fn: Callable, *args,
                 policy: str = "full"):
    """``fn(*args)``, recomputed in backward when the reference would
    remat it: ``cfg.remat``, and only while grad is enabled.  ``policy``
    ``"dots"`` saves the products of :func:`dots_policy`; any other value
    recomputes everything (the reference's ``policy=None``).  The
    transformer passes ``cfg.remat_policy``; the hybrid and xLSTM units
    take the default, as the reference's ignore the policy."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    fn = _with_weights_of_now(fn)
    if policy != "dots":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, dots_policy))


def _with_weights_of_now(fn: Callable) -> Callable:
    """``fn``, a module or a method of one, reading the module's
    parameters as they are now when it runs again in backward: a forward
    under ``torch.func.functional_call`` (the train step's weights taken
    from the ZeRO masters to the layout it computes in) is recomputed
    with the same weights after the call has put the masters back."""
    module = fn if isinstance(fn, torch.nn.Module) else getattr(
        fn, "__self__", None)
    if not isinstance(module, torch.nn.Module):
        return fn
    now = dict(module.named_parameters())
    if all(isinstance(p, torch.nn.Parameter) for p in now.values()):
        return fn                       # the module's own: nothing to keep

    def run(*args):
        with _reparametrize_module(module, now):
            return fn(*args)
    return run
