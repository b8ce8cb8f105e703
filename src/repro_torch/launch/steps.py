"""Train / serve step factories of the port, the counterparts of the
reference's ``repro.launch.steps``.

train_step: gradient-accumulation microbatching (the per-arch
  ``microbatches`` knob is the main memory lever), f32 master weights with
  bf16 casts inside the model, AdamW update; the model's weights and the
  optimiser state are updated in place.  The reference scans the
  microbatches with ``lax.scan``; here a loop runs ``backward`` once per
  microbatch.
serve_step: one decode step against the model's cache (the KV cache, and
  the recurrent state of the hybrid and xLSTM families), updated in place;
prefill_step: full forward returning last-position logits, on token ids
or a batch dict of any family.

Under a mesh (``ctx`` from ``launch.shardings.assemble``) the model's
parameters, the batch and the cache are DTensors (``shardings.place``:
the train step's parameters in the ZeRO layout, ``opt_params``, as the
reference jits it), and so are the outputs.  A microbatched train step
splits each rank's own rows of a ``Shard(0)`` batch into M parts, so a
microbatch gathers the i-th part of every rank's rows rather than a
global slice of B/M rows: another grouping of the rows, the same mean
gradient (M equal-sized microbatch means), and no communication.  On
one rank the two groupings are the same.  Where a rank holds fewer rows
than M can share evenly (B/M rows over more batch ranks than B/M, which
GSPMD pads), the step makes fewer, larger microbatches (``_parts``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import zoo
from repro_torch.dtensor import DTensor, is_dtensor, whole
from repro_torch.models.sharding import ModelContext, mesh_scope
from repro_torch.models.zoo import LM
from repro_torch.optim.adamw import AdamW


def build_loss_fn(model: LM, ctx: Optional[ModelContext],
                  compute: Optional[dict] = None):
    """``loss_fn(batch)``: the model's loss.  ``compute``: placements by
    parameter name (``assemble``'s ``params``) that the forward takes
    each parameter to from its own (the masters' ``opt_params``): the
    ZeRO gather, whose backward reduce-scatters the gradient."""
    def loss_fn(batch: dict) -> torch.Tensor:
        if compute is None:
            return zoo.loss(model, batch, ctx)
        mesh = ctx.mesh
        return zoo.loss(model, batch, ctx, params={
            n: p.redistribute(mesh, compute[n])
            for n, p in model.named_parameters()})
    return loss_fn


def build_train_step(model: LM, optimizer: AdamW,
                     ctx: Optional[ModelContext],
                     microbatches: Optional[int] = None,
                     compute: Optional[dict] = None):
    """``train_step(opt_state, batch) -> {"loss", "grad_norm", "lr"}``
    (0-d tensors on the model's device), after the reference's: the batch
    (B, ...) is cut into ``M = microbatches or cfg.microbatches``
    microbatches (M, B/M, ...), each microbatch's gradient is added into
    the f32 ``.grad`` of each master weight (autograd's accumulation,
    from zero: the reference's ``gacc + g``), the summed loss and the
    gradients are divided by M, and ``optimizer.update`` updates the
    weights and ``opt_state`` in place.

    The model holds f32 masters that require grad (``build_model(...,
    trainable=True)``), and the optimizer carries the model's decayed set
    (``AdamW(decayed=model.decayed())``).  On a mesh the masters lie in
    the ZeRO layout (``assemble``'s ``opt_params``) and ``compute`` gives
    the layout the forward runs in (its ``params``), as the reference's
    jit gathers them; the moments follow the masters."""
    M = microbatches or model.cfg.microbatches
    loss_fn = build_loss_fn(model, ctx, compute)

    def train_step(opt_state: dict, batch: dict) -> dict:
        # read at each step: shardings.place replaces the parameters
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        n = _parts(batch, M)
        if n > 1:
            loss = torch.zeros((), dtype=torch.float32,
                               device=model.device)
            for i in range(n):
                mb_loss = loss_fn({k: _microbatch(v, n, i)
                                   for k, v in batch.items()})
                with mesh_scope(ctx):
                    mb_loss.backward()
                    loss = loss + mb_loss.detach()
            with torch.no_grad(), mesh_scope(ctx):
                for p in params.values():
                    if p.grad is not None:
                        p.grad.div_(n)
                loss = loss / n
        else:
            loss = loss_fn(batch)
            with mesh_scope(ctx):
                loss.backward()
            loss = loss.detach()
        # a weight the loss does not reach (an xLSTM block's leaves of the
        # other kind) has no .grad; the reference's gradient there is
        # zero, and AdamW still decays the weight
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        _, _, metrics = optimizer.update(grads, opt_state, params)
        for p in params.values():
            p.grad = None
        return {k: whole(v) for k, v in {"loss": loss, **metrics}.items()}

    return train_step


def _parts(batch: dict, M: int) -> int:
    """The microbatches a step makes of ``batch``: ``M``, or on a DTensor
    batch whose ranks each hold fewer rows than ``M`` parts can share
    evenly, the largest count that divides both (each rank's part is
    then more than B/M rows over all of them: the same rows a rank holds
    in each of GSPMD's padded microbatches, and fewer passes)."""
    v = next(iter(batch.values()))
    if not is_dtensor(v):
        return M
    return math.gcd(v.to_local().shape[0], M)


def _microbatch(v: torch.Tensor, M: int, i: int) -> torch.Tensor:
    """The i-th of M microbatches of ``v`` (B, ...): rows i B/M to (i+1)
    B/M, or on a DTensor the i-th part of each rank's own rows (see the
    module docstring)."""
    if not is_dtensor(v):
        return v.reshape(M, v.shape[0] // M, *v.shape[1:])[i]
    local = v.to_local()
    part = local.reshape(M, local.shape[0] // M, *local.shape[1:])[i]
    return DTensor.from_local(part, v.device_mesh, v.placements,
                              run_check=False)


def build_serve_step(model: LM, ctx: ModelContext):
    @torch.no_grad()
    def serve_step(cache: "dict | list", tokens: torch.Tensor,
                   pos: torch.Tensor):
        return model.decode_step(cache, tokens, pos, ctx)
    return serve_step


def build_prefill_step(model: LM, ctx: ModelContext,
                       last_only: bool = False):
    """``prefill_step(batch) -> (B, V)`` last-position logits; ``batch``
    is the token ids (B, S) or a batch dict of the model's family
    (``{"embeds"}`` for audio, ``{"tokens", "patch_embeds"}`` for vlm)."""
    @torch.no_grad()
    def prefill_step(batch: "torch.Tensor | dict") -> torch.Tensor:
        if last_only:
            # the vocab head for the final position only
            return model(batch, ctx, last_only=True)[:, 0]
        return model(batch, ctx)[:, -1]
    return prefill_step
