"""Hand-rolled AdamW, the port's counterpart of the reference's
``repro.optim.adamw``.

Decoupled weight decay, bias-corrected moments, optional global-norm
clipping.  The reference's state is a pytree matching its params; here
params, grads and the moments are dicts of named tensors (a model's
``named_parameters()``), and :meth:`AdamW.update` updates the params and
the moments in place, under ``torch.no_grad()``, element by element in
the reference's order of operations.

Which tensors decay follows the reference's layout, not the port's.  The
reference decays a leaf of rank >= 2 ("no decay on norms"), but it
stacks every per-layer parameter on a leading layer axis, so it decays
the per-layer norms and SSM vectors too; the port keeps each layer's
tensors apart.  So the caller names the tensors that decay: a model
passes its own set (``model.decayed()``) as ``decayed``.

On a device mesh the params, grads and moments are DTensors (the moments
follow their params' placements): the global norm's sum of squares
reduces over every shard (a DTensor reduction), each grad is reduced to
its param's placements, and the update, element by element, runs on each
rank's shards.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Union

import torch

from repro_torch.dtensor import is_dtensor, local, replicated_scope, whole


def _global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every grad's squares, in float32 (over every
    shard of a DTensor grad)."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """Returns (clipped grads, global norm): each grad scaled by
    ``min(1, max_norm / max(norm, 1e-9))`` in float32, cast back to its
    dtype."""
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {k: _scaled(g, scale) for k, g in grads.items()}, gn


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    #: names of the tensors that decay (see the module docstring)
    decayed: frozenset = dataclasses.field(kw_only=True)

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        """{"m", "v": float32 zeros like each param, "step": int32 0}."""
        dev = next(iter(params.values())).device
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": {k: zeros(p) for k, p in params.items()},
                "v": {k: zeros(p) for k, p in params.items()},
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.tensor(self.learning_rate, dtype=torch.float32,
                            device=torch.as_tensor(step).device)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor]):
        """Returns (params, state, {"grad_norm", "lr"}); ``params`` and the
        state's moments are updated in place, its step replaced.  Each
        grad is clipped as :func:`clip_by_global_norm` clips it, one
        tensor at a time (no second copy of the grads).  On DTensors each
        grad is first reduced to its param's placements, and the update
        runs on each rank's shards."""
        with replicated_scope():
            gnorm = _global_norm(grads)
        gnorm = whole(gnorm)
        scale = (_clip_scale(gnorm, self.grad_clip_norm)
                 if self.grad_clip_norm > 0 else None)
        step = whole(state["step"]) + 1
        lr = self.lr_at(step)
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()
        for name, p in params.items():
            g = grads[name]
            if is_dtensor(p):
                g = g.redistribute(p.device_mesh, p.placements).to_local()
            g = (g if scale is None else _scaled(g, scale)).float()
            m, v, p = (local(t) for t in (state["m"][name],
                                          state["v"][name], p))
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p32 = p.float()
            if self.weight_decay > 0 and name in self.decayed:
                delta = delta + self.weight_decay * p32
            p.copy_(p32 - lr * delta)
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}
