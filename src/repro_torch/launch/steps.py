"""Serve / prefill step factories of the port, the counterparts of the
reference's ``repro.launch.steps`` (its train step is a later slice).

serve_step: one decode step against the KV cache (updated in place);
prefill_step: full forward returning last-position logits.
"""

from __future__ import annotations

import torch

from repro_torch.models.sharding import ModelContext
from repro_torch.models.zoo import LM


def build_serve_step(model: LM, ctx: ModelContext):
    @torch.no_grad()
    def serve_step(cache: dict, tokens: torch.Tensor, pos: torch.Tensor):
        return model.decode_step(cache, tokens, pos, ctx)
    return serve_step


def build_prefill_step(model: LM, ctx: ModelContext,
                       last_only: bool = False):
    @torch.no_grad()
    def prefill_step(tokens: torch.Tensor) -> torch.Tensor:
        if last_only:
            # the vocab head for the final position only
            return model(tokens, ctx, last_only=True)[:, 0]
        return model(tokens, ctx)[:, -1]
    return prefill_step
