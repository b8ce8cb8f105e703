"""Model zoo of the port: ``build_model(cfg, device)``.

The counterpart of the reference's ``repro.models.zoo``.  The reference
returns a bundle of pure functions over a params pytree; the port
returns an ``nn.Module`` that holds its weights (fill them with
``init_params(generator)`` or load the reference's with the
``params_from_jax`` of :mod:`repro_torch.models.transformer` or
:mod:`repro_torch.models.hybrid`).  So far the dense and hybrid families
are ported.
"""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.transformer import TransformerLM

#: the port's language models: each has ``forward(tokens, ctx,
#: last_only)``, ``init_cache(batch, max_len)``, ``decode_step(cache,
#: tokens, pos, ctx)`` and ``init_params(generator)``
LM = Union[TransformerLM, HybridLM]


def build_model(cfg: ArchConfig, device: "torch.device | str" = "cuda") -> LM:
    """The model of ``cfg`` on ``device`` (the GPU unless the caller asks
    for ``"cpu"``), weights zero.  Raises ``RuntimeError`` when ``device``
    is CUDA and no GPU is available, ``NotImplementedError`` for a family
    that is not ported yet."""
    device = resolve_device(device)
    if cfg.family == "hybrid":
        return HybridLM(cfg, device)
    return TransformerLM(cfg, device)
