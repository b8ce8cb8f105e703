"""Model zoo of the port: ``build_model(cfg, device)``.

The counterpart of the reference's ``repro.models.zoo``.  The reference
returns a bundle of pure functions over a params pytree; the port
returns an ``nn.Module`` that holds its weights (fill them with
``init_params(generator)`` or load the reference's with
:func:`repro_torch.models.transformer.params_from_jax`).  So far the
dense family is ported.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig, device: "torch.device | str" = "cuda"
                ) -> TransformerLM:
    """The model of ``cfg`` on ``device`` (the GPU unless the caller asks
    for ``"cpu"``), weights zero.  Raises ``RuntimeError`` when ``device``
    is CUDA and no GPU is available, ``NotImplementedError`` for a family
    that is not ported yet."""
    return TransformerLM(cfg, resolve_device(device))
