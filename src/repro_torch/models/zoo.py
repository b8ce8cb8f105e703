"""Model zoo of the port: ``build_model(cfg, device)``.

The counterpart of the reference's ``repro.models.zoo``.  The reference
returns a bundle of pure functions over a params pytree; the port
returns an ``nn.Module`` that holds its weights (fill them with
``init_params(generator)`` or load the reference's with the
``params_from_jax`` of :mod:`repro_torch.models.transformer` or
:mod:`repro_torch.models.hybrid`).  So far the dense and hybrid families
are ported.  The reference's ``Model.loss``, ``batch_shapes`` and
``make_batch`` are functions of the model or its config here.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.layers import cross_entropy
from repro_torch.models.sharding import ModelContext
from repro_torch.models.transformer import TransformerLM

#: the port's language models: each has ``forward(tokens, ctx,
#: last_only)``, ``init_cache(batch, max_len)``, ``decode_step(cache,
#: tokens, pos, ctx)``, ``init_params(generator)`` and ``decayed()``
LM = Union[TransformerLM, HybridLM]


def build_model(cfg: ArchConfig, device: "torch.device | str" = "cuda",
                trainable: bool = False) -> LM:
    """The model of ``cfg`` on ``device`` (the GPU unless the caller asks
    for ``"cpu"``), weights zero: matmul weights in bf16 to serve, or, with
    ``trainable``, every weight an f32 master that requires grad, which
    training updates.  Raises ``RuntimeError`` when ``device`` is CUDA and
    no GPU is available, ``NotImplementedError`` for a family that is not
    ported yet."""
    device = resolve_device(device)
    cls = HybridLM if cfg.family == "hybrid" else TransformerLM
    return cls(cfg, device, trainable)


def _text_only(cfg: ArchConfig) -> None:
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} frontend is not ported yet "
            "(ROADMAP §1)")


def loss(model: LM, batch: dict, ctx: Optional[ModelContext] = None
         ) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` ({"tokens", "labels"}
    (B, S), optional "loss_mask"), the reference's ``Model.loss``."""
    _text_only(model.cfg)
    logits = model(batch["tokens"], ctx)
    return cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


def batch_shapes(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """(shape, dtype) of each entry of one training/prefill batch."""
    _text_only(cfg)
    return {"tokens": ((batch, seq), torch.int32),
            "labels": ((batch, seq), torch.int32)}


def make_batch(cfg: ArchConfig, generator: torch.Generator, batch: int,
               seq: int) -> dict:
    """A random batch on ``generator``'s device: ids uniform in
    ``[0, vocab)``, drawn entry by entry."""
    return {name: torch.randint(0, cfg.vocab_size, shape,
                                generator=generator, dtype=dtype,
                                device=generator.device)
            for name, (shape, dtype) in batch_shapes(cfg, batch, seq).items()}
