"""Model zoo of the port: ``build_model(cfg, device)``.

The counterpart of the reference's ``repro.models.zoo``.  The reference
returns a bundle of pure functions over a params pytree; the port
returns an ``nn.Module`` that holds its weights (fill them with
``init_params(generator)`` or load the reference's with the
``params_from_jax`` of :mod:`repro_torch.models.transformer`,
:mod:`repro_torch.models.hybrid` or :mod:`repro_torch.models.xlstm`).
Every family of the reference is ported: dense, MoE, audio, VLM, hybrid
and xLSTM (``"ssm"``).  The reference's
``Model.loss``, ``batch_shapes`` and ``make_batch`` are functions of the
model or its config here.
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
from repro_torch.models.xlstm import XLSTMLM

#: the port's language models: each has ``forward(batch, ctx,
#: last_only)`` (token ids or a batch dict), ``init_cache(batch,
#: max_len)``, ``decode_step(cache, tokens, pos, ctx)``,
#: ``init_params(generator)`` and ``decayed()``
LM = Union[TransformerLM, HybridLM, XLSTMLM]


def build_model(cfg: ArchConfig, device: "torch.device | str" = "cuda",
                trainable: bool = False) -> LM:
    """The model of ``cfg`` on ``device`` (the GPU unless the caller asks
    for ``"cpu"``), weights zero: matmul weights in bf16 to serve, or, with
    ``trainable``, every weight an f32 master that requires grad, which
    training updates.  Raises ``RuntimeError`` when ``device`` is CUDA and
    no GPU is available, ``NotImplementedError`` for an unknown family."""
    device = resolve_device(device)
    cls = {"hybrid": HybridLM, "ssm": XLSTMLM}.get(cfg.family, TransformerLM)
    return cls(cfg, device, trainable)


def loss(model: LM, batch: dict, ctx: Optional[ModelContext] = None
         ) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` (one of
    :func:`batch_shapes`'s forms with its "labels", optional
    "loss_mask"), the reference's ``Model.loss``: for the vlm family only
    on the text positions (the image prefix is conditioning)."""
    logits = model(batch, ctx)
    if model.cfg.family == "vlm":
        logits = logits[:, model.cfg.num_patches:]
    return cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


def batch_shapes(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """(shape, dtype) of each entry of one training/prefill batch: ids
    (B, S) and labels, or for audio bf16 frame embeddings (B, S, D), or
    for vlm ``num_patches`` bf16 patch embeddings before S - num_patches
    ids, as the reference's."""
    ids, emb = torch.int32, torch.bfloat16
    if cfg.family == "audio":
        return {"embeds": ((batch, seq, cfg.d_model), emb),
                "labels": ((batch, seq), ids)}
    if cfg.family == "vlm":
        P = cfg.num_patches
        return {"tokens": ((batch, seq - P), ids),
                "patch_embeds": ((batch, P, cfg.d_model), emb),
                "labels": ((batch, seq - P), ids)}
    return {"tokens": ((batch, seq), ids), "labels": ((batch, seq), ids)}


def make_batch(cfg: ArchConfig, generator: torch.Generator, batch: int,
               seq: int) -> dict:
    """A random batch on ``generator``'s device, drawn entry by entry:
    ids uniform in ``[0, vocab)``, embeddings 0.02 x N(0, 1) rounded to
    their dtype before the product, as the reference makes them."""
    out = {}
    for name, (shape, dtype) in batch_shapes(cfg, batch, seq).items():
        if dtype.is_floating_point:
            out[name] = 0.02 * torch.randn(
                shape, generator=generator,
                device=generator.device).to(dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, shape,
                                      generator=generator, dtype=dtype,
                                      device=generator.device)
    return out
