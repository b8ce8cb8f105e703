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
model or its config here, and so are its logical-axis specs
(``param_specs``, ``cache_specs``, ``batch_logical_axes``), keyed like
the port's tensors.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.layers import cross_entropy
from repro_torch.models.sharding import ModelContext, mesh_scope
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.xlstm import XLSTMLM, slstm_flags

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


def loss(model: LM, batch: dict, ctx: Optional[ModelContext] = None,
         params: Optional[dict] = None) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` (one of
    :func:`batch_shapes`'s forms with its "labels", optional
    "loss_mask"), the reference's ``Model.loss``: for the vlm family only
    on the text positions (the image prefix is conditioning).
    ``params`` (by name) stand in for the model's own parameters in the
    forward (``torch.func.functional_call``)."""
    logits = (model(batch, ctx) if params is None else
              torch.func.functional_call(model, params, (batch, ctx)))
    if model.cfg.family == "vlm":
        logits = logits[:, model.cfg.num_patches:]
    with mesh_scope(ctx):
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


# --------------------------------------------------------------------------
# logical-axis specs (the reference's ``lm_param_specs``,
# ``hybrid_param_specs``, ``xlstm_param_specs`` and cache specs)
# --------------------------------------------------------------------------


def _lm_specs(cfg: ArchConfig) -> dict:
    """The reference's ``transformer.lm_param_specs`` without its stacked
    ``"layers"`` dim (rule ``None``): the port keeps each layer apart."""
    blocks = {
        "attn_norm": ("d_model",),
        "wq": ("d_model", "heads"),
        "wk": ("d_model", "kv_heads"),
        "wv": ("d_model", "kv_heads"),
        "wo": ("heads", "d_model"),
        "mlp_norm": ("d_model",),
    }
    if cfg.is_moe:
        blocks["router"] = ("d_model", None)
        blocks["wi_e"] = ("experts", "d_model", None)
        blocks["wo_e"] = ("experts", None, "d_model")
        if cfg.n_shared_experts > 0:
            blocks["wi_s"] = ("d_model", "d_ff")
            blocks["wo_s"] = ("d_ff", "d_model")
    else:
        blocks["wi"] = ("d_model", "d_ff")
        blocks["wo_mlp"] = ("d_ff", "d_model")
    if cfg.post_norms:
        blocks["post_attn_norm"] = ("d_model",)
        blocks["post_mlp_norm"] = ("d_model",)
    specs = {"embed": ("vocab", "d_model"), "blocks": blocks,
             "final_norm": ("d_model",)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("d_model", "vocab")
    return specs


def _hybrid_specs(cfg: ArchConfig) -> dict:
    """The reference's ``hybrid.hybrid_param_specs`` without the Mamba2
    stack's ``"layers"`` dim."""
    return {
        "embed": ("vocab", "d_model"),
        "mamba": {
            "norm": ("d_model",),
            "in_proj": ("d_model", None),
            "conv": ("conv", None),
            "A_log": ("ssm_heads",),
            "D": ("ssm_heads",),
            "dt_bias": ("ssm_heads",),
            "out_norm": (None,),
            "out_proj": (None, "d_model"),
        },
        "shared_attn": {
            "attn_norm": ("d_model",),
            "wq": ("d_model", "heads"),
            "wk": ("d_model", "kv_heads"),
            "wv": ("d_model", "kv_heads"),
            "wo": ("heads", "d_model"),
            "mlp_norm": ("d_model",),
            "wi": ("d_model", "d_ff"),
            "wo_mlp": ("d_ff", "d_model"),
        },
        "final_norm": ("d_model",),
        "lm_head": ("d_model", "vocab"),
    }


def _xlstm_specs(cfg: ArchConfig) -> dict:
    """The reference's ``xlstm.xlstm_param_specs`` without the block
    stack's ``"layers"`` dim."""
    return {
        "embed": ("vocab", "d_model"),
        "blocks": {
            "norm": ("d_model",),
            "up_proj": ("d_model", None),
            "qkv": ("d_model", "d_ff"),
            "gates": ("d_model", None),
            "gate_bias": (None,),
            "r_diag": (None, "d_model"),
            "o_proj": ("d_model", "d_ff"),
            "out_norm": ("d_model",),
            "down_proj": ("d_model", None),
        },
        "final_norm": ("d_model",),
        "lm_head": ("d_model", "vocab"),
    }


def spec_table(cfg: ArchConfig) -> dict:
    """The family's per-leaf specs: top-level names, and for each stack
    of layers (or the shared block) a dict by leaf name."""
    if cfg.family == "hybrid":
        return _hybrid_specs(cfg)
    if cfg.family == "ssm":
        return _xlstm_specs(cfg)
    return _lm_specs(cfg)


def param_specs(model: LM) -> dict:
    """Logical-axis names of each of ``model``'s parameters, keyed by its
    ``named_parameters()`` name (``blocks.3.wq``, ``mamba.7.in_proj``,
    ``shared_attn.wi``, ``embed``): the reference's spec of the same
    leaf, one layer of it."""
    table = spec_table(model.cfg)
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        out[name] = (table[parts[0]] if len(parts) == 1
                     else table[parts[0]][parts[-1]])
    return out


def cache_specs(cfg: ArchConfig):
    """Logical-axis names of the decode cache, in its layout: the
    reference's ``transformer.cache_specs``, ``hybrid_cache_specs`` or
    ``xlstm_cache_specs``."""
    kv = (None, "batch", "kv_seq", "kv_heads", "head_dim")
    if cfg.family == "hybrid":
        return {"mamba": {"conv": (None, "batch", None, None),
                          "ssm": (None, "batch", "ssm_heads", None, None)},
                "k": kv, "v": kv}
    if cfg.family == "ssm":
        return [(("batch", None),) * 3 if f else
                (("batch", "ssm_heads", None, "xlstm_hd"),
                 ("batch", "ssm_heads", None))
                for f in slstm_flags(cfg)]
    return {"k": kv, "v": kv}


def batch_logical_axes(cfg: ArchConfig) -> dict:
    """Logical-axis names of each entry of a batch of ``cfg``'s family,
    the reference's ``Model.batch_logical_axes``."""
    if cfg.family == "audio":
        return {"embeds": ("batch", "seq", "d_model"),
                "labels": ("batch", "seq")}
    if cfg.family == "vlm":
        return {"tokens": ("batch", "seq"),
                "patch_embeds": ("batch", "seq", "d_model"),
                "labels": ("batch", "seq")}
    return {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
