"""zamba2-style hybrid LM of the port: Mamba2 backbone + one *shared*
transformer block applied periodically (one weight set, reused at every
application), the counterpart of the reference's ``repro.models.hybrid``.

Layout: ``n_macro_blocks`` macro-blocks of ``mamba_per_block`` Mamba2
layers each, the shared attention+MLP block applied after every
macro-block, then ``tail_mamba_layers`` trailing Mamba2 layers.
zamba2-7b: 13 x 6 + shared-attn + 3 = 81 Mamba2 layers, 13 attention
applications (each application has its own KV cache at serve time).  As
in the reference, the shared block consumes the residual stream directly
(no concat-with-embedding input or per-application LoRA deltas).

The reference stacks the Mamba2 parameters over the 81 layers and scans
them; here each layer is a :class:`~repro_torch.models.mamba2.Mamba2` in
a ``ModuleList``.  The shared block is one
:class:`~repro_torch.models.transformer.Block` (global attention, no
window).  Weights keep the reference's orientation and names, matmul
weights and the embedding in bf16 to serve or as f32 masters to train
(``trainable``, as in :mod:`repro_torch.models.transformer`) and the rest
in f32, so :func:`params_from_jax` is a copy and a cast.  Under grad,
``cfg.remat`` recomputes each macro-block (its Mamba2 layers and the
shared block) in backward, the reference's checkpoint unit, whole
whatever ``cfg.remat_policy`` says, as the reference's.  The decode
cache (per-layer conv and SSM state, 13 K/V caches) is updated in place.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import Mamba2, init_mamba2_state
from repro_torch.models.remat import checkpointed
from repro_torch.models.sharding import ModelContext, mesh_scope
from repro_torch.models.transformer import (
    ACT_DTYPE, INIT_SCALE, Block, _host, _numpy, _weight, decayed_names,
    weight_kinds)

#: standard deviation of the conv weights' random init (the reference's)
CONV_INIT_SCALE = 0.1


class HybridLM(nn.Module):
    """zamba2-style hybrid LM.  Weights start at zero: fill them with
    :meth:`init_params` or :func:`params_from_jax`.  ``trainable`` as
    :class:`~repro_torch.models.transformer.TransformerLM`'s."""

    #: parameter-name prefixes of the layers the reference stacks
    STACKED = ("mamba.",)

    def __init__(self, cfg: ArchConfig, device: "torch.device | str",
                 trainable: bool = False):
        super().__init__()
        if cfg.family != "hybrid":
            raise NotImplementedError(f"{cfg.name}: not a hybrid config")
        if (cfg.n_macro_blocks * cfg.mamba_per_block + cfg.tail_mamba_layers
                != cfg.n_layers):
            raise ValueError(f"{cfg.name}: {cfg.n_macro_blocks} x "
                             f"{cfg.mamba_per_block} + {cfg.tail_mamba_layers}"
                             f" != {cfg.n_layers} Mamba2 layers")
        device = torch.device(device)
        self.cfg = cfg
        self.device = device
        mm, norm = weight_kinds(device, trainable)
        self.embed = _weight(cfg.vocab_size, cfg.d_model, **mm)
        self.mamba = nn.ModuleList(Mamba2(cfg, device, trainable)
                                   for _ in range(cfg.n_layers))
        self.shared_attn = Block(cfg, device, trainable)
        self.final_norm = _weight(cfg.d_model, **norm)
        self.lm_head = _weight(cfg.d_model, cfg.vocab_size, **mm)

    def _shared_after(self, i: int) -> bool:
        """Whether the shared block follows Mamba2 layer ``i``."""
        per = self.cfg.mamba_per_block
        return (i + 1) % per == 0 and (i + 1) // per <= self.cfg.n_macro_blocks

    def decayed(self) -> frozenset:
        """Names of the parameters AdamW decays, by the reference's rule in
        its layout (:func:`~repro_torch.models.transformer.decayed_names`):
        every Mamba2 parameter (``A_log``, ``D``, ``dt_bias`` and the norms
        too: the reference stacks them), the shared block's matmul
        weights, the embedding and ``lm_head``; not the shared block's
        norms or ``final_norm``."""
        return decayed_names(self, self.STACKED)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "HybridLM":
        """Random weights on the model's device, the reference's init:
        every matmul weight and the embedding N(0, 0.02^2), the conv
        N(0, 0.1^2) (the tensors of rank 2), drawn in place in their
        storage dtype from ``generator`` (on the same device);
        ``A_log = log(linspace(1, 16, nh))``, ``D = 1``; norms and
        ``dt_bias`` 0."""
        for name, p in self.named_parameters():
            if p.dim() >= 2:
                std = CONV_INIT_SCALE if name.endswith(".conv") else INIT_SCALE
                p.normal_(0.0, std, generator=generator)
            else:
                p.zero_()
        for m in self.mamba:
            m.reset_ssm_params()
        return self

    def _macro(self, x: torch.Tensor, layers: range, positions: torch.Tensor,
               ctx: ModelContext) -> torch.Tensor:
        """Mamba2 layers ``layers``, then the shared block."""
        for i in layers:
            x = x + self.mamba[i](x, ctx)
        return self.shared_attn(x, 0, positions, ctx)

    def forward(self, tokens: "torch.Tensor | Mapping",
                ctx: Optional[ModelContext] = None,
                last_only: bool = False) -> torch.Tensor:
        """tokens (B, S), or a batch dict holding them under ``"tokens"``
        -> logits (B, S, V), or (B, 1, V) when ``last_only``.  S must be a
        multiple of the SSD chunk (256) or shorter than it."""
        ctx = ctx or ModelContext()
        cfg = self.cfg
        if isinstance(tokens, Mapping):
            tokens = tokens["tokens"]
        with mesh_scope(ctx):
            x = L.embed(tokens, self.embed.to(ACT_DTYPE), ctx)
            positions = torch.arange(x.shape[1], dtype=torch.int32,
                                     device=x.device)
            per = cfg.mamba_per_block
            for b in range(cfg.n_macro_blocks):
                x = checkpointed(cfg, self._macro, x,
                                 range(b * per, (b + 1) * per), positions,
                                 ctx)
            for i in range(cfg.n_macro_blocks * per, cfg.n_layers):
                x = x + self.mamba[i](x, ctx)
            if last_only:
                x = x[:, -1:]
            x = L.rmsnorm(x, self.final_norm, ctx=ctx)
            logits = L.unembed(x, self.lm_head, self.cfg.final_logit_softcap)
            return ctx.shard(logits, "batch", "seq", "vocab")

    def prefill(self, tokens: "torch.Tensor | Mapping",
                ctx: Optional[ModelContext] = None) -> torch.Tensor:
        """Full forward returning last-position logits (B, V)."""
        return self.forward(tokens, ctx)[:, -1]

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        """{"mamba": {"conv": (L, B, K-1, d_in+2N) bf16, "ssm": (L, B, nh,
        hd, N) f32}, "k"/"v": (n_macro_blocks, B, max_len, KV, hd)}, the
        reference's layout, zero."""
        cfg = self.cfg
        st = init_mamba2_state(batch, cfg, cfg.d_model, self.device)
        mamba = {k: torch.zeros((cfg.n_layers, *v.shape), dtype=v.dtype,
                                device=self.device) for k, v in st.items()}
        shape = (cfg.n_macro_blocks, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {"mamba": mamba,
                "k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    pos: torch.Tensor, ctx: Optional[ModelContext] = None):
        """One decode step.  tokens: (B,) ids; pos: (B,) current index.
        Returns (logits (B, V), cache); the cache is updated in place (the
        reference returns a new one)."""
        ctx = ctx or ModelContext()
        with mesh_scope(ctx):
            x = L.embed(tokens[:, None], self.embed.to(ACT_DTYPE))
            app = 0
            for i, blk in enumerate(self.mamba):
                st = {k: v[i] for k, v in cache["mamba"].items()}
                x = x + blk(x, ctx, st)
                if self._shared_after(i):
                    x = self.shared_attn.decode(x, cache["k"][app],
                                                cache["v"][app], pos, 0, ctx)
                    app += 1
            x = L.rmsnorm(x[:, 0], self.final_norm, ctx=ctx)
            return (L.unembed(x, self.lm_head, self.cfg.final_logit_softcap),
                    cache)


@torch.no_grad()
def params_from_jax(tree: Mapping, cfg: ArchConfig,
                    device: "torch.device | str" = "cuda",
                    trainable: bool = False) -> HybridLM:
    """A :class:`HybridLM` holding the reference's parameters.

    ``tree`` is the reference's hybrid params pytree as numpy arrays:
    ``embed`` (V, D), ``mamba`` with each entry stacked over the layers
    (L, ...), ``shared_attn``, ``final_norm`` (D,) and ``lm_head`` (D, V).
    To serve, matmul weights and the embedding are rounded to bf16 (round
    to nearest even, the reference's on-the-fly cast); ``trainable``
    copies the reference's f32 masters exactly.  The rest is kept in
    f32."""
    model = HybridLM(cfg, device, trainable)
    for key, mods in (("mamba", list(model.mamba)),
                      ("shared_attn", [model.shared_attn])):
        want = {name for name, _ in mods[0].named_parameters()}
        if set(tree[key]) != want:
            raise KeyError(f"params_from_jax: {key} parameters "
                           f"{sorted(tree[key])} != {sorted(want)}")
        for name, arr in tree[key].items():
            arr = _host(arr)
            for i, m in enumerate(mods):
                getattr(m, name).copy_(arr[i] if key == "mamba" else arr)
    model.embed.copy_(_host(tree["embed"]))
    model.final_norm.copy_(_host(tree["final_norm"]))
    model.lm_head.copy_(_host(tree["lm_head"]))
    return model


def params_to_numpy(model: HybridLM) -> dict:
    """The inverse of :func:`params_from_jax`: the model's weights as
    float32 numpy arrays in the reference's tree, each Mamba2 parameter
    stacked on the layer axis."""
    return {"embed": _numpy(model.embed),
            "mamba": {name: np.stack([_numpy(getattr(m, name))
                                      for m in model.mamba])
                      for name, _ in model.mamba[0].named_parameters()},
            "shared_attn": {name: _numpy(p) for name, p
                            in model.shared_attn.named_parameters()},
            "final_norm": _numpy(model.final_norm),
            "lm_head": _numpy(model.lm_head)}
