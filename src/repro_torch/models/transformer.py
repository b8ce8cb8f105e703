"""Decoder-only transformer LM of the dense family, the port's counterpart
of the reference's ``repro.models.transformer``.

The reference stacks parameters along a leading layer axis and scans
the layers; here each layer is a :class:`Block` in a ``ModuleList`` and
the layers run in a Python loop.  gemma2's local/global alternation
(the reference's ``_pair``) is a static window per layer: even layers
``cfg.window``, odd layers 0 (global).

Activations are bf16, as the reference hard-codes (``_input_embeds``).
Matmul weights are stored in bf16 and norm weights in f32: the reference
keeps f32 master weights and casts each matmul weight to the activation
dtype on the fly (``.astype(x.dtype)``), so storing the bf16 cast is the
same arithmetic.  Weights keep the reference orientation (``x @ w``,
``(in, out)``), so carrying them over (:func:`params_from_jax`) is a copy
and a cast.  This slice serves: no parameter requires a gradient.

Under ``attention_impl="pallas"`` every norm runs the fused RMSNorm
kernel and decode the flash decode kernel, beside flash attention.  The
hybrid family is :mod:`repro_torch.models.hybrid` (its shared block is a
:class:`Block`); the MoE family (``models/moe.py``), the audio and VLM
frontends and the xLSTM family are later slices of the port.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.sharding import ModelContext

#: standard deviation of the random init, the reference's ``dense_init``
INIT_SCALE = 0.02


def _weight(*shape: int, device, dtype=torch.bfloat16) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Block(nn.Module):
    """One pre-norm transformer block (the reference's
    ``transformer_block``); parameter names are the reference's keys."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        D, H, KV, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.hd, cfg.d_ff)
        self.cfg = cfg
        f32 = torch.float32
        self.attn_norm = _weight(D, device=device, dtype=f32)
        self.wq = _weight(D, H * hd, device=device)
        self.wk = _weight(D, KV * hd, device=device)
        self.wv = _weight(D, KV * hd, device=device)
        self.wo = _weight(H * hd, D, device=device)
        self.mlp_norm = _weight(D, device=device, dtype=f32)
        self.wi = _weight(D, 2 * ff, device=device)
        self.wo_mlp = _weight(ff, D, device=device)
        if cfg.post_norms:
            self.post_attn_norm = _weight(D, device=device, dtype=f32)
            self.post_mlp_norm = _weight(D, device=device, dtype=f32)

    def _attn_proj(self, x: torch.Tensor, positions: torch.Tensor):
        B, S, _ = x.shape
        cfg = self.cfg
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = (x @ self.wq).reshape(B, S, H, hd)
        k = (x @ self.wk).reshape(B, S, KV, hd)
        v = (x @ self.wv).reshape(B, S, KV, hd)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _mlp(self, x: torch.Tensor, ctx: ModelContext) -> torch.Tensor:
        h = L.rmsnorm(x, self.mlp_norm, ctx=ctx)
        m = L.swiglu(h, self.wi, self.wo_mlp)
        if self.cfg.post_norms:
            m = L.rmsnorm(m, self.post_mlp_norm, ctx=ctx)
        return x + m

    def forward(self, x: torch.Tensor, window: int, positions: torch.Tensor,
                ctx: ModelContext) -> torch.Tensor:
        """x: (B, S, D); ``window`` static (0 = global)."""
        B, S, _ = x.shape
        cfg = self.cfg
        h = L.rmsnorm(x, self.attn_norm, ctx=ctx)
        q, k, v = self._attn_proj(h, positions)
        a = L.attention(q, k, v, positions, positions, causal=True,
                        window=window, logit_cap=cfg.attn_logit_softcap,
                        ctx=ctx)
        a = a.reshape(B, S, cfg.n_heads * cfg.hd) @ self.wo
        if cfg.post_norms:
            a = L.rmsnorm(a, self.post_attn_norm, ctx=ctx)
        return self._mlp(x + a, ctx)

    def decode(self, x: torch.Tensor, k_l: torch.Tensor, v_l: torch.Tensor,
               pos: torch.Tensor, window: int, ctx: ModelContext
               ) -> torch.Tensor:
        """One token: x (B, 1, D); writes its K/V into this layer's cache
        ``k_l``/``v_l`` (B, T, KV, hd) at ``pos`` in place."""
        B = x.shape[0]
        cfg = self.cfg
        h = L.rmsnorm(x, self.attn_norm, ctx=ctx)
        q, k, v = self._attn_proj(h, pos[:, None])
        _cache_write(k_l, k[:, 0], pos)
        _cache_write(v_l, v[:, 0], pos)
        a = L.decode_attention(q[:, 0], k_l, v_l, pos, window=window,
                               logit_cap=cfg.attn_logit_softcap, ctx=ctx)
        a = a.reshape(B, cfg.n_heads * cfg.hd) @ self.wo
        if cfg.post_norms:
            a = L.rmsnorm(a, self.post_attn_norm, ctx=ctx)
        return self._mlp(x + a[:, None], ctx)


def _cache_write(cache_l: torch.Tensor, kv_t: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """cache_l: (B, T, KV, hd); kv_t: (B, KV, hd); pos: (B,).  Writes row b
    at ``pos[b]`` in place; a position outside [0, T) is dropped (the
    reference's ``mode="drop"``), without a host sync."""
    B, T = cache_l.shape[:2]
    rows = torch.arange(B, device=cache_l.device)
    ok = ((pos >= 0) & (pos < T))[:, None, None]
    idx = pos.long().clamp(0, T - 1)
    cache_l[rows, idx] = torch.where(ok, kv_t.to(cache_l.dtype),
                                     cache_l[rows, idx])


class TransformerLM(nn.Module):
    """Dense decoder-only LM.  Weights start at zero: fill them with
    :meth:`init_params` or :func:`params_from_jax`."""

    def __init__(self, cfg: ArchConfig, device: "torch.device | str"):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not a dense "
                "transformer (the port serves the dense and hybrid "
                "families; MoE, the audio/VLM frontends and xLSTM are "
                "later slices)")
        if cfg.attn_pattern == "local_global" and cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: local_global needs an even layer "
                             f"count, got {cfg.n_layers}")
        device = torch.device(device)
        self.cfg = cfg
        self.device = device
        self.embed = _weight(cfg.vocab_size, cfg.d_model, device=device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _weight(cfg.d_model, device=device,
                                  dtype=torch.float32)
        if not cfg.tie_embeddings:
            self.lm_head = _weight(cfg.d_model, cfg.vocab_size, device=device)
        #: static attention window of each layer (0 = global)
        self.windows = tuple(
            cfg.window if cfg.attn_pattern == "local_global" and i % 2 == 0
            else 0 for i in range(cfg.n_layers))

    def head(self) -> torch.Tensor:
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "TransformerLM":
        """Random weights on the model's device: every matmul weight and
        the embedding N(0, 0.02^2), drawn in place in bf16 from
        ``generator`` (on the same device); norm weights 0, i.e. a scale
        of 1, as the reference's init."""
        for p in self.parameters():
            if p.dtype == torch.bfloat16:
                p.normal_(0.0, INIT_SCALE, generator=generator)
            else:
                p.zero_()
        return self

    def forward(self, tokens: torch.Tensor, ctx: Optional[ModelContext] = None,
                last_only: bool = False) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V), or (B, 1, V) when
        ``last_only`` (prefill: the vocab head for the last position
        only).  Positions are 0..S-1, made once as int32."""
        ctx = ctx or ModelContext()
        x = L.embed(tokens, self.embed)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        for blk, window in zip(self.blocks, self.windows):
            x = blk(x, window, positions, ctx)
        if last_only:
            x = x[:, -1:]
        x = L.rmsnorm(x, self.final_norm, ctx=ctx)
        return L.unembed(x, self.head(), self.cfg.final_logit_softcap)

    def prefill(self, tokens: torch.Tensor,
                ctx: Optional[ModelContext] = None) -> torch.Tensor:
        """Full forward returning last-position logits (B, V)."""
        return self.forward(tokens, ctx)[:, -1]

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    pos: torch.Tensor, ctx: Optional[ModelContext] = None):
        """One decode step.  tokens: (B,) ids; pos: (B,) current index.
        Returns (logits (B, V), cache); the cache is updated in place (the
        reference returns a new one)."""
        ctx = ctx or ModelContext()
        x = L.embed(tokens[:, None], self.embed)
        for i, (blk, window) in enumerate(zip(self.blocks, self.windows)):
            x = blk.decode(x, cache["k"][i], cache["v"][i], pos, window, ctx)
        x = L.rmsnorm(x[:, 0], self.final_norm, ctx=ctx)
        return L.unembed(x, self.head(), self.cfg.final_logit_softcap), cache


@torch.no_grad()
def params_from_jax(tree: Mapping, cfg: ArchConfig,
                    device: "torch.device | str" = "cuda") -> TransformerLM:
    """A :class:`TransformerLM` holding the reference's parameters.

    ``tree`` is the reference's params pytree as numpy arrays:
    ``embed`` (V, D), ``blocks`` with each entry stacked (L, ...),
    ``final_norm`` (D,) and ``lm_head`` (D, V) unless tied.  Matmul
    weights are rounded to bf16 (round to nearest even, the reference's
    on-the-fly cast), norm weights kept in f32."""
    model = TransformerLM(cfg, device)
    blocks = tree["blocks"]
    want = {name for name, _ in model.blocks[0].named_parameters()}
    if set(blocks) != want:
        raise KeyError(f"params_from_jax: block parameters {sorted(blocks)} "
                       f"!= {sorted(want)}")
    for name, stacked in blocks.items():
        stacked = _host(stacked)
        for i, blk in enumerate(model.blocks):
            getattr(blk, name).copy_(stacked[i])
    model.embed.copy_(_host(tree["embed"]))
    model.final_norm.copy_(_host(tree["final_norm"]))
    if not cfg.tie_embeddings:
        model.lm_head.copy_(_host(tree["lm_head"]))
    return model


def _host(a) -> torch.Tensor:
    """A CPU tensor holding a (writable) copy of the array ``a``."""
    return torch.from_numpy(np.array(a))
