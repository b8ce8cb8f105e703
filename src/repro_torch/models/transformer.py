"""Decoder-only transformer LM of the port, covering the dense, MoE,
audio-backbone and VLM-backbone families: the counterpart of the
reference's ``repro.models.transformer``.

The reference stacks parameters along a leading layer axis and scans
the layers; here each layer is a :class:`Block` in a ``ModuleList`` and
the layers run in a Python loop.  gemma2's local/global alternation
(the reference's ``_pair``) is a static window per layer: even layers
``cfg.window``, odd layers 0 (global).  An MoE config's block holds the
reference's expert weights (``router``, ``wi_e``, ``wo_e`` and, with
shared experts, ``wi_s``, ``wo_s``) in place of ``wi``/``wo_mlp`` and
runs :func:`repro_torch.models.moe.moe_block`.

``forward`` takes the token ids (B, S) or one of the reference's batch
forms (the modality frontends are stubs, as there):

  {"tokens": (B, S) int}                            LM
  {"embeds": (B, S, D)}                             audio (musicgen)
  {"tokens": (B, S_text), "patch_embeds": (B, P, D)}  vlm (pixtral)

Decode steps take token ids for every family, as in the reference.

Activations are bf16, as the reference hard-codes (``_input_embeds``).
The reference keeps f32 master weights and casts each matmul weight and
the embedding table to the activation dtype where it is used
(``.astype(x.dtype)``); the port does the same (``w.to(x.dtype)``).  For
serving (the default), the matmul weights are stored in bf16 and frozen:
the cast is then a no-op and storing the bf16 cast is the same
arithmetic.  The MoE router, which the reference runs in float32 on its
f32 weights, is stored in f32 like the norms.  For training,
``trainable=True`` gives every weight as an f32 master that requires
grad, and the gradient flows through the cast into f32.  Norm weights
are f32 either way.
Weights keep the reference orientation (``x @ w``, ``(in, out)``), so
carrying them over (:func:`params_from_jax`, and back,
:func:`params_to_numpy`) is a copy and a cast.

Under grad, ``cfg.remat`` recomputes each of the reference's checkpoint
units in backward (:func:`repro_torch.models.remat.checkpointed`): each
layer, or each gemma2 local/global pair, under ``cfg.remat_policy``
(``"full"``, or ``"dots"``: the products with no batch dimensions kept).

Under ``attention_impl="pallas"`` every norm runs the fused RMSNorm
kernel and decode the flash decode kernel, beside flash attention.  The
hybrid family is :mod:`repro_torch.models.hybrid` (its shared block is a
:class:`Block`); the xLSTM family is :mod:`repro_torch.models.xlstm`.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig
from repro_torch.dtensor import (
    is_dtensor, local_span, matmul, on_mesh, whole)
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_block
from repro_torch.models.remat import checkpointed, output_unread
from repro_torch.models.sharding import ModelContext, mesh_scope

#: standard deviation of the random init, the reference's ``dense_init``
INIT_SCALE = 0.02
#: activation dtype, which the reference hard-codes
ACT_DTYPE = torch.bfloat16
#: the families this module builds (the reference's zoo's)
TRANSFORMER_FAMILIES = ("dense", "moe", "audio", "vlm")


def _weight(*shape: int, device, dtype, trainable: bool) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=trainable)


def weight_kinds(device, trainable: bool) -> tuple:
    """:func:`_weight`'s keywords for the matmul weights and the embedding
    (bf16 and frozen to serve, f32 masters that require grad to train) and
    for the norms and the SSM vectors (f32 either way)."""
    mm = dict(device=device, trainable=trainable,
              dtype=torch.float32 if trainable else torch.bfloat16)
    return mm, dict(mm, dtype=torch.float32)


def decayed_names(model: nn.Module, stacked: tuple) -> frozenset:
    """Names of ``model``'s parameters that the reference's AdamW decays:
    its leaves of rank >= 2, where each parameter whose name starts with
    one of ``stacked`` is one layer of a leaf stacked on a leading layer
    axis (one rank more than the port's tensor)."""
    return frozenset(n for n, p in model.named_parameters()
                     if p.dim() + n.startswith(stacked) >= 2)


class Block(nn.Module):
    """One pre-norm transformer block (the reference's
    ``transformer_block``); parameter names are the reference's keys."""

    def __init__(self, cfg: ArchConfig, device: torch.device,
                 trainable: bool = False):
        super().__init__()
        D, H, KV, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.hd, cfg.d_ff)
        self.cfg = cfg
        mm, norm = weight_kinds(device, trainable)
        self.attn_norm = _weight(D, **norm)
        self.wq = _weight(D, H * hd, **mm)
        self.wk = _weight(D, KV * hd, **mm)
        self.wv = _weight(D, KV * hd, **mm)
        self.wo = _weight(H * hd, D, **mm)
        self.mlp_norm = _weight(D, **norm)
        if cfg.is_moe:
            E, ns = cfg.n_experts, cfg.n_shared_experts
            self.router = _weight(D, E, **norm)
            self.wi_e = _weight(E, D, 2 * ff, **mm)
            self.wo_e = _weight(E, ff, D, **mm)
            if ns > 0:
                self.wi_s = _weight(D, 2 * ff * ns, **mm)
                self.wo_s = _weight(ff * ns, D, **mm)
        else:
            self.wi = _weight(D, 2 * ff, **mm)
            self.wo_mlp = _weight(ff, D, **mm)
        if cfg.post_norms:
            self.post_attn_norm = _weight(D, **norm)
            self.post_mlp_norm = _weight(D, **norm)

    def _attn_proj(self, x: torch.Tensor, positions: torch.Tensor,
                   ctx: Optional[ModelContext] = None):
        B, S, _ = x.shape
        cfg = self.cfg
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = matmul(x, self.wq.to(x.dtype)).reshape(B, S, H, hd)
        k = matmul(x, self.wk.to(x.dtype)).reshape(B, S, KV, hd)
        v = matmul(x, self.wv.to(x.dtype)).reshape(B, S, KV, hd)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        if ctx is not None:
            q = ctx.shard(q, "batch", "attn_seq", "heads", "head_dim")
        return q, k, v

    def moe_params(self) -> dict:
        """The MoE weights under the names of the reference's ``moe``
        module (its ``_moe_params``)."""
        mp = {"router": self.router, "wi": self.wi_e, "wo": self.wo_e}
        if self.cfg.n_shared_experts > 0:
            mp.update(wi_s=self.wi_s, wo_s=self.wo_s)
        return mp

    def _mlp(self, x: torch.Tensor, ctx: ModelContext,
             unit_end: bool = False) -> torch.Tensor:
        """x plus the MLP's output.  ``unit_end``: this block closes its
        remat unit, so without a post-MLP norm only the residual add reads
        the MLP's output (``remat.output_unread``)."""
        cfg = self.cfg
        h = L.rmsnorm(x, self.mlp_norm, ctx=ctx)
        h = ctx.shard(h, "batch", "seq", "d_model")
        with output_unread(unit_end and not cfg.post_norms):
            if cfg.is_moe:
                m = moe_block(h, self.moe_params(), k=cfg.experts_per_token,
                              n_experts=cfg.n_experts,
                              n_shared=cfg.n_shared_experts,
                              capacity_factor=cfg.capacity_factor, ctx=ctx)
            else:
                m = L.swiglu(h, self.wi, self.wo_mlp, ctx)
        # placed before the post-norm: its statistics need the sum
        m = ctx.shard(m, "batch", "seq", "d_model")
        if cfg.post_norms:
            m = L.rmsnorm(m, self.post_mlp_norm, ctx=ctx)
        return x + m

    def attend(self, x: torch.Tensor, window: int, positions: torch.Tensor,
               ctx: ModelContext) -> torch.Tensor:
        """The block's attention half: x plus its attention output."""
        B, S, _ = x.shape
        cfg = self.cfg
        h = L.rmsnorm(x, self.attn_norm, ctx=ctx)
        q, k, v = self._attn_proj(h, positions, ctx)
        a = L.attention(q, k, v, positions, positions, causal=True,
                        window=window, logit_cap=cfg.attn_logit_softcap,
                        ctx=ctx)
        a = matmul(a.reshape(B, S, cfg.n_heads * cfg.hd),
                   self.wo.to(x.dtype))
        a = ctx.shard(a, "batch", "seq", "d_model")
        if cfg.post_norms:
            a = L.rmsnorm(a, self.post_attn_norm, ctx=ctx)
        return x + a

    def forward(self, x: torch.Tensor, window: int, positions: torch.Tensor,
                ctx: ModelContext, unit_end: bool = False) -> torch.Tensor:
        """x: (B, S, D); ``window`` static (0 = global); ``unit_end`` as
        :meth:`_mlp`'s."""
        return self._mlp(self.attend(x, window, positions, ctx), ctx,
                         unit_end)

    def decode_attend(self, x: torch.Tensor, k_l: torch.Tensor,
                      v_l: torch.Tensor, pos: torch.Tensor, window: int,
                      ctx: ModelContext) -> torch.Tensor:
        """The attention half of :meth:`decode`: x plus its attention
        output; writes the token's K/V into the cache."""
        B = x.shape[0]
        cfg = self.cfg
        h = L.rmsnorm(x, self.attn_norm, ctx=ctx)
        q, k, v = self._attn_proj(h, pos[:, None], ctx)
        _cache_write(k_l, k[:, 0], pos)
        _cache_write(v_l, v[:, 0], pos)
        k_l = ctx.shard(k_l, "batch", "kv_seq", "kv_heads", "head_dim")
        v_l = ctx.shard(v_l, "batch", "kv_seq", "kv_heads", "head_dim")
        a = L.decode_attention(q[:, 0], k_l, v_l, pos, window=window,
                               logit_cap=cfg.attn_logit_softcap, ctx=ctx)
        a = matmul(a.reshape(B, cfg.n_heads * cfg.hd), self.wo.to(x.dtype))
        if cfg.post_norms:
            a = L.rmsnorm(ctx.shard(a, "batch", "d_model"),
                          self.post_attn_norm, ctx=ctx)
        return x + a[:, None]

    def decode(self, x: torch.Tensor, k_l: torch.Tensor, v_l: torch.Tensor,
               pos: torch.Tensor, window: int, ctx: ModelContext
               ) -> torch.Tensor:
        """One token: x (B, 1, D); writes its K/V into this layer's cache
        ``k_l``/``v_l`` (B, T, KV, hd) at ``pos`` in place."""
        return self._mlp(self.decode_attend(x, k_l, v_l, pos, window, ctx),
                         ctx)


def _cache_write(cache_l: torch.Tensor, kv_t: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """cache_l: (B, T, KV, hd); kv_t: (B, KV, hd); pos: (B,).  Writes row b
    at ``pos[b]`` in place; a position outside [0, T) is dropped (the
    reference's ``mode="drop"``), without a host sync.

    On a cache placed on a mesh (a DTensor) each rank writes its own
    shard: the rows of its requests, at the positions that fall in its
    slice of the sequence (the reference's scatter "stays local under a
    seq-sharded cache")."""
    if is_dtensor(cache_l):
        mesh = cache_l.device_mesh
        t0, _ = local_span(cache_l, 1)
        pc = cache_l.placements
        pb = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pc)

        def local(c, kv, p):
            _write_rows(c, kv, p, t0)
            return c
        local_map(local, out_placements=list(pc), in_placements=(pc, pb, pb),
                  device_mesh=mesh, redistribute_inputs=True)(
            cache_l, on_mesh(kv_t, mesh), on_mesh(pos, mesh))
        return
    _write_rows(cache_l, whole(kv_t), whole(pos), 0)


def _write_rows(cache_l: torch.Tensor, kv_t: torch.Tensor, pos: torch.Tensor,
                t0: int) -> None:
    """:func:`_cache_write` on a slice of the sequence starting at ``t0``."""
    B, T = cache_l.shape[:2]
    rows = torch.arange(B, device=cache_l.device)
    ok = ((pos >= t0) & (pos < t0 + T))[:, None, None]
    idx = (pos.long() - t0).clamp(0, T - 1)
    cache_l[rows, idx] = torch.where(ok, kv_t.to(cache_l.dtype),
                                     cache_l[rows, idx])


class TransformerLM(nn.Module):
    """Decoder-only LM of the dense, MoE, audio and VLM families (the
    last two on their stub frontends).  Weights start at zero: fill them
    with
    :meth:`init_params` or :func:`params_from_jax`.  ``trainable`` gives
    f32 masters that require grad (to train); by default the matmul
    weights and the embedding are stored in bf16 and frozen (to serve)."""

    #: parameter-name prefixes of the layers the reference stacks
    STACKED = ("blocks.",)

    def __init__(self, cfg: ArchConfig, device: "torch.device | str",
                 trainable: bool = False):
        super().__init__()
        if cfg.family not in TRANSFORMER_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not a "
                f"transformer LM ({TRANSFORMER_FAMILIES}); the hybrid family "
                "is HybridLM, and xLSTM ('ssm') is XLSTMLM")
        if cfg.attn_pattern == "local_global" and cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: local_global needs an even layer "
                             f"count, got {cfg.n_layers}")
        device = torch.device(device)
        self.cfg = cfg
        self.device = device
        mm, norm = weight_kinds(device, trainable)
        self.embed = _weight(cfg.vocab_size, cfg.d_model, **mm)
        self.blocks = nn.ModuleList(Block(cfg, device, trainable)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _weight(cfg.d_model, **norm)
        if not cfg.tie_embeddings:
            self.lm_head = _weight(cfg.d_model, cfg.vocab_size, **mm)
        #: static attention window of each layer (0 = global)
        self.windows = tuple(
            cfg.window if cfg.attn_pattern == "local_global" and i % 2 == 0
            else 0 for i in range(cfg.n_layers))

    def head(self) -> torch.Tensor:
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head

    def decayed(self) -> frozenset:
        """Names of the parameters AdamW decays, by the reference's rule in
        its layout (:func:`decayed_names`): every block parameter, the
        embedding and ``lm_head``; not ``final_norm``."""
        return decayed_names(self, self.STACKED)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "TransformerLM":
        """Random weights on the model's device: every matmul weight, the
        MoE router and experts and the embedding (the tensors of rank 2 or
        more) N(0, 0.02^2), drawn in place in their storage dtype from
        ``generator`` (on the same device); norm weights 0, i.e. a scale of
        1, as the reference's init."""
        for p in self.parameters():
            if p.dim() >= 2:
                p.normal_(0.0, INIT_SCALE, generator=generator)
            else:
                p.zero_()
        return self

    def _unit(self, x: torch.Tensor, layers: range, positions: torch.Tensor,
              ctx: ModelContext) -> torch.Tensor:
        for i in layers:
            x = self.blocks[i](x, self.windows[i], positions, ctx,
                               unit_end=i == layers[-1])
        return x

    def input_embeds(self, batch: Mapping,
                     ctx: Optional[ModelContext] = None) -> torch.Tensor:
        """The residual stream's input (B, S, D), the reference's
        ``_input_embeds``: ``embeds`` as given (audio stub), or the
        token embeddings in the activation dtype with ``patch_embeds``
        cast to it and put before them (vlm stub)."""
        if "embeds" in batch:
            return batch["embeds"]
        x = L.embed(batch["tokens"], self.embed.to(ACT_DTYPE), ctx)
        if "patch_embeds" in batch:
            x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
        return x

    def forward(self, batch: "torch.Tensor | Mapping",
                ctx: Optional[ModelContext] = None,
                last_only: bool = False) -> torch.Tensor:
        """batch: token ids (B, S) or a batch dict (see the module
        docstring) -> logits (B, S, V), or (B, 1, V) when ``last_only``
        (prefill: the vocab head for the last position only).  Positions
        are 0..S-1, made once as int32.  The layers run in the
        reference's checkpoint units: one layer, or a gemma2 local/global
        pair."""
        ctx = ctx or ModelContext()
        with mesh_scope(ctx):
            x = self.input_embeds(batch if isinstance(batch, Mapping)
                                  else {"tokens": batch}, ctx)
            positions = torch.arange(x.shape[1], dtype=torch.int32,
                                     device=x.device)
            per = 2 if self.cfg.attn_pattern == "local_global" else 1
            for i in range(0, self.cfg.n_layers, per):
                x = checkpointed(self.cfg, self._unit, x, range(i, i + per),
                                 positions, ctx, policy=self.cfg.remat_policy)
            if last_only:
                x = x[:, -1:]
            x = L.rmsnorm(x, self.final_norm, ctx=ctx)
            logits = L.unembed(x, self.head(), self.cfg.final_logit_softcap)
            return ctx.shard(logits, "batch", "seq", "vocab")

    def prefill(self, batch: "torch.Tensor | Mapping",
                ctx: Optional[ModelContext] = None) -> torch.Tensor:
        """Full forward returning last-position logits (B, V)."""
        return self.forward(batch, ctx)[:, -1]

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
        with mesh_scope(ctx):
            x = L.embed(tokens[:, None], self.embed.to(ACT_DTYPE))
            for i, (blk, window) in enumerate(zip(self.blocks, self.windows)):
                x = blk.decode(x, cache["k"][i], cache["v"][i], pos, window,
                               ctx)
            x = L.rmsnorm(x[:, 0], self.final_norm, ctx=ctx)
            return (L.unembed(x, self.head(), self.cfg.final_logit_softcap),
                    cache)


@torch.no_grad()
def params_from_jax(tree: Mapping, cfg: ArchConfig,
                    device: "torch.device | str" = "cuda",
                    trainable: bool = False) -> TransformerLM:
    """A :class:`TransformerLM` holding the reference's parameters.

    ``tree`` is the reference's params pytree as numpy arrays:
    ``embed`` (V, D), ``blocks`` with each entry stacked (L, ...),
    ``final_norm`` (D,) and ``lm_head`` (D, V) unless tied.  To serve,
    matmul weights and the embedding are rounded to bf16 (round to
    nearest even, the reference's on-the-fly cast); ``trainable`` copies
    the reference's f32 masters exactly.  Norm weights and the MoE
    router are kept in f32."""
    model = TransformerLM(cfg, device, trainable)
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


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy of ``t`` (exact for f32 weights)."""
    return t.detach().float().cpu().numpy()


def params_to_numpy(model: TransformerLM) -> dict:
    """The inverse of :func:`params_from_jax`: the model's weights as
    float32 numpy arrays in the reference's tree, each block parameter
    stacked on the layer axis."""
    tree = {"embed": _numpy(model.embed),
            "blocks": {name: np.stack([_numpy(getattr(b, name))
                                       for b in model.blocks])
                       for name, _ in model.blocks[0].named_parameters()},
            "final_norm": _numpy(model.final_norm)}
    if not model.cfg.tie_embeddings:
        tree["lm_head"] = _numpy(model.lm_head)
    return tree
