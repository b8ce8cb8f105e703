"""Architecture configuration schema: the port's copy of the reference's
``repro.configs.base``, every field and property kept.

One frozen dataclass describes every model family (dense / MoE /
hybrid-SSM / xLSTM / audio / VLM); the port builds every one.  Each
architecture's module exports ``CONFIG`` (full size) and
``SMOKE_CONFIG`` (reduced same-family config for CPU tests).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // n_heads
    # --- attention variants ---
    attn_pattern: str = "global"     # "global" | "local_global" (gemma2)
    window: int = 4096               # sliding window for local layers
    attn_logit_softcap: float = 0.0  # gemma2: 50.0
    final_logit_softcap: float = 0.0 # gemma2: 30.0
    post_norms: bool = False         # gemma2: post-attn/post-ffn RMSNorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # --- SSM / hybrid (zamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    mamba_per_block: int = 0         # zamba2: mamba layers per macro-block
    n_macro_blocks: int = 0          # zamba2: shared-attn applications
    tail_mamba_layers: int = 0
    # --- xLSTM ---
    slstm_every: int = 0             # every k-th block is sLSTM (0 = none)
    # --- modality frontends (stubs; see DESIGN.md) ---
    frontend: str = "none"           # none | audio_stub | vision_stub
    num_patches: int = 0             # vlm: image-prefix length
    # --- training / memory knobs (the reference's; unused when serving) ---
    microbatches: int = 1
    remat: bool = True
    remat_policy: str = "full"       # full | dots
    scan_layers: bool = True
    dtype: str = "bfloat16"
    # --- implementation switches ---
    attention_impl: str = "auto"     # auto | reference | blocked | pallas
    moe_impl: str = "auto"           # auto | dense | ep
    # --- serving ---
    max_cache_len: int = 0           # set by shape at serve time

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Total parameters (for 6ND model-FLOPs accounting)."""
        return sum(x for x, _ in self._param_terms())

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed-to experts)."""
        return sum(a for _, a in self._param_terms())

    def _param_terms(self) -> list[tuple[int, int]]:
        """(total, active) parameter pairs per component."""
        D, V, ff = self.d_model, self.vocab_size, self.d_ff
        hd = self.hd
        terms: list[tuple[int, int]] = []
        emb = V * D
        terms.append((emb, emb))
        if not self.tie_embeddings:
            terms.append((emb, emb))
        if self.family in ("dense", "moe", "audio", "vlm"):
            attn = D * (self.n_heads * hd) + 2 * D * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * D
            per_layer = attn + 2 * D  # norms
            if self.is_moe:
                router = D * self.n_experts
                expert = 3 * D * ff
                moe_total = router + self.n_experts * expert \
                    + self.n_shared_experts * expert
                moe_active = router + self.experts_per_token * expert \
                    + self.n_shared_experts * expert
                terms.append((self.n_layers * (per_layer + moe_total),
                              self.n_layers * (per_layer + moe_active)))
            else:
                mlp = 3 * D * ff
                t = self.n_layers * (per_layer + mlp)
                terms.append((t, t))
        elif self.family == "hybrid":   # zamba2
            d_in = self.ssm_expand * D
            nh = d_in // self.ssm_head_dim
            mamba = (D * (2 * d_in + 2 * self.ssm_state + nh)
                     + self.conv_kernel * (d_in + 2 * self.ssm_state)
                     + d_in * D + 2 * D)
            n_mamba = self.n_layers
            shared_attn = (D * (self.n_heads * hd)
                           + 2 * D * (self.n_kv_heads * hd)
                           + (self.n_heads * hd) * D + 3 * D * self.d_ff
                           + 2 * D)
            t = n_mamba * mamba + shared_attn   # shared weights counted once
            a = n_mamba * mamba + self.n_macro_blocks * shared_attn
            terms.append((t, min(a, a)))
        elif self.family == "ssm":      # xlstm
            d_in = 2 * D
            per_m = D * (3 * d_in) + d_in * D + 2 * D \
                + d_in * (3 * self.n_heads)   # qkv-ish gates
            t = self.n_layers * per_m
            terms.append((t, t))
        return terms
