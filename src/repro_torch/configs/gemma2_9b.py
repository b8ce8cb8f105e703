"""gemma2-9b [dense]: local+global alternating attention, logit softcaps,
post-norms [arXiv:2408.00118; hf]. head_dim=256 (projected)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    d_ff=14336, vocab_size=256000, head_dim=256,
    attn_pattern="local_global", window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_norms=True, microbatches=4,
)

SMOKE_CONFIG = ArchConfig(
    name="gemma2-9b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=128, head_dim=32,
    attn_pattern="local_global", window=16,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_norms=True, remat=False,
)
