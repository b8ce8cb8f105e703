"""qwen3-moe-30b-a3b [moe]: 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].
d_ff=768 per expert; head_dim=128 (projected q: 2048 -> 4096)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    n_experts=128, experts_per_token=8, n_shared_experts=0,
    microbatches=4,
)

SMOKE_CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab_size=128, head_dim=32,
    n_experts=8, experts_per_token=2, n_shared_experts=0,
    remat=False,
)
