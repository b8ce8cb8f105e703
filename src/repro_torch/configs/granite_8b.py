"""granite-8b [dense]: llama-arch code model [arXiv:2405.04324; hf]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=49152, microbatches=4,
)

SMOKE_CONFIG = ArchConfig(
    name="granite-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=128, remat=False,
)
