"""granite-34b [dense]: llama-arch code model, MQA (kv=1)
[arXiv:2405.04324; hf]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, microbatches=16,
)

SMOKE_CONFIG = ArchConfig(
    name="granite-34b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab_size=128, remat=False,
)
