"""granite-3-8b [dense]: GQA [hf:ibm-granite/granite-3.0-2b-base; hf].
vocab 49155 padded to 49280 (multiple of 128) for clean TP vocab sharding
(the 125 pad rows are never produced by the tokenizer stub)."""

from repro_torch.configs.base import ArchConfig

VOCAB_RAW = 49155

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab_size=49280, microbatches=8,
)

SMOKE_CONFIG = ArchConfig(
    name="granite-3-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=128, remat=False,
)
