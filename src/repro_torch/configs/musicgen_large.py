"""musicgen-large [audio]: decoder-only over EnCodec tokens
[arXiv:2306.05284; hf]. The EnCodec frontend is a stub: input_specs()
provides precomputed frame embeddings (B, S, d_model)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    frontend="audio_stub", microbatches=4,
)

SMOKE_CONFIG = ArchConfig(
    name="musicgen-large-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=128, frontend="audio_stub",
    remat=False,
)
