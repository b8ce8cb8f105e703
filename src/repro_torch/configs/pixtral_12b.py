"""pixtral-12b [vlm]: pixtral-ViT + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified]. The ViT is a stub:
input_specs() provides precomputed patch embeddings occupying the first
``num_patches`` positions; the decoder is mistral-nemo-style (head_dim
128)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128,
    frontend="vision_stub", num_patches=1024,
    microbatches=8,
)

SMOKE_CONFIG = ArchConfig(
    name="pixtral-12b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=128, head_dim=32,
    frontend="vision_stub", num_patches=8,
    remat=False,
)
