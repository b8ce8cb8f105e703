"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified]. 81 Mamba2 layers = 13 macro-blocks x 6 +
3 tail; the shared attention block is applied after every macro-block
(13 applications, one weight set)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, conv_kernel=4,
    mamba_per_block=6, n_macro_blocks=13, tail_mamba_layers=3,
    microbatches=8,
)

SMOKE_CONFIG = ArchConfig(
    name="zamba2-7b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=128,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, conv_kernel=4,
    mamba_per_block=2, n_macro_blocks=2, tail_mamba_layers=1,
    remat=False,
)
