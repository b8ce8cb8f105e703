"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].
48 blocks, every 8th is sLSTM (6 sLSTM : 42 mLSTM); d_ff=0 — blocks carry
their own 2x up/down projections.  The reference gives every block the
leaves of both kinds, so its parameter tree holds 4,637,886,848
parameters; ``ArchConfig.param_count``'s 1.3e9 is its own estimate."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_every=8, microbatches=1, scan_layers=False,
)

SMOKE_CONFIG = ArchConfig(
    name="xlstm-1.3b-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab_size=128, slstm_every=2, scan_layers=False,
    remat=False,
)
