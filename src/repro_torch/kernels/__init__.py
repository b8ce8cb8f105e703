"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it.  Sources live in ``csrc/`` and are built on first use
(:mod:`repro_torch.kernels._build`).  The model kernels are forward-only,
as the reference's Pallas kernels are: under grad, with an input that
requires grad, each wrapper raises (:mod:`repro_torch.kernels._grad`)."""

from repro_torch.kernels import (
    decode_attention, flash_attention, pump_assign, rmsnorm, ssm_scan)

#: every kernel of the port: name (its ``csrc/<name>.cu``) -> its wrapper
#: (which counts launches)
KERNELS = {"pump_assign": pump_assign.pump_assign,
           "flash_attention": flash_attention.flash_attention,
           "rmsnorm": rmsnorm.rmsnorm,
           "flash_decode": decode_attention.flash_decode,
           "ssd_state_scan": ssm_scan.ssd_state_scan}
