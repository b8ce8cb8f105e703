"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it.  Sources live in ``csrc/`` and are built on first use
(:mod:`repro_torch.kernels._build`)."""

from repro_torch.kernels import flash_attention, pump_assign

#: every kernel of the port: name (its module and its ``csrc/<name>.cu``)
#: -> its wrapper (which counts launches)
KERNELS = {"pump_assign": pump_assign.pump_assign,
           "flash_attention": flash_attention.flash_attention}
