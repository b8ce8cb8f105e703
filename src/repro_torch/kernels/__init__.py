"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it.  Sources live in ``csrc/`` and are built on first use
(:mod:`repro_torch.kernels._build`)."""

from repro_torch.kernels.pump_assign import pump_assign, pump_assign_ref

#: every kernel of the port: name -> its wrapper (which counts launches)
KERNELS = {"pump_assign": pump_assign}
