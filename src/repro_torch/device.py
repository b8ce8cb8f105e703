"""The port's device rule: entry points run on the GPU unless the caller
asks for the CPU, and raise when CUDA is asked for but missing."""

from __future__ import annotations

import torch


def resolve_device(device: "torch.device | str") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    return device
