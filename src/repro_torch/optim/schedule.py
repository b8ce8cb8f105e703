"""LR schedules, the port's copy of the reference's
``repro.optim.schedule``."""

from __future__ import annotations

import math

import torch


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """Linear warmup then cosine decay to floor*peak.  The returned
    callable takes the step (an int or a 0-d tensor, on any device) and
    gives a float32 0-d tensor on the step's device."""

    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr
