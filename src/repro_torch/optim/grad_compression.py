"""Int8 error-feedback gradient compression for the cross-pod all-reduce,
the port's counterpart of the reference's ``repro.optim.grad_compression``.

The paper's broadcast&gather pattern maps to the DDP gradient collective;
across pods that collective crosses the slowest link ("cross-facility"
analogue), so we offer 1-byte compressed exchange with error feedback:
each pod quantizes (grad + carried error) to int8 with a per-tensor
scale, all-gathers (values, scales), reconstructs the true mean, and
carries the quantization residual into the next step.  The reference
gathers inside ``shard_map`` over its pod axis; here a
``torch.distributed`` group takes its place, and ``group=None`` (one
card) gathers this rank alone, as the reference's 1-sized pod axis does.
"""

from __future__ import annotations

from typing import Optional

import torch


def quantize_int8(x: torch.Tensor):
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_pod_mean(grad: torch.Tensor, error: torch.Tensor,
                        group: Optional["torch.distributed.ProcessGroup"]
                        = None):
    """Returns (mean_grad, new_error) over the ranks of ``group``.

    Exchanges int8 values + one fp32 scale per rank instead of bf16/fp32
    grads (about 2-4x less cross-pod traffic)."""
    comp_in = grad.to(torch.float32) + error
    q, s = quantize_int8(comp_in)
    if group is None:
        qs, ss = q[None], s[None]                      # (1, ...), (1,)
    else:
        import torch.distributed as dist
        n = dist.get_world_size(group)
        qs = [torch.empty_like(q) for _ in range(n)]
        ss = [torch.empty_like(s) for _ in range(n)]
        dist.all_gather(qs, q.contiguous(), group=group)
        dist.all_gather(ss, s, group=group)
        qs, ss = torch.stack(qs), torch.stack(ss)      # (n, ...), (n,)
    n = qs.shape[0]
    mean = torch.tensordot(ss, qs.to(torch.float32), dims=([0], [0])) / n
    new_error = comp_in - dequantize_int8(q, s)
    return mean.to(grad.dtype), new_error
