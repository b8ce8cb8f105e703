"""Pump window assignment: the wave program's prefetch-ring gate.

For each member ``m`` and lane ``l``::

    out[m, l] = max(t_ready[m, l], ring[gid[m], idx_on[m] % P, l])
                                        if idx_on[m] >= P and valid[m]
    out[m, l] = max(t_ready[m, l], 0)   otherwise

It serves both pumps of the wave step: deliveries gated on each
consumer's ack ring, and feedback replies gated on each producer's
reply ring.  :func:`pump_assign` launches the hand-written CUDA kernel
``csrc/pump_assign.cu`` (which replaces the Pallas TPU kernel
``_pump_assign_pallas`` of the reference's ``core/jax_device_loop.py``)
on CUDA tensors, and runs :func:`pump_assign_ref`, the plain PyTorch
version, on CPU tensors.  A CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def pump_assign_ref(ring: torch.Tensor, t_ready: torch.Tensor,
                    gid: torch.Tensor, idx_on: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch pump window assignment (the reference's XLA closed
    form, without its unused ``base_cnt`` argument)."""
    P = ring.shape[1]
    gate = ring[gid, idx_on % P]
    gate = torch.where(((idx_on >= P) & valid)[:, None], gate, 0.0)
    return torch.maximum(t_ready, gate)


def _check(ring: torch.Tensor, t_ready: torch.Tensor, gid: torch.Tensor,
           idx_on: torch.Tensor, valid: torch.Tensor) -> None:
    """Raise unless the kernel can read and write these tensors safely."""
    if (ring.dtype != torch.float64 or t_ready.dtype != torch.float64
            or gid.dtype != torch.int64 or idx_on.dtype != torch.int64
            or valid.dtype != torch.bool):
        raise TypeError("pump_assign: want float64 ring and t_ready, int64 "
                        "gid and idx_on, bool valid")
    if ring.dim() != 3 or t_ready.dim() != 2:
        raise ValueError("pump_assign: want ring (R, P, L), t_ready (Np, L)")
    Np, L = t_ready.shape
    if (ring.shape[2] != L or ring.shape[1] < 1 or gid.shape != (Np,)
            or idx_on.shape != (Np,) or valid.shape != (Np,)):
        raise ValueError(f"pump_assign: ring {tuple(ring.shape)}, t_ready "
                         f"{tuple(t_ready.shape)}, gid {tuple(gid.shape)}, "
                         f"idx_on {tuple(idx_on.shape)}, valid "
                         f"{tuple(valid.shape)} do not match")
    dev = ring.device
    if not (t_ready.device == gid.device == idx_on.device == valid.device
            == dev):
        raise ValueError("pump_assign: tensors on more than one device")
    if not (ring.is_contiguous() and t_ready.is_contiguous()
            and gid.is_contiguous() and idx_on.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("pump_assign: tensors must be contiguous")


@functools.cache
def _launcher():
    """The kernel's C entry point, built and typed once, on first use."""
    from repro_torch.kernels import _build
    fn = _build.load("pump_assign").pump_assign_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pump_assign(ring: torch.Tensor, t_ready: torch.Tensor,
                gid: torch.Tensor, idx_on: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Pump window assignment; see the module docstring.

    ``ring`` (R, P, L) float64, ``t_ready`` (Np, L) float64, ``gid`` and
    ``idx_on`` (Np,) int64 with ``0 <= gid < R`` and ``idx_on >= 0``,
    ``valid`` (Np,) bool; all contiguous, all on one device (for CUDA,
    the current one)."""
    _check(ring, t_ready, gid, idx_on, valid)
    if ring.device.type == "cpu":
        return pump_assign_ref(ring, t_ready, gid, idx_on, valid)
    if ring.device.type != "cuda":
        raise ValueError(f"pump_assign: unsupported device {ring.device}")
    if ring.device.index != torch.cuda.current_device():
        raise ValueError(f"pump_assign: tensors on {ring.device}, current "
                         f"device cuda:{torch.cuda.current_device()}")
    out = torch.empty_like(t_ready)
    Np, L = t_ready.shape
    err = _launcher()(ring.data_ptr(), t_ready.data_ptr(), gid.data_ptr(),
                      idx_on.data_ptr(), valid.data_ptr(), out.data_ptr(),
                      Np, L, ring.shape[1],
                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pump_assign: kernel launch failed "
                           f"(cudaGetLastError {err})")
    pump_assign.launches += 1
    return out


#: kernel launches so far (CPU calls run the plain version and do not count)
pump_assign.launches = 0  # type: ignore[attr-defined]
