"""SSD inter-chunk state scan: the sequential part of the chunked Mamba2
scan (:func:`repro_torch.models.mamba2.ssd_chunked`), fused with the
output it feeds.  For chunks c = 0 .. nc-1, with the running state
starting at zero::

    y_inter_c = (C_c @ state_{c-1}^T) * exp(cum_c)        # (Q, hd) per head
    state_c   = state_{c-1} * exp(total_c) + states_c

:func:`ssd_state_scan` launches the hand-written CUDA kernel
``csrc/ssd_state_scan.cu`` (which replaces the Pallas TPU kernel
``ssd_state_scan`` of the reference's ``kernels/ssm_scan.py``) on CUDA
tensors, and runs :func:`ssd_state_scan_ref`, the plain PyTorch version
(the reference's ``ssd_state_scan_ref``, a loop over the chunks), on CPU
tensors.  A CUDA tensor launches the kernels or raises: the source holds
a recurrence kernel, which writes the state before each chunk into
scratch, and a persistent kernel that computes ``y_inter`` from it on
the tensor cores as 3xTF32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels._grad import refuse_grad

#: largest SSM head dim and state size the CUDA kernel takes
KERNEL_MAX_DIM = 64


def ssd_state_scan_ref(states: torch.Tensor, totals: torch.Tensor,
                       C: torch.Tensor, cum: torch.Tensor,
                       init_state: Optional[torch.Tensor] = None):
    """Plain PyTorch scan.  states (B, nc, nh, hd, N); totals (B, nc, nh);
    C (B, nc, Q, N); cum (B, nc, Q, nh).  Returns (y_inter (B, nc, Q, nh,
    hd), final_state (B, nh, hd, N)), float32.  ``init_state`` (B, nh,
    hd, N) is the state before the first chunk (zero when omitted): the
    reference's ``ssd_chunked`` takes one, its kernel does not."""
    B, nc, nh, hd, N = states.shape
    s = (torch.zeros((B, nh, hd, N), dtype=torch.float32,
                     device=states.device)
         if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * torch.exp(totals[:, c])[:, :, None, None] + states[:, c].float()
    prev = torch.stack(prev, dim=1)                        # state BEFORE chunk c
    y = torch.einsum("bcin,bchdn,bcih->bcihd", C.float(), prev,
                     torch.exp(cum).float())
    return y, s


def _check(states, totals, C, cum) -> None:
    """Raise unless the kernel (or, on the CPU, the plain version) can
    take these tensors."""
    if states.dim() != 5 or totals.dim() != 3 or C.dim() != 4 or cum.dim() != 4:
        raise ValueError(f"ssd_state_scan: want states (B,nc,nh,hd,N), totals "
                         f"(B,nc,nh), C (B,nc,Q,N), cum (B,nc,Q,nh); got "
                         f"{tuple(states.shape)}, {tuple(totals.shape)}, "
                         f"{tuple(C.shape)}, {tuple(cum.shape)}")
    B, nc, nh, hd, N = states.shape
    Q = C.shape[2]
    if (totals.shape != (B, nc, nh) or C.shape != (B, nc, Q, N)
            or cum.shape != (B, nc, Q, nh)):
        raise ValueError(f"ssd_state_scan: states {tuple(states.shape)}, "
                         f"totals {tuple(totals.shape)}, C {tuple(C.shape)}, "
                         f"cum {tuple(cum.shape)} do not match")
    if any(t.dtype != torch.float32 for t in (states, totals, C, cum)):
        raise TypeError("ssd_state_scan: want float32 inputs")
    if not (states.device == totals.device == C.device == cum.device):
        raise ValueError("ssd_state_scan: tensors on more than one device")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built and its entry points typed once, on
    first use."""
    from repro_torch.kernels import _build
    lib = _build.load("ssd_state_scan")
    lib.ssd_state_scan_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 16
        + [ctypes.c_void_p])
    lib.ssd_state_scan_launch.restype = ctypes.c_int
    lib.ssd_state_scan_info.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.ssd_state_scan_info.restype = ctypes.c_int
    return lib


@functools.cache
def kernel_info() -> dict:
    """What the compiler and the occupancy API report for the product
    kernel (needs a CUDA device)."""
    out = (ctypes.c_int * 5)()
    err = _lib().ssd_state_scan_info(out)
    if err != 0:
        raise RuntimeError(f"ssd_state_scan: kernel_info failed ({err})")
    return dict(registers=out[0], ctas_per_sm=out[1], smem_bytes=out[2],
                threads=out[3], local_bytes=out[4])


def ssd_state_scan(states: torch.Tensor, totals: torch.Tensor,
                   C: torch.Tensor, cum: torch.Tensor):
    """The inter-chunk scan; see the module docstring.  Returns
    (y_inter (B, nc, Q, nh, hd), final_state (B, nh, hd, N)), float32 and
    contiguous.

    All inputs float32, any strides, in the layouts above.  On CUDA (the
    current device) hd and N are at most :data:`KERNEL_MAX_DIM`; the
    kernel reads the inputs in place."""
    _check(states, totals, C, cum)
    refuse_grad("ssd_state_scan", states, totals, C, cum)
    if states.device.type == "cpu":
        return ssd_state_scan_ref(states, totals, C, cum)
    if states.device.type != "cuda":
        raise ValueError(f"ssd_state_scan: unsupported device {states.device}")
    if states.device.index != torch.cuda.current_device():
        raise ValueError(f"ssd_state_scan: tensors on {states.device}, "
                         f"current device cuda:{torch.cuda.current_device()}")
    B, nc, nh, hd, N = states.shape
    Q = C.shape[2]
    if hd > KERNEL_MAX_DIM or N > KERNEL_MAX_DIM:
        raise ValueError(f"ssd_state_scan: head dim {hd} or state {N} > "
                         f"{KERNEL_MAX_DIM}")
    if B * nh >= 2 ** 31:
        raise ValueError(f"ssd_state_scan: B*nh = {B * nh} >= 2^31")
    y = torch.empty((B, nc, Q, nh, hd), dtype=torch.float32,
                    device=states.device)
    final = torch.empty((B, nh, hd, N), dtype=torch.float32,
                        device=states.device)
    if B * nh == 0:
        return y, final
    # the state before each chunk, written by the recurrence and read by
    # the products (64 x 64 a block, zero-padded)
    prefix = torch.empty((B, nc, nh, KERNEL_MAX_DIM, KERNEL_MAX_DIM),
                         dtype=torch.float32, device=states.device)
    err = _lib().ssd_state_scan_launch(
        states.data_ptr(), totals.data_ptr(), C.data_ptr(), cum.data_ptr(),
        y.data_ptr(), final.data_ptr(), prefix.data_ptr(), B, nc, nh, hd, N,
        Q, *states.stride(),
        *totals.stride(), *C.stride(), *cum.stride(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_state_scan: kernel launch failed "
                           f"(cudaGetLastError {err})")
    ssd_state_scan.launches += 1
    return y, final


#: kernel launches so far (CPU calls run the plain version and do not count)
ssd_state_scan.launches = 0  # type: ignore[attr-defined]
