"""RMSNorm: ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` over the last dim,
with float32 statistics, cast back to x's dtype.

:func:`rmsnorm` launches the hand-written CUDA kernel ``csrc/rmsnorm.cu``
(which replaces the Pallas TPU kernel ``rmsnorm`` of the reference's
``kernels/rmsnorm.py``) on CUDA tensors, and runs :func:`rmsnorm_ref`,
the plain PyTorch version (the reference's ``layers.rmsnorm``, its
oracle), on CPU tensors.  A CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._grad import refuse_grad

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
                ) -> torch.Tensor:
    """Plain PyTorch RMSNorm (the reference's ``layers.rmsnorm``)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(dt)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise unless the kernel (or, on the CPU, the plain version) can
    take these tensors."""
    if x.dim() < 1 or x.shape[-1] < 1 or w.shape != x.shape[-1:]:
        raise ValueError(f"rmsnorm: want x (..., D) and w (D,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODE or w.dtype != torch.float32:
        raise TypeError(f"rmsnorm: want x float32 or bfloat16 and w "
                        f"float32; got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError("rmsnorm: tensors on more than one device")


@functools.cache
def _launcher():
    """The kernel's C entry point, built and typed once, on first use."""
    from repro_torch.kernels import _build
    fn = _build.load("rmsnorm").rmsnorm_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm over the last dim; see the module docstring.  Returns a
    contiguous tensor of x's shape and dtype.

    x float32 or bfloat16, any leading shape and row count; w (D,)
    float32.  On CUDA (the current device) the rows of x must be one
    stride apart with the last dim contiguous (any view that reshapes to
    (rows, D) without a copy, e.g. ``x[:, -1:]``); the kernel reads them
    in place."""
    _check(x, w)
    refuse_grad("rmsnorm", x, w)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"rmsnorm: tensors on {x.device}, current device "
                         f"cuda:{torch.cuda.current_device()}")
    D = x.shape[-1]
    try:
        rows = x.view(-1, D)
    except RuntimeError:
        raise ValueError("rmsnorm: x's rows must be one stride apart") from None
    if (rows.stride(1) != 1 and D > 1) or not w.is_contiguous():
        raise ValueError("rmsnorm: x's last dim and w must be contiguous")
    if rows.shape[0] >= 2 ** 31:
        raise ValueError(f"rmsnorm: {rows.shape[0]} rows >= 2^31")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows.shape[0] == 0:
        return out
    vec = 16 // x.element_size()
    vector = (D % vec == 0 and rows.stride(0) % vec == 0
              and rows.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    err = _launcher()(rows.data_ptr(), w.data_ptr(), out.data_ptr(),
                      _DTYPE_CODE[x.dtype], rows.shape[0], D, rows.stride(0),
                      float(eps), int(vector),
                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm: kernel launch failed "
                           f"(cudaGetLastError {err})")
    rmsnorm.launches += 1
    return out


#: kernel launches so far (CPU calls run the plain version and do not count)
rmsnorm.launches = 0  # type: ignore[attr-defined]
