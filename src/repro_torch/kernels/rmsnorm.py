"""RMSNorm: ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` over the last dim,
with float32 statistics, cast back to x's dtype.

:func:`rmsnorm` launches the hand-written CUDA kernel ``csrc/rmsnorm.cu``
(which replaces the Pallas TPU kernel ``rmsnorm`` of the reference's
``kernels/rmsnorm.py``) on CUDA tensors, and runs :func:`rmsnorm_ref`,
the plain PyTorch version (the reference's ``layers.rmsnorm``, its
oracle), on CPU tensors.  A CUDA tensor launches the kernel or raises.

Decode calls it on a few rows, where the host's cost a call is the time,
so the launch path is short: the checks are attribute comparisons, the
output is the one allocation, and the C entry point decides the route
(16-byte vectors held in registers, or a loop) and the grid (one CTA a
row) itself.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._grad import refuse_grad

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: ``rmsnorm_plan``'s fields, in order
PLAN_FIELDS = ("vector", "loop", "threads", "units_per_thread", "grid",
               "ctas_per_sm", "registers", "local_bytes", "vec", "many",
               "stream")


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
                ) -> torch.Tensor:
    """Plain PyTorch RMSNorm (the reference's ``layers.rmsnorm``)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(dt)


def _rows(shape: torch.Size, strides: tuple) -> tuple[int, int]:
    """(rows, row stride) of a tensor seen as (rows, D) without a copy, as
    ``x.view(-1, D)`` sees it; ``ValueError`` where that view fails (the
    leading dims do not merge into one stride)."""
    D = shape[-1]
    if len(shape) == 2:
        return shape[0], strides[0]
    rows, stride, outer = 1, D, None
    for n in shape[:-1]:
        rows *= n
    if rows == 0:
        return 0, D
    for i in range(len(shape) - 2, -1, -1):
        n = shape[i]
        if n == 1:
            continue
        if outer is None:
            stride = strides[i]
        elif strides[i] != outer:
            raise ValueError("rmsnorm: x's rows must be one stride apart")
        outer = strides[i] * n
    return rows, stride


@functools.cache
def _cuda():
    """The kernel's C entry point, built and typed once, on first use, with
    the current device's index and its current stream (the raw
    ``cudaStream_t``, read on every call, so that a capture on a side
    stream sees the launch).  The entry point is called with the GIL held
    (``PyDLL``): it only enqueues a launch, and releasing and taking back
    the GIL would cost more than the call."""
    from repro_torch.kernels import _build
    fn = ctypes.PyDLL(str(_build.build("rmsnorm"))).rmsnorm_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_int64, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, torch._C._cuda_getDevice, torch._C._cuda_getCurrentRawStream


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm over the last dim; see the module docstring.  Returns a
    contiguous tensor of x's shape and dtype.

    x float32 or bfloat16, any leading shape and row count; w (D,)
    float32.  On CUDA (the current device) the rows of x must be one
    stride apart with the last dim contiguous (any view that reshapes to
    (rows, D) without a copy, e.g. ``x[:, -1:]``); the kernel reads them
    in place."""
    shape = x.shape
    if not shape or shape[-1] < 1 or w.shape != (shape[-1],):
        raise ValueError(f"rmsnorm: want x (..., D) and w (D,); got "
                         f"{tuple(shape)}, {tuple(w.shape)}")
    code = _DTYPE_CODE.get(x.dtype)
    if code is None or w.dtype != torch.float32:
        raise TypeError(f"rmsnorm: want x float32 or bfloat16 and w "
                        f"float32; got {x.dtype}, {w.dtype}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        refuse_grad("rmsnorm", x, w)
    if not x.is_cuda:
        if x.device != w.device:
            raise ValueError("rmsnorm: tensors on more than one device")
        if x.device.type != "cpu":
            raise ValueError(f"rmsnorm: unsupported device {x.device}")
        return rmsnorm_ref(x, w, eps)
    launch, current_device, current_stream = _cuda()
    dev = x.get_device()
    if w.get_device() != dev:
        raise ValueError("rmsnorm: tensors on more than one device")
    if dev != current_device():
        raise ValueError(f"rmsnorm: tensors on cuda:{dev}, current device "
                         f"cuda:{current_device()}")
    D = shape[-1]
    strides = x.stride()
    if (strides[-1] != 1 and D > 1) or not w.is_contiguous():
        raise ValueError("rmsnorm: x's last dim and w must be contiguous")
    R, row_stride = _rows(shape, strides)
    if R >= 2 ** 31:
        raise ValueError(f"rmsnorm: {R} rows >= 2^31")
    # a contiguous x's own layout is contiguous, and the keyword costs
    out = (torch.empty_like(x) if x.is_contiguous() else
           torch.empty_like(x, memory_format=torch.contiguous_format))
    if R == 0:
        return out
    err = launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), code, R, D,
                 row_stride, eps, current_stream(dev))
    if err:
        raise RuntimeError(f"rmsnorm: kernel launch failed "
                           f"(cudaGetLastError {err})")
    rmsnorm.launches += 1
    return out


#: kernel launches so far (CPU calls run the plain version and do not count)
rmsnorm.launches = 0  # type: ignore[attr-defined]


def plan(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> dict:
    """What a CUDA call on ``x``, ``w`` into ``out`` launches, as the C
    entry point decides it (``PLAN_FIELDS``).  Launches nothing."""
    from repro_torch.kernels import _build
    fn = _build.load("rmsnorm").rmsnorm_plan
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_int64, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    R, row_stride = _rows(x.shape, x.stride())
    vals = (ctypes.c_int * len(PLAN_FIELDS))()
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
             _DTYPE_CODE[x.dtype], R, x.shape[-1], row_stride, vals)
    if err:
        raise RuntimeError(f"rmsnorm_plan failed (CUDA error {err})")
    return dict(zip(PLAN_FIELDS, vals))
