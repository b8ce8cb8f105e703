"""Flash-attention forward: grouped-query attention with causal and
sliding-window masks from explicit positions and a logit softcap.

q is (B, S, H, hd), k and v are (B, T, KV, hd); query head ``h`` reads
KV head ``h // (H // KV)``; ``q_pos`` (S,) and ``k_pos`` (T,) are the
tokens' positions.  :func:`flash_attention` launches a hand-written CUDA
kernel of ``csrc/flash_attention.cu`` (which replaces the Pallas TPU
kernel ``flash_attention_fwd`` of the reference's
``kernels/flash_attention.py``) on CUDA tensors, and runs
:func:`flash_attention_ref`, the plain PyTorch version (the reference's
``attention_reference``: full score matrix, masks as a -1e30 bias,
probabilities cast to v's dtype), on CPU tensors.  A CUDA tensor
launches a kernel or raises.

Which kernel (:func:`route`) follows from the inputs alone, before any
launch: bf16 at a head dim of :data:`TC_HEAD_DIMS` whose q, k and v TMA
can address (16-byte aligned pointers, every stride a multiple of 8
elements) goes to the tensor-core kernel; everything else (f32, hd 256,
and bf16 that TMA cannot address) to the FMA kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels._grad import refuse_grad

#: additive mask value of the reference (never -inf: see the kernel source)
NEG_INF = -1e30
#: head dims the CUDA kernels are built for
KERNEL_HEAD_DIMS = (64, 112, 128, 256)
#: head dims of the tensor-core kernel (bf16 only)
TC_HEAD_DIMS = (64, 112, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, T, H, hd) by repeating each KV head."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kv, dim=2)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(S, T) additive float32 bias: 0 where visible, NEG_INF where masked."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch attention with the full (S, T) score matrix: the
    reference's ``attention_reference``, operation for operation."""
    H, hd = q.shape[2], q.shape[3]
    scale = (hd ** -0.5) if scale is None else scale
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    s = torch.einsum("bshd,bthd->bhst", q.float() * scale, k.float())
    if logit_cap > 0:
        s = softcap(s, logit_cap)
    s = s + _mask_bias(q_pos, k_pos, causal, window)[None, None]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p.to(v.dtype), v)


def _check(q, k, v, q_pos, k_pos, window) -> None:
    """Raise unless the kernel (or, on the CPU, the plain version) can
    take these tensors."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B,S,H,hd), k and v "
                         f"(B,T,KV,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != hd or KV < 1 or H % KV
            or T < 1 or q_pos.shape != (S,) or k_pos.shape != (T,)):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, q_pos {tuple(q_pos.shape)}, "
                         f"k_pos {tuple(k_pos.shape)} do not match")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: want q, k, v all float32 or all "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q_pos.dtype.is_floating_point or k_pos.dtype.is_floating_point:
        raise TypeError("flash_attention: positions must be integers")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if not (q.device == k.device == v.device == q_pos.device
            == k_pos.device):
        raise ValueError("flash_attention: tensors on more than one device")


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_int64] * 12
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, built and its entry points typed once, on
    first use."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    for fn in (lib.flash_attention_launch, lib.flash_attention_tc_launch):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.flash_attention_info.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.flash_attention_info.restype = ctypes.c_int
    return lib


def _tma_ok(x: torch.Tensor) -> bool:
    """TMA can address ``x``: a 16-byte aligned pointer, and the stride of
    every dimension longer than 1 a multiple of 8 elements (16 bytes)."""
    return x.data_ptr() % 16 == 0 and all(
        n == 1 or st % 8 == 0 for n, st in zip(x.shape[:3], x.stride()[:3]))


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a CUDA call runs: ``"tc"`` (tensor cores) for bf16 at a
    head dim of :data:`TC_HEAD_DIMS` with q, k and v TMA can address,
    else ``"fma"``."""
    if (q.dtype == torch.bfloat16 and q.shape[3] in TC_HEAD_DIMS
            and all(_tma_ok(x) for x in (q, k, v))):
        return "tc"
    return "fma"


def _strides(x: torch.Tensor) -> tuple:
    """x's first three strides; a dimension of length 1 is only ever read
    at 0, so its stride is rounded up to a multiple of 8, as TMA wants."""
    return tuple(st if n > 1 else max(8, -(-st // 8) * 8)
                 for n, st in zip(x.shape[:3], x.stride()[:3]))


def kernel_info(kernel_route: str, dtype: torch.dtype, hd: int) -> dict:
    """What the compiler and the occupancy API report for the kernel that
    ``kernel_route`` (``"tc"`` or ``"fma"``) runs at ``dtype`` and ``hd``
    (needs a CUDA device)."""
    out = (ctypes.c_int * 5)()
    err = _lib().flash_attention_info(int(kernel_route == "tc"),
                                      _DTYPE_CODE[dtype], hd, out)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel_info failed ({err})")
    return dict(registers=out[0], ctas_per_sm=out[1], smem_bytes=out[2],
                threads=out[3], local_bytes=out[4])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash-attention forward; see the module docstring.  Returns
    (B, S, H, hd) in q's dtype.

    q, k, v float32 or bfloat16 (all one dtype) with the head dim
    contiguous, any other strides; positions integer, increasing.  On
    CUDA (the current device) hd must be one of :data:`KERNEL_HEAD_DIMS`
    and B*H at most 65535; :func:`route` picks the kernel; positions are
    cast to int32 here, once per call (a no-op when the caller already
    holds int32)."""
    _check(q, k, v, q_pos, k_pos, window)
    refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                                   window=window, logit_cap=logit_cap,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention: tensors on {q.device}, current "
                         f"device cuda:{torch.cuda.current_device()}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B*H = {B * H} > 65535")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    tc = route(q, k, v) == "tc"
    scale = (hd ** -0.5) if scale is None else scale
    qp = q_pos.to(torch.int32).contiguous()
    kp = k_pos.to(torch.int32).contiguous()
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lib = _lib()
    fn = lib.flash_attention_tc_launch if tc else lib.flash_attention_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
             kp.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype], B, S, T, H,
             KV, hd, *_strides(q), *_strides(k), *_strides(v),
             *out.stride()[:3], float(scale), float(logit_cap), int(causal),
             int(window), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: {'tensor-core' if tc else 'FMA'}"
                           f" kernel launch failed (error {err})")
    flash_attention.launches += 1
    if tc:
        flash_attention.tc_launches += 1
    return out


#: kernel launches so far, both routes (CPU calls run the plain version and
#: do not count)
flash_attention.launches = 0  # type: ignore[attr-defined]
#: of those, launches of the tensor-core kernel
flash_attention.tc_launches = 0  # type: ignore[attr-defined]
