"""Flash decode: one query token per request against its KV cache,
grouped-query, with an optional sliding window and logit softcap.

q is (B, H, hd), the caches (B, T, KV, hd), ``pos`` (B,) the index of
each request's current token (already written into the cache); query
head ``h`` reads KV head ``h // (H // KV)``, and keys past ``pos`` (and
outside the window) are masked.  :func:`flash_decode` launches the
hand-written CUDA kernel ``csrc/flash_decode.cu`` (which replaces the
Pallas TPU kernel ``flash_decode`` of the reference's
``kernels/decode_attention.py``) on CUDA tensors, and runs
:func:`flash_decode_ref`, the plain PyTorch version (the reference's
``layers.decode_attention``, a grouped einsum, its oracle), on CPU
tensors.  A CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import NEG_INF, softcap

#: head dims the CUDA kernel is built for
KERNEL_HEAD_DIMS = (64, 112, 128, 256)
#: a split of the keys of one (request, KV head) holds at least this many
MIN_SPLIT_KEYS = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: int = 0, logit_cap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch decode attention: the reference's grouped einsum
    (no KV expansion), f32 scores over the whole cache, masked past
    ``pos`` and outside the window."""
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    T = k_cache.shape[1]
    scale = (hd ** -0.5) if scale is None else scale
    qg = q.reshape(B, KV, G, hd).float() * scale
    s = torch.einsum("bkgh,btkh->bkgt", qg, k_cache.float())
    if logit_cap > 0:
        s = softcap(s, logit_cap)
    t_idx = torch.arange(T, device=q.device)
    ok = t_idx[None, :] <= pos[:, None]                       # (B, T)
    if window > 0:
        ok &= (pos[:, None] - t_idx[None, :]) < window
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", p, v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


def _check(q, k_cache, v_cache, pos, window) -> None:
    """Raise unless the kernel (or, on the CPU, the plain version) can
    take these tensors."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"flash_decode: want q (B,H,hd), caches "
                         f"(B,T,KV,hd); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, H, hd = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape[0] != B or k_cache.shape[3] != hd or KV < 1 or H % KV
            or T < 1 or pos.shape != (B,)):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}, pos {tuple(pos.shape)} "
                         f"do not match")
    if (q.dtype not in _DTYPE_CODE or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise TypeError(f"flash_decode: want q and caches all float32 or all "
                        f"bfloat16; got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if pos.dtype.is_floating_point or pos.dtype == torch.bool:
        raise TypeError("flash_decode: pos must be integers")
    if window < 0:
        raise ValueError(f"flash_decode: window {window} < 0")
    if not (q.device == k_cache.device == v_cache.device == pos.device):
        raise ValueError("flash_decode: tensors on more than one device")


def group_block(G: int) -> int:
    """Query heads of one KV group a CTA takes: 1, 2, 4 or 8."""
    return min(8, 1 << (G - 1).bit_length())


def n_splits(B: int, KV: int, G: int, T: int, sms: int) -> int:
    """Key ranges per (request, KV head): enough CTAs for about four per
    SM, with at least :data:`MIN_SPLIT_KEYS` keys in each range."""
    ctas = B * KV * -(-G // group_block(G))
    return max(1, min(-(-4 * sms // ctas), -(-T // MIN_SPLIT_KEYS)))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _launcher():
    """The kernel's C entry point, built and typed once, on first use."""
    from repro_torch.kernels import _build
    fn = _build.load("flash_decode").flash_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_int64] * 8
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: torch.Tensor, *,
                 window: int = 0, logit_cap: float = 0.0,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention; see the module docstring.  Returns (B, H, hd)
    in q's dtype.

    q and the caches float32 or bfloat16 (all one dtype), ``pos``
    integer.  On CUDA (the current device) hd must be one of
    :data:`KERNEL_HEAD_DIMS`, the head dims contiguous and the caches'
    strides and addresses whole 16-byte vectors (any slice of a
    contiguous cache along its leading dims); the kernel reads the
    caches in place and stops at each request's ``pos``.  ``pos`` is
    cast to int32 here (a no-op when it already is)."""
    _check(q, k_cache, v_cache, pos, window)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, pos, window=window,
                                logit_cap=logit_cap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_decode: tensors on {q.device}, current "
                         f"device cuda:{torch.cuda.current_device()}")
    B, H, hd = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {hd} not in "
                         f"{KERNEL_HEAD_DIMS}")
    vec = 16 // q.element_size()
    for c in (k_cache, v_cache):
        if (c.stride(3) != 1 or any(s % vec for s in c.stride()[:3])
                or c.data_ptr() % 16):
            raise ValueError("flash_decode: the caches' head dims must be "
                             "contiguous and their strides and addresses "
                             "whole 16-byte vectors")
    if q.stride(2) != 1:
        raise ValueError("flash_decode: q's head dim must be contiguous")
    G = H // KV
    gb = group_block(G)
    n_split = n_splits(B, KV, G, T, _sm_count(q.device.index))
    chunk = -(-T // n_split)
    if B * KV * -(-G // gb) >= 2 ** 31:
        raise ValueError("flash_decode: too many (request, KV head) blocks")
    scale = (hd ** -0.5) if scale is None else scale
    p32 = pos.to(torch.int32).contiguous()
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    part = (torch.empty((n_split, B, H, hd + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    err = _launcher()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), p32.data_ptr(),
        out.data_ptr(), 0 if part is None else part.data_ptr(),
        _DTYPE_CODE[q.dtype], B, T, H, KV, hd, gb, n_split, chunk,
        q.stride(0), q.stride(1), *k_cache.stride()[:3],
        *v_cache.stride()[:3], float(scale), float(logit_cap), int(window),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode: kernel launch failed "
                           f"(cudaGetLastError {err})")
    flash_decode.launches += 1
    return out


#: kernel launches so far (CPU calls run the plain version and do not count)
flash_decode.launches = 0  # type: ignore[attr-defined]
