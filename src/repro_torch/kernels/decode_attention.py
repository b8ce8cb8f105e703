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

The source holds two kernels (:func:`route` picks one from the inputs):
bf16 at hd 64, 112 and 128 runs the tensor-core kernel, f32 and hd 256
the FMA kernel.  Both walk a persistent grid of one full wave
(:func:`plan`): ``n_ctas`` CTAs, the SMs times the CTAs an SM that the
occupancy API reports for the instance, each take an equal share of the
(unit, 16-key group) sequence, where a unit is one (request, one or two
KV heads, block of query heads); when a share boundary cuts a unit, a
second kernel merges its partials.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels.flash_attention import NEG_INF, softcap

#: head dims the CUDA kernels are built for
KERNEL_HEAD_DIMS = (64, 112, 128, 256)
#: head dims of the tensor-core kernel (bf16 only)
TC_HEAD_DIMS = (64, 112, 128)
#: keys of one group: the persistent grid's unit of work (``KG`` in the
#: source)
GROUP_KEYS = 16
#: a CTA's share of the keys holds at least this many
MIN_CTA_KEYS = 256
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


def route(q: torch.Tensor, k_cache: torch.Tensor) -> str:
    """The kernel a CUDA call runs: ``"tc"`` (the tensor-core kernel) for
    bf16 at a head dim of :data:`TC_HEAD_DIMS`, else ``"fma"``."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS:
        return "tc"
    return "fma"


def group_block(G: int) -> int:
    """Query heads of one KV group the FMA kernel's unit takes: 1, 2, 4
    or 8."""
    return min(8, 1 << (G - 1).bit_length())


def heads_per_unit(G: int, kernel_route: str) -> int:
    """Query heads of one unit: the tensor-core kernel takes up to 16 (the
    rows of its products), the FMA kernel :func:`group_block`."""
    return min(16, G) if kernel_route == "tc" else group_block(G)


def kv_heads_per_unit(KV: int, hd: int, kernel_route: str) -> int:
    """KV heads of one unit: 2 (read in turns, group by group) for the
    tensor-core kernel when a head's bf16 row is not a whole number of the
    memory's 64-byte granules (hd 112: 224 bytes) and KV is even, so that
    the granule two neighbouring heads' rows share is fetched once; else
    1."""
    return 2 if (kernel_route == "tc" and (2 * hd) % 64 and KV % 2 == 0) else 1


def n_ctas(groups: int, sms: int, ctas_per_sm: int) -> int:
    """CTAs of the persistent grid over ``groups`` 16-key groups: one full
    wave, ``sms`` times the CTAs an SM that the occupancy API reports for
    the instance, each taking an equal share; fewer when that would leave
    a CTA under :data:`MIN_CTA_KEYS` keys (then one CTA per that many)."""
    return max(1, min(sms * ctas_per_sm,
                      groups * GROUP_KEYS // MIN_CTA_KEYS))


@functools.lru_cache(maxsize=1024)
def cuts_a_unit(units: int, ng: int, ctas: int) -> bool:
    """Whether a boundary between two CTAs' shares falls inside one of the
    units of ``ng`` groups each (then the kernel writes partials and a
    second kernel merges them)."""
    W = units * ng
    return any((c * W // ctas) % ng for c in range(1, ctas))


def plan(B: int, KV: int, G: int, T: int, hd: int, kernel_route: str,
         sms: int, ctas_per_sm: int) -> tuple:
    """(query heads of a unit's KV head, KV heads a unit, CTAs, whether a
    unit is cut) of one call."""
    gb = heads_per_unit(G, kernel_route)
    kvu = kv_heads_per_unit(KV, hd, kernel_route)
    units = B * (KV // kvu) * -(-G // gb)
    ng = kvu * -(-T // GROUP_KEYS)
    ctas = n_ctas(units * ng, sms, ctas_per_sm)
    return gb, kvu, ctas, cuts_a_unit(units, ng, ctas)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, built and its entry points typed once, on
    first use."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_decode")
    lib.flash_decode_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_int64] * 8
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_decode_launch.restype = ctypes.c_int
    lib.flash_decode_info.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.flash_decode_info.restype = ctypes.c_int
    return lib


@functools.cache
def kernel_info(kernel_route: str, dtype: torch.dtype, hd: int,
                gb: int) -> dict:
    """What the compiler and the occupancy API report for the instance
    that ``kernel_route`` runs at ``dtype``, ``hd`` and ``gb`` query heads
    a unit (needs a CUDA device)."""
    out = (ctypes.c_int * 5)()
    err = _lib().flash_decode_info(int(kernel_route == "tc"),
                                   _DTYPE_CODE[dtype], hd, gb, out)
    if err != 0:
        raise RuntimeError(f"flash_decode: kernel_info failed ({err})")
    return dict(registers=out[0], ctas_per_sm=out[1], smem_bytes=out[2],
                threads=out[3], local_bytes=out[4])


@functools.cache
def _plan(B: int, KV: int, G: int, T: int, kernel_route: str,
          dtype: torch.dtype, hd: int, index: int) -> tuple:
    """:func:`plan` on the card ``index`` for its SMs and the instance's
    CTAs an SM."""
    gb = heads_per_unit(G, kernel_route)
    occ = kernel_info(kernel_route, dtype, hd, gb)["ctas_per_sm"]
    if occ < 1:
        raise RuntimeError(f"flash_decode: the {kernel_route} kernel at hd "
                           f"{hd} does not fit on an SM")
    return plan(B, KV, G, T, hd, kernel_route, _sm_count(index), occ)


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
    refuse_grad("flash_decode", q, k_cache, v_cache)
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
    kernel_route = route(q, k_cache)
    if B * KV * G >= 2 ** 31:
        raise ValueError("flash_decode: too many (request, query head) rows")
    gb, kvu, ctas, cut = _plan(B, KV, G, T, kernel_route, q.dtype, hd,
                               q.device.index)
    scale = (hd ** -0.5) if scale is None else scale
    p32 = pos.to(torch.int32).contiguous()
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    units = B * (KV // kvu) * -(-G // gb)
    part = (torch.empty((ctas + units - 1, kvu * gb, hd + 2),
                        dtype=torch.float32, device=q.device)
            if cut else None)
    err = _lib().flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), p32.data_ptr(),
        out.data_ptr(), 0 if part is None else part.data_ptr(),
        int(kernel_route == "tc"), _DTYPE_CODE[q.dtype], B, T, H, KV, hd, gb,
        kvu, ctas, int(cut), q.stride(0), q.stride(1), *k_cache.stride()[:3],
        *v_cache.stride()[:3], float(scale), float(logit_cap), int(window),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode: kernel launch failed "
                           f"(cudaGetLastError {err})")
    flash_decode.launches += 1
    if kernel_route == "tc":
        flash_decode.tc_launches += 1
    return out


#: kernel launches so far (CPU calls run the plain version and do not count)
flash_decode.launches = 0  # type: ignore[attr-defined]
#: of those, launches of the tensor-core kernel
flash_decode.tc_launches = 0  # type: ignore[attr-defined]
