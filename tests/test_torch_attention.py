"""The port's attention and layers (``repro_torch.kernels.flash_attention``,
``repro_torch.models.layers``) against the reference's, on the CPU.

* the port's flash attention on CPU tensors (its plain version) against
  the reference's Pallas kernel in interpret mode and its oracle, at the
  shapes and tolerances of ``tests/test_kernels.py`` (f32 2e-5, bf16
  2e-2, window/softcap and non-causal 3e-5);
* the layers in f32 at 1e-5;
* the wrapper's contract: CPU calls do not count launches, inputs the
  kernel does not take raise, the route rule; the CUDA kernels against
  their plain version (``gpu`` marker, skipped without a card);
* the tensor-core kernel's rounding (bf16 operands, f32 accumulation, P
  split into two bf16 halves), emulated tile by tile in plain PyTorch,
  against the reference's Pallas kernel in f32 within the row limit the
  card's check applies, and bf16-only P shown to miss that limit.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the reference runs on the CPU also where a GPU is present: the
# tolerances here are set against its CPU results
jax.config.update("jax_platforms", "cpu")

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro_torch.kernels import KERNELS, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as TL

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _qkv(B, S, T, H, KV, hd, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, T, KV, hd), dtype=np.float32),
            rng.standard_normal((B, T, KV, hd), dtype=np.float32))


def _both(arrays, dtype):
    """The same numpy arrays as jax and torch arrays of ``dtype`` (both
    cast from f32 with round-to-nearest-even)."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------- plain flash attention ---------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd,bq,bk", [
    (1, 128, 4, 4, 32, 64, 64),      # MHA
    (2, 256, 8, 2, 16, 128, 64),     # GQA 4:1
    (1, 192, 4, 1, 64, 64, 64),      # MQA, ragged S/block
    (2, 64, 2, 2, 128, 64, 32),      # TPU-width head_dim
    (2, 128, 4, 4, 112, 64, 64),     # zamba2's head_dim
])
def test_plain_attention_matches_pallas_interpret_and_oracle(
        B, S, H, KV, hd, bq, bk, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, S, S, H, KV, hd), dtype)
    pos = np.arange(S, dtype=np.int32)
    got = ops.flash_attention(tq, tk, tv, torch.from_numpy(pos),
                              torch.from_numpy(pos))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, hd)
    pallas = jops.flash_attention(jq, jk, jv, jnp.asarray(pos),
                                  jnp.asarray(pos), block_q=bq, block_k=bk)
    oracle = jref.flash_attention_ref(jq, jk, jv, jnp.asarray(pos),
                                      jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("window,cap,causal", [
    (32, 0.0, True), (0, 50.0, True), (64, 30.0, True), (0, 0.0, False)])
def test_plain_attention_window_softcap_noncausal(window, cap, causal):
    B, S, H, hd = 1, 256, 2, 32
    if not causal:
        S, hd = 128, 16
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, S, S, H, H, hd), "float32")
    pos = np.arange(S, dtype=np.int32)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    got = fa.flash_attention(tq, tk, tv, torch.from_numpy(pos),
                             torch.from_numpy(pos), **kw)
    pallas = jops.flash_attention(jq, jk, jv, jnp.asarray(pos),
                                  jnp.asarray(pos), block_q=64, block_k=64,
                                  **kw)
    oracle = jref.flash_attention_ref(jq, jk, jv, jnp.asarray(pos),
                                      jnp.asarray(pos), **kw)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=3e-5, atol=3e-5)


def test_cpu_calls_run_the_plain_version_and_do_not_count():
    _, (q, k, v) = _both(_qkv(1, 16, 16, 4, 2, 64), "bfloat16")
    pos = torch.arange(16)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, pos, pos, window=4, logit_cap=20.0)
    assert fa.flash_attention.launches == before
    assert torch.equal(out, fa.flash_attention_ref(q, k, v, pos, pos,
                                                   window=4, logit_cap=20.0))
    assert KERNELS["flash_attention"] is fa.flash_attention


@pytest.mark.parametrize("bad", ["dtype", "kv_shape", "heads", "q_pos",
                                 "float_pos", "window"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, (q, k, v) = _both(_qkv(1, 16, 16, 4, 2, 64), "float32")
    qp = kp = torch.arange(16)
    kw = {}
    if bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "kv_shape":
        v = v[:, :8]
    elif bad == "heads":
        _, (q, k, v) = _both(_qkv(1, 16, 16, 4, 3, 64), "float32")
    elif bad == "q_pos":
        qp = torch.arange(15)
    elif bad == "float_pos":
        qp = qp.float()
    else:
        kw = dict(window=-1)
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention(q, k, v, qp, kp, **kw)


# ---------------------------- the tensor-core kernel's rounding -----------------

#: the row limit of the card's check (``chip_smoke._hold_rows``): twice one
#: bf16 rounding of the output plus 1e-4 of the row's RMS
ROW_ULP, ROW_ATOL = 2.0 ** -7, 1e-4
LOG2E = 1.4426950408889634


def _row_limit_used(got, want32):
    """The largest share of the row limit ``got`` uses against the f32
    ``want32`` (torch tensors, (..., hd))."""
    rms = want32.pow(2).mean(-1, keepdim=True).sqrt()
    diff = (got.float() - want32).abs()
    return (diff / (ROW_ULP * want32.abs() + ROW_ATOL * rms)).max().item()


def _emulate_tc(q, k, v, q_pos, k_pos, *, causal, window, cap, split,
                rows=64, keys=64):
    """The tensor-core kernel's arithmetic in plain PyTorch: each 64-row
    query tile of a (batch, head) walks the 64-key tiles it sees; scores
    from the bf16 values with f32 sums, scaled in f32, in log2 units;
    the online softmax in f32; P·V as P_hi·V + P_lo·V with P_hi = bf16(P)
    and P_lo = bf16(P - P_hi) (only P_hi when ``split`` is False), summed
    in f32; the output rounded to bf16."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    scale = hd ** -0.5
    neg = torch.tensor(-1e30)
    out = torch.empty(B, S, H, hd)
    for b in range(B):
        for h in range(H):
            Q, K, V = q[b, :, h].float(), k[b, :, h // G].float(), \
                v[b, :, h // G].float()
            for r0 in range(0, S, rows):
                qr, qp = Q[r0:r0 + rows], q_pos[r0:r0 + rows]
                m = torch.full((qr.shape[0],), -1e30)
                l = torch.zeros(qr.shape[0])
                acc = torch.zeros(qr.shape[0], hd)
                for k0 in range(0, K.shape[0], keys):
                    kp, vt = k_pos[k0:k0 + keys], V[k0:k0 + keys]
                    if causal and not kp[0] <= qp[-1]:
                        continue
                    if window and not kp[-1] > qp[0] - window:
                        continue
                    s = qr @ K[k0:k0 + keys].T
                    s = (cap * torch.tanh(s * scale / cap) * LOG2E if cap
                         else s * (scale * LOG2E))
                    ok = torch.ones_like(s, dtype=torch.bool)
                    if causal:
                        ok &= qp[:, None] >= kp[None, :]
                    if window:
                        ok &= (qp[:, None] - kp[None, :]) < window
                    s = torch.where(ok, s, neg)
                    m_new = torch.maximum(m, s.max(-1).values)
                    corr = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new[:, None])
                    hi = p.to(torch.bfloat16).float()
                    acc = acc * corr[:, None] + hi @ vt
                    if split:
                        acc = acc + (p - hi).to(torch.bfloat16).float() @ vt
                    l = l * corr + p.sum(-1)
                    m = m_new
                out[b, r0:r0 + rows, h] = acc / l.clamp_min(1e-30)[:, None]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,cap", [
    (1, 256, 4, 2, 64, True, 0, 0.0),      # GQA
    (1, 256, 2, 2, 128, True, 0, 0.0),     # granite's head dim
    (1, 200, 4, 1, 112, True, 64, 30.0),   # zamba2's, MQA, ragged, window
    (1, 128, 2, 2, 64, False, 0, 0.0),     # non-causal
])
def test_tensor_core_rounding_against_pallas_in_f32(B, S, H, KV, hd, causal,
                                                    window, cap, split):
    """The tensor-core kernel's rounding on bf16 inputs, emulated, against
    the reference's Pallas kernel in interpret mode on the same values in
    f32 (the function the TPU kernel computes: f32 scores, f32 P·V): with
    P split into two bf16 halves it stays within the row limit, using
    under 0.5 of it, as the output's own rounding does; with bf16 P alone
    it goes far over (tens of times the limit), which is why the kernel
    splits P."""
    arrays = [a.astype(np.float32) for a in _qkv(B, S, S, H, KV, hd)]
    _, (q, k, v) = _both(arrays, "bfloat16")
    pos = np.arange(S, dtype=np.int32)
    blk = 64 if S % 64 == 0 else S
    want = jops.flash_attention(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
        jnp.asarray(pos), jnp.asarray(pos), causal=causal, window=window,
        logit_cap=cap, block_q=blk, block_k=blk)
    want32 = torch.from_numpy(np.array(want, np.float32))
    tp = torch.from_numpy(pos)
    got = _emulate_tc(q, k, v, tp, tp, causal=causal, window=window, cap=cap,
                      split=split)
    used = _row_limit_used(got, want32)
    if split:
        assert used < 0.5, used
    else:
        assert used > 10.0, used


@pytest.mark.parametrize("case,want", [
    ("bf16 hd128", "tc"), ("bf16 hd64", "tc"), ("bf16 hd112", "tc"),
    ("f32", "fma"), ("bf16 hd256", "fma"), ("pointer", "fma"),
    ("stride", "fma"), ("length-1 head axis", "tc")])
def test_route_follows_dtype_head_dim_and_alignment(case, want):
    """The wrapper's rule, decided from the inputs alone: bf16 at hd 64,
    112 or 128 whose q, k, v TMA can address runs on the tensor cores,
    anything else on the FMA kernel."""
    hd = {"bf16 hd64": 64, "bf16 hd112": 112, "bf16 hd256": 256}.get(case, 128)
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    H = 1 if case == "length-1 head axis" else 4
    q = torch.zeros(2, 16, H, hd, dtype=dtype)
    k = v = torch.zeros(2, 16, 1 if H == 1 else 2, hd, dtype=dtype)
    if case == "pointer":
        q = torch.zeros(2 * 16 * H * hd + 1, dtype=dtype)[1:].view(2, 16, H, hd)
    elif case == "stride":
        q = torch.zeros(2, 16, H, hd + 4, dtype=dtype)[..., :hd]
    elif case == "length-1 head axis":
        # a length-1 axis is only read at 0: its stride does not matter
        q = torch.zeros(2 * 16 * hd, dtype=dtype).as_strided(
            (2, 16, 1, hd), (16 * hd, hd, 3, 1))
    assert fa.route(q, k, v) == want


# ---------------------------- layers ------------------------------------------

def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 6, 4, 32), dtype=np.float32)
    w = rng.standard_normal(32, dtype=np.float32) * 0.1
    np.testing.assert_allclose(
        _np(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))),
        _np(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w))), **F32_TOL)
    pos = np.arange(6, dtype=np.int32) * 37
    np.testing.assert_allclose(
        _np(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)),
        _np(JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)), **F32_TOL)


@pytest.mark.parametrize("window,cap,causal", [
    (0, 0.0, True), (24, 50.0, True), (0, 0.0, False)])
def test_attention_blocked_matches_reference(window, cap, causal):
    """Over 4 whole blocks the port's blocked attention matches the
    reference's; with a ragged last block it matches the full-score
    reference (the reference's blocked version pads T with keys that a
    causal mask without a window leaves visible, so it is not the oracle
    there)."""
    B, S, H, KV, hd = 2, 64, 4, 2, 16
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, S, S, H, KV, hd), "float32")
    pos = np.arange(S, dtype=np.int32)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)
    got = TL.attention_blocked(tq, tk, tv, tp, tp, block=16, **kw)
    want = JL.attention_blocked(jq, jk, jv, jp, jp, block=16, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    ragged = TL.attention_blocked(tq, tk, tv, tp, tp, block=24, **kw)
    full = JL.attention_reference(jq, jk, jv, jp, jp, **kw)
    np.testing.assert_allclose(_np(ragged), _np(full), **F32_TOL)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (8, 50.0)])
def test_decode_attention_matches_reference(window, cap):
    rng = np.random.default_rng(2)
    B, T, H, KV, hd = 3, 32, 4, 2, 16
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    kc = rng.standard_normal((B, T, KV, hd), dtype=np.float32)
    vc = rng.standard_normal((B, T, KV, hd), dtype=np.float32)
    pos = np.array([0, 13, 31], dtype=np.int32)
    got = TL.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc, pos)),
                              window=window, logit_cap=cap)
    want = JL.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc, pos)),
                               window=window, logit_cap=cap)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_mlp_unembed_and_loss_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32), dtype=np.float32)
    wi = rng.standard_normal((32, 96), dtype=np.float32) * 0.2
    wo = rng.standard_normal((48, 32), dtype=np.float32) * 0.2
    head = rng.standard_normal((32, 50), dtype=np.float32)
    labels = rng.integers(0, 50, size=(2, 5)).astype(np.int32)
    t, j = torch.from_numpy, jnp.asarray
    np.testing.assert_allclose(_np(TL.swiglu(t(x), t(wi), t(wo))),
                               _np(JL.swiglu(j(x), j(wi), j(wo))), **F32_TOL)
    for cap in (0.0, 30.0):
        got = TL.unembed(t(x), t(head), cap)
        want = JL.unembed(j(x), j(head), cap)
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(
        TL.cross_entropy(got, t(labels)).item(),
        float(JL.cross_entropy(want, j(labels))), **F32_TOL)


# ---------------------------- the CUDA kernel ---------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype,B,S,T,H,KV,hd,causal,window,cap", [
    ("bfloat16", 1, 512, 512, 8, 2, 128, True, 0, 0.0),
    ("bfloat16", 1, 300, 300, 4, 2, 256, True, 128, 50.0),
    ("float32", 2, 256, 256, 4, 4, 64, True, 0, 0.0),
    ("float32", 1, 200, 200, 4, 1, 64, False, 0, 0.0),
    ("bfloat16", 2, 300, 300, 4, 4, 112, True, 0, 0.0),
    ("float32", 1, 130, 130, 2, 2, 112, True, 64, 30.0),
])
def test_kernel_matches_plain_version_on_gpu(dtype, B, S, T, H, KV, hd,
                                             causal, window, cap):
    """The CUDA kernel against its plain version on the card, one launch
    per call (needs a card; skipped elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to("cuda", td)
               for a in _qkv(B, S, T, H, KV, hd))
    pos = torch.arange(S, device="cuda", dtype=torch.int32)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, pos, pos, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_ref(q, k, v, pos, pos, **kw)
    tol = (dict(rtol=3e-5, atol=3e-5) if dtype == "float32" and (window or cap)
           else _tol(dtype))
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **tol)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,window,cap", [
    (2, 512, 512, 8, 2, 64, True, 0, 0.0),      # hd 64, GQA
    (2, 384, 384, 4, 4, 112, True, 0, 0.0),     # zamba2's head dim
    (1, 640, 640, 8, 2, 128, True, 0, 0.0),     # granite's
    (1, 300, 300, 4, 2, 128, True, 0, 0.0),     # ragged S
    (2, 256, 256, 8, 1, 128, True, 0, 0.0),     # MQA
    (1, 520, 520, 4, 2, 112, True, 200, 30.0),  # window and softcap
    (2, 200, 330, 4, 2, 64, False, 0, 0.0),     # non-causal, S != T
])
def test_tensor_core_route_on_gpu(B, S, T, H, KV, hd, causal, window, cap):
    """bf16 at hd 64/112/128 runs the tensor-core kernel (one launch,
    counted in ``tc_launches``) and holds the card's checks: the plain
    version in bf16 at 2e-2, and the plain version in f32 on the same
    values within the row limit."""
    _needs_card()
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16)
               for a in _qkv(B, S, T, H, KV, hd))
    qp = torch.arange(T - S, T, device="cuda", dtype=torch.int32)
    kp = torch.arange(T, device="cuda", dtype=torch.int32)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    assert fa.route(q, k, v) == "tc"
    n, n_tc = fa.flash_attention.launches, fa.flash_attention.tc_launches
    got = fa.flash_attention(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1
    assert fa.flash_attention.tc_launches == n_tc + 1
    want = fa.flash_attention_ref(q, k, v, qp, kp, **kw)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()),
                               **_tol("bfloat16"))
    want32 = fa.flash_attention_ref(q.float(), k.float(), v.float(), qp, kp,
                                    **kw)
    assert _row_limit_used(got.cpu(), want32.cpu()) <= 1.0


@pytest.mark.gpu
def test_misaligned_bf16_operand_takes_the_fma_route_on_gpu():
    """A bf16 operand that TMA cannot address (a pointer off 16 bytes)
    runs on the FMA kernel, as the route rule says: one launch, none on
    the tensor cores, and the same answer."""
    _needs_card()
    B, S, H, KV, hd = 1, 256, 4, 2, 128
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16)
               for a in _qkv(B, S, S, H, KV, hd))
    buf = torch.empty(q.numel() + 1, device="cuda", dtype=torch.bfloat16)
    q_off = buf[1:].view(q.shape)
    q_off.copy_(q)
    pos = torch.arange(S, device="cuda", dtype=torch.int32)
    assert fa.route(q_off, k, v) == "fma"
    n, n_tc = fa.flash_attention.launches, fa.flash_attention.tc_launches
    got = fa.flash_attention(q_off, k, v, pos, pos)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1
    assert fa.flash_attention.tc_launches == n_tc
    np.testing.assert_allclose(
        _np(got.cpu()), _np(fa.flash_attention_ref(q, k, v, pos, pos).cpu()),
        **_tol("bfloat16"))
