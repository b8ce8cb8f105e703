"""The port's flash decode (``repro_torch.kernels.decode_attention``)
against the reference's, on the CPU.

* the port's flash decode on CPU tensors (its plain version, the grouped
  einsum) against the reference's Pallas kernel in interpret mode and its
  oracle, at the shapes and tolerances of ``tests/test_kernels.py`` (f32
  2e-5, bf16 2e-2), with hd 112 (zamba2), ragged positions, a window and
  a softcap; keys past ``pos`` have no influence;
* ``layers.decode_attention`` runs the kernel's entry point under
  ``pallas``; the dense model's decode steps under ``pallas`` match the
  reference's;
* the wrapper's persistent grid (one full wave, shares of 16-key groups)
  and its route rule; its contract: CPU calls do not count launches,
  inputs the kernel does not take raise; the CUDA kernels against their
  plain version, at the four serving shapes too (``gpu`` marker, skipped
  without a card);
* the tensor-core kernel's arithmetic (bf16 Q.K^T with f32 sums, the
  online softmax in f32, P split into two bf16 halves, its grid's warp
  and segment merges), emulated in plain PyTorch, against the
  reference's Pallas kernel in f32 within the card's row limit, and
  bf16-only P shown to miss that limit.

Inputs are made with numpy from a seed and handed to both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the reference runs on the CPU also where a GPU is present: the
# tolerances here are set against its CPU results
jax.config.update("jax_platforms", "cpu")

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.steps import build_serve_step as jax_serve_step
from repro.models.sharding import ModelContext as JaxCtx
from repro.models.zoo import build_model as jax_build
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import KERNELS, ops
from repro_torch.kernels import decode_attention as fd
from repro_torch.launch.steps import build_serve_step
from repro_torch.models import layers as TL
from repro_torch.models.sharding import ModelContext
from repro_torch.models.transformer import params_from_jax

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(B, T, H, KV, hd, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, hd), dtype=np.float32),
            rng.standard_normal((B, T, KV, hd), dtype=np.float32),
            rng.standard_normal((B, T, KV, hd), dtype=np.float32))


def _both(arrays, dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,KV,hd,bk", [
    (2, 256, 4, 4, 32, 64),
    (3, 512, 8, 2, 64, 128),
    (1, 128, 4, 1, 128, 64),
    (2, 256, 4, 4, 112, 64),     # zamba2's head dim
])
def test_plain_decode_matches_pallas_interpret_and_oracle(
        B, T, H, KV, hd, bk, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, T, H, KV, hd), dtype)
    pos = np.random.default_rng(0).integers(1, T - 1, size=(B,)).astype(
        np.int32)
    got = ops.flash_decode(tq, tk, tv, torch.from_numpy(pos))
    assert got.dtype == tq.dtype and got.shape == (B, H, hd)
    pallas = jops.flash_decode(jq, jk, jv, jnp.asarray(pos), block_k=bk)
    oracle = jref.flash_decode_ref(jq, jk, jv, jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("window,cap", [(0, 0.0), (40, 0.0), (0, 50.0),
                                        (24, 30.0)])
def test_plain_decode_ragged_positions_window_softcap(window, cap):
    """Requests at different positions in one batch, among them the first
    and the last slot, each stopping at its own position."""
    B, T, H, KV, hd = 4, 256, 8, 2, 112
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, T, H, KV, hd, seed=3),
                                       "float32")
    pos = np.array([0, 37, 200, T - 1], np.int32)
    kw = dict(window=window, logit_cap=cap)
    got = fd.flash_decode(tq, tk, tv, torch.from_numpy(pos), **kw)
    pallas = jops.flash_decode(jq, jk, jv, jnp.asarray(pos), block_k=64, **kw)
    oracle = jref.flash_decode_ref(jq, jk, jv, jnp.asarray(pos), **kw)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=3e-5, atol=3e-5)


def test_plain_decode_respects_cache_length():
    """Entries beyond pos must not influence the output."""
    _, (q, kc, vc) = _both(_qkv(2, 128, 2, 2, 16, seed=4), "float32")
    pos = torch.tensor([40, 90], dtype=torch.int32)
    out1 = fd.flash_decode(q, kc, vc, pos)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[0, 60:], vc2[0, 60:] = 99.0, -99.0
    kc2[1, 91:], vc2[1, 91:] = -99.0, 99.0
    assert torch.equal(out1, fd.flash_decode(q, kc2, vc2, pos))


@pytest.mark.parametrize("impl", ["pallas", "reference"])
def test_layer_dispatch(impl, monkeypatch):
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return fd.flash_decode_ref(*a, **kw)
    monkeypatch.setattr(TL.kops, "flash_decode", spy)
    _, (q, kc, vc) = _both(_qkv(2, 32, 4, 2, 16, seed=5), "float32")
    pos = torch.tensor([3, 31], dtype=torch.int32)
    out = TL.decode_attention(q, kc, vc, pos, window=8, logit_cap=20.0,
                              ctx=ModelContext(attention_impl=impl))
    assert len(calls) == (impl == "pallas")
    assert torch.equal(out, fd.flash_decode_ref(q, kc, vc, pos, window=8,
                                                logit_cap=20.0))


@functools.cache
def _dense_pair(arch):
    jm = jax_build(jax_smoke(arch))
    params = jm.init_params(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    return jm, params, params_from_jax(tree, get_smoke_config(arch), "cpu")


@pytest.mark.parametrize("arch", ["granite-8b", "gemma2-9b"])
def test_dense_decode_under_pallas_matches_reference(arch):
    """The dense model's decode steps with every norm and decode attention
    on the kernels' entry points (on the CPU their plain versions)
    against the reference's, teacher-forced; the caches at the end."""
    jm, params, model = _dense_pair(arch)
    B, T, n_steps = 2, 20, 8
    V = get_smoke_config(arch).vocab_size
    toks = np.random.default_rng(6).integers(0, V, size=(B, n_steps)).astype(
        np.int32)
    jstep = jax.jit(jax_serve_step(jm, JaxCtx()))
    step = build_serve_step(model, ModelContext(attention_impl="pallas"))
    jcache, cache = jm.init_cache(B, T), model.init_cache(B, T)
    for t in range(n_steps):
        pos = np.array([t, t + 3], np.int32)
        want, jcache = jstep(params, jcache, jnp.asarray(toks[:, t]),
                             jnp.asarray(pos))
        got, cache = step(cache, torch.from_numpy(toks[:, t]),
                          torch.from_numpy(pos))
        np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(_np(cache[kv]), _np(jcache[kv]), **BF16_TOL)


@pytest.mark.parametrize("B,KV,G,T,hd,kernel,occ,kvu,ctas,cut", [
    (128, 8, 4, 2048, 128, "tc", 2, 1, 264, True),   # granite 128 x 2048
    (32, 8, 4, 8192, 128, "tc", 2, 1, 264, True),    # granite 32 x 8192
    (32, 32, 1, 4096, 112, "tc", 2, 2, 264, True),   # zamba2 32 x 4096
    (8, 32, 1, 16384, 112, "tc", 2, 2, 264, True),   # zamba2 8 x 16384
    (264, 1, 1, 256, 64, "tc", 2, 1, 264, False),    # a whole unit a CTA
    (3, 2, 4, 512, 112, "fma", 3, 1, 12, True),      # 256 keys a CTA
    (1, 1, 48, 100, 128, "tc", 2, 1, 1, False),      # three units of 16
    (2, 8, 2, 8192, 256, "fma", 1, 1, 132, True),
])
def test_splits(B, KV, G, T, hd, kernel, occ, kvu, ctas, cut):
    """The persistent grid on a 132-SM card: one full wave of SMs x the
    CTAs an SM the instance gets, unless that leaves a CTA under 256 keys;
    two KV heads a unit where a bf16 head row is not whole 64-byte
    granules (tensor-core kernel, hd 112); whether a share boundary cuts a
    unit (then partials are merged)."""
    gb, k, n, c = fd.plan(B, KV, G, T, hd, kernel, 132, occ)
    assert (k, n, c) == (kvu, ctas, cut)
    assert gb == fd.heads_per_unit(G, kernel)
    groups = B * KV * -(-G // gb) * -(-T // 16)
    assert n == 132 * occ or n * fd.MIN_CTA_KEYS <= groups * 16
    assert [fd.group_block(g) for g in (1, 2, 3, 4, 5, 8, 48)] == [
        1, 2, 4, 4, 8, 8, 8]
    assert [fd.heads_per_unit(g, "tc") for g in (1, 4, 16, 48)] == [
        1, 4, 16, 16]


@pytest.mark.parametrize("dtype,hd,want", [
    ("bfloat16", 128, "tc"), ("bfloat16", 112, "tc"), ("bfloat16", 64, "tc"),
    ("bfloat16", 256, "fma"), ("float32", 128, "fma")])
def test_route_follows_dtype_and_head_dim(dtype, hd, want):
    """bf16 at hd 64, 112 and 128 takes the tensor-core kernel; f32 and
    hd 256 the FMA kernel."""
    _, (q, kc, _) = _both(_qkv(1, 16, 2, 1, hd), dtype)
    assert fd.route(q, kc) == want


#: the row limit of the card's check (``chip_smoke._hold_rows``): twice one
#: bf16 rounding of the output plus 1e-4 of the row's RMS
ROW_ULP, ROW_ATOL = 2.0 ** -7, 1e-4


def _row_limit_used(got, want32):
    rms = want32.pow(2).mean(-1, keepdim=True).sqrt()
    diff = (got.float() - want32).abs()
    return (diff / (ROW_ULP * want32.abs() + ROW_ATOL * rms)).max().item()


def _lse_merge(parts):
    """(m, l, acc) triples merged by log-sum-exp."""
    m = torch.stack([p[0] for p in parts]).max(0).values
    w = [torch.exp(p[0] - m) for p in parts]
    l = sum(p[1] * wi for p, wi in zip(parts, w))
    acc = sum(p[2] * wi[:, None] for p, wi in zip(parts, w))
    return m, l, acc


def _emulate_tc_decode(q, k, v, pos, *, window, cap, ctas, split=True):
    """The tensor-core kernel's arithmetic in plain PyTorch, on the grid of
    ``ctas`` CTAs: each CTA's share of the (unit, 16-key group) sequence,
    cut into segments at unit boundaries (a unit of two KV heads takes
    them in turns, group by group); in a segment warp w takes the share's
    groups w, w + 4, ... (all of one KV head); per group the scores from
    the bf16
    values with f32 sums, scaled, softcapped and masked in f32 (keys
    outside [lo, pos] zero-filled, -1e30), the online softmax in f32, P.V
    as P_hi.V + P_lo.V (P_hi = bf16(P), P_lo = bf16(P - P_hi); only P_hi
    when ``split`` is False) summed in f32; the warps merged by log-sum-
    exp, then the segments of a cut unit; the output rounded to bf16."""
    B, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    gb = fd.heads_per_unit(G, "tc")
    kvu = fd.kv_heads_per_unit(KV, hd, "tc")
    n_gb = -(-G // gb)
    ng = kvu * -(-T // 16)
    W = B * (KV // kvu) * n_gb * ng
    scale = hd ** -0.5
    out = torch.zeros(B, H, hd)
    parts = {}
    for c in range(ctas):
        gs, ge = c * W // ctas, (c + 1) * W // ctas
        sa = gs
        while sa < ge:
            u = sa // ng
            sb = min(ge, (u + 1) * ng)
            g0 = u % n_gb * gb
            kv0 = u // n_gb % (KV // kvu) * kvu
            b = u // (n_gb * (KV // kvu))
            p = int(pos[b])
            lo, hi = (max(0, p - window + 1) if window else 0), min(T, p + 1)
            warps = {}
            for w in range(4):
                sub = (gs + w) % kvu   # the warp's KV head of the unit
                kvh = kv0 + sub
                heads = slice(kvh * G + g0, kvh * G + min(G, g0 + gb))
                qs = q[b, heads].float()
                m = torch.full((qs.shape[0],), -1e30)
                l = torch.zeros(qs.shape[0])
                acc = torch.zeros(qs.shape[0], hd)
                for x in range(gs + w, sb, 4):
                    key0 = (x - u * ng) // kvu * 16
                    if x < sa or not (key0 < hi and key0 + 16 > lo):
                        continue
                    keys = torch.arange(key0, key0 + 16)
                    ok = (keys >= lo) & (keys < hi)
                    kt = torch.zeros(16, hd)
                    vt = torch.zeros(16, hd)
                    kt[ok] = k[b, keys[ok], kvh].float()
                    vt[ok] = v[b, keys[ok], kvh].float()
                    s = (qs @ kt.T) * scale
                    if cap:
                        s = cap * torch.tanh(s / cap)
                    s = torch.where(ok, s, torch.tensor(-1e30))
                    mx = torch.maximum(m, s.max(-1).values)
                    corr = torch.exp(m - mx)
                    pr = torch.exp(s - mx[:, None])
                    ph = pr.to(torch.bfloat16).float()
                    pv = ph @ vt
                    if split:
                        pv = pv + (pr - ph).to(torch.bfloat16).float() @ vt
                    acc = acc * corr[:, None] + pv
                    l = l * corr + pr.sum(-1)
                    m = mx
                warps.setdefault(heads, []).append((m, l, acc))
            for heads, states in warps.items():
                seg = _lse_merge(states)
                if sa == u * ng and sb == (u + 1) * ng:
                    out[b, heads] = seg[2] / seg[1].clamp_min(1e-30)[:, None]
                else:
                    parts.setdefault((b, heads.start, heads.stop),
                                     []).append(seg)
            sa = sb
    for (b, h0, h1), segs in parts.items():
        _, l, acc = _lse_merge(segs)
        out[b, h0:h1] = acc / l.clamp_min(1e-30)[:, None]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("B,T,H,KV,hd,window,cap,ctas", [
    (2, 512, 8, 2, 128, 0, 0.0, 5),      # granite's G = 4, cut units
    (3, 300, 4, 4, 112, 0, 0.0, 7),      # zamba2's G = 1, two KV heads a unit
    (2, 256, 8, 2, 64, 40, 30.0, 3),     # window and softcap
    (1, 200, 20, 1, 128, 0, 0.0, 1),     # 20 heads: units of 16 and 4
])
def test_tensor_core_rounding_against_pallas_in_f32(B, T, H, KV, hd, window,
                                                    cap, ctas, split):
    """The tensor-core kernel's rounding on bf16 inputs, emulated on its
    grid (ragged positions, one request at T - 1), against the reference's
    Pallas kernel in interpret mode on the same values in f32: with P split
    into two bf16 halves it stays within the card's row limit, using under
    0.5 of it as the output's own rounding does, and matches the plain
    version at the bf16 tolerance; with bf16 P alone it goes far over
    (10 to 25 times the limit here), which is why the kernel splits P."""
    arrays = _qkv(B, T, H, KV, hd, seed=11)
    _, (q, k, v) = _both(arrays, "bfloat16")
    pos = np.random.default_rng(12).integers(0, T, size=(B,)).astype(
        np.int32)
    pos[0] = T - 1
    want = jops.flash_decode(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
                             jnp.asarray(pos), block_k=64 if T % 64 == 0 else T,
                             window=window, logit_cap=cap)
    want32 = torch.from_numpy(np.array(want, np.float32))
    tp = torch.from_numpy(pos)
    got = _emulate_tc_decode(q, k, v, tp, window=window, cap=cap, ctas=ctas,
                             split=split)
    used = _row_limit_used(got, want32)
    if split:
        assert used < 0.5, used
        plain = fd.flash_decode_ref(q, k, v, tp, window=window, logit_cap=cap)
        np.testing.assert_allclose(_np(got), _np(plain), **BF16_TOL)
    else:
        assert used > 5.0, used


def test_cpu_calls_run_the_plain_version_and_do_not_count():
    _, (q, kc, vc) = _both(_qkv(2, 64, 4, 2, 64), "bfloat16")
    pos = torch.tensor([10, 63])
    before = fd.flash_decode.launches
    out = fd.flash_decode(q, kc, vc, pos, window=16, logit_cap=20.0)
    assert fd.flash_decode.launches == before
    assert torch.equal(out, fd.flash_decode_ref(q, kc, vc, pos, window=16,
                                                logit_cap=20.0))
    assert KERNELS["flash_decode"] is fd.flash_decode


@pytest.mark.parametrize("bad", ["dtype", "kv_shape", "heads", "pos_shape",
                                 "float_pos", "window"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, (q, kc, vc) = _both(_qkv(2, 16, 4, 2, 64), "float32")
    pos = torch.tensor([3, 5])
    kw = {}
    if bad == "dtype":
        kc = kc.to(torch.bfloat16)
    elif bad == "kv_shape":
        vc = vc[:, :8]
    elif bad == "heads":
        _, (q, kc, vc) = _both(_qkv(2, 16, 4, 3, 64), "float32")
    elif bad == "pos_shape":
        pos = torch.tensor([3])
    elif bad == "float_pos":
        pos = pos.float()
    else:
        kw = dict(window=-1)
    with pytest.raises((TypeError, ValueError)):
        fd.flash_decode(q, kc, vc, pos, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,B,T,H,KV,hd,window,cap", [
    ("bfloat16", 4, 2048, 32, 8, 128, 0, 0.0),     # granite, few CTAs
    ("bfloat16", 1, 20000, 32, 32, 112, 0, 0.0),   # zamba2, one long request
    ("bfloat16", 2, 3000, 16, 8, 256, 1000, 50.0),  # gemma2 local
    ("float32", 3, 512, 8, 2, 64, 0, 0.0),
    ("float32", 2, 777, 48, 1, 128, 0, 0.0),       # MQA, six head blocks
    ("bfloat16", 2, 777, 48, 1, 64, 100, 30.0),    # MQA, three units of 16
    ("bfloat16", 128, 2048, 32, 8, 128, 0, 0.0),   # the serving shapes
    ("bfloat16", 32, 8192, 32, 8, 128, 0, 0.0),
    ("bfloat16", 32, 4096, 32, 32, 112, 0, 0.0),
    ("bfloat16", 8, 16384, 32, 32, 112, 0, 0.0),
])
def test_kernel_matches_plain_version_on_gpu(dtype, B, T, H, KV, hd, window,
                                             cap):
    """The CUDA kernel against its plain version on the card, ragged
    positions, one launch per call on the route the wrapper's rule picks,
    and no change when the cache past each position is overwritten (needs
    a card; skipped elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    td = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(1)
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(td)
    kc = torch.randn(B, T, KV, hd, generator=g, device="cuda").to(td)
    vc = torch.randn(B, T, KV, hd, generator=g, device="cuda").to(td)
    pos = torch.randint(0, T, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    pos[0] = T - 1
    kw = dict(window=window, logit_cap=cap)
    before = fd.flash_decode.launches
    tc_before = fd.flash_decode.tc_launches
    got = fd.flash_decode(q, kc, vc, pos, **kw)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    assert fd.flash_decode.tc_launches - tc_before == (
        fd.route(q, kc) == "tc")
    want = fd.flash_decode_ref(q, kc, vc, pos, **kw)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **_tol(dtype))
    past = torch.arange(T, device="cuda")[None, :] > pos[:, None]
    kc[past], vc[past] = 1e4, -1e4
    assert torch.equal(got, fd.flash_decode(q, kc, vc, pos, **kw))
