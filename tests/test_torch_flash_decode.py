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
* how the wrapper cuts the keys into splits; its contract: CPU calls do
  not count launches, inputs the kernel does not take raise; the CUDA
  kernel against its plain version (``gpu`` marker, skipped without a
  card).

Inputs are made with numpy from a seed and handed to both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("B,KV,G,T,want", [
    (128, 8, 4, 2048, 1), (32, 8, 4, 8192, 3), (32, 32, 1, 4096, 1),
    (8, 32, 1, 16384, 3), (1, 32, 1, 65536, 17), (8, 8, 2, 8192, 9),
    (3, 2, 4, 512, 2), (1, 1, 48, 100, 1),
])
def test_splits(B, KV, G, T, want):
    """About four CTAs per SM of a 132-SM card, at least 256 keys each."""
    assert fd.n_splits(B, KV, G, T, 132) == want
    assert [fd.group_block(g) for g in (1, 2, 3, 4, 5, 8, 48)] == [
        1, 2, 4, 4, 8, 8, 8]


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
    ("bfloat16", 4, 2048, 32, 8, 128, 0, 0.0),     # granite, one split
    ("bfloat16", 1, 20000, 32, 32, 112, 0, 0.0),   # zamba2, many splits
    ("bfloat16", 2, 3000, 16, 8, 256, 1000, 50.0),  # gemma2 local
    ("float32", 3, 512, 8, 2, 64, 0, 0.0),
    ("float32", 2, 777, 48, 1, 128, 0, 0.0),       # MQA, two head blocks
])
def test_kernel_matches_plain_version_on_gpu(dtype, B, T, H, KV, hd, window,
                                             cap):
    """The CUDA kernel against its plain version on the card, ragged
    positions, one launch per call, and no change when the cache past
    each position is overwritten (needs a card; skipped elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    td = getattr(torch, dtype)
    q, kc, vc = (torch.from_numpy(a).to("cuda", td)
                 for a in _qkv(B, T, H, KV, hd))
    pos = torch.from_numpy(np.random.default_rng(1).integers(
        0, T, size=(B,)).astype(np.int32)).cuda()
    pos[0] = T - 1
    kw = dict(window=window, logit_cap=cap)
    before = fd.flash_decode.launches
    got = fd.flash_decode(q, kc, vc, pos, **kw)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    want = fd.flash_decode_ref(q, kc, vc, pos, **kw)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **_tol(dtype))
    past = torch.arange(T, device="cuda")[None, :] > pos[:, None]
    kc[past], vc[past] = 1e4, -1e4
    assert torch.equal(got, fd.flash_decode(q, kc, vc, pos, **kw))
