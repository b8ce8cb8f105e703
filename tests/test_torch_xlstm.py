"""The port's xLSTM (``repro_torch.models.xlstm``, the ``ssm`` family:
xlstm-1.3b) against the reference's ``repro.models.xlstm``, on the CPU.

Inputs are made with numpy from a seed; whole models carry the
reference's smoke-config parameters over with ``params_from_jax``.
Tolerances: the mLSTM and sLSTM functions in float32 within 2e-5 (rtol
= atol; measured at most 6.7e-6 on values of order 1, the reference and
the port summing in different orders); the port's chunked form against
its own step-by-step recurrence within the reference's own 2e-4
(``tests/test_models.py``); blocks and whole models at bf16 tolerance
(rtol = atol = 2e-2), as the other families' tests: activations are
bf16 in both packages, which round at different places.  Decode states
are f32 and held at that bf16 tolerance too, since they take bf16
projections.  ``pallas`` runs the port's norms through the RMSNorm
kernel's entry point (on the CPU its plain version); the reference's
xLSTM never calls its Pallas kernel.  Training is held with
``tests/test_torch_train.py``'s checks: loss, gradients with f32
activations within 1e-4 and with bf16 within 2e-2 plus the reference's
own bf16 rounding, three microbatched train steps by their losses, grad
norms and each leaf's trained change.  JAX is kept on the CPU also where
a GPU is present (``jax_platforms``), as every file here that runs the
port on the card keeps it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch.serve import generate as jax_generate
from repro.launch.steps import build_prefill_step as jax_prefill_step
from repro.launch.steps import build_serve_step as jax_serve_step
from repro.models import xlstm as ref
from repro.models.sharding import ModelContext as JaxCtx
from repro.models.zoo import build_model as jax_build
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.launch.train import run as train_run
from repro_torch.models import xlstm, zoo
from repro_torch.models.sharding import ModelContext
from repro_torch.models.zoo import build_model
from test_torch_train import (
    DW_TOL_BF16, DW_TOL_F32, _args, _f32, _grads, _hold_trained, _ref_leaf,
    _trained)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
ARCH = "xlstm-1.3b"
B = 2
IMPLS = {
    "reference": (ModelContext(attention_impl="reference"),
                  JaxCtx(attention_impl="reference")),
    "pallas": (ModelContext(attention_impl="pallas"),
               JaxCtx(attention_impl="pallas", interpret=True)),
}


@functools.cache
def _pair():
    """(reference model, its params, the port's model on the same weights)."""
    jm = jax_build(jax_smoke(ARCH))
    params = jm.init_params(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    return jm, params, xlstm.params_from_jax(tree, get_smoke_config(ARCH),
                                             "cpu")


def _tokens(shape, seed=0):
    V = get_smoke_config(ARCH).vocab_size
    return np.random.default_rng(seed).integers(0, V, size=shape).astype(
        np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _mlstm_inputs(seed: int, Bb=2, S=64, nh=3, hd=8):
    """q, k, v (Bb, S, nh, hd), input and forget logits (Bb, S, nh), f32;
    forget logits around +2, as the forget gate's bias puts them."""
    g = np.random.default_rng(seed)
    f = lambda *s: g.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(Bb, S, nh, hd), f(Bb, S, nh, hd), f(Bb, S, nh, hd),
            f(Bb, S, nh), f(Bb, S, nh) + 2.0)


def _mlstm_state(seed: int, Bb=2, nh=3, hd=8):
    g = np.random.default_rng(seed)
    return (g.standard_normal((Bb, nh, hd, hd)).astype(np.float32),
            g.standard_normal((Bb, nh, hd)).astype(np.float32))


def _slstm_state(seed: int, Bb=2, d_in=16):
    """(c, n, h) f32 with n >= 1, as a scan from (0, 1, 0) keeps it."""
    g = np.random.default_rng(seed)
    return (g.standard_normal((Bb, d_in)).astype(np.float32),
            1.0 + np.abs(g.standard_normal((Bb, d_in))).astype(np.float32),
            0.5 * g.standard_normal((Bb, d_in)).astype(np.float32))


def _t(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# --------------------------------------------------------------------------
# the recurrences
# --------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk,with_state", [
    (64, 16, False), (64, 16, True), (40, 16, False), (64, 64, True)])
def test_mlstm_chunked_matches_reference(S, chunk, with_state):
    """Four chunks, with and without an initial state; S not a multiple
    of the chunk (the reference's fallback to one chunk); one chunk."""
    ins = _mlstm_inputs(S + chunk, S=S)
    st = _mlstm_state(1) if with_state else None
    want, (wC, wn) = ref.mlstm_chunked(*_j(ins), chunk=chunk,
                                       init_state=st and _j(st))
    got, (gC, gn) = xlstm.mlstm_chunked(*_t(ins), chunk=chunk,
                                        init_state=st and _t(st))
    assert got.shape == want.shape and got.dtype == torch.float32
    for a, b in ((got, want), (gC, wC), (gn, wn)):
        np.testing.assert_allclose(_np(a), _np(b), **F32_TOL)


def test_mlstm_chunked_returns_the_input_dtype():
    ins = _t(_mlstm_inputs(3, S=32))
    q, k, v = (t.bfloat16() for t in ins[:3])
    got, (C, n) = xlstm.mlstm_chunked(q, k, v, *ins[3:], chunk=16)
    assert got.dtype == torch.bfloat16
    assert C.dtype == n.dtype == torch.float32


def test_mlstm_decode_step_matches_reference_and_updates_in_place():
    q, k, v, ig, fg = (a[:, 0] for a in _mlstm_inputs(5))
    st = _mlstm_state(6)
    want, (wC, wn) = ref.mlstm_decode_step(*_j((q, k, v, ig, fg)), _j(st))
    state = _t(st)
    got, (gC, gn) = xlstm.mlstm_decode_step(*_t((q, k, v, ig, fg)), state)
    assert gC is state[0] and gn is state[1]
    for a, b in ((got, want), (gC, wC), (gn, wn)):
        np.testing.assert_allclose(_np(a), _np(b), **F32_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches_reference(with_state):
    g = np.random.default_rng(7)
    zifo = g.standard_normal((B, 24, 4, 16)).astype(np.float32)
    r = (0.5 * g.standard_normal((4, 16))).astype(np.float32)
    st = _slstm_state(8) if with_state else None
    want, wst = ref.slstm_scan(jnp.asarray(zifo), jnp.asarray(r), 2,
                               init_state=st and _j(st))
    got, gst = xlstm.slstm_scan(torch.from_numpy(zifo), torch.from_numpy(r),
                                2, init_state=st and _t(st))
    assert got.shape == want.shape == (B, 24, 16)
    for a, b in ((got, want), *zip(gst, wst)):
        np.testing.assert_allclose(_np(a), _np(b), **F32_TOL)


def test_slstm_decode_step_matches_reference_and_updates_in_place():
    g = np.random.default_rng(9)
    zifo = g.standard_normal((B, 4, 16)).astype(np.float32)
    r = (0.5 * g.standard_normal((4, 16))).astype(np.float32)
    st = _slstm_state(10)
    want, wst = ref.slstm_decode_step(jnp.asarray(zifo), jnp.asarray(r),
                                      _j(st))
    state = _t(st)
    got, gst = xlstm.slstm_decode_step(torch.from_numpy(zifo),
                                       torch.from_numpy(r), state)
    assert all(a is b for a, b in zip(gst, state))
    for a, b in ((got, want), *zip(gst, wst)):
        np.testing.assert_allclose(_np(a), _np(b), **F32_TOL)


def test_slstm_scan_backward_is_the_gradient():
    """``_SLSTMScan``'s written-out backward against finite differences in
    float64 (``gradcheck``), with input-gate logits past the clamp and
    normalizers below 1, and against autograd through the position loop
    in float32 within 1e-6 of each gradient's max."""
    g = torch.Generator().manual_seed(0)
    f64 = dict(dtype=torch.float64)
    x = torch.randn(2, 7, 4, 5, generator=g, **f64)
    x[:, :, 1] *= 6.0
    args = [x, 0.5 * torch.randn(4, 5, generator=g, **f64),
            torch.randn(2, 5, generator=g, **f64),
            0.5 + torch.rand(2, 5, generator=g, **f64),
            torch.randn(2, 5, generator=g, **f64)]
    assert torch.autograd.gradcheck(
        xlstm._SLSTMScan.apply, [a.requires_grad_() for a in args])
    zifo = 2.0 * torch.randn(3, 40, 4, 16, generator=g)
    r = 0.5 * torch.randn(4, 16, generator=g)
    w = torch.randn(3, 40, 16, generator=g)

    def loop(x, r):
        state, hs = xlstm._slstm_zero_state(3, 16, "cpu"), []
        for x_t in x.unbind(1):
            state = xlstm._slstm_step(x_t, r, state)[1]
            hs.append(state[2])
        return torch.stack(hs, 1), state

    grads = []
    for fn in (loop, lambda x, r: xlstm.slstm_scan(x, r, 2)):
        a, b = zifo.clone().requires_grad_(), r.clone().requires_grad_()
        hs, (c, n, h) = fn(a, b)
        ((hs * w).sum() + c.sum() + 2 * n.sum() + h.sum()).backward()
        grads.append((a.grad, b.grad))
    for want, got in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-6 * want.abs().max().item())


def test_mlstm_chunked_equals_stepwise():
    """The port's chunked mLSTM against its own step-by-step recurrence
    from the same initial state, as the reference's test holds its own."""
    q, k, v, ig, fg = _t(_mlstm_inputs(11, S=32))
    st = _t(_mlstm_state(12))
    h_chunk, (finC, finN) = xlstm.mlstm_chunked(
        q, k, v, ig, fg, chunk=8, init_state=st)
    state = tuple(s.clone() for s in st)
    h_step = torch.stack([xlstm.mlstm_decode_step(
        q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t], state)[0]
        for t in range(q.shape[1])], 1)
    for a, b in ((h_chunk, h_step), (finC, state[0]), (finN, state[1])):
        np.testing.assert_allclose(_np(a), _np(b), **STEP_TOL)


def test_slstm_scan_equals_stepwise():
    g = np.random.default_rng(13)
    zifo = torch.from_numpy(g.standard_normal((B, 12, 4, 16)).astype(
        np.float32))
    r = torch.from_numpy((0.5 * g.standard_normal((4, 16))).astype(
        np.float32))
    h_scan, fin = xlstm.slstm_scan(zifo, r, 2)
    state = xlstm.init_xlstm_state(B, 8, 2, True, "cpu")
    h_step = torch.stack([xlstm.slstm_decode_step(zifo[:, t], r, state)[0]
                          .clone() for t in range(12)], 1)
    torch.testing.assert_close(h_scan, h_step, rtol=0, atol=0)
    for a, b in zip(fin, state):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------


def _ref_state(cfg, i, seed):
    """A decode state of block ``i`` from a seed, numpy."""
    d_in = 2 * cfg.d_model
    if xlstm.slstm_flags(cfg)[i]:
        return _slstm_state(seed, d_in=d_in)
    return _mlstm_state(seed, nh=cfg.n_heads, hd=d_in // cfg.n_heads)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("i", [0, 1], ids=["mlstm", "slstm"])
def test_block_matches_reference(i, mode):
    """``xlstm_block`` of each kind (block 0 is mLSTM, block 1 sLSTM in the
    smoke config) on a bf16 input: a 64-token prefill, or one decode token
    against a state from a seed; the output and the new state."""
    cfg = get_smoke_config(ARCH)
    assert xlstm.slstm_flags(cfg)[i] == bool(i)
    _, params, model = _pair()
    p_i = jax.tree.map(lambda a: a[i], params["blocks"])
    S = 64 if mode == "prefill" else 1
    x = (np.random.default_rng(20 + i).standard_normal(
        (B, S, cfg.d_model)) * 0.5).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    st = _ref_state(cfg, i, 30 + i) if mode == "decode" else None
    want, wst = ref.xlstm_block(xj, p_i, n_heads=cfg.n_heads,
                                is_slstm=bool(i), ctx=JaxCtx(),
                                decode_state=st and _j(st))
    state = st and _t(st)
    with torch.no_grad():
        got = model.blocks[i](xt, ModelContext(), state)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    if mode == "decode":
        for a, b in zip(state, wst):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(_np(a), _np(b), **BF16_TOL)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl,S", [("reference", 64), ("pallas", 64),
                                    ("reference", 512)])
def test_forward_matches_reference(impl, S):
    """One mLSTM chunk at 64 tokens, two at 512."""
    jm, params, model = _pair()
    tok = _tokens((B, S), seed=S)
    ctx, jctx = IMPLS[impl]
    with torch.no_grad():
        got = model(torch.from_numpy(tok), ctx)
    want = jm.forward(params, {"tokens": jnp.asarray(tok)}, jctx)
    assert got.shape == want.shape == (B, S, get_smoke_config(ARCH).vocab_size)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_prefill_step_runs_every_norm_on_the_kernel_and_matches_reference(
        monkeypatch):
    """``build_prefill_step(last_only=True)`` under ``pallas``: the RMSNorm
    entry point once for each of the 2 x n_layers + 1 norms, logits as the
    reference's and as the full forward's last position."""
    jm, params, model = _pair()
    cfg = get_smoke_config(ARCH)
    tok = _tokens((B, 64), seed=1)
    calls = []
    real = ops._rmsnorm
    monkeypatch.setattr(ops, "_rmsnorm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    step = build_prefill_step(model, ModelContext(attention_impl="pallas"),
                              last_only=True)
    got = step(torch.from_numpy(tok))
    assert len(calls) == 2 * cfg.n_layers + 1
    want = jax_prefill_step(jm, JaxCtx(attention_impl="pallas"),
                            last_only=True)(params, {"tokens": jnp.asarray(tok)})
    assert got.shape == want.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    full = build_prefill_step(model, ModelContext(attention_impl="pallas"))(
        torch.from_numpy(tok))
    np.testing.assert_allclose(_np(full), _np(got), **BF16_TOL)
    np.testing.assert_allclose(_np(model.prefill(torch.from_numpy(tok))),
                               _np(got), **BF16_TOL)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_decode_steps_match_reference_teacher_forced(impl, monkeypatch):
    """8 decode steps: a 4-token prompt, then the reference's greedy
    tokens, fed to both; logits every step and every block's state at the
    end at bf16 tolerance; under ``pallas`` the RMSNorm entry point runs
    2 x n_layers + 1 times a step."""
    jm, params, model = _pair()
    cfg = get_smoke_config(ARCH)
    n_steps = 8
    prompt = _tokens((B, 4), seed=2)
    calls = []
    real = ops._rmsnorm
    monkeypatch.setattr(ops, "_rmsnorm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jstep = jax.jit(jax_serve_step(jm, JaxCtx()))
    step = build_serve_step(model, IMPLS[impl][0])
    jcache, cache = jm.init_cache(B, 12), model.init_cache(B, 12)
    cur = prompt[:, 0]
    for t in range(n_steps):
        pos = np.full((B,), t, np.int32)
        want, jcache = jstep(params, jcache, jnp.asarray(cur), jnp.asarray(pos))
        got, cache = step(cache, torch.from_numpy(cur), torch.from_numpy(pos))
        np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
        cur = (prompt[:, t + 1] if t + 1 < prompt.shape[1]
               else np.array(jnp.argmax(want, -1), np.int32))
    assert len(calls) == (n_steps * (2 * cfg.n_layers + 1)
                          if impl == "pallas" else 0)
    assert len(cache) == len(jcache) == cfg.n_layers
    for st, jst in zip(cache, jcache):
        assert len(st) == len(jst)
        for a, b in zip(st, jst):
            assert a.dtype == torch.float32 and a.shape == b.shape
            np.testing.assert_allclose(_np(a), _np(b), **BF16_TOL)


def test_chunked_forward_equals_decode_recurrence():
    """The port's whole model: the chunked prefill's logits at every
    position against the decode steps' from an empty cache (two mLSTM
    chunks at 512 tokens), at bf16 tolerance."""
    _, _, model = _pair()
    tok = torch.from_numpy(_tokens((B, 512), seed=4))
    with torch.no_grad():
        full = model(tok)
    step = build_serve_step(model, ModelContext())
    cache = model.init_cache(B)
    steps = [step(cache, tok[:, t], torch.full((B,), t, dtype=torch.int32))[0]
             for t in range(tok.shape[1])]
    np.testing.assert_allclose(_np(torch.stack(steps, 1)), _np(full),
                               **BF16_TOL)


def test_generate_matches_the_reference_shape():
    jm, params, model = _pair()
    prompt = _tokens((B, 5), seed=3)
    want = jax_generate(jm, params, jnp.asarray(prompt), 6)
    got = serve.generate(model, torch.from_numpy(prompt), 6,
                         ModelContext(attention_impl="pallas"))
    assert got.shape == want.shape == (B, 11) and got.dtype == torch.int32
    assert torch.equal(got[:, :5], torch.from_numpy(prompt))


def test_init_params_follow_the_reference_init():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    assert isinstance(model, xlstm.XLSTMLM)
    model.init_params(torch.Generator().manual_seed(0))
    nh = cfg.n_heads
    for blk in model.blocks:
        assert torch.equal(blk.gate_bias, torch.cat([
            torch.zeros(nh), torch.linspace(3.0, 6.0, nh)]))
        assert not blk.norm.any() and not blk.out_norm.any()
    assert not model.final_norm.any()
    big = torch.cat([torch.cat([b.up_proj.flatten(), b.qkv.flatten(),
                                b.down_proj.flatten()]).float()
                     for b in model.blocks])
    small = torch.cat([torch.cat([b.gates.flatten(), b.r_diag.flatten(),
                                  b.o_proj.flatten()]).float()
                       for b in model.blocks])
    assert 0.018 < big.std().item() < 0.022
    assert 0.008 < small.std().item() < 0.012
    assert 0.018 < model.embed.float().std().item() < 0.022
    assert 0.018 < model.lm_head.float().std().item() < 0.022
    _, params, _ = _pair()
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))


def test_parameters_dtypes_and_the_full_size_count():
    """To serve, the projections and the embedding in bf16, the norms,
    ``gate_bias`` and ``r_diag`` in f32; the full config's tree holds the
    reference's 4,637,886,848 parameters (built on the meta device)."""
    model = build_model(get_smoke_config(ARCH), "cpu")
    f32 = {"norm", "out_norm", "gate_bias", "r_diag", "final_norm"}
    for name, p in model.named_parameters():
        want = torch.float32 if name.split(".")[-1] in f32 else torch.bfloat16
        assert p.dtype == want and not p.requires_grad, name
    full = xlstm.XLSTMLM(get_config(ARCH), "meta")
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        jax_build(jax_config(ARCH)).abstract_params()))
    assert sum(p.numel() for p in full.parameters()) == want == 4637886848
    assert xlstm.slstm_flags(get_config(ARCH)).count(True) == 6


def test_cache_layout():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    cache = model.init_cache(3, 10)
    jcache = jax_build(jax_smoke(ARCH)).init_cache(3, 10)
    assert len(cache) == cfg.n_layers
    for st, jst in zip(cache, jcache):
        assert [tuple(a.shape) for a in st] == [a.shape for a in jst]
        for a, b in zip(st, jst):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(_np(a), _np(b))


def test_params_from_jax_and_the_model_reject_bad_input():
    _, params, _ = _pair()
    tree = jax.tree.map(np.asarray, params)
    bad = dict(tree, blocks=dict(tree["blocks"], extra=tree["blocks"]["norm"]))
    with pytest.raises(KeyError):
        xlstm.params_from_jax(bad, get_smoke_config(ARCH), "cpu")
    with pytest.raises(NotImplementedError):
        xlstm.XLSTMLM(get_smoke_config("granite-8b"), "cpu")


def test_params_to_numpy_inverts_params_from_jax():
    cfg = get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, _pair()[1])
    got = xlstm.params_to_numpy(xlstm.params_from_jax(tree, cfg, "cpu",
                                                      trainable=True))
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    """A trainable model's state and its optimiser state saved and
    restored into a fresh model: every tensor equal."""
    from repro_torch.optim import AdamW
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu", trainable=True).init_params(
        torch.Generator().manual_seed(1))
    opt = AdamW(learning_rate=1e-3, decayed=model.decayed())
    state = opt.init(dict(model.named_parameters()))
    path = save_checkpoint(str(tmp_path), 3, (model.state_dict(), state))
    fresh = build_model(cfg, "cpu", trainable=True)
    fstate = opt.init(dict(fresh.named_parameters()))
    step, (params, ostate) = restore_checkpoint(
        path, (fresh.state_dict(), fstate))
    fresh.load_state_dict(params)
    assert step == 3
    for (n, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    flat = lambda t: jax.tree.leaves(  # noqa: E731
        jax.tree.map(lambda x: x.numpy(), t))
    for a, b in zip(flat(state), flat(ostate)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# training (``tests/test_torch_train.py``'s checks)
# --------------------------------------------------------------------------


def _grad(model, name: str) -> np.ndarray:
    """The port's gradient of ``name``, f32; zero where the loss does not
    reach the weight (an mLSTM block's ``r_diag`` and ``o_proj``, an sLSTM
    block's ``gates`` and ``gate_bias``), which then has no ``.grad``, as
    the reference's gradient there is zero."""
    p = model.get_parameter(name)
    parts = name.split(".")
    unused = parts[0] == "blocks" and parts[2] in (
        ("gates", "gate_bias") if model.blocks[int(parts[1])].is_slstm
        else ("r_diag", "o_proj"))
    assert (p.grad is None) == unused, name
    if unused:
        return np.zeros(p.shape, np.float32)
    assert p.grad.dtype == torch.float32, name
    return p.grad.numpy()


@pytest.mark.parametrize("masked", [False, True])
def test_loss_matches_reference(masked):
    from test_torch_train import _batches, _port, _torch, _tree
    batch = _batches(ARCH, 1)[0]
    if masked:
        batch["loss_mask"] = (np.arange(batch["tokens"].shape[1])[None] % 3
                              != 0).repeat(batch["tokens"].shape[0], 0
                                           ).astype(np.float32)
    jm = jax_build(jax_smoke(ARCH))
    want = jm.loss(_tree(ARCH), {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = zoo.loss(_port(ARCH), _torch(batch))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), **BF16_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_f32_gradients_match_reference(remat, monkeypatch):
    """With float32 activations in both packages, every parameter's
    gradient within 1e-4 of its reference leaf's max |g|."""
    from test_torch_train import _batches
    grads, model = _grads(ARCH, remat, _batches(ARCH, 1, seed=3)[0],
                          monkeypatch, f32=True)
    for name, p in model.named_parameters():
        want, leaf = _ref_leaf(grads, name)
        np.testing.assert_allclose(_grad(model, name), want, rtol=0,
                                   atol=1e-4 * np.abs(leaf).max(),
                                   err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_reference(remat, monkeypatch):
    """With bf16 activations, every parameter's gradient within 2e-2 of
    its reference leaf's max |g| plus the reference's own bf16 rounding
    there (its bf16 gradient against its f32 one)."""
    from test_torch_train import _batches
    batch = _batches(ARCH, 1, seed=3)[0]
    grads, model = _grads(ARCH, remat, batch, monkeypatch, f32=False)
    with monkeypatch.context() as m:
        grads32, _ = _grads(ARCH, remat, batch, m, f32=True)
    for name, p in model.named_parameters():
        want, leaf = _ref_leaf(grads, name)
        noise = np.abs(leaf - _ref_leaf(grads32, name)[1]).max()
        np.testing.assert_allclose(_grad(model, name), want, rtol=0,
                                   atol=2e-2 * np.abs(leaf).max() + noise,
                                   err_msg=name)


def test_remat_gives_the_same_gradients():
    from test_torch_train import _batches, _port, _torch
    out = []
    for remat in (False, True):
        model = _port(ARCH, remat=remat)
        zoo.loss(model, _torch(_batches(ARCH, 1)[0])).backward()
        out.append({n: p.grad for n, p in model.named_parameters()
                    if p.grad is not None})
    assert out[0].keys() == out[1].keys()
    for n in out[0]:
        torch.testing.assert_close(out[0][n], out[1][n], rtol=0, atol=0)


@pytest.mark.parametrize("M", [1, 2])
def test_train_steps_match_reference(M):
    """Three ``build_train_step`` steps against the reference's with bf16
    activations: losses and grad norms within 2e-2 relative, each leaf's
    trained change within ``DW_TOL_BF16``."""
    _hold_trained(*_trained(ARCH, M), rtol=2e-2, dw_tol=DW_TOL_BF16)


@pytest.mark.parametrize("M", [1, 2])
def test_f32_train_steps_match_reference(M, monkeypatch):
    """The same three steps with float32 activations: within 1e-4
    relative and ``DW_TOL_F32``."""
    _f32(monkeypatch)
    _hold_trained(*_trained(ARCH, M), rtol=1e-4, dw_tol=DW_TOL_F32)


def test_training_under_pallas_raises():
    from test_torch_train import _batches, _port, _torch
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import AdamW
    model = _port(ARCH)
    opt = AdamW(learning_rate=1e-3, decayed=model.decayed())
    step = build_train_step(model, opt, ModelContext(attention_impl="pallas"))
    with pytest.raises(RuntimeError, match="forward-only"):
        step(opt.init(dict(model.named_parameters())),
             _torch(_batches(ARCH, 1)[0]))


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def test_serve_main_runs_on_cpu(capsys):
    serve.main(["--arch", "xlstm-1.3b-smoke", "--batch", "2", "--prompt-len",
                "3", "--max-new", "2", "--device", "cpu"])
    assert "generated (2, 5) on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("M", [1, 2])
def test_train_run_on_cpu_loss_decreases(M):
    out = train_run(_args(arch="xlstm-1.3b-smoke", microbatches=M, steps=15))
    assert len(out["losses"]) == 15
    assert isinstance(out["model"], xlstm.XLSTMLM)
    assert out["losses"][0] > out["final_loss"]


def test_train_run_resumes_from_its_checkpoint(tmp_path):
    kw = dict(arch="xlstm-1.3b-smoke", ckpt_dir=str(tmp_path), ckpt_every=3)
    train_run(_args(steps=6, **kw))
    assert len(train_run(_args(steps=8, **kw))["losses"]) == 2


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the CPU-only path")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_smoke_config(ARCH))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "xlstm-1.3b-smoke", "--max-new", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_run(_args(arch="xlstm-1.3b-smoke", steps=1, device="cuda"))


@pytest.mark.gpu
def test_smoke_model_on_gpu_matches_cpu():
    """The smoke model on the card under ``pallas`` (the RMSNorm kernel)
    and plain, against the same weights on the CPU: the prefill logits and
    eight decode steps at bf16 tolerance (needs a card; skipped
    elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cfg = get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, _pair()[1])
    cpu = xlstm.params_from_jax(tree, cfg, "cpu")
    gpu = xlstm.params_from_jax(tree, cfg, "cuda")
    tok = torch.from_numpy(_tokens((B, 512), seed=5))
    with torch.no_grad():
        want = cpu(tok).float()
        for impl in ("pallas", "reference"):
            got = gpu(tok.cuda(), ModelContext(attention_impl=impl))
            np.testing.assert_allclose(_np(got.cpu()), _np(want), **BF16_TOL)
    caches = [cpu.init_cache(B), gpu.init_cache(B)]
    steps = [build_serve_step(cpu, ModelContext()),
             build_serve_step(gpu, ModelContext(attention_impl="pallas"))]
    for t in range(8):
        pos = torch.full((B,), t, dtype=torch.int32)
        want, _ = steps[0](caches[0], tok[:, t], pos)
        got, _ = steps[1](caches[1], tok[:, t].cuda(), pos.cuda())
        np.testing.assert_allclose(_np(got.cpu()), _np(want), **BF16_TOL)
