"""The MoE, audio and VLM families of the port (``repro_torch.models.moe``,
the MoE blocks and the batch frontends of ``models.transformer``, the
zoo's batches and loss, the prefill and decode steps) against the
reference's, on the CPU.

Inputs are made with numpy from a seed; whole models carry the
reference's smoke-config parameters over with ``params_from_jax``.
Tolerances: the MoE functions within 1e-6 (router, aux loss) and 1e-5
(f32) or 2e-2 (bf16); whole models at bf16 tolerance (rtol = atol =
2e-2), as the dense models' tests, and the two MoE models also with
float32 activations in both packages within 1e-4.  Routing is
discontinuous: where an expert choice flips between the packages, the
failure message shows the flip (``_routing_flips``), the reference's
gap between its k-th and (k+1)-th router logits at that token against
the two packages' router-logit difference there.  ``pallas`` runs the
reference's Pallas kernels in interpret mode and the port's plain
versions of its CUDA kernels; the ``gpu`` tests run the kernels on the
card against the reference on the CPU.  JAX is kept on the CPU also
where a GPU is present (``jax_platforms``): left to take the H100, the
reference's float32 prefill of the kernel-sized qwen3 model lay 6.7e-4
from the port's, past the 1e-4 this file holds float32 to.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.serve import generate as jax_generate
from repro.launch.steps import build_prefill_step as jax_prefill_step
from repro.launch.steps import build_serve_step as jax_serve_step
from repro.models import moe as ref_moe
from repro.models import transformer as ref_transformer
from repro.models.sharding import ModelContext as JaxCtx
from repro.models.zoo import build_model as jax_build
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import serve
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import moe, transformer, xlstm, zoo
from repro_torch.models.sharding import ModelContext
from repro_torch.models.transformer import params_from_jax, params_to_numpy

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
MOE_ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"]
ARCHS = MOE_ARCHS + ["musicgen-large", "pixtral-12b"]
B, S = 2, 64

#: port ctx, reference ctx, as ``tests/test_torch_model.py``'s: the port's
#: blocked forward is held to the reference's full-score forward
IMPLS = {
    "reference": (ModelContext(attention_impl="reference"),
                  JaxCtx(attention_impl="reference")),
    "blocked": (ModelContext(attention_impl="auto", blocked_threshold=16),
                JaxCtx(attention_impl="reference")),
    "pallas": (ModelContext(attention_impl="pallas"),
               JaxCtx(attention_impl="pallas", interpret=True)),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _f32(monkeypatch) -> None:
    """Float32 activations in both packages: the reference's hard-coded
    bf16 cast of the embedding table patched to float32 in its
    transformer module, and the port's ``ACT_DTYPE``, as
    ``tests/test_torch_train.py`` does."""
    ns = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                  if not k.startswith("__")})
    ns.bfloat16 = jnp.float32
    monkeypatch.setattr(ref_transformer, "jnp", ns)
    monkeypatch.setattr(transformer, "ACT_DTYPE", torch.float32)


@functools.cache
def _ref(arch: str):
    """(the reference's model, its smoke params (seed 0), as numpy)."""
    jm = jax_build(jax_smoke(arch))
    params = jm.init_params(jax.random.key(0))
    return jm, params, jax.tree.map(np.asarray, params)


def _port(arch: str, f32: bool = False):
    """The port's model on the reference's weights: bf16 matmul weights to
    serve, or (``f32``) the f32 masters, exact."""
    return params_from_jax(_ref(arch)[2], get_smoke_config(arch), "cpu",
                           trainable=f32)


def _batch(arch: str, seed: int, f32: bool = False, b: int = B,
           s: int = S, cfg=None) -> tuple:
    """(reference batch, port batch) of ``arch``'s family (its smoke
    config unless ``cfg``) from numpy: token ids, audio frame embeddings
    or patch embeddings before ids; embeddings 0.02 x N(0, 1) in bf16
    (float32 with ``f32``)."""
    cfg = cfg or get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dtype) in zoo.batch_shapes(cfg, b, s).items():
        if name == "labels":
            continue
        if dtype.is_floating_point:
            out[name] = (0.02 * rng.standard_normal(shape)).astype(np.float32)
        else:
            out[name] = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    jd, td = (jnp.float32, torch.float32) if f32 else (jnp.bfloat16,
                                                       torch.bfloat16)
    jb = {k: jnp.asarray(v).astype(jd) if v.dtype == np.float32
          else jnp.asarray(v) for k, v in out.items()}
    tb = {k: torch.from_numpy(v).to(td) if v.dtype == np.float32
          else torch.from_numpy(v) for k, v in out.items()}
    return jb, tb


def _record(monkeypatch, module, store: list) -> None:
    """Record the input of each call to ``module.moe_block`` in ``store``."""
    orig = module.moe_block

    def rec(h, params, **kw):
        store.append((np.asarray(h, np.float32) if not isinstance(
            h, torch.Tensor) else _np(h), params["router"]))
        return orig(h, params, **kw)
    monkeypatch.setattr(module, "moe_block", rec)


def _routing_flips(arch: str, jb, tb, jctx, ctx, f32: bool = False) -> list:
    """Each token where the two packages' top-k experts differ, layer by
    layer over one forward: the reference's gap between its k-th and
    (k+1)-th router logits there and the largest difference between the
    two packages' router logits at that token.  A flip that rounding
    explains has gap <= 2 x difference.  The reference runs its layers
    unscanned, so that its MoE inputs are concrete."""
    cfg = get_smoke_config(arch)
    jm, params, _ = _ref(arch)
    jm_loop = jax_build(dataclasses.replace(jax_smoke(arch),
                                            scan_layers=False))
    ref_in, port_in = [], []
    with pytest.MonkeyPatch.context() as m:
        _record(m, ref_transformer, ref_in)
        _record(m, transformer, port_in)
        jm_loop.forward(params, jb, jctx)
        with torch.no_grad():
            _port(arch, f32=f32)(tb, ctx)
    k = cfg.experts_per_token
    flips = []
    for layer, ((hr, wr), (hp, wp)) in enumerate(zip(ref_in, port_in)):
        lr = hr.reshape(-1, cfg.d_model) @ np.asarray(wr, np.float32)
        lp = hp.reshape(-1, cfg.d_model) @ _np(wp)
        top_r = np.argsort(-lr, axis=-1)
        top_p = np.argsort(-lp, axis=-1)
        srt = -np.sort(-lr, axis=-1)
        for t in range(lr.shape[0]):
            if set(top_r[t, :k]) != set(top_p[t, :k]):
                flips.append(dict(layer=layer, token=t,
                                  gap=float(srt[t, k - 1] - srt[t, k]),
                                  logit_diff=float(
                                      np.abs(lr[t] - lp[t]).max())))
    return flips


def _hold_model(arch, got, want, tol, what, flips=None):
    """``got`` against ``want`` within ``tol``; on failure of an MoE model
    the message lists the routing flips (``flips()``)."""
    try:
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    except AssertionError as e:
        if flips is None:
            raise
        raise AssertionError(f"{arch} {what}: {e}\nrouting flips "
                             f"(reference top-k gap vs router-logit "
                             f"difference): {flips()}") from None


# --------------------------------------------------------------------------
# the MoE functions
# --------------------------------------------------------------------------


def _moe_params(rng, D, E, F, n_shared):
    p = {"router": rng.standard_normal((D, E)) * 0.5,
         "wi": rng.standard_normal((E, D, 2 * F)) * 0.1,
         "wo": rng.standard_normal((E, F, D)) * 0.1}
    if n_shared:
        p["wi_s"] = rng.standard_normal((D, 2 * F * n_shared)) * 0.1
        p["wo_s"] = rng.standard_normal((F * n_shared, D)) * 0.1
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_probs_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((96, 32)).astype(np.float32)
    w = (0.3 * rng.standard_normal((32, 16))).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    g, i, p = ref_moe.router_probs(jx, jnp.asarray(w), 4)
    tg, ti, tp = moe.router_probs(tx, torch.from_numpy(w), 4)
    assert tg.dtype == tp.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(i))
    np.testing.assert_allclose(tg.numpy(), np.asarray(g), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(p), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_load_balancing_loss_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((200, 32)).astype(np.float32)
    w = (0.3 * rng.standard_normal((32, 8))).astype(np.float32)
    _, i, p = ref_moe.router_probs(jnp.asarray(x), jnp.asarray(w), 2)
    _, ti, tp = moe.router_probs(torch.from_numpy(x), torch.from_numpy(w), 2)
    want = float(ref_moe.load_balancing_loss(p, i, 8))
    got = moe.load_balancing_loss(tp, ti, 8)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dense_and_block_match_reference(dtype, n_shared):
    """``moe_dense`` and ``moe_block`` (routed experts, plus shared
    experts) on the same inputs: f32 within 1e-5, bf16 within 2e-2."""
    rng = np.random.default_rng(2)
    D, E, F, k = 32, 8, 24, 2
    x = rng.standard_normal((3, 20, D)).astype(np.float32)
    params = _moe_params(rng, D, E, F, n_shared)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.from_numpy(v) for n, v in params.items()}
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    want = ref_moe.moe_dense(jx, jp, k)
    got = moe.moe_dense(tx, tp, k)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    kw = dict(k=k, n_experts=E, n_shared=n_shared, capacity_factor=1.25)
    want = ref_moe.moe_block(jx, jp, ctx=JaxCtx(), **kw)
    for ctx in (None, ModelContext(), ModelContext(moe_impl="dense")):
        got = moe.moe_block(tx, tp, ctx=ctx, **kw)
        np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_expert_ffn_matches_reference():
    rng = np.random.default_rng(3)
    p = _moe_params(rng, 16, 4, 12, 0)
    xs = rng.standard_normal((4, 5, 16)).astype(np.float32)
    want = ref_moe._expert_ffn(jnp.asarray(xs), jnp.asarray(p["wi"]),
                               jnp.asarray(p["wo"]))
    got = moe._expert_ffn(torch.from_numpy(xs), torch.from_numpy(p["wi"]),
                          torch.from_numpy(p["wo"]))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_model_context_moe_impl():
    """``"ep"`` is accepted, as in the reference, and raises where
    ``moe_ep`` runs without a mesh (the reference asserts there)."""
    assert ModelContext().moe_impl == JaxCtx().moe_impl == "auto"
    assert ModelContext(moe_impl="ep").moe_impl == JaxCtx(
        moe_impl="ep").moe_impl == "ep"
    rng = np.random.default_rng(3)
    p = {k: torch.from_numpy(v) for k, v in _moe_params(rng, 16, 4, 12,
                                                       0).items()}
    x = torch.from_numpy(rng.standard_normal((1, 3, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="mesh"):
        moe.moe_block(x, p, k=2, n_experts=4, n_shared=0,
                      capacity_factor=1.0, ctx=ModelContext(moe_impl="ep"))
    with pytest.raises(ValueError, match="moe_impl"):
        ModelContext(moe_impl="sparse")


# --------------------------------------------------------------------------
# the MoE models' parameters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_round_trip(arch):
    """``params_from_jax`` then ``params_to_numpy`` gives the reference's
    tree back: exactly for f32 masters; to serve, the matmul weights and
    experts rounded to bf16 and the router kept in f32."""
    tree = _ref(arch)[2]
    cfg = get_smoke_config(arch)
    back = params_to_numpy(_port(arch, f32=True))
    assert set(back["blocks"]) == set(tree["blocks"]) == (
        {"attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router", "wi_e",
         "wo_e"} | ({"wi_s", "wo_s"} if cfg.n_shared_experts else set()))
    for name, leaf in jax.tree_util.tree_leaves_with_path(tree):
        got = back
        for p in name:
            got = got[p.key]
        np.testing.assert_array_equal(got, leaf)
    served = _port(arch)
    blk = served.blocks[0]
    assert blk.router.dtype == torch.float32
    assert blk.wi_e.dtype == blk.wo_e.dtype == torch.bfloat16
    assert not hasattr(blk, "wi") and not hasattr(blk, "wo_mlp")
    for name in ("router", "wi_e", "wo_e"):
        want = torch.from_numpy(tree["blocks"][name][1]).to(
            getattr(blk, name).dtype)
        assert torch.equal(getattr(served.blocks[1], name), want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decayed_follows_the_reference_rank_rule(arch):
    """``decayed()`` names the port's tensors of the reference's leaves of
    rank >= 2 (each block leaf stacked on the layer axis): every block
    parameter, the router and experts among them, the embedding and
    ``lm_head``; not ``final_norm``."""
    tree = _ref(arch)[2]
    cfg = get_smoke_config(arch)
    want = {f"blocks.{i}.{name}" for name, leaf in tree["blocks"].items()
            if leaf.ndim >= 2 for i in range(cfg.n_layers)}
    want |= {name for name in ("embed", "lm_head", "final_norm")
             if name in tree and tree[name].ndim >= 2}
    model = _port(arch, f32=True)
    assert model.decayed() == want
    assert {f"blocks.0.{n}" for n in ("router", "wi_e", "wo_e")} <= want
    assert "final_norm" not in want


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, impl):
    jm, params, _ = _ref(arch)
    model = _port(arch)
    jb, tb = _batch(arch, seed=0)
    ctx, jctx = IMPLS[impl]
    with torch.no_grad():
        got = model(tb, ctx)
    want = jm.forward(params, jb, jctx)
    assert got.shape == want.shape == (B, S, get_smoke_config(arch).vocab_size)
    assert got.dtype == torch.bfloat16
    flips = (functools.partial(_routing_flips, arch, jb, tb, jctx, ctx)
             if arch in MOE_ARCHS else None)
    _hold_model(arch, got, want, BF16_TOL, f"forward under {impl}", flips)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_f32_forward_matches_reference(arch, impl, monkeypatch):
    """The MoE models with float32 activations in both packages (and the
    port on the reference's f32 masters), within 1e-4."""
    _f32(monkeypatch)
    jm, params, _ = _ref(arch)
    jb, tb = _batch(arch, seed=0, f32=True)
    ctx, jctx = IMPLS[impl]
    with torch.no_grad():
        got = _port(arch, f32=True)(tb, ctx)
    want = jm.forward(params, jb, jctx)
    assert got.dtype == torch.float32
    _hold_model(arch, got, want, F32_TOL, f"f32 forward under {impl}",
                functools.partial(_routing_flips, arch, jb, tb, jctx, ctx,
                                  f32=True))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_agrees_layer_by_layer(arch):
    """Every layer's top-k experts at every token equal the reference's
    on the same batch (bf16), or the flip is one rounding explains: the
    reference's k-th/(k+1)-th router-logit gap there at most twice the
    two packages' router-logit difference."""
    jb, tb = _batch(arch, seed=0)
    ctx, jctx = IMPLS["pallas"]
    flips = _routing_flips(arch, jb, tb, jctx, ctx)
    bad = [f for f in flips if f["gap"] > 2 * f["logit_diff"]]
    assert not bad, bad


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch):
    """``build_prefill_step(last_only=True)`` under each implementation
    against the reference's, and the full-head prefill and ``prefill``
    against it."""
    jm, params, _ = _ref(arch)
    model = _port(arch)
    jb, tb = _batch(arch, seed=1)
    V = get_smoke_config(arch).vocab_size
    for impl, (ctx, jctx) in IMPLS.items():
        got = build_prefill_step(model, ctx, last_only=True)(tb)
        want = jax_prefill_step(jm, jctx, last_only=True)(params, jb)
        assert got.shape == want.shape == (B, V)
        _hold_model(arch, got, want, BF16_TOL, f"prefill under {impl}")
    full = build_prefill_step(model, ModelContext(attention_impl="pallas"))(tb)
    np.testing.assert_allclose(_np(full), _np(got), **BF16_TOL)
    np.testing.assert_allclose(_np(model.prefill(tb)), _np(got), **BF16_TOL)


def _decode(arch, impl, f32: bool, n_steps: int = 8, T: int = 12):
    """Teacher-forced decode steps on both packages: a 4-token prompt,
    then the reference's greedy tokens; logits every step and the caches
    at the end.  With ``f32`` the caches are float32 in both."""
    jm, params, _ = _ref(arch)
    cfg = get_smoke_config(arch)
    model = _port(arch, f32=f32)
    tol = F32_TOL if f32 else BF16_TOL
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, 4)).astype(np.int32)
    ctx, jctx = IMPLS[impl]
    jstep = jax.jit(jax_serve_step(jm, jctx))
    step = build_serve_step(model, ctx)
    if f32:
        jcache = ref_transformer.init_lm_cache(jax_smoke(arch), B, T,
                                               jnp.float32)
        cache = model.init_cache(B, T, torch.float32)
    else:
        jcache, cache = jm.init_cache(B, T), model.init_cache(B, T)
    cur = prompt[:, 0]
    for t in range(n_steps):
        pos = np.full((B,), t, np.int32)
        want, jcache = jstep(params, jcache, jnp.asarray(cur), jnp.asarray(pos))
        got, cache = step(cache, torch.from_numpy(cur), torch.from_numpy(pos))
        _hold_model(arch, got, want, tol, f"decode step {t} under {impl}")
        cur = (prompt[:, t + 1] if t + 1 < prompt.shape[1]
               else np.asarray(jnp.argmax(want, -1), np.int32))
    for kv in ("k", "v"):
        np.testing.assert_allclose(_np(cache[kv]), _np(jcache[kv]), **tol)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference_teacher_forced(arch, impl):
    _decode(arch, impl, f32=False)


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_f32_decode_steps_match_reference(arch, impl, monkeypatch):
    _f32(monkeypatch)
    _decode(arch, impl, f32=True)


def _step_logits(arch, impl, tokens: np.ndarray) -> tuple:
    """Both packages' logits after teacher-forced decode steps on
    ``tokens`` (B, n): (reference's, port's) at the last step."""
    jm, params, _ = _ref(arch)
    ctx, jctx = IMPLS[impl]
    model = _port(arch)
    jstep = jax.jit(jax_serve_step(jm, jctx))
    step = build_serve_step(model, ctx)
    n = tokens.shape[1]
    jcache, cache = jm.init_cache(B, n), model.init_cache(B, n)
    for t in range(n):
        pos = np.full((B,), t, np.int32)
        want, jcache = jstep(params, jcache, jnp.asarray(tokens[:, t]),
                             jnp.asarray(pos))
        got, cache = step(cache, torch.from_numpy(tokens[:, t]),
                          torch.from_numpy(pos))
    return _np(want), _np(got)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch, impl):
    """``generate``: a 5-token prompt and 6 greedy tokens, the same as the
    reference's on every family (decode runs on token ids), up to the
    first step whose choice is a tie within rounding: where the tokens
    first differ, both packages' logits there (teacher-forced on the
    reference's tokens) agree at bf16 tolerance, and the reference's gap
    between its top two logits is at most twice their largest
    difference, so that rounding alone can swap them."""
    jm, params, _ = _ref(arch)
    cfg = get_smoke_config(arch)
    P = 5
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    ctx, jctx = IMPLS[impl]
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompt), 6, jctx))
    got = serve.generate(_port(arch), torch.from_numpy(prompt), 6, ctx)
    assert got.shape == want.shape == (B, P + 6) and got.dtype == torch.int32
    got = got.numpy()
    np.testing.assert_array_equal(got[:, :P], prompt)
    cols = np.flatnonzero((got != want).any(0))
    if not cols.size:
        return
    j = cols[0]
    ref_l, port_l = _step_logits(arch, impl, want[:, :j])
    np.testing.assert_allclose(port_l, ref_l, **BF16_TOL)
    for r in np.flatnonzero(got[:, j] != want[:, j]):
        top = np.sort(ref_l[r])[::-1]
        diff = np.abs(port_l[r] - ref_l[r]).max()
        assert top[0] - top[1] <= 2 * diff, (
            f"{arch} generate under {impl}, request {r}, token {j}: "
            f"{got[r, j]} vs the reference's {want[r, j]}, top-two gap "
            f"{top[0] - top[1]} > 2 x logit difference {diff}")
        assert ref_l[r, got[r, j]] >= top[0] - 2 * diff


# --------------------------------------------------------------------------
# the zoo: batches and loss
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + ["granite-8b"])
def test_batch_shapes_and_make_batch_match_reference(arch):
    jm = jax_build(jax_smoke(arch))
    cfg = get_smoke_config(arch)
    want = jm.batch_shapes(3, 24)
    got = zoo.batch_shapes(cfg, 3, 24)
    assert list(got) == list(want)
    for name, (shape, dtype) in got.items():
        assert shape == want[name].shape
        assert str(dtype).removeprefix("torch.") == str(want[name].dtype)
    batch = zoo.make_batch(cfg, torch.Generator().manual_seed(0), 3, 24)
    ref = jm.make_batch(jax.random.key(0), 3, 24)
    for name, x in batch.items():
        assert x.shape == ref[name].shape
        assert str(x.dtype).removeprefix("torch.") == str(ref[name].dtype)
        if x.dtype.is_floating_point:
            # 0.02 x N(0, 1): the same scale as the reference's draws
            assert 0.015 < float(x.float().std()) < 0.025
            assert x.float().std() == pytest.approx(
                float(np.asarray(ref[name], np.float32).std()), rel=0.2)
        else:
            assert int(x.min()) >= 0 and int(x.max()) < cfg.vocab_size


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch, masked):
    """``zoo.loss`` against the reference's ``Model.loss`` (for vlm only
    over the text positions), with and without a loss mask."""
    jm, params, _ = _ref(arch)
    cfg = get_smoke_config(arch)
    jb, tb = _batch(arch, seed=4)
    n_text = tb["tokens"].shape[1] if "tokens" in tb else S
    labels = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, n_text)).astype(np.int32)
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    if masked:
        mask = (np.arange(n_text)[None] % 3 != 0).repeat(B, 0).astype(
            np.float32)
        jb["loss_mask"], tb["loss_mask"] = (jnp.asarray(mask),
                                            torch.from_numpy(mask))
    want = float(jm.loss(params, jb))
    with torch.no_grad():
        got = zoo.loss(_port(arch), tb)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, **BF16_TOL)


def test_build_model_builds_every_transformer_family_and_refuses_ssm():
    """Every transformer family builds a ``TransformerLM``; the ``ssm``
    family (xLSTM), which the port once refused, builds an ``XLSTMLM``,
    and ``TransformerLM`` itself still refuses it."""
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        model = zoo.build_model(cfg, device="cpu")
        assert isinstance(model, transformer.TransformerLM)
        assert model.cfg is cfg
    xl = ArchConfig(**dataclasses.asdict(jax_smoke("xlstm-1.3b")))
    model = zoo.build_model(xl, device="cpu")
    assert isinstance(model, xlstm.XLSTMLM) and model.cfg is xl
    with pytest.raises(NotImplementedError, match="ssm"):
        transformer.TransformerLM(xl, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_cpu(arch, capsys):
    serve.main(["--arch", f"{arch}-smoke", "--batch", "2", "--prompt-len",
                "3", "--max-new", "2", "--device", "cpu"])
    assert "generated (2, 5) on cpu" in capsys.readouterr().out


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


def _kernel_sized(arch: str) -> tuple:
    """``arch``'s smoke config with heads the kernels take (hd 64, d_model
    256), for both packages."""
    over = dict(d_model=256, n_heads=4, head_dim=64)
    return (dataclasses.replace(get_smoke_config(arch), **over),
            dataclasses.replace(jax_smoke(arch), **over))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_kernels_on_gpu_match_reference_on_cpu(arch, monkeypatch):
    """Each smoke model at kernel-sized heads on the card, under
    ``pallas`` (flash attention, RMSNorm, flash decode): its prefill and
    two decode steps against the reference on the CPU; the MoE models
    with float32 activations in both packages (1e-4; the FMA kernels),
    the others in bf16 (2e-2; the tensor-core kernels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    f32 = arch in MOE_ARCHS
    if f32:
        _f32(monkeypatch)
    tol = F32_TOL if f32 else BF16_TOL
    cfg, jcfg = _kernel_sized(arch)
    jm = jax_build(jcfg)
    params = jm.init_params(jax.random.key(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cuda",
                            trainable=f32)
    jb, tb = _batch(arch, seed=6, f32=f32, s=256, cfg=cfg)
    tb = {k: v.cuda() for k, v in tb.items()}
    ctx = ModelContext(attention_impl="pallas")
    got = build_prefill_step(model, ctx, last_only=True)(tb)
    want = jax_prefill_step(jm, JaxCtx(attention_impl="reference"),
                            last_only=True)(params, jb)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    T = 16
    cache = model.init_cache(B, T, torch.float32 if f32 else torch.bfloat16)
    jcache = ref_transformer.init_lm_cache(
        jcfg, B, T, jnp.float32 if f32 else jnp.bfloat16)
    step = build_serve_step(model, ctx)
    jstep = jax.jit(jax_serve_step(jm, JaxCtx()))
    tok = np.array([3, 7], np.int32)
    for t in range(2):
        pos = np.full((B,), t, np.int32)
        want, jcache = jstep(params, jcache, jnp.asarray(tok), jnp.asarray(pos))
        got, cache = step(cache, torch.from_numpy(tok).cuda(),
                          torch.from_numpy(pos).cuda())
        np.testing.assert_allclose(_np(got), _np(want), **tol)
