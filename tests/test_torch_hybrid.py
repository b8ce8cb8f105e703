"""The port's hybrid (zamba2) serving path (``repro_torch.models.hybrid``,
``repro_torch.launch``) against the reference's, on the CPU.

The reference's zamba2 smoke-config parameters are carried into the port
with ``params_from_jax``; tokens are made with numpy from a seed.
Forward, last-position prefill and decode logits, and the decode caches,
are held to the reference at bf16 tolerance (rtol = atol = 2e-2):
activations are bf16 in both packages, which round at different places.
Under ``pallas`` the port runs every norm, the SSD state scan, flash
attention and flash decode through the kernels' entry points (on the
CPU their plain versions), and the reference its flash-attention Pallas
kernel in interpret mode.
"""

import dataclasses
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
from repro.launch.serve import generate as jax_generate
from repro.launch.steps import build_prefill_step as jax_prefill_step
from repro.launch.steps import build_serve_step as jax_serve_step
from repro.models.sharding import ModelContext as JaxCtx
from repro.models.zoo import build_model as jax_build
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import hybrid
from repro_torch.models.sharding import ModelContext
from repro_torch.models.zoo import build_model

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
ARCH = "zamba2-7b"
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
    return jm, params, hybrid.params_from_jax(tree, get_smoke_config(ARCH),
                                              "cpu")


def _tokens(shape, seed=0):
    V = get_smoke_config(ARCH).vocab_size
    return np.random.default_rng(seed).integers(0, V, size=shape).astype(
        np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("impl,S", [("reference", 64), ("pallas", 64),
                                    ("reference", 512)])
def test_forward_matches_reference(impl, S):
    """One SSD chunk at 64 tokens, two at 512."""
    jm, params, model = _pair()
    tok = _tokens((B, S), seed=S)
    ctx, jctx = IMPLS[impl]
    with torch.no_grad():
        got = model(torch.from_numpy(tok), ctx)
    want = jm.forward(params, {"tokens": jnp.asarray(tok)}, jctx)
    assert got.shape == want.shape == (B, S, get_smoke_config(ARCH).vocab_size)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_prefill_step_runs_the_scan_entry_point_and_matches_reference(
        monkeypatch):
    """``build_prefill_step(last_only=True)`` under ``pallas``: one SSD scan
    call per Mamba2 layer, logits as the reference's and as the full
    forward's last position."""
    jm, params, model = _pair()
    tok = _tokens((B, 64), seed=1)
    calls = []
    real = ops._scan
    monkeypatch.setattr(ops, "_scan", lambda *a: calls.append(1) or real(*a))
    step = build_prefill_step(model, ModelContext(attention_impl="pallas"),
                              last_only=True)
    got = step(torch.from_numpy(tok))
    assert len(calls) == get_smoke_config(ARCH).n_layers
    want = jax_prefill_step(jm, JaxCtx(attention_impl="pallas"),
                            last_only=True)(params, {"tokens": jnp.asarray(tok)})
    assert got.shape == want.shape == (B, get_smoke_config(ARCH).vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    full = build_prefill_step(model, ModelContext(attention_impl="pallas"))(
        torch.from_numpy(tok))
    np.testing.assert_allclose(_np(full), _np(got), **BF16_TOL)
    np.testing.assert_allclose(_np(model.prefill(torch.from_numpy(tok))),
                               _np(got), **BF16_TOL)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_decode_steps_match_reference_teacher_forced(impl):
    """8 decode steps: a 4-token prompt, then the reference's greedy
    tokens, fed to both; logits every step and the whole cache (K/V, conv
    carries, SSM states) at the end at bf16 tolerance."""
    jm, params, model = _pair()
    n_steps, T = 8, 12
    prompt = _tokens((B, 4), seed=2)
    jstep = jax.jit(jax_serve_step(jm, JaxCtx()))
    step = build_serve_step(model, IMPLS[impl][0])
    jcache, cache = jm.init_cache(B, T), model.init_cache(B, T)
    cur = prompt[:, 0]
    for t in range(n_steps):
        pos = np.full((B,), t, np.int32)
        want, jcache = jstep(params, jcache, jnp.asarray(cur), jnp.asarray(pos))
        got, cache = step(cache, torch.from_numpy(cur), torch.from_numpy(pos))
        np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
        cur = (prompt[:, t + 1] if t + 1 < prompt.shape[1]
               else np.asarray(jnp.argmax(want, -1), np.int32))
    for kv in ("k", "v"):
        np.testing.assert_allclose(_np(cache[kv]), _np(jcache[kv]), **BF16_TOL)
    for key in ("conv", "ssm"):
        assert cache["mamba"][key].dtype == getattr(
            torch, str(jcache["mamba"][key].dtype))
        np.testing.assert_allclose(_np(cache["mamba"][key]),
                                   _np(jcache["mamba"][key]), **BF16_TOL)


def test_generate_returns_the_reference_shape():
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
    assert isinstance(model, hybrid.HybridLM)
    model.init_params(torch.Generator().manual_seed(0))
    m = model.mamba[0]
    nh = m.nh
    assert torch.allclose(m.A_log, torch.log(torch.linspace(1.0, 16.0, nh)))
    assert torch.equal(m.D, torch.ones(nh))
    assert not m.dt_bias.any() and not m.norm.any() and not m.out_norm.any()
    assert not model.final_norm.any() and not model.shared_attn.attn_norm.any()
    assert 0.08 < model.mamba[1].conv.float().std().item() < 0.12
    assert 0.018 < m.in_proj.float().std().item() < 0.022
    assert 0.018 < model.embed.float().std().item() < 0.022
    _, params, _ = _pair()
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))


def test_cache_layout_and_shared_block_placement():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    cache = model.init_cache(3, 10)
    assert cache["k"].shape == (cfg.n_macro_blocks, 3, 10, cfg.n_kv_heads,
                                cfg.hd)
    assert cache["mamba"]["ssm"].shape == (cfg.n_layers, 3, 8, 16, 16)
    assert cache["mamba"]["conv"].dtype == torch.bfloat16
    assert [i for i in range(cfg.n_layers) if model._shared_after(i)] == [1, 3]


def test_params_from_jax_and_the_model_reject_bad_input():
    _, params, _ = _pair()
    tree = jax.tree.map(np.asarray, params)
    bad = dict(tree, mamba=dict(tree["mamba"], extra=tree["mamba"]["D"]))
    with pytest.raises(KeyError):
        hybrid.params_from_jax(bad, get_smoke_config(ARCH), "cpu")
    with pytest.raises(NotImplementedError):
        hybrid.HybridLM(get_smoke_config("granite-8b"), "cpu")
    with pytest.raises(ValueError):
        hybrid.HybridLM(dataclasses.replace(get_smoke_config(ARCH),
                                            n_layers=6), "cpu")


def test_serve_main_runs_on_cpu(capsys):
    serve.main(["--arch", "zamba2-7b-smoke", "--batch", "2", "--prompt-len",
                "3", "--max-new", "2", "--device", "cpu"])
    assert "generated (2, 5) on cpu" in capsys.readouterr().out


@pytest.mark.gpu
def test_kernel_path_matches_plain_path_on_gpu():
    """A zamba2 of kernel-sized heads (hd 64, SSM head dim and state 64)
    on the card: the prefill and a decode step under ``pallas`` against
    the all-plain path (needs a card; skipped elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cfg = dataclasses.replace(get_smoke_config(ARCH), d_model=256, n_heads=4,
                              n_kv_heads=4, ssm_state=64, ssm_head_dim=64)
    model = build_model(cfg, "cuda").init_params(
        torch.Generator("cuda").manual_seed(0))
    tok = torch.from_numpy(_tokens((B, 512), seed=4)).cuda()
    ctxs = [ModelContext(attention_impl=i) for i in ("pallas", "reference")]
    with torch.no_grad():
        got, want = (model(tok, c, last_only=True).float() for c in ctxs)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **BF16_TOL)
    outs = []
    for c in ctxs:
        cache = model.init_cache(B, 16)
        pos = torch.tensor([3, 15], dtype=torch.int32, device="cuda")
        outs.append(build_serve_step(model, c)(cache, tok[:, 0], pos)[0])
    np.testing.assert_allclose(_np(outs[0].cpu()), _np(outs[1].cpu()),
                               **BF16_TOL)
