"""The port's dense transformer serving path (``repro_torch.models``,
``repro_torch.launch``) against the reference's, on the CPU.

The reference's smoke-config parameters are carried into the port with
``params_from_jax``; tokens are made with numpy from a seed.  Forward,
prefill and decode logits are held to the reference at bf16 tolerance
(rtol = atol = 2e-2): activations are bf16 in both packages, which round
at different places (matmul accumulation order, SiLU).  ``pallas`` runs
the reference's Pallas kernel in interpret mode and the port's plain
version of its CUDA kernel.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch.serve import generate as jax_generate
from repro.launch.steps import build_prefill_step as jax_prefill_step
from repro.launch.steps import build_serve_step as jax_serve_step
from repro.models.sharding import ModelContext as JaxCtx
from repro.models.zoo import build_model as jax_build
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models.sharding import ModelContext
from repro_torch.models.transformer import params_from_jax
from repro_torch.models.zoo import build_model

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
ARCHS = ["granite-8b", "gemma2-9b"]
B, S = 2, 64


@functools.cache
def _pair(arch):
    """(reference model, its params, the port's model on the same weights)."""
    jm = jax_build(jax_smoke(arch))
    params = jm.init_params(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    return jm, params, params_from_jax(tree, get_smoke_config(arch), "cpu")


def _tokens(arch, shape, seed=0):
    V = get_smoke_config(arch).vocab_size
    return np.random.default_rng(seed).integers(0, V, size=shape).astype(
        np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_dense_configs_match_reference(name):
    for port, ref in ((get_config(name), jax_config(name)),
                      (get_smoke_config(name), jax_smoke(name))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert (port.hd, port.param_count(), port.active_param_count()) == (
            ref.hd, ref.param_count(), ref.active_param_count())


#: port ctx, reference ctx.  The reference's blocked attention pads T to
#: a multiple of its 1024-key block with keys a causal mask leaves
#: visible, so the port's blocked forward (which does not pad) is held to
#: the reference's full-score forward, the function it computes.
IMPLS = {
    "reference": (ModelContext(attention_impl="reference"),
                  JaxCtx(attention_impl="reference")),
    "blocked": (ModelContext(attention_impl="auto", blocked_threshold=16),
                JaxCtx(attention_impl="reference")),
    "pallas": (ModelContext(attention_impl="pallas"),
               JaxCtx(attention_impl="pallas", interpret=True)),
}


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, impl):
    jm, params, model = _pair(arch)
    tok = _tokens(arch, (B, S))
    ctx, jctx = IMPLS[impl]
    with torch.no_grad():
        got = model(torch.from_numpy(tok), ctx)
    want = jm.forward(params, {"tokens": jnp.asarray(tok)}, jctx)
    assert got.shape == want.shape == (B, S, get_smoke_config(arch).vocab_size)
    assert got.dtype == (torch.float32 if arch == "gemma2-9b"
                         else torch.bfloat16)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch):
    jm, params, model = _pair(arch)
    tok = _tokens(arch, (B, S), seed=1)
    step = build_prefill_step(model, ModelContext(attention_impl="pallas"),
                              last_only=True)
    got = step(torch.from_numpy(tok))
    want = jax_prefill_step(jm, JaxCtx(attention_impl="pallas"),
                            last_only=True)(params, {"tokens": jnp.asarray(tok)})
    assert got.shape == want.shape == (B, get_smoke_config(arch).vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    full = build_prefill_step(model, ModelContext(attention_impl="pallas"))(
        torch.from_numpy(tok))
    np.testing.assert_allclose(_np(full), _np(got), **BF16_TOL)
    np.testing.assert_allclose(_np(model.prefill(torch.from_numpy(tok))),
                               _np(got), **BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference_teacher_forced(arch):
    """8 decode steps: a 4-token prompt, then the reference's greedy
    tokens, fed to both; logits every step and the KV caches at the end
    at bf16 tolerance."""
    jm, params, model = _pair(arch)
    n_steps, T = 8, 12
    prompt = _tokens(arch, (B, 4), seed=2)
    jstep = jax.jit(jax_serve_step(jm, JaxCtx()))
    step = build_serve_step(model, ModelContext())
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


def test_generate_returns_the_reference_shape():
    jm, params, model = _pair("granite-8b")
    prompt = _tokens("granite-8b", (B, 5), seed=3)
    want = jax_generate(jm, params, jnp.asarray(prompt), 6)
    got = serve.generate(model, torch.from_numpy(prompt), 6)
    assert got.shape == want.shape == (B, 11) and got.dtype == torch.int32
    assert torch.equal(got[:, :5], torch.from_numpy(prompt))
    V = get_smoke_config("granite-8b").vocab_size
    g = [serve.generate(model, torch.from_numpy(prompt), 6, greedy=False,
                        generator=torch.Generator().manual_seed(5))
         for _ in range(2)]
    assert torch.equal(g[0], g[1])
    assert int(g[0].min()) >= 0 and int(g[0].max()) < V


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the CPU-only path")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_smoke_config("granite-8b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "granite-8b-smoke", "--max-new", "2"])


def test_model_context_and_params_from_jax_reject_bad_input():
    with pytest.raises(ValueError):
        ModelContext(attention_impl="flash")
    _, params, _ = _pair("granite-8b")
    tree = jax.tree.map(np.asarray, params)
    tree["blocks"] = dict(tree["blocks"], extra=tree["blocks"]["wq"])
    with pytest.raises(KeyError):
        params_from_jax(tree, get_smoke_config("granite-8b"), "cpu")


def test_serve_main_runs_on_cpu(capsys):
    serve.main(["--arch", "gemma2-9b-smoke", "--batch", "2", "--prompt-len",
                "3", "--max-new", "2", "--device", "cpu"])
    assert "generated (2, 5) on cpu" in capsys.readouterr().out
