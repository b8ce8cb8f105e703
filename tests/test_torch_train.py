"""Training in the port (``repro_torch.data``, ``models.zoo``'s loss and
batches, f32 masters, remat, ``launch.steps.build_train_step``,
``launch.train``) against the reference's, on the CPU.

The reference's smoke-config parameters are carried into the port as f32
masters (``params_from_jax(..., trainable=True)``);
batches come from ``SyntheticTokens``, which both packages draw bit for
bit alike.  Activations are bf16 in both packages and round at different
places, so each check runs twice: with the models' bf16 activations at
bf16 tolerance, and with float32 activations in both packages (the
function, with nothing of bf16's rounding in the way) much tighter.
Gradients are held within 2e-2 of each leaf's max |g| plus the
reference's own bf16 rounding of that leaf (the largest difference
between its bf16 and f32 gradients, up to 3.2% on zamba2's SSD vectors),
and within 1e-4 with f32.  Three train steps are held by their losses
and grad norms and by each leaf's trained change (``w_3 - w_0``) against
the reference's, within limits that a step updating nothing, or (with
f32) decaying nothing, exceeds.
"""

import argparse
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data import SyntheticTokens as JaxTokens
from repro.launch.steps import build_train_step as jax_train_step
from repro.models import hybrid as ref_hybrid
from repro.models import transformer as ref_transformer
from repro.models import xlstm as ref_xlstm
from repro.models.zoo import build_model as jax_build
from repro.optim import AdamW as JaxAdamW
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.launch.steps import build_train_step
from repro_torch.launch.train import run as train_run
from repro_torch.models import hybrid, mamba2, transformer, xlstm, zoo
from repro_torch.models.sharding import ModelContext
from repro_torch.models.zoo import build_model
from repro_torch.optim import AdamW

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
ARCHS = ["granite-8b", "gemma2-9b", "zamba2-7b"]
B, S = 4, 32
LR = 1e-3
STEPS = 3
#: limits on the deviation of a leaf's trained change from the
#: reference's over STEPS steps (``_trained``), each set between the
#: sound runs' largest reading and the controls' (a step that updates
#: nothing reads 1.0; one that decays nothing 3.7e-3 to 0.47 with f32
#: activations): with the models' bf16 activations, and with float32
DW_TOL_BF16 = 0.3
DW_TOL_F32 = 1e-3


def _module(cfg):
    return {"hybrid": hybrid, "ssm": xlstm}.get(cfg.family, transformer)


@functools.cache
def _tree(arch: str):
    """The reference's smoke params of ``arch`` (seed 0) as numpy."""
    params = jax_build(jax_smoke(arch)).init_params(jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def _port(arch: str, **over):
    """The port's model on the reference's weights as trainable f32
    masters, with config fields ``over`` (e.g. remat) on both sides."""
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    return _module(cfg).params_from_jax(_tree(arch), cfg, "cpu",
                                        trainable=True)


def _batches(arch: str, n: int, seed: int = 0) -> list:
    it = iter(SyntheticTokens(get_smoke_config(arch).vocab_size, S,
                              seed=seed, batch_size=B))
    return [next(it) for _ in range(n)]


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_leaf(tree: dict, name: str) -> np.ndarray:
    """The slice of the reference's leaf that the port's parameter
    ``name`` holds (one layer of a stacked leaf)."""
    parts = name.split(".")
    if parts[0] in ("blocks", "mamba"):
        return tree[parts[0]][parts[2]][int(parts[1])], tree[parts[0]][parts[2]]
    if parts[0] == "shared_attn":
        leaf = tree["shared_attn"][parts[1]]
    else:
        leaf = tree[parts[0]]
    return leaf, leaf


def test_synthetic_tokens_bit_for_bit():
    for vocab, seq, seed in ((128, 32, 0), (49152, 64, 7)):
        a = iter(SyntheticTokens(vocab, seq, seed=seed, batch_size=4))
        b = iter(JaxTokens(vocab, seq, seed=seed, batch_size=4))
        for _ in range(3):
            x, y = next(a), next(b)
            assert x.keys() == y.keys() == {"tokens", "labels"}
            for k in x:
                assert x[k].dtype == y[k].dtype == np.int32
                np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shapes_and_make_batch(arch):
    cfg = get_smoke_config(arch)
    want = jax_build(jax_smoke(arch)).batch_shapes(3, 16)
    got = zoo.batch_shapes(cfg, 3, 16)
    assert got.keys() == want.keys()
    for k, (shape, dtype) in got.items():
        assert shape == want[k].shape and dtype == torch.int32
    batch = zoo.make_batch(cfg, torch.Generator().manual_seed(0), 3, 16)
    for k, v in batch.items():
        assert v.shape == (3, 16) and v.dtype == torch.int32
        assert 0 <= int(v.min()) and int(v.max()) < cfg.vocab_size
    again = zoo.make_batch(cfg, torch.Generator().manual_seed(0), 3, 16)
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    for family in ("audio", "vlm"):
        over = dict(family=family, num_patches=4)
        fwant = jax_build(dataclasses.replace(jax_smoke(arch), **over)
                          ).batch_shapes(3, 16)
        fgot = zoo.batch_shapes(dataclasses.replace(cfg, **over), 3, 16)
        assert list(fgot) == list(fwant)
        for k, (shape, dtype) in fgot.items():
            assert shape == fwant[k].shape
            assert str(dtype).removeprefix("torch.") == str(fwant[k].dtype)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch, masked):
    batch = _batches(arch, 1)[0]
    if masked:
        batch["loss_mask"] = (np.arange(S)[None] % 3 != 0).repeat(
            B, 0).astype(np.float32)
    jm = jax_build(jax_smoke(arch))
    want = jm.loss(_tree(arch), {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = zoo.loss(_port(arch), _torch(batch))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), **BF16_TOL)


def _f32(monkeypatch) -> None:
    """Float32 activations in both packages: the reference's hard-coded
    bf16 cast of the embedding table patched to float32 in its three model
    modules, and the port's ``ACT_DTYPE``."""
    ns = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                  if not k.startswith("__")})
    ns.bfloat16 = jnp.float32
    for mod in (ref_hybrid, ref_transformer, ref_xlstm):
        monkeypatch.setattr(mod, "jnp", ns)
    for mod in (hybrid, transformer, xlstm):
        monkeypatch.setattr(mod, "ACT_DTYPE", torch.float32)


def _grads(arch: str, remat: bool, batch: dict, monkeypatch, f32: bool):
    """(the reference's gradient tree, the port's model after backward) on
    ``batch``; ``f32``: both packages with float32 activations
    (:func:`_f32`)."""
    if f32:
        _f32(monkeypatch)
    jm = jax_build(dataclasses.replace(jax_smoke(arch), remat=remat))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.tree.map(np.asarray, jax.grad(
        lambda p: jm.loss(p, jb))(jax.tree.map(jnp.asarray, _tree(arch))))
    model = _port(arch, remat=remat)
    zoo.loss(model, _torch(batch)).backward()
    return grads, model


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_f32_gradients_match_reference(arch, remat, monkeypatch):
    """With float32 activations in both packages, every parameter's
    gradient equals the reference's leaf, sliced per layer, within 1e-4
    of that leaf's max |g| (measured: 1.2e-5 on zamba2's ``A_log``, under
    1e-6 on the dense models): the gradient function is the reference's,
    with nothing of bf16's rounding in the way."""
    batch = _batches(arch, 1, seed=3)[0]
    grads, model = _grads(arch, remat, batch, monkeypatch, f32=True)
    for name, p in model.named_parameters():
        want, leaf = _ref_leaf(grads, name)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(leaf).max(),
                                   err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch, remat, monkeypatch):
    """With the models' bf16 activations, every parameter's gradient
    against ``jax.grad``'s leaf, sliced per layer, within 2e-2 of that
    leaf's max |g| plus the reference's own bf16 rounding there: the
    largest difference between its bf16 and its f32 gradient over the
    leaf (up to 3.2% of max |g| on zamba2's ``A_log``, where a sum over
    every position cancels; under 1.6% on the dense models).  The shared
    block's gradient sums both of its applications."""
    batch = _batches(arch, 1, seed=3)[0]
    grads, model = _grads(arch, remat, batch, monkeypatch, f32=False)
    with monkeypatch.context() as m:
        grads32, _ = _grads(arch, remat, batch, m, f32=True)
    for name, p in model.named_parameters():
        want, leaf = _ref_leaf(grads, name)
        noise = np.abs(leaf - _ref_leaf(grads32, name)[1]).max()
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=2e-2 * np.abs(leaf).max() + noise,
                                   err_msg=name)


def test_remat_gives_the_same_gradients():
    """Recomputing each checkpoint unit in backward changes no value."""
    out = []
    for remat in (False, True):
        model = _port("zamba2-7b", remat=remat)
        zoo.loss(model, _torch(_batches("zamba2-7b", 1)[0])).backward()
        out.append({n: p.grad for n, p in model.named_parameters()})
    for n in out[0]:
        torch.testing.assert_close(out[0][n], out[1][n], rtol=0, atol=0)


def _trained(arch: str, M: int, decayed=None):
    """Three ``build_train_step`` steps of the port and of the reference
    on the same batches from the same weights.  Returns the (port,
    reference) metrics of each step and, for each leaf of the reference's
    tree, the trained change's deviation ``||dW_port - dW_ref|| /
    ||dW_ref||`` (``dW = w_3 - w_0``).  ``decayed`` overrides the port's
    decayed set (the controls)."""
    jm = jax_build(jax_smoke(arch))
    jopt = JaxAdamW(learning_rate=LR)
    jstep = jax.jit(jax_train_step(jm, jopt, None, microbatches=M))
    jparams = jax.tree.map(jnp.asarray, _tree(arch))
    jstate = jopt.init(jparams)
    model = _port(arch)
    opt = AdamW(learning_rate=LR, decayed=(model.decayed() if decayed is None
                                           else decayed))
    step = build_train_step(model, opt, None, microbatches=M)
    state = opt.init(dict(model.named_parameters()))
    mets = []
    for batch in _batches(arch, STEPS, seed=1):
        jparams, jstate, jmet = jstep(
            jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        mets.append((step(state, _torch(batch)), jmet))
    dev = {}
    for (path, w0), ref, got in zip(
            jax.tree_util.tree_flatten_with_path(_tree(arch))[0],
            jax.tree.leaves(jax.tree.map(np.asarray, jparams)),
            jax.tree.leaves(_module(model.cfg).params_to_numpy(model))):
        d_ref = ref - w0
        dev[jax.tree_util.keystr(path)] = float(
            np.linalg.norm(got - w0 - d_ref) / np.linalg.norm(d_ref))
    return mets, dev


def _hold_trained(mets, dev, rtol: float, dw_tol: float) -> None:
    for met, jmet in mets:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=rtol, err_msg=k)
        assert float(met["lr"]) == pytest.approx(float(jmet["lr"]))
    worst = max(dev, key=dev.get)
    assert dev[worst] <= dw_tol, (worst, dev[worst])


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, M):
    """Three ``build_train_step`` steps on the same batches with the
    models' bf16 activations: losses and grad norms within 2e-2 relative,
    and each leaf's trained change within ``DW_TOL_BF16`` of the
    reference's (``_trained``).  Measured: at most 0.142 (zamba2's ``D``),
    against 1.0 for a step that updates nothing."""
    _hold_trained(*_trained(arch, M), rtol=2e-2, dw_tol=DW_TOL_BF16)


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_f32_train_steps_match_reference(arch, M, monkeypatch):
    """The same three steps with float32 activations in both packages:
    losses and grad norms within 1e-4 relative, and each leaf's trained
    change within ``DW_TOL_F32`` of the reference's.  Measured: at most
    2.3e-4 (gemma2's ``wi``, zamba2's ``A_log``), against 3.7e-3 to 0.47
    for a step that decays nothing and 1.0 for one that updates
    nothing."""
    _f32(monkeypatch)
    _hold_trained(*_trained(arch, M), rtol=1e-4, dw_tol=DW_TOL_F32)


def test_f32_train_check_sees_a_wrong_decay_set(monkeypatch):
    """The control of the check above: the port decaying nothing fails
    it on a dense model, whose decayed leaves start near 0.02 in size."""
    _f32(monkeypatch)
    mets, dev = _trained("granite-8b", 1, decayed=frozenset())
    assert max(dev.values()) > DW_TOL_F32
    with pytest.raises(AssertionError):
        _hold_trained(mets, dev, rtol=1e-4, dw_tol=DW_TOL_F32)


def test_microbatches_split_the_batch():
    """M microbatches of B/M rows give the loss and gradient of the whole
    batch (the mean of the microbatches' means)."""
    batch = _torch(_batches("granite-8b", 1)[0])
    out = []
    for M in (1, 2, 4):
        model = _port("granite-8b")
        opt = AdamW(learning_rate=LR, decayed=model.decayed())
        out.append(build_train_step(model, opt, None, microbatches=M)(
            opt.init(dict(model.named_parameters())), batch))
    for met in out[1:]:
        for k in ("loss", "grad_norm"):
            assert float(met[k]) == pytest.approx(float(out[0][k]), rel=1e-2)


def test_trainable_gives_f32_masters_and_serving_frozen_bf16():
    """``trainable`` is the one switch: every weight an f32 master that
    requires grad, or (to serve) the matmul weights and the embedding in
    bf16 and every weight frozen, the norms and SSM vectors in f32."""
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        train = build_model(cfg, "cpu", trainable=True)
        assert all(p.dtype == torch.float32 and p.requires_grad
                   for p in train.parameters())
        serve = build_model(cfg, "cpu")
        for name, p in serve.named_parameters():
            want = torch.bfloat16 if p.dim() >= 2 else torch.float32
            assert p.dtype == want and not p.requires_grad, name


def test_params_to_numpy_inverts_params_from_jax():
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        tree = _tree(arch)
        got = _module(cfg).params_to_numpy(
            _module(cfg).params_from_jax(tree, cfg, "cpu", trainable=True))
        assert jax.tree.structure(got) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_ssd_chunk_terms_equal_under_grad_and_no_grad():
    g = np.random.default_rng(0)
    Bb, L, nh, hd, N, Q = 2, 64, 3, 4, 5, 16
    x = torch.from_numpy(g.standard_normal((Bb, L, nh, hd)).astype(np.float32))
    dt = torch.from_numpy(g.uniform(1e-3, 0.1, (Bb, L, nh)).astype(np.float32))
    A = -torch.from_numpy(g.uniform(1, 16, nh).astype(np.float32))
    Bm = torch.from_numpy(g.standard_normal((Bb, L, N)).astype(np.float32))
    Cm = torch.from_numpy(g.standard_normal((Bb, L, N)).astype(np.float32))
    with torch.no_grad():
        want = mamba2.ssd_chunk_terms(x, dt, A, Bm, Cm, Q)
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    got = mamba2.ssd_chunk_terms(*ins, Q)
    for a, b in zip(got, want):
        assert torch.equal(a.detach(), b)
    sum(t.sum() for t in got).backward()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in ins)


def _kernel_calls():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    pos = torch.arange(8, dtype=torch.int32)
    return {
        "rmsnorm": (lambda a, b: ops.rmsnorm(a, b), (r(4, 8), r(8))),
        "flash_attention": (lambda q, k, v: ops.flash_attention(
            q, k, v, pos, pos), (r(1, 8, 2, 4), r(1, 8, 1, 4),
                                 r(1, 8, 1, 4))),
        "flash_decode": (lambda q, k, v: ops.flash_decode(
            q, k, v, torch.tensor([5])), (r(1, 2, 4), r(1, 8, 1, 4),
                                          r(1, 8, 1, 4))),
        "ssd_state_scan": (ops.ssd_state_scan, (
            r(1, 2, 2, 3, 4), -r(1, 2, 2).abs(), r(1, 2, 4, 4),
            -r(1, 2, 4, 2).abs())),
    }


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention",
                                  "flash_decode", "ssd_state_scan"])
def test_kernel_wrappers_refuse_grad(name):
    """A kernel's output carries no grad_fn: under grad, with an input
    that requires grad, the wrapper raises (on the CPU as on the card)
    and never runs its plain version instead; without grad it runs."""
    fn, args = _kernel_calls()[name]
    fn(*args)
    for i in range(len(args)):
        ins = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match="forward-only"):
            fn(*ins)
        with torch.no_grad():
            fn(*ins)


@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-7b"])
def test_training_under_pallas_raises(arch):
    model = _port(arch)
    opt = AdamW(learning_rate=LR, decayed=model.decayed())
    step = build_train_step(model, opt, ModelContext(attention_impl="pallas"))
    with pytest.raises(RuntimeError, match="forward-only"):
        step(opt.init(dict(model.named_parameters())),
             _torch(_batches(arch, 1)[0]))


def _args(**kw):
    base = dict(arch="granite-8b-smoke", steps=25, batch=8, seq=32,
                lr=2e-3, seed=0, microbatches=1, data="local",
                ckpt_dir="", ckpt_every=50, resume=True, log_every=100,
                feedback_every=5, crash_consumer_at=-1, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def test_local_training_loss_decreases():
    out = train_run(_args())
    assert out["losses"][0] > out["final_loss"] + 0.3


@pytest.mark.parametrize("arch", ["granite-8b-smoke", "zamba2-7b-smoke"])
def test_microbatched_equals_more_steps_loss_trend(arch):
    out = train_run(_args(arch=arch, microbatches=2, steps=15))
    assert out["losses"][0] > out["final_loss"]


def test_checkpoint_restart_continues(tmp_path):
    train_run(_args(steps=10, ckpt_dir=str(tmp_path), ckpt_every=5))
    out2 = train_run(_args(steps=14, ckpt_dir=str(tmp_path), ckpt_every=5))
    # resumed run starts from step 10 and produces only 4 more losses
    assert len(out2["losses"]) == 4


def test_train_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_run(_args(device="cuda", steps=1))


def report() -> None:
    """Print, for each smoke config, the largest gradient deviation over
    its leaves (each over that leaf's max |g|): the port against the
    reference with f32 activations and with bf16, and the reference's
    own bf16 gradient against its f32 one; then :func:`report_trained`.
    ``PYTHONPATH=src python tests/test_torch_train.py``"""
    for arch in ARCHS:
        batch = _batches(arch, 1, seed=3)[0]
        with pytest.MonkeyPatch.context() as m:
            g32, m32 = _grads(arch, False, batch, m, f32=True)
        with pytest.MonkeyPatch.context() as m:
            g16, m16 = _grads(arch, False, batch, m, f32=False)
        worst = {"port_vs_ref_f32": (0.0, ""), "port_vs_ref_bf16": (0.0, ""),
                 "ref_bf16_vs_ref_f32": (0.0, "")}
        for (name, p32), p16 in zip(m32.named_parameters(),
                                    m16.parameters()):
            w32, l32 = _ref_leaf(g32, name)
            w16, l16 = _ref_leaf(g16, name)
            for key, d in (
                    ("port_vs_ref_f32",
                     np.abs(p32.grad.numpy() - w32).max() / np.abs(l32).max()),
                    ("port_vs_ref_bf16",
                     np.abs(p16.grad.numpy() - w16).max() / np.abs(l16).max()),
                    ("ref_bf16_vs_ref_f32",
                     np.abs(w16 - w32).max() / np.abs(l16).max())):
                worst[key] = max(worst[key], (float(d), name))
        print(arch, worst)
    report_trained()


def report_trained() -> None:
    """Print, for each smoke config and M, the largest deviation of a
    leaf's trained change from the reference's (``_trained``): the sound
    run with bf16 and with f32 activations, and the control that decays
    nothing (a step that updates nothing reads 1.0 by definition)."""
    for arch in ARCHS:
        for M in (1, 2):
            row = {}
            for acts in ("bf16", "f32"):
                for run, decayed in (("sound", None),
                                     ("no_decay", frozenset())):
                    with pytest.MonkeyPatch.context() as m:
                        if acts == "f32":
                            _f32(m)
                        dev = _trained(arch, M, decayed)[1]
                    worst = max(dev, key=dev.get)
                    row[f"{run}_{acts}"] = (dev[worst], worst)
            print(arch, f"M={M}", row, flush=True)


if __name__ == "__main__":
    report()
