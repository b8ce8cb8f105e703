"""Training of the MoE, audio and VLM families in the port, and the
remat policies, against the reference's, on the CPU.

The four smoke configs (qwen3-moe-30b-a3b, moonshot-v1-16b-a3b with its
shared experts, musicgen-large on frame embeddings, pixtral-12b on patch
embeddings before text, its loss on the text positions only) train from
the reference's smoke parameters as f32 masters, on the same batches in
both packages: ``SyntheticTokens`` for the MoE models, the reference's
``make_batch`` converted with numpy for audio and vlm.  Each is held as
``tests/test_torch_train.py`` holds the dense models: the loss; every
gradient within 2e-2 of its leaf's max |g| plus the reference's own bf16
rounding there, and within 1e-4 with float32 activations in both
packages; three train steps at M = 1 and 2 by loss, grad norm and each
leaf's trained change (``DW_TOL_BF16``, ``DW_TOL_F32``).  Routing is
discontinuous: where a check of an MoE model fails, its message lists
the tokens whose experts flipped between the packages
(``test_torch_moe._routing_flips``).

``remat_policy="dots"`` (the reference's
``dots_with_no_batch_dims_saveable``) changes no value: no remat, full
and dots give equal gradients.  In one transformer unit the port's
policy saves as many product elements as the reference's residuals
(``saved_residuals``), and full remat saves none.  Only the transformer
reads the policy: zamba2 and xLSTM under ``"dots"`` recompute their
units whole and give the reference's gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals

jax.config.update("jax_platforms", "cpu")

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.steps import build_train_step as jax_train_step
from repro.launch.train import run as jax_train_run
from repro.models import transformer as ref_transformer
from repro.models.sharding import ModelContext as JaxCtx
from repro.models.zoo import build_model as jax_build
from repro.optim import AdamW as JaxAdamW
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.launch.steps import build_train_step
from repro_torch.launch.train import run as train_run
from repro_torch.models import remat, zoo
from repro_torch.models.sharding import ModelContext
from repro_torch.optim import AdamW
from test_torch_moe import _routing_flips
from test_torch_train import (
    DW_TOL_BF16, DW_TOL_F32, LR, STEPS, _args, _f32, _hold_trained, _module,
    _port, _ref_leaf, _tree)

FAMILIES = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "musicgen-large",
            "pixtral-12b"]
B, S = 2, 32
_aten = torch.ops.aten


def _pairs(arch: str, n: int, seed: int, f32: bool = False) -> list:
    """``n`` (reference batch, port batch) pairs of ``arch``'s family:
    ``SyntheticTokens(seed)`` ids and labels for the MoE models; for audio
    and vlm the reference's ``make_batch`` with keys ``seed``, ``seed +
    1``, ... converted with numpy.  Embeddings in bf16, or (``f32``)
    those bf16 values in float32."""
    cfg = get_smoke_config(arch)
    if cfg.family in ("audio", "vlm"):
        jm = jax_build(jax_smoke(arch))
        host = [{k: np.array(v, np.float32 if jnp.issubdtype(
                    v.dtype, jnp.floating) else v.dtype)
                 for k, v in jm.make_batch(jax.random.key(seed + i), B,
                                           S).items()}
                for i in range(n)]
    else:
        it = iter(SyntheticTokens(cfg.vocab_size, S, seed=seed, batch_size=B))
        host = [next(it) for _ in range(n)]
    jd, td = ((jnp.float32, torch.float32) if f32
              else (jnp.bfloat16, torch.bfloat16))
    return [({k: jnp.asarray(v, jd) if v.dtype == np.float32
              else jnp.asarray(v) for k, v in h.items()},
             {k: torch.from_numpy(v).to(td) if v.dtype == np.float32
              else torch.from_numpy(v) for k, v in h.items()})
            for h in host]


def _flips(arch: str, jb: dict, tb: dict, f32: bool):
    """A thunk listing the routing flips on this batch (MoE models)."""
    if not get_smoke_config(arch).is_moe:
        return None
    return lambda: _routing_flips(arch, jb, tb, JaxCtx(), ModelContext(),
                                  f32=f32)


def _grads(arch: str, batch: tuple, monkeypatch, f32: bool, **over):
    """(the reference's gradient tree, the port's model after backward) on
    ``batch``, a (reference, port) pair; config fields ``over`` on both
    sides; ``f32``: both packages with float32 activations."""
    if f32:
        _f32(monkeypatch)
    jb, tb = batch
    jm = jax_build(dataclasses.replace(jax_smoke(arch), **over))
    grads = jax.tree.map(np.asarray, jax.grad(lambda p: jm.loss(p, jb))(
        jax.tree.map(jnp.asarray, _tree(arch))))
    model = _port(arch, **over)
    zoo.loss(model, tb).backward()
    return grads, model


def _grad(model, name: str) -> np.ndarray:
    """A parameter's gradient; zeros where the loss does not reach it (an
    xLSTM block's leaves of the other kind), as the reference's."""
    p = model.get_parameter(name)
    return (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()


def _hold_grads(grads, model, atol, flips=None) -> None:
    """Every parameter's gradient against the reference's leaf, sliced per
    layer, within ``atol(name, leaf)``; an MoE model's failure lists the
    routing flips."""
    for name, _ in model.named_parameters():
        want, leaf = _ref_leaf(grads, name)
        try:
            np.testing.assert_allclose(_grad(model, name), want, rtol=0,
                                       atol=atol(name, leaf), err_msg=name)
        except AssertionError as e:
            if flips is None:
                raise
            raise AssertionError(f"{e}\nrouting flips (reference top-k gap "
                                 f"vs router-logit difference): {flips()}"
                                 ) from None


# --------------------------------------------------------------------------
# the four families: loss, gradients, train steps
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_matches_reference(arch):
    """``zoo.loss`` under grad on the f32 masters (pixtral's over its text
    positions only) against the reference's ``Model.loss``."""
    jb, tb = _pairs(arch, 1, seed=2)[0]
    want = float(jax_build(jax_smoke(arch)).loss(_tree(arch), jb))
    got = zoo.loss(_port(arch), tb)
    assert got.dtype == torch.float32 and got.dim() == 0 and got.requires_grad
    np.testing.assert_allclose(float(got.detach()), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("arch", FAMILIES)
def test_f32_gradients_match_reference(arch, monkeypatch):
    """With float32 activations in both packages, every gradient within
    1e-4 of its leaf's max |g|: no expert flips, and nothing of bf16's
    rounding in the way."""
    batch = _pairs(arch, 1, seed=3, f32=True)[0]
    grads, model = _grads(arch, batch, monkeypatch, f32=True)
    _hold_grads(grads, model, lambda n, leaf: 1e-4 * np.abs(leaf).max(),
                _flips(arch, *batch, f32=True))


@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_match_reference(arch, monkeypatch):
    """With the models' bf16 activations, every gradient within 2e-2 of
    its leaf's max |g| plus the reference's own bf16 rounding there (its
    bf16 gradient against its f32 one, on the same bf16 values)."""
    batch = _pairs(arch, 1, seed=3)[0]
    grads, model = _grads(arch, batch, monkeypatch, f32=False)
    with monkeypatch.context() as m:
        grads32, _ = _grads(arch, _pairs(arch, 1, seed=3, f32=True)[0], m,
                            f32=True)
    _hold_grads(grads, model, lambda n, leaf: 2e-2 * np.abs(leaf).max()
                + np.abs(leaf - _ref_leaf(grads32, n)[1]).max(),
                _flips(arch, *batch, f32=False))


def _trained(arch: str, M: int, f32: bool):
    """Three ``build_train_step`` steps of the port and of the reference
    on the same batches from the same weights, as
    ``test_torch_train._trained``: the (port, reference) metrics of each
    step and each leaf's trained-change deviation ``||dW_port - dW_ref||
    / ||dW_ref||``."""
    jm = jax_build(jax_smoke(arch))
    jopt = JaxAdamW(learning_rate=LR)
    jstep = jax.jit(jax_train_step(jm, jopt, None, microbatches=M))
    jparams = jax.tree.map(jnp.asarray, _tree(arch))
    jstate = jopt.init(jparams)
    model = _port(arch)
    opt = AdamW(learning_rate=LR, decayed=model.decayed())
    step = build_train_step(model, opt, None, microbatches=M)
    state = opt.init(dict(model.named_parameters()))
    mets = []
    for jb, tb in _pairs(arch, STEPS, seed=1, f32=f32):
        jparams, jstate, jmet = jstep(jparams, jstate, jb)
        mets.append((step(state, tb), jmet))
    dev = {}
    for (path, w0), ref, got in zip(
            jax.tree_util.tree_flatten_with_path(_tree(arch))[0],
            jax.tree.leaves(jax.tree.map(np.asarray, jparams)),
            jax.tree.leaves(_module(model.cfg).params_to_numpy(model))):
        d_ref = ref - w0
        dev[jax.tree_util.keystr(path)] = float(
            np.linalg.norm(got - w0 - d_ref) / np.linalg.norm(d_ref))
    return mets, dev


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps_match_reference(arch, M):
    """Three steps with bf16 activations: losses and grad norms within
    2e-2 relative, each leaf's trained change within ``DW_TOL_BF16``."""
    _hold_trained(*_trained(arch, M, f32=False), rtol=2e-2,
                  dw_tol=DW_TOL_BF16)


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_f32_train_steps_match_reference(arch, M, monkeypatch):
    """The same three steps with float32 activations in both packages:
    losses and grad norms within 1e-4 relative, each leaf's trained change
    within ``DW_TOL_F32``."""
    _f32(monkeypatch)
    _hold_trained(*_trained(arch, M, f32=True), rtol=1e-4,
                  dw_tol=DW_TOL_F32)


@pytest.mark.parametrize("arch", ["musicgen-large", "pixtral-12b"])
def test_train_run_feeds_token_batches_as_the_reference_does(arch):
    """``launch.train.run`` feeds ``SyntheticTokens`` whatever the family,
    as the reference's does: musicgen (no ``"embeds"`` in the batch) then
    trains on the ids through its embedding table in both packages, and
    pixtral's loss, which drops the first ``num_patches`` logits, meets
    labels of the full length and raises in both."""
    args = _args(arch=f"{arch}-smoke", steps=2, batch=4, seq=32)
    if arch == "pixtral-12b":
        with pytest.raises(ValueError, match="Incompatible shapes"):
            jax_train_run(args)
        with pytest.raises(RuntimeError, match="Size does not match"):
            train_run(args)
        return
    want, got = jax_train_run(args)["losses"], train_run(args)["losses"]
    assert len(want) == len(got) == 2
    np.testing.assert_allclose(got, want, rtol=2e-2)


# --------------------------------------------------------------------------
# remat policies
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-8b", "gemma2-9b",
                                  "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"])
def test_no_remat_full_and_dots_give_equal_gradients(arch):
    """Recomputing each unit in backward, all of it or all but the saved
    products, changes no value: the gradients equal each other bit for
    bit (gemma2's unit is its local/global pair, moonshot's MLP ends in
    its shared experts)."""
    tb = _pairs(arch, 1, seed=0)[0][1]
    out = []
    for over in (dict(remat=False), dict(remat=True, remat_policy="full"),
                 dict(remat=True, remat_policy="dots")):
        model = _port(arch, **over)
        zoo.loss(model, tb).backward()
        out.append({n: p.grad for n, p in model.named_parameters()})
    for got in out[1:]:
        for n in out[0]:
            torch.testing.assert_close(got[n], out[0][n], rtol=0, atol=0,
                                       msg=n)


def _product_numel(func, args) -> int:
    """Elements of the output of the product ``func(*args)``."""
    a, b = args[-2:]
    if func in (_aten.mm.default, _aten.addmm.default):
        return a.shape[0] * b.shape[1]
    return a.shape[0] * a.shape[1] * b.shape[2]


def _port_saved(arch: str, policy: str, monkeypatch) -> tuple:
    """(product elements the port's dots policy saves in its first unit,
    calls of the policy), on a (B, S, D) input under ``policy``."""
    cfg = dataclasses.replace(get_smoke_config(arch), remat=True)
    model = _port(arch)
    saved, calls = [], []
    policy_fn = remat.dots_policy

    def recording(ctx, func, *args, **kwargs):
        out = policy_fn(ctx, func, *args, **kwargs)
        calls.append(func)
        if (out == remat.CheckpointPolicy.MUST_SAVE
                and not ctx.is_recompute):
            saved.append(_product_numel(func, args))
        return out
    monkeypatch.setattr(remat, "dots_policy", recording)
    per = 2 if cfg.attn_pattern == "local_global" else 1
    x = (0.02 * torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, S, cfg.d_model)))).to(torch.bfloat16).requires_grad_()
    positions = torch.arange(S, dtype=torch.int32)
    y = remat.checkpointed(cfg, model._unit, x, range(per), positions,
                           ModelContext(), policy=policy)
    y.float().sum().backward()
    return sum(saved), len(calls)


def _ref_saved(arch: str, policy) -> int:
    """Elements of the reference's residuals of its first checkpoint unit
    under ``jax.checkpoint(policy=policy)`` that are neither arguments
    (the input, the weights) nor constants (the positions)."""
    cfg = jax_smoke(arch)
    blocks = jax.tree.map(jnp.asarray, _tree(arch)["blocks"])
    windows = ((cfg.window, 0) if cfg.attn_pattern == "local_global"
               else (0,))
    ps = [jax.tree.map(lambda a, i=i: a[i], blocks)
          for i in range(len(windows))]
    positions = jnp.arange(S)

    def unit(x, ps):
        for p, window in zip(ps, windows):
            x = ref_transformer.transformer_block(x, p, window, cfg,
                                                  JaxCtx(), positions)
        return x
    x = (0.02 * jax.random.normal(jax.random.key(0), (B, S, cfg.d_model))
         ).astype(jnp.bfloat16)
    body = jax.checkpoint(unit, policy=policy)
    res = saved_residuals(lambda x, ps: body(x, ps).astype(
        jnp.float32).sum(), x, ps)
    return sum(int(np.prod(aval.shape)) for aval, why in res
               if not why.startswith(("from the argument", "from a constant")))


@pytest.mark.parametrize("arch", ["granite-8b", "gemma2-9b",
                                  "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"])
def test_dots_saves_the_reference_residuals(arch, monkeypatch):
    """The products the port's dots policy saves in one unit hold as many
    elements as the reference's non-argument residuals under
    ``dots_with_no_batch_dims_saveable`` (the projections, the router's
    logits and the MoE's first expert product; not the unit's closing
    MLP product where only the residual add reads it); under full remat
    the reference keeps none and the port never asks the policy."""
    want = _ref_saved(
        arch, jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    got, calls = _port_saved(arch, "dots", monkeypatch)
    assert got == want > 0 and calls > 0
    assert _ref_saved(arch, None) == 0
    assert _port_saved(arch, "full", monkeypatch) == (0, 0)


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_dots_recomputes_hybrid_and_xlstm_units_whole(arch, monkeypatch):
    """The reference's hybrid and xLSTM units call ``jax.checkpoint``
    without a policy, so a ``remat_policy="dots"`` config trains there as
    under full remat; the port's gives the reference's gradients, with
    float32 activations in both packages within 1e-4 of each leaf's max
    |g|."""
    host = next(iter(SyntheticTokens(get_smoke_config(arch).vocab_size, S,
                                     seed=3, batch_size=B)))
    batch = ({k: jnp.asarray(v) for k, v in host.items()},
             {k: torch.from_numpy(v) for k, v in host.items()})
    grads, model = _grads(arch, batch, monkeypatch, f32=True, remat=True,
                          remat_policy="dots")
    _hold_grads(grads, model, lambda n, leaf: 1e-4 * np.abs(leaf).max())


def test_no_batch_dims_follows_the_operands():
    """A product has no batch dimensions when it is an ``mm``, or a
    ``bmm`` whose operand is broadcast over the batch (``torch.matmul``
    of a 2-D tensor by a 3-D one, expanded with stride 0); a ``bmm`` of
    two batched operands has them."""
    a, b = torch.randn(4, 3), torch.randn(3, 5)
    assert remat.no_batch_dims(_aten.mm.default, (a, b))
    batched = torch.randn(2, 4, 3)
    assert not remat.no_batch_dims(_aten.bmm.default,
                                   (batched, torch.randn(2, 3, 5)))
    assert remat.no_batch_dims(_aten.bmm.default,
                               (a.expand(2, 4, 3), torch.randn(2, 3, 5)))
    assert not remat.no_batch_dims(_aten.add.Tensor, (a, a))
