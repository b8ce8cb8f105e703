"""The port's optimiser substrate (``repro_torch.optim``) against the
reference's (``repro.optim``), on the CPU.

AdamW is held to the reference's over three steps on the same grads at
1e-6, with clipping on and off; the schedule at every step of 0..40; the
int8 compressor to the same scale and values.  The decayed sets of the
port's models are pinned to the reference's rule in the reference's
layout: a leaf of rank >= 2 in its ``init_params`` tree, where each
per-layer parameter is stacked on a leading layer axis.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.compat import AxisType, make_mesh, shard_map
from repro.configs import get_smoke_config as jax_smoke
from repro.models.zoo import build_model as jax_build
from repro.optim import AdamW as JaxAdamW
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import compressed_pod_mean as jax_pod_mean
from repro.optim import cosine_warmup as jax_cosine
from repro.optim import quantize_int8 as jax_quantize
from repro_torch.configs import get_smoke_config
from repro_torch.models.zoo import build_model
from repro_torch.optim import (
    AdamW, clip_by_global_norm, compressed_pod_mean, cosine_warmup,
    dequantize_int8, quantize_int8)

SHAPES = {"w": (6, 5), "b": (5,), "k": (2, 3, 4)}
#: the reference's rule on this tree, laid out as the reference's: the
#: tensors of rank >= 2 decay
RANK_RULE = frozenset(k for k, s in SHAPES.items() if len(s) >= 2)


def _grads(seed: int, scale: float) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_reference_over_three_steps(clip, schedule):
    """Grads of global norm about 4 (so clipping at 1 scales them) drawn
    anew each step; the port decays the set that the reference's rank
    rule picks on a tree laid out as the reference's."""
    lr = cosine_warmup(1e-2, 2, 10) if schedule else 1e-2
    jlr = jax_cosine(1e-2, 2, 10) if schedule else 1e-2
    port = AdamW(learning_rate=lr, grad_clip_norm=clip, decayed=RANK_RULE)
    ref = JaxAdamW(learning_rate=jlr, grad_clip_norm=clip)
    p0 = _grads(0, 1.0)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state, jstate = port.init(params), ref.init(jparams)
    for t in range(3):
        g = _grads(t + 1, 1.0)
        params, state, m = port.update(
            {k: torch.from_numpy(v) for k, v in g.items()}, state, params)
        jparams, jstate, jm = ref.update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        for k in SHAPES:
            for got, want in ((params[k], jparams[k]),
                              (state["m"][k], jstate["m"][k]),
                              (state["v"][k], jstate["v"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3


def test_adamw_decays_the_named_set_only():
    """``decayed`` names the tensors that decay, whatever their rank, and
    has no default: the rank rule is the reference's only in its
    layout."""
    g = {k: torch.from_numpy(v) for k, v in _grads(1, 1.0).items()}
    p0 = {k: torch.from_numpy(v) for k, v in _grads(0, 1.0).items()}

    def step(**kw):
        params = {k: v.clone() for k, v in p0.items()}
        opt = AdamW(learning_rate=1e-2, **kw)
        opt.update(g, opt.init(params), params)
        return params

    rank = step(decayed=RANK_RULE)                 # w, k
    only_b = step(decayed=frozenset({"b"}))
    none = step(decayed=frozenset())
    assert all(torch.equal(none[k], v) for k, v in
               step(decayed=RANK_RULE, weight_decay=0.0).items())
    assert torch.equal(only_b["w"], none["w"])
    assert torch.equal(only_b["k"], none["k"])
    assert torch.equal(rank["b"], none["b"])
    assert not torch.equal(only_b["b"], none["b"])
    assert not torch.equal(rank["w"], none["w"])
    with pytest.raises(TypeError, match="decayed"):
        AdamW(learning_rate=1e-2)


def test_adamw_descends_quadratic():
    opt = AdamW(learning_rate=0.1, weight_decay=0.0, decayed=frozenset())
    x = torch.tensor([5.0, -3.0], requires_grad=True)
    params = {"x": x}
    state = opt.init(params)
    for _ in range(200):
        loss = ((x - 1.0) ** 2).sum()
        (g,) = torch.autograd.grad(loss, x)
        opt.update({"x": g}, state, params)
    np.testing.assert_allclose(x.detach().numpy(), [1.0, 1.0], atol=1e-2)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _grads(3, 2.0)
    got, gn = clip_by_global_norm({k: torch.from_numpy(v)
                                   for k, v in g.items()}, max_norm)
    want, jgn = jax_clip({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
        assert got[k].dtype == torch.float32
    norm = float(torch.sqrt(sum(x.square().sum() for x in got.values())))
    assert norm == pytest.approx(min(max_norm, float(gn)), rel=1e-5)


def test_cosine_warmup_matches_reference_at_every_step():
    lr, jlr = cosine_warmup(1e-3, 10, 30), jax_cosine(1e-3, 10, 30)
    for s in range(41):
        got = lr(s)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == pytest.approx(float(jlr(jnp.asarray(s))),
                                           rel=1e-6, abs=1e-12)
        assert float(lr(torch.tensor(s, dtype=torch.int32))) == float(got)
    assert float(lr(0)) == 0.0
    assert float(lr(40)) == pytest.approx(1e-4, rel=1e-5)


def test_quantize_matches_reference_and_error_bounded():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jax_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert float(s) == pytest.approx(float(js), rel=1e-7)
    assert np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1
    err = np.abs((dequantize_int8(q, s) - torch.from_numpy(x)).numpy())
    assert err.max() <= float(s) * 0.5 + 1e-6


def test_compressed_pod_mean_one_rank_matches_reference():
    """``group=None`` gathers this rank alone, as the reference's 1-sized
    pod axis does: mean + error equals the input, and both equal the
    reference's."""
    x = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    e0 = np.zeros_like(x)
    mean, err = compressed_pod_mean(torch.from_numpy(x), torch.from_numpy(e0))
    np.testing.assert_allclose((mean + err).numpy(), x, rtol=1e-5, atol=1e-6)
    mesh = make_mesh((1,), ("pod",), axis_types=(AxisType.Auto,))
    P = jax.sharding.PartitionSpec
    fn = shard_map(lambda g, e: jax_pod_mean(g, e, "pod"), mesh=mesh,
                   in_specs=(P(), P()), out_specs=(P(), P()),
                   check_vma=False)
    jmean, jerr = fn(jnp.asarray(x), jnp.asarray(e0))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-6)


def test_compressed_pod_mean_over_a_group_gathers(tmp_path):
    """A one-rank gloo group takes the all-gather path and gives what
    ``group=None`` gives."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(32)
                         .astype(np.float32))
    e = torch.full_like(x, 0.01)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        got = compressed_pod_mean(x, e, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    want = compressed_pod_mean(x, e)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_error_feedback_sgd_converges():
    """Quadratic descent *through the compressor* still converges (the
    error-feedback guarantee)."""
    x = torch.tensor([4.0, -7.0, 2.0])
    err = torch.zeros_like(x)
    for _ in range(300):
        g = 2 * (x - 1.0)
        g_hat, err = compressed_pod_mean(g, err)
        x = x - 0.05 * g_hat
    np.testing.assert_allclose(x.numpy(), 1.0, atol=5e-2)


def _ref_leaf(tree: dict, name: str):
    """The reference's leaf holding the port's parameter ``name``, and
    whether it is stacked on a layer axis."""
    parts = name.split(".")
    if parts[0] in ("blocks", "mamba"):
        return tree[parts[0]][parts[2]], True
    if parts[0] == "shared_attn":
        return tree["shared_attn"][parts[1]], False
    return tree[parts[0]], False


@pytest.mark.parametrize("arch", ["granite-8b", "gemma2-9b", "zamba2-7b",
                                  "xlstm-1.3b"])
def test_decayed_sets_follow_the_reference_layout(arch):
    """The port decays exactly the parameters whose leaf in the reference's
    tree has rank >= 2; every reference leaf is some port parameter."""
    tree = jax.eval_shape(lambda: jax_build(jax_smoke(arch)).init_params(
        jax.random.key(0)))
    model = build_model(get_smoke_config(arch), "cpu")
    names = [n for n, _ in model.named_parameters()]
    want = set()
    for n in names:
        leaf, stacked = _ref_leaf(tree, n)
        assert leaf.ndim == model.get_parameter(n).dim() + stacked, n
        if leaf.ndim >= 2:
            want.add(n)
    assert model.decayed() == want
    paths = {"/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert paths == {"/".join(n.split(".")[::2]) if stacked else
                     n.replace(".", "/")
                     for n in names
                     for stacked in [_ref_leaf(tree, n)[1]]}
    norms = {n for n in names if n.endswith("norm") and "." in n
             and not n.startswith("shared_attn")}
    assert norms and norms <= model.decayed()          # per-layer norms decay
    assert "final_norm" not in model.decayed()


def test_decayed_set_is_rank_independent_of_dtype():
    cfg = dataclasses.replace(get_smoke_config("zamba2-7b"))
    a = build_model(cfg, "cpu").decayed()
    b = build_model(cfg, "cpu", trainable=True).decayed()
    assert a == b and {"mamba.0.A_log", "mamba.0.D", "mamba.0.dt_bias",
                       "mamba.0.norm", "mamba.0.out_norm"} <= a
    assert not {"shared_attn.attn_norm", "shared_attn.mlp_norm"} & a
