"""The model zoo on gloo ranks at layouts where a dim the model code
splits does not divide over the ranks that shard it, held to the
reference's single-device numbers at ``tests/test_torch_mesh*.py``'s
tolerances.  The production meshes (16 ``model`` ranks) meet such dims
everywhere (granite-8b's 8 KV heads, qwen3's 4, xLSTM's three-way qkv
split); GSPMD pads them, DTensor refuses to split them:

* granite-8b-smoke (4 heads, 2 KV heads) at (1, 4): the prefill, and
  decode steps against a cache sharded along its sequence, whose query
  heads are sharded 4 ways over 2 KV heads (each rank's slice attends
  with every head of its requests; the slices combine by log-sum-exp);
* xlstm-1.3b-smoke at (1, 4): the mLSTM's qkv product (3 x 128 columns
  over 4 ranks) gathered before its three-way split, prefill and decode;
* granite-8b-smoke at (2, 4) with remat and 4 microbatches of a 4-row
  batch: the masters in the ZeRO layout (``d_model`` over ``data``), so
  a recompute that read them, not the gathered weights, split a
  KV-sharded product (``remat._with_weights_of_now``);
  each rank's 2 rows make 2 microbatches, not 4 (``steps._parts``); the
  loss over vocab-sharded logits (``layers._nll_on_shards``); the MLP's
  gate and up halves by one all-to-all (``layers._halves``).  Loss and
  every gradient against the reference's, then one train step.

Each test spawns one world (``run_ranks``) under its own timeout; the
ranks import neither ``jax`` nor ``repro``.
"""

import dataclasses

import numpy as np

from repro_torch.launch.mesh import run_ranks

WORLD_TIMEOUT = 240.0
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DEC_B, DEC_T = 4, 32
#: teacher-forced decode positions: slices 0, 1 and 3 of the 8-position
#: shards
DEC_POS = (0, 9, 27)


def _ref_model(arch: str, **cfg_kw):
    import jax
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.zoo import build_model as jax_build
    jm = jax_build(dataclasses.replace(jax_smoke(arch), **cfg_kw))
    params = jm.init_params(jax.random.key(0))
    return jm, params, jax.tree.map(lambda a: np.asarray(a, np.float32),
                                    params)


def _port(arch: str, tree: dict, trainable: bool = False, **cfg_kw):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer, xlstm
    cfg = dataclasses.replace(get_smoke_config(arch), **cfg_kw)
    mod = xlstm if cfg.family == "ssm" else transformer
    return mod.params_from_jax(tree, cfg, "cpu", trainable=trainable)


def _serve_worker(rank, world, arch, tree, toks, prompt):
    """Prefill and teacher-forced decode steps at (1, world)."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.shardings import assemble, place
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    mesh = make_local_mesh(1, world, device="cpu")
    out = {}
    model = _port(arch, tree)
    ctx, sh = assemble(model, mesh, "prefill", *prompt.shape)
    out["prefill_rules"] = {k: ctx.rules[k] for k in ("heads", "d_ff")}
    place(model, sh["params"], mesh)
    tokens = place(torch.from_numpy(prompt), sh["batch"]["tokens"], mesh)
    out["prefill"] = build_prefill_step(model, ctx)(
        tokens).full_tensor().float().numpy()
    model = _port(arch, tree)
    ctx, sh = assemble(model, mesh, "decode", DEC_B, DEC_T)
    out["kv_seq"] = ctx.rules["kv_seq"]
    place(model, sh["params"], mesh)
    cache = place(model.init_cache(DEC_B, DEC_T), sh["cache"], mesh)
    step = build_serve_step(model, ctx)
    logits = []
    for t, p in zip(toks, DEC_POS):
        tok = place(torch.from_numpy(t), sh["tokens"], mesh)
        pos = place(torch.full((DEC_B,), p, dtype=torch.int32),
                    sh["tokens"], mesh)
        lg, cache = step(cache, tok, pos)
        logits.append(lg.full_tensor().float().numpy())
    out["decode"] = np.stack(logits)
    return out if rank == 0 else None


def _ref_serve(jm, params, seed: int):
    """The reference's teacher-forced decode logits at ``DEC_POS`` and
    its prefill's last-position logits, on ids from ``seed``."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    V = jm.cfg.vocab_size
    toks = [rng.integers(0, V, DEC_B).astype(np.int32) for _ in DEC_POS]
    cache = jm.init_cache(DEC_B, DEC_T)
    step = jax.jit(jm.decode_step)
    want = []
    for t, p in zip(toks, DEC_POS):
        lg, cache = step(params, cache, jnp.asarray(t),
                         jnp.full((DEC_B,), p, jnp.int32))
        want.append(np.asarray(lg, np.float32))
    prompt = rng.integers(0, V, (2, 16)).astype(np.int32)
    want_prefill = np.asarray(jax.jit(jm.forward)(params, {
        "tokens": jnp.asarray(prompt)})[:, -1], np.float32)
    return toks, np.stack(want), prompt, want_prefill


def test_query_heads_over_more_ranks_than_kv_heads(tmp_path):
    """granite-8b-smoke at (1, 4): 4 query heads over the 4 ``model``
    ranks, 2 KV heads; prefill and three decode steps (at positions in
    three ranks' slices of the cache) within 2e-2 of the reference's."""
    jm, params, tree = _ref_model("granite-8b")
    toks, want, prompt, want_prefill = _ref_serve(jm, params, 3)
    got = run_ranks(_serve_worker, 4, "granite-8b", tree, toks, prompt,
                    out_dir=tmp_path, timeout=WORLD_TIMEOUT)[0]
    assert got["prefill_rules"]["heads"] == "model"
    assert tuple(got["kv_seq"]) == ("model",)
    np.testing.assert_allclose(got["prefill"], want_prefill, **BF16_TOL)
    np.testing.assert_allclose(got["decode"], want, **BF16_TOL)


def test_xlstm_qkv_split_over_four_ranks(tmp_path):
    """xlstm-1.3b-smoke at (1, 4): the qkv projection's 384 columns over
    the 4 ``model`` ranks (``d_ff``), split three ways; prefill and three
    decode steps within 2e-2 of the reference's."""
    jm, params, tree = _ref_model("xlstm-1.3b")
    toks, want, prompt, want_prefill = _ref_serve(jm, params, 4)
    got = run_ranks(_serve_worker, 4, "xlstm-1.3b", tree, toks, prompt,
                    out_dir=tmp_path, timeout=WORLD_TIMEOUT)[0]
    assert got["prefill_rules"]["d_ff"] == "model"
    np.testing.assert_allclose(got["prefill"], want_prefill, **BF16_TOL)
    np.testing.assert_allclose(got["decode"], want, **BF16_TOL)


TRAIN_KW = dict(remat=True, microbatches=4)
TRAIN_B, TRAIN_S = 4, 16


def _train_worker(rank, world, tree, batch, cfg_kw):
    """granite-8b-smoke at (2, 4): the loss and every gradient (whole)
    through ``build_loss_fn``, then one microbatched train step."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.shardings import assemble, place
    from repro_torch.launch.steps import (
        _parts, build_loss_fn, build_train_step)
    from repro_torch.models.sharding import mesh_scope
    from repro_torch.optim import AdamW
    mesh = make_local_mesh(2, world // 2, device="cpu")
    model = _port("granite-8b", tree, trainable=True, **cfg_kw)
    ctx, sh = assemble(model, mesh, "train", TRAIN_B, TRAIN_S)
    place(model, sh["opt_params"], mesh)
    tb = place({k: torch.from_numpy(v) for k, v in batch.items()},
               sh["batch"], mesh)
    out = {"parts": _parts(tb, model.cfg.microbatches)}
    loss = build_loss_fn(model, ctx, sh["params"])(tb)
    with mesh_scope(ctx):
        loss.backward()
    out["loss"] = loss.full_tensor().item()
    out["grads"] = {n: p.grad.full_tensor().numpy()
                    for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    opt = AdamW(learning_rate=1e-3, decayed=model.decayed())
    state = opt.init(dict(model.named_parameters()))
    metrics = build_train_step(model, opt, ctx, compute=sh["params"])(
        state, tb)
    out["step_loss"] = metrics["loss"].item()
    out["finite"] = all(bool(torch.isfinite(p.full_tensor()).all())
                        for p in model.parameters())
    return out if rank == 0 else None


def test_train_step_at_two_by_four(tmp_path):
    """granite-8b-smoke at (2, 4), remat on, 4 microbatches of a 4-row
    batch (2 rows a ``data`` rank: 2 microbatches of 2): the loss within
    2e-4 of the reference's single-device loss (4 microbatches of 1),
    each gradient within 2e-2 of max |g|, as ``test_torch_mesh_train.py``
    holds its own; the train step's loss the same, its weights finite."""
    import jax
    from repro.models.zoo import build_model as jax_build
    from repro.configs import get_smoke_config as jax_smoke
    jm, params, tree = _ref_model("granite-8b", **TRAIN_KW)
    jb = jax_build(dataclasses.replace(jax_smoke("granite-8b"), **TRAIN_KW))
    batch = jb.make_batch(jax.random.key(1), TRAIN_B, TRAIN_S)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, batch, None)))(params)
    grads = jax.tree.map(lambda a: np.asarray(a, np.float32), grads)
    got = run_ranks(_train_worker, 8, tree,
                    {k: np.asarray(v) for k, v in batch.items()}, TRAIN_KW,
                    out_dir=tmp_path, timeout=WORLD_TIMEOUT)[0]
    assert got["parts"] == 2
    np.testing.assert_allclose(got["loss"], float(loss), rtol=2e-4)
    assert got["grads"]
    for name, g in got["grads"].items():
        parts = name.split(".")
        want = (grads[parts[0]] if len(parts) == 1
                else grads[parts[0]][parts[-1]][int(parts[1])])
        err = np.abs(g - want).max() / max(np.abs(want).max(), 1e-6)
        assert err < 2e-2, (name, err)
    np.testing.assert_allclose(got["step_loss"], float(loss), rtol=2e-4)
    assert got["finite"]
