"""The model zoo on a device mesh of gloo ranks on the CPU, held to the
reference's single-device results at ``tests/test_distributed.py``'s
tolerances:

* granite-34b (MQA) at (1, 4): decode against a cache sharded along its
  sequence (``kv_seq`` over ``model``), teacher-forced over positions
  that fall in three ranks' slices, under ``auto`` and ``pallas`` (the
  grouped einsum on DTensors either way); and prefill under ``pallas``
  with the query heads over ``model``, each rank's flash attention
  reading the single KV head;
* xlstm-1.3b at (1, 4) under ``parallelism="ring"`` (the sequence over
  ``model``): the forward, and ``mlstm_seq_parallel`` against the
  reference's ``mlstm_chunked`` in float32;
* xlstm-1.3b under ``"vtp"`` (the merged weights), in process: rules
  set, no mesh, so every ``shard`` is a no-op, as in the reference;
* zamba2-7b at (2, 2) under ``pallas``: the forward, the SSD state scan
  and attention per rank.

Each multi-rank test spawns one world under its own timeout
(``run_ranks``); the ranks import neither ``jax`` nor ``repro``.
"""

import functools
import types

import numpy as np
import torch

from repro_torch.launch.mesh import run_ranks

WORLD_TIMEOUT = 180.0
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _ref_model(arch: str):
    """The reference's smoke model and its params (key 0), as numpy."""
    import jax
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.zoo import build_model as jax_build
    jm = jax_build(jax_smoke(arch))
    params = jm.init_params(jax.random.key(0))
    return jm, params, jax.tree.map(lambda a: np.asarray(a, np.float32),
                                    params)


def _port(arch: str, tree: dict, trainable: bool = False):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import hybrid, transformer, xlstm
    cfg = get_smoke_config(arch)
    mod = {"hybrid": hybrid, "ssm": xlstm}.get(cfg.family, transformer)
    return mod.params_from_jax(tree, cfg, "cpu", trainable=trainable)


# --------------------------------------------------------------------------
# granite-34b: sequence-sharded decode, head-sharded prefill
# --------------------------------------------------------------------------

DEC_B, DEC_T = 4, 32
#: teacher-forced decode positions: slices 0, 1 and 2 of the 8-position
#: shards
DEC_POS = (0, 9, 17)


def _granite34b_worker(rank, world, tree, toks, prompt):
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.shardings import assemble, place
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    mesh = make_local_mesh(1, world, device="cpu")
    out = {}
    for impl in ("auto", "pallas"):
        model = _port("granite-34b", tree)
        ctx, sh = assemble(model, mesh, "decode", DEC_B, DEC_T,
                           attention_impl=impl)
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
        out[f"decode_{impl}"] = np.stack(logits)
    model = _port("granite-34b", tree)
    ctx, sh = assemble(model, mesh, "prefill", *prompt.shape,
                       attention_impl="pallas")
    out["heads"] = ctx.rules["heads"]
    place(model, sh["params"], mesh)
    tokens = place(torch.from_numpy(prompt), sh["batch"]["tokens"], mesh)
    out["prefill"] = build_prefill_step(model, ctx)(
        tokens).full_tensor().float().numpy()
    return out if rank == 0 else None


def test_granite34b_seq_sharded_decode_and_head_sharded_prefill(tmp_path):
    """Decode with ``kv_seq`` over ``model`` at (1, 4) within 2e-2 of the
    reference's unsharded steps, at positions in three ranks' slices of
    the cache; prefill with one query head a rank, all reading KV head 0,
    within 2e-2 of the reference's."""
    import jax
    import jax.numpy as jnp
    jm, params, tree = _ref_model("granite-34b")
    rng = np.random.default_rng(1)
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
    got = run_ranks(_granite34b_worker, 4, tree, toks, prompt,
                    out_dir=tmp_path, timeout=WORLD_TIMEOUT)[0]
    assert tuple(got["kv_seq"]) == ("model",)
    assert got["heads"] == "model"
    for impl in ("auto", "pallas"):
        np.testing.assert_allclose(got[f"decode_{impl}"], np.stack(want),
                                   **BF16_TOL)
    np.testing.assert_allclose(got["prefill"], want_prefill, **BF16_TOL)


# --------------------------------------------------------------------------
# xlstm-1.3b: ring (sequence parallel) and vtp
# --------------------------------------------------------------------------

RING_B, RING_S = 2, 64


def _ring_worker(rank, world, tree, tokens, mlstm):
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.shardings import make_rules
    from repro_torch.models.sharding import ModelContext
    from repro_torch.models.xlstm import mlstm_seq_parallel
    mesh = make_local_mesh(1, world, device="cpu")
    cfg = get_smoke_config("xlstm-1.3b")
    rules = make_rules(cfg, mesh, "prefill", RING_B, parallelism="ring")
    ctx = ModelContext(mesh=mesh, rules=rules)
    model = _port("xlstm-1.3b", tree)
    out = {"logits": model(torch.from_numpy(tokens), ctx)
           .full_tensor().float().numpy()}
    q, k, v, ig, fg = (torch.from_numpy(a) for a in mlstm)
    out["mlstm"] = mlstm_seq_parallel(
        q, k, v, ig, fg, mesh=mesh, batch_axes=rules["batch"],
        chunk=RING_S // world).full_tensor().numpy()
    return out if rank == 0 else None


def test_ring_mlstm_matches_baseline(tmp_path):
    """xlstm-1.3b's forward with the sequence over a 4-way ``model``
    axis (the sLSTM gathered, the mLSTM by the affine state exchange)
    within 0.05 of the reference's single-device forward, its own test's
    limit; ``mlstm_seq_parallel`` against the reference's
    ``mlstm_chunked`` in float32 within 1e-5 (a 16-position chunk a rank,
    both chunked alike)."""
    import jax
    import jax.numpy as jnp
    from repro.models.xlstm import mlstm_chunked
    jm, params, tree = _ref_model("xlstm-1.3b")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jm.cfg.vocab_size, (RING_B, RING_S)).astype(
        np.int32)
    want = np.asarray(jax.jit(jm.forward)(params, {
        "tokens": jnp.asarray(tokens)}), np.float32)
    nh, hd = 4, 16
    mlstm = [rng.standard_normal((RING_B, RING_S, nh, hd)).astype(np.float32)
             for _ in range(3)]
    mlstm += [rng.standard_normal((RING_B, RING_S, nh)).astype(np.float32),
              (2.0 + rng.standard_normal((RING_B, RING_S, nh))).astype(
                  np.float32)]
    want_m, _ = jax.jit(functools.partial(mlstm_chunked, chunk=16))(
        *(jnp.asarray(a) for a in mlstm))
    got = run_ranks(_ring_worker, 4, tree, tokens, mlstm, out_dir=tmp_path,
                    timeout=WORLD_TIMEOUT)[0]
    err = np.abs(got["logits"] - want).max()
    assert err < 0.05, err
    np.testing.assert_allclose(got["mlstm"], np.asarray(want_m), rtol=1e-5,
                               atol=1e-5)


def test_vtp_matches_reference_arithmetic():
    """``parallelism="vtp"`` at (1, 2): the merged ``up_proj @ qkv`` and
    ``up_proj @ gates`` weights, in process with the rules and no mesh
    (every ``shard`` a no-op, as the reference's), against the
    reference's vtp forward: bf16 within 2e-2, and with float32
    activations and the f32 masters in both packages within 1e-4."""
    import jax
    import jax.numpy as jnp
    from repro.launch.shardings import make_rules as ref_rules
    from repro.models import xlstm as ref_xlstm
    from repro.models.sharding import ModelContext as JaxCtx
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.shardings import make_rules
    from repro_torch.models import xlstm
    from repro_torch.models.sharding import ModelContext
    jm, params, tree = _ref_model("xlstm-1.3b")
    cfg = get_smoke_config("xlstm-1.3b")
    rules = make_rules(cfg, types.SimpleNamespace(
        mesh_dim_names=("data", "model"), shape=(1, 2)), "prefill", 2,
        parallelism="vtp")
    want_rules = ref_rules(jm.cfg, types.SimpleNamespace(
        shape={"data": 1, "model": 2}, axis_names=("data", "model")),
        "prefill", 2, parallelism="vtp")
    assert rules == want_rules and rules["xlstm_hd"] == "model"
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    ctx, jctx = ModelContext(rules=rules), JaxCtx(rules=want_rules)
    assert not ctx.distributed

    def ref(p):
        return np.asarray(jax.jit(lambda q: jm.forward(
            q, {"tokens": jnp.asarray(tokens)}, jctx))(p), np.float32)
    got = _port("xlstm-1.3b", tree)(torch.from_numpy(tokens), ctx)
    np.testing.assert_allclose(got.float().numpy(), ref(params), **BF16_TOL)
    # float32 activations in both packages: the embedding's bf16 cast
    # patched to f32 in the reference's module, as test_torch_moe does
    ns = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                  if not k.startswith("__")})
    ns.bfloat16 = jnp.float32
    saved = (ref_xlstm.jnp, xlstm.ACT_DTYPE)
    ref_xlstm.jnp, xlstm.ACT_DTYPE = ns, torch.float32
    try:
        want32 = ref(params)
        got32 = _port("xlstm-1.3b", tree, trainable=True)(
            torch.from_numpy(tokens), ctx)
    finally:
        ref_xlstm.jnp, xlstm.ACT_DTYPE = saved
    np.testing.assert_allclose(got32.detach().numpy(), want32, rtol=1e-4,
                               atol=1e-4)
    # the merged weights change the arithmetic: without the rules the
    # forward is the plain one
    plain = _port("xlstm-1.3b", tree)(torch.from_numpy(tokens))
    np.testing.assert_allclose(plain.float().numpy(), ref(params),
                               **BF16_TOL)


# --------------------------------------------------------------------------
# zamba2-7b at (2, 2)
# --------------------------------------------------------------------------


def _zamba2_worker(rank, world, tree, tokens):
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.shardings import assemble, place
    mesh = make_local_mesh(2, 2, device="cpu")
    model = _port("zamba2-7b", tree)
    ctx, sh = assemble(model, mesh, "prefill", *tokens.shape,
                       attention_impl="pallas")
    place(model, sh["params"], mesh)
    t = place(torch.from_numpy(tokens), sh["batch"]["tokens"], mesh)
    out = model(t, ctx).full_tensor().float().numpy()
    return (out, ctx.rules["ssm_heads"]) if rank == 0 else None


def test_zamba2_forward_on_a_2x2_mesh(tmp_path):
    """zamba2-7b's forward at (2, 2) (batch over data, SSM heads and
    attention heads over model) under ``pallas``, whose SSD state scan,
    flash attention and RMSNorm run per rank (their plain versions on
    the CPU), within 2e-2 of the reference's single-device forward."""
    import jax
    import jax.numpy as jnp
    jm, params, tree = _ref_model("zamba2-7b")
    tokens = np.random.default_rng(5).integers(
        0, jm.cfg.vocab_size, (4, 64)).astype(np.int32)
    want = np.asarray(jax.jit(jm.forward)(params, {
        "tokens": jnp.asarray(tokens)}), np.float32)
    got, ssm_heads = run_ranks(_zamba2_worker, 4, tree, tokens,
                               out_dir=tmp_path, timeout=WORLD_TIMEOUT)[0]
    assert ssm_heads == "model"
    np.testing.assert_allclose(got, want, **BF16_TOL)
