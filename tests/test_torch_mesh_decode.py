"""zamba2-7b's and xlstm-1.3b's decode step on a device mesh of gloo
ranks on the CPU, held to the reference's unsharded step.

Each smoke model carries the reference's weights (key 0) across by its
family's ``params_from_jax``.  Four requests decode against a 32-token
cache, teacher-forced with the same random tokens at positions 0, 9, 17
and 25 (each in another rank's slice of an 8-position shard of the
cache, where the cache's sequence is sharded), under ``auto`` and
``pallas`` (the plain versions of the kernels on the CPU), on the
(2, 2) and the (1, 4) ("data", "model") meshes: the placements
``launch.shardings.assemble`` gives, whose rules equal the reference's
``make_rules``.  Every step's logits lie within 2e-2 of the reference's
(bf16 activations in both packages).

Each test spawns one world of 4 ranks under its own timeout
(``run_ranks``); the ranks import neither ``jax`` nor ``repro``.
"""

import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_ranks
from test_torch_mesh_models import BF16_TOL, WORLD_TIMEOUT, _port, _ref_model

DEC_B, DEC_T = 4, 32
#: teacher-forced decode positions: slices 0, 1, 2 and 3 of the
#: 8-position shards
DEC_POS = (0, 9, 17, 25)
ARCHS = ("zamba2-7b", "xlstm-1.3b")
MESHES = ((2, 2), (1, 4))
IMPLS = ("auto", "pallas")


def _decode_worker(rank, world, arch, shape, tree, toks):
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.shardings import assemble, place
    from repro_torch.launch.steps import build_serve_step
    mesh = make_local_mesh(*shape, device="cpu")
    out = {}
    for impl in IMPLS:
        model = _port(arch, tree)
        ctx, sh = assemble(model, mesh, "decode", DEC_B, DEC_T,
                           attention_impl=impl)
        out["rules"] = dict(ctx.rules)
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
        out[impl] = np.stack(logits)
    return out if rank == 0 else None


@functools.cache
def _reference(arch: str) -> tuple:
    """The reference's tree (numpy), the teacher-forced tokens, and its
    unsharded steps' logits at ``DEC_POS``."""
    import jax
    import jax.numpy as jnp
    jm, params, tree = _ref_model(arch)
    rng = np.random.default_rng(6)
    toks = [rng.integers(0, jm.cfg.vocab_size, DEC_B).astype(np.int32)
            for _ in DEC_POS]
    cache = jm.init_cache(DEC_B, DEC_T)
    step = jax.jit(jm.decode_step)
    want = []
    for t, p in zip(toks, DEC_POS):
        lg, cache = step(params, cache, jnp.asarray(t),
                         jnp.full((DEC_B,), p, jnp.int32))
        want.append(np.asarray(lg, np.float32))
    return jm, tree, toks, np.stack(want)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_on_a_mesh_matches_reference(arch, shape, tmp_path):
    """Four teacher-forced decode steps of ``arch`` on a ``shape`` mesh,
    under ``auto`` and ``pallas``, within 2e-2 of the reference's
    unsharded steps; the placement rules are the reference's."""
    from repro.launch.shardings import make_rules as ref_rules
    jm, tree, toks, want = _reference(arch)
    got = run_ranks(_decode_worker, 4, arch, shape, tree, toks,
                    out_dir=tmp_path, timeout=WORLD_TIMEOUT)[0]
    rules = ref_rules(jm.cfg, types.SimpleNamespace(
        shape=dict(zip(("data", "model"), shape)),
        axis_names=("data", "model")), "decode", DEC_B)
    assert got["rules"] == rules
    for impl in IMPLS:
        assert got[impl].shape == want.shape
        np.testing.assert_allclose(got[impl], want, **BF16_TOL)


def test_decode_step_off_the_mesh_matches_reference():
    """The same steps off the mesh, in process, within 2e-2 of the
    reference's: the yardstick the mesh runs are read against."""
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models.sharding import ModelContext
    for arch in ARCHS:
        jm, tree, toks, want = _reference(arch)
        for impl in IMPLS:
            model = _port(arch, tree)
            step = build_serve_step(model, ModelContext(attention_impl=impl))
            cache = model.init_cache(DEC_B, DEC_T)
            got = []
            for t, p in zip(toks, DEC_POS):
                lg, cache = step(cache, torch.from_numpy(t),
                                 torch.full((DEC_B,), p, dtype=torch.int32))
                got.append(lg.float().numpy())
            np.testing.assert_allclose(np.stack(got), want, **BF16_TOL)
