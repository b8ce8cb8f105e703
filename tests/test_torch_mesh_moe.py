"""Expert parallelism (``repro_torch.models.moe.moe_ep``) on gloo ranks on
the CPU, held to the reference.

At a capacity factor of 8 nothing is dropped, and EP equals the dense
oracle (the reference's ``moe_block`` on one device) at the reference's
own test tolerances; the gradients of sum(y * w) with respect to x, the
router and both expert weights equal ``jax.grad`` of the same oracle.  At
a capacity factor of 1.0 pairs are dropped: the port's EP and the
reference's ``moe_ep`` on the same (1, 4) mesh, run in a subprocess with
4 forced host devices as ``tests/test_distributed.py`` runs it, give the
same outputs and gradients and drop the same (token, expert) pairs.
Each test spawns one world under its own timeout (``run_ranks``); the
ranks import neither ``jax`` nor ``repro``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np

from repro_torch.launch.mesh import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, E, F, K = 32, 8, 16, 2
WORLD_TIMEOUT = 180.0
NAMES = ("x", "router", "wi", "wo")
#: the gradients against the reference's: max |diff| over max |g| (f32;
#: at most 4.3e-7 measured, at capacity factors 8 and 1.0)
GRAD_TOL = 1e-5


def _inputs(seed: int = 0) -> dict:
    """The reference test's shapes: x (8, 16, D) f32, E = 8 experts; w,
    the cotangent of the gradient checks, like x."""
    rng = np.random.default_rng(seed)
    return {"router": (0.5 * rng.standard_normal((D, E))).astype(np.float32),
            "wi": (0.1 * rng.standard_normal((E, D, 2 * F))).astype(
                np.float32),
            "wo": (0.1 * rng.standard_normal((E, F, D))).astype(np.float32),
            "x": rng.standard_normal((8, 16, D)).astype(np.float32),
            "w": rng.standard_normal((8, 16, D)).astype(np.float32)}


def _hold_grads(got: dict, want: dict, what: str) -> None:
    for name in NAMES:
        g, r = got[name], want[name]
        assert g.shape == r.shape, (what, name)
        err = np.abs(g - r).max() / np.abs(r).max()
        assert err <= GRAD_TOL, f"{what}: d{name} {err} > {GRAD_TOL}"


def _ep_worker(rank, world, inp, cf):
    """EP on a (1, world) mesh: the output, the gradients of sum(y * w)
    (each gathered whole), and the pairs this rank keeps."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.models.sharding import (
        ModelContext, default_rules, mesh_scope)
    mesh = make_local_mesh(1, world, device="cpu")
    ctx = ModelContext(mesh=mesh, rules=default_rules(), moe_impl="ep")
    t = {k: torch.from_numpy(inp[k]).requires_grad_() for k in NAMES}
    params = {k: t[k] for k in ("router", "wi", "wo")}
    kw = dict(k=K, n_experts=E, n_shared=0, capacity_factor=cf)
    y = moe.moe_block(t["x"], params, ctx=ctx, **kw)
    out = {"y": y.full_tensor().detach().numpy()}
    with mesh_scope(ctx):
        (y * torch.from_numpy(inp["w"])).sum().backward()
    out["grads"] = {k: (v.grad.full_tensor() if hasattr(v.grad, "placements")
                        else v.grad).numpy() for k, v in t.items()}
    # the pairs this rank keeps, by the dispatch moe_ep runs, on its own
    # routing of its slice of the tokens
    T = inp["x"].shape[0] * inp["x"].shape[1] // world
    xt = t["x"].detach().reshape(-1, D)[rank * T:(rank + 1) * T]
    _, idx, _ = moe.router_probs(xt, params["router"].detach(), K)
    order, _, _, keep = moe.dispatch_slots(
        idx, E, moe.capacity(T, K, cf, E))
    kept = torch.zeros(T * K, dtype=torch.bool)
    kept[order] = keep
    out["keep"] = kept.reshape(T, K).numpy()
    out["idx"] = idx.numpy()
    return out


def test_moe_ep_matches_dense(tmp_path):
    """EP over model = 4 (8 experts, 2 a rank) at capacity factor 8 (no
    drops) against the reference's dense oracle on one device: the output
    at rtol 2e-4, atol 2e-5, as the reference's own EP test; the
    gradients of sum(y * w) against ``jax.grad`` of the oracle's within
    ``GRAD_TOL``, on every rank (the declared gradient placements, the
    gather's backward and both exchanges' transposes)."""
    import jax
    import jax.numpy as jnp
    from repro.models.moe import moe_block as jax_moe_block
    inp = _inputs()

    def loss(x, router, wi, wo):
        y = jax_moe_block(x, {"router": router, "wi": wi, "wo": wo}, k=K,
                          n_experts=E, n_shared=0, capacity_factor=8.0,
                          ctx=None)
        return jnp.sum(y * inp["w"]), y
    (_, want), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                      has_aux=True)(
        *(jnp.asarray(inp[n]) for n in NAMES))
    want_g = {n: np.asarray(v) for n, v in zip(NAMES, g)}
    got = run_ranks(_ep_worker, 4, inp, 8.0, out_dir=tmp_path,
                    timeout=WORLD_TIMEOUT)
    for rank, r in enumerate(got):
        np.testing.assert_allclose(r["y"], np.asarray(want), rtol=2e-4,
                                   atol=2e-5)
        assert r["keep"].all() and r["keep"].size == 8 * 16 * K // 4
        _hold_grads(r["grads"], want_g, f"rank {rank}")


REF_EP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.launch.mesh import make_local_mesh
    from repro.models.moe import moe_block, router_probs
    from repro.models.sharding import ModelContext, default_rules
    assert jax.device_count() == 4
    d = dict(np.load(sys.argv[1]))
    cf, k, E = float(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
    mesh = make_local_mesh(1, 4)
    ctx = ModelContext(mesh=mesh, rules=default_rules(), moe_impl="ep")
    names = ("x", "router", "wi", "wo")

    def loss(x, router, wi, wo):
        y = moe_block(x, {"router": router, "wi": wi, "wo": wo}, k=k,
                      n_experts=E, n_shared=0, capacity_factor=cf, ctx=ctx)
        return jnp.sum(y * d["w"]), y
    (_, y), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(d[n]) for n in names))
    params = {n: jnp.asarray(d[n]) for n in ("router", "wi", "wo")}
    # the reference's dispatch on each EP rank's token slice (its
    # _ep_local: a stable argsort, searchsorted slots, pos < C kept)
    xt = d["x"].reshape(-1, d["x"].shape[-1])
    T = xt.shape[0] // 4
    C = max(1, int(T * k * cf) // E)
    keeps, idxs, ys = [], [], []
    for r in range(4):
        gates, idx, _ = router_probs(jnp.asarray(xt[r * T:(r + 1) * T]),
                                     params["router"], k)
        flat = np.asarray(idx).reshape(-1)
        order = np.argsort(flat, kind="stable")
        se = flat[order]
        pos = np.arange(T * k) - np.searchsorted(se, np.arange(E))[se]
        keep = np.zeros(T * k, bool)
        keep[order] = pos < C
        keeps.append(keep.reshape(T, k))
        idxs.append(np.asarray(idx))
        # the slice's output rebuilt from the kept pairs alone
        h = np.einsum("td,edf->etf", xt[r * T:(r + 1) * T], d["wi"])
        g, u = np.split(h, 2, axis=-1)
        ye = np.einsum("etf,efd->etd", g / (1 + np.exp(-g)) * u, d["wo"])
        w = np.asarray(gates) * keep.reshape(T, k)
        ys.append(sum(w[:, j, None] * ye[np.asarray(idx)[:, j],
                                          np.arange(T)] for j in range(k)))
    np.savez(sys.argv[2], y=np.asarray(y), keep=np.stack(keeps),
             idx=np.stack(idxs), y_kept=np.concatenate(ys),
             **{"g_" + n: np.asarray(v) for n, v in zip(names, grads)})
""")


def test_moe_ep_drops_the_reference_pairs(tmp_path):
    """At capacity factor 1.0 the port's EP and the reference's ``moe_ep``
    on a (1, 4) mesh drop the same (token, expert) pairs and give the
    same outputs (rtol 2e-4, atol 2e-5) and the same gradients of
    sum(y * w) (``GRAD_TOL``; the reference's differentiated under
    ``jit``).  The reference's dropped pairs are those its dispatch keeps
    out; its output is held to the output rebuilt from its kept pairs, so
    they are the pairs it dropped."""
    inp = _inputs(3)
    np.savez(tmp_path / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_EP, str(tmp_path / "in.npz"),
                        str(tmp_path / "ref.npz"), "1.0", str(K), str(E)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    ref = np.load(tmp_path / "ref.npz")
    np.testing.assert_allclose(ref["y"].reshape(-1, D), ref["y_kept"],
                               rtol=1e-4, atol=1e-5)
    assert (~ref["keep"]).sum() > 0                 # the case drops pairs
    got = run_ranks(_ep_worker, 4, inp, 1.0, out_dir=tmp_path / "w",
                    timeout=WORLD_TIMEOUT)
    want_g = {n: ref["g_" + n] for n in NAMES}
    for rank, g in enumerate(got):
        np.testing.assert_array_equal(g["idx"], ref["idx"][rank])
        np.testing.assert_array_equal(g["keep"], ref["keep"][rank])
        np.testing.assert_allclose(g["y"], ref["y"], rtol=2e-4, atol=2e-5)
        _hold_grads(g["grads"], want_g, f"rank {rank}")
