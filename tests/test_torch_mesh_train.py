"""Training on a device mesh of gloo ranks on the CPU: the port's DTensor
train path held to the reference's single-device numbers, at
``tests/test_distributed.py``'s tolerances.

Each test spawns one world (``repro_torch.launch.mesh.run_ranks``: a
``FileStore`` under ``tmp_path``, so xdist workers never share a port)
and joins it under its own timeout, so a hung rank fails its test.  The
ranks import neither ``jax`` nor ``repro``; the reference runs in this
process (one device), or, for its ``shard_map`` over four devices, in a
subprocess with ``--xla_force_host_platform_device_count=4``, as
``tests/test_distributed.py`` runs it.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro_torch.launch.mesh import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 4, 16
WORLD_TIMEOUT = 240.0


def _ref_grads(arch: str, b: int, s: int, **cfg_kw):
    """The reference's single-device (loss, grads, params, batch) on its
    smoke config (params from key 0, the batch from key 1), as numpy."""
    import jax
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.zoo import build_model as jax_build
    cfg = dataclasses.replace(jax_smoke(arch), **cfg_kw)
    jm = jax_build(cfg)
    params = jm.init_params(jax.random.key(0))
    batch = jm.make_batch(jax.random.key(1), b, s)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, batch, None)))(params)
    np_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return (float(loss), jax.tree.map(lambda a: np.asarray(a, np.float32),
                                      grads), np_tree,
            {k: np.asarray(v) for k, v in batch.items()})


def _by_port_name(tree: dict, name: str) -> np.ndarray:
    """The reference tree's leaf for the port parameter ``name``
    (``blocks.3.wq`` is layer 3 of ``blocks/wq``)."""
    parts = name.split(".")
    if len(parts) == 1:
        return tree[parts[0]]
    return tree[parts[0]][parts[-1]][int(parts[1])]


def _hold_grads(got: dict, ref: dict) -> None:
    """Each gradient's max |diff| / max |g| < 2e-2, as the reference's
    DP x TP test holds its own."""
    assert got
    for name, g in got.items():
        want = _by_port_name(ref, name)
        denom = max(np.abs(want).max(), 1e-6)
        err = np.abs(g - want).max() / denom
        assert err < 2e-2, (name, err)


def _train_worker(rank, world, arch, tree, batch, shape, cfg_kw, step):
    """Rank body: the port model on the reference's f32 masters, placed in
    the ZeRO layout of ``assemble(..., "train")``; its loss and every
    gradient (whole), then one full train step."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.shardings import assemble, place
    from repro_torch.launch.steps import build_loss_fn, build_train_step
    from repro_torch.models.sharding import mesh_scope
    from repro_torch.models.transformer import params_from_jax
    from repro_torch.optim import AdamW
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    cfg = dataclasses.replace(get_smoke_config(arch), **cfg_kw)
    model = params_from_jax(tree, cfg, "cpu", trainable=True)
    b, s = batch["tokens"].shape
    ctx, sh = assemble(model, mesh, "train", b, s)
    place(model, sh["opt_params"], mesh)
    tb = place({k: torch.from_numpy(v) for k, v in batch.items()},
               sh["batch"], mesh)
    out = {"batch_axes": ctx.rules["batch"]}
    compute = sh["params"]
    if not step:
        loss = build_loss_fn(model, ctx, compute)(tb)
        with mesh_scope(ctx):
            loss.backward()
        out["loss"] = loss.full_tensor().item()
        out["grads"] = {n: p.grad.full_tensor().numpy()
                        for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
    opt = AdamW(learning_rate=1e-3, decayed=model.decayed())
    state = opt.init(dict(model.named_parameters()))
    metrics = build_train_step(model, opt, ctx, compute=compute)(state, tb)
    out["step_loss"] = metrics["loss"].item()
    out["grad_norm"] = metrics["grad_norm"].item()
    out["finite"] = all(bool(torch.isfinite(p.full_tensor()).all())
                        for p in model.parameters())
    return out if rank == 0 else None


def test_dp_tp_train_step_matches_single_device(tmp_path):
    """(2, 2): DP over data, TP over model; the loss within 2e-4 of the
    reference's single-device loss, each gradient within 2e-2 of max |g|,
    and one full train step finite."""
    loss, grads, tree, batch = _ref_grads("granite-8b", B, S)
    got = run_ranks(_train_worker, 4, "granite-8b", tree, batch, (2, 2), {},
                    False, out_dir=tmp_path, timeout=WORLD_TIMEOUT)[0]
    np.testing.assert_allclose(got["loss"], loss, rtol=2e-4)
    _hold_grads(got["grads"], grads)
    assert np.isfinite(got["step_loss"]) and got["finite"]
    np.testing.assert_allclose(got["step_loss"], loss, rtol=2e-4)


def test_dots_gradients_under_a_mesh(tmp_path):
    """``remat_policy="dots"`` under a (2, 2) mesh: the selective
    checkpoint's policy sees DTensor products; loss and gradients held to
    the reference's dots run on one device as above."""
    kw = dict(remat=True, remat_policy="dots")
    loss, grads, tree, batch = _ref_grads("granite-8b", B, S, **kw)
    got = run_ranks(_train_worker, 4, "granite-8b", tree, batch, (2, 2), kw,
                    False, out_dir=tmp_path, timeout=WORLD_TIMEOUT)[0]
    np.testing.assert_allclose(got["loss"], loss, rtol=2e-4)
    _hold_grads(got["grads"], grads)


def test_multipod_train_step(tmp_path):
    """A (2, 2, 2) pod mesh: the batch over ("pod", "data"), two
    microbatches, one train step, finite."""
    kw = dict(microbatches=2)
    loss, _, tree, batch = _ref_grads("granite-8b", 8, 32, **kw)
    got = run_ranks(_train_worker, 8, "granite-8b", tree, batch, (2, 2, 2),
                    kw, True, out_dir=tmp_path, timeout=WORLD_TIMEOUT)[0]
    assert tuple(got["batch_axes"]) == ("pod", "data")
    assert np.isfinite(got["step_loss"]) and got["finite"]
    assert np.isfinite(got["grad_norm"])


# --------------------------------------------------------------------------
# compressed_pod_mean over a pod group of four ranks
# --------------------------------------------------------------------------


def _pod_inputs(n: int) -> tuple:
    rng = np.random.default_rng(7)
    return (rng.standard_normal((n, 3, 40)).astype(np.float32),
            (0.01 * rng.standard_normal((n, 3, 40))).astype(np.float32))


def _pod_worker(rank, world, grads, errors):
    import torch
    import torch.distributed as dist
    from repro_torch.optim import compressed_pod_mean
    mean, err = compressed_pod_mean(torch.from_numpy(grads[rank]),
                                    torch.from_numpy(errors[rank]),
                                    dist.group.WORLD)
    return mean.numpy(), err.numpy()


REF_POD = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import AxisType, make_mesh, shard_map
    from repro.optim import compressed_pod_mean
    assert jax.device_count() == 4
    d = np.load(sys.argv[1])
    mesh = make_mesh((4,), ("pod",), axis_types=(AxisType.Auto,))
    fn = shard_map(lambda g, e: tuple(x[None] for x in compressed_pod_mean(
                       g[0], e[0], "pod")),
                   mesh=mesh, in_specs=(P("pod"), P("pod")),
                   out_specs=(P("pod"), P("pod")), check_vma=False)
    mean, err = fn(d["grads"], d["errors"])
    np.savez(sys.argv[2], mean=np.asarray(mean), err=np.asarray(err))
""")


def test_compressed_pod_mean_over_four_ranks(tmp_path):
    """The int8 error-feedback mean over a gloo group of 4 ranks against
    the reference's ``shard_map`` over a 4-device pod axis, at 1e-6."""
    grads, errors = _pod_inputs(4)
    np.savez(tmp_path / "in.npz", grads=grads, errors=errors)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_POD, str(tmp_path / "in.npz"),
                        str(tmp_path / "ref.npz")], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    ref = np.load(tmp_path / "ref.npz")
    got = run_ranks(_pod_worker, 4, grads, errors, out_dir=tmp_path / "w",
                    timeout=WORLD_TIMEOUT)
    for rank, (mean, err) in enumerate(got):
        np.testing.assert_allclose(mean, ref["mean"][rank], rtol=0, atol=1e-6)
        np.testing.assert_allclose(err, ref["err"][rank], rtol=0, atol=1e-6)
    # the mean is the same on every rank
    for mean, _ in got[1:]:
        np.testing.assert_array_equal(mean, got[0][0])
