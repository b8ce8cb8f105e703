"""The port's examples (``examples_torch/``) held to the reference's
(``examples/``) on the CPU: the quickstart's standard output line for
line on both engines, each script run in a process of its own (the PRS
session's uid counter and S3M's cluster counter start at 1 in each, as
they do for a user); the steering server's generated tokens on carried
weights, and its script; the edge-to-HPC example's configuration and
parameter count; every example's entry point raising without a GPU.
The comparison and the edge-to-HPC runs are in
``test_torch_examples_comparison.py`` and
``test_torch_examples_edge.py``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("quickstart", "cross_facility_comparison",
            "edge_to_hpc_training", "steering_serve")


def run_script(path: Path, *args: str, timeout: float = 300.0):
    """``python path args`` from the repo's root with ``src`` on the path
    and JAX on the CPU; the finished process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    return subprocess.run([sys.executable, str(path), *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def example(name: str):
    """The port's example module ``name``."""
    import importlib
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"examples_torch.{name}")


@pytest.mark.parametrize("engine", ["vectorized", "heap"])
def test_quickstart_prints_the_reference_lines(engine):
    """``examples_torch/quickstart.py --device cpu`` prints what
    ``examples/quickstart.py`` prints, line for line."""
    want = run_script(ROOT / "examples" / "quickstart.py", "--engine",
                      engine)
    got = run_script(ROOT / "examples_torch" / "quickstart.py", "--engine",
                     engine, "--device", "cpu")
    assert want.returncode == 0, want.stderr
    assert got.returncode == 0, got.stderr
    assert got.stdout.splitlines() == want.stdout.splitlines()
    assert len(got.stdout.splitlines()) == 15


def test_quickstart_main_returns_its_lines(capsys):
    """``main`` prints and returns the same lines; ``work_sharing`` runs
    one cohort cell an architecture on the requested engine."""
    qs = example("quickstart")
    lines = qs.main(["--engine", "heap", "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == lines
    table, overhead, results = qs.work_sharing("heap", "cpu")
    assert [ln.split()[0] for ln in table] == list(qs.ARCHS)
    assert len(overhead) == len(qs.ARCHS) - 1
    assert {r.spec.params.engine for r in results} == {"heap"}


def _reference_generate(prompt: np.ndarray, max_new: int):
    """The reference's granite-8b smoke model (key 0) generating from
    ``prompt``; (model, params, tokens)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.serve import generate
    from repro.models.zoo import build_model as jax_build
    jm = jax_build(jax_smoke("granite-8b"))
    params = jm.init_params(jax.random.key(0))
    toks = generate(jm, params, jnp.asarray(prompt)[None, :],
                    max_new=max_new)
    return jm, params, np.asarray(toks)


def _held_where_tied(jm, params, model, want: np.ndarray, got: np.ndarray):
    """Where the greedy tokens part, the smoke's prefill rule: both
    packages teacher-forced on the reference's tokens, each step's token
    equal unless the reference's top-two gap there is within the spread
    between the two packages' logits (a tie within bf16 rounding)."""
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import build_serve_step as jax_serve_step
    from repro.models.sharding import ModelContext as JaxCtx
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models.sharding import ModelContext
    jstep = jax.jit(jax_serve_step(jm, JaxCtx()))
    step = build_serve_step(model, ModelContext())
    T = want.shape[1]
    jcache, cache = jm.init_cache(1, T), model.init_cache(1, T)
    for t in range(T - 1):
        cur = want[:, t].astype(np.int32)
        pos = np.full((1,), t, np.int32)
        ref, jcache = jstep(params, jcache, jnp.asarray(cur),
                            jnp.asarray(pos))
        lg, cache = step(cache, torch.from_numpy(cur), torch.from_numpy(pos))
        ref = np.asarray(ref, np.float32)[0]
        lg = lg.float().numpy()[0]
        if t + 1 < 8:
            continue                # the prompt
        top2 = np.sort(ref)[-2:]
        if int(np.argmax(lg)) != int(want[0, t + 1]):
            spread = float(np.abs(lg - ref).max())
            assert top2[1] - top2[0] <= spread, (t, top2, spread)


def test_steering_generates_the_reference_tokens():
    """The steering server's call, ``generate(model, prompt[None],
    max_new=8)`` on granite-8b's smoke model, gives the reference's
    greedy tokens on the reference's weights (key 0, carried across by
    ``transformer.params_from_jax``), on the prompt ``tokens_from_payload``
    makes of one Dstream payload."""
    import jax
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.workloads import DSTREAM, tokens_from_payload
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import params_from_jax
    cfg = get_smoke_config("granite-8b")
    prompt = tokens_from_payload(DSTREAM.payload(seed=0), cfg.vocab_size, 8)
    jm, params, want = _reference_generate(prompt, 8)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    got = generate(model, torch.from_numpy(prompt)[None, :], max_new=8)
    assert got.shape == want.shape == (1, 16)
    assert (got[0, :8].numpy() == prompt).all()
    if not (got.numpy() == want).all():
        _held_where_tied(jm, params, model, want, got.numpy())


def test_steering_script_serves_and_steers_on_cpu():
    """``examples_torch/steering_serve.py --device cpu`` serves four
    streamed requests and steers both producers."""
    out = run_script(ROOT / "examples_torch" / "steering_serve.py",
                     "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    requests = [ln for ln in lines if ln.startswith("request ")]
    assert len(requests) == 4
    assert all(ln.endswith("generated 16 tokens -> feedback published")
               for ln in requests)
    for j in (0, 1):
        assert any(ln.startswith(f"beamline-{j} received steering: {{")
                   for ln in lines), lines
    assert lines[-1] == "served 4 streamed requests"


def test_steering_main_stops_its_producers():
    """In process: ``main`` returns the tokens on the CPU, both steering
    replies, and producers whose threads end."""
    out = example("steering_serve").main(["--device", "cpu"])
    assert [tuple(t.shape) for t in out["tokens"]] == [(1, 16)] * 4
    assert all(t.device.type == "cpu" for t in out["tokens"])
    assert None not in out["steering"] and len(out["steering"]) == 2
    for p in out["producers"]:
        p.join(timeout=2.0)
        assert not p._thread.is_alive()


def _reference_edge_config():
    """The ``ArchConfig`` that ``examples/edge_to_hpc_training.py``
    builds, read from its source and made with the reference's class."""
    import ast
    from repro.configs.base import ArchConfig
    tree = ast.parse((ROOT / "examples" / "edge_to_hpc_training.py")
                     .read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "ArchConfig")
    return ArchConfig(**{k.arg: ast.literal_eval(k.value)
                         for k in call.keywords})


def test_edge_config_and_parameter_count_match_reference():
    """``edge-100m`` equals the reference example's config field by
    field; its ``param_count()`` equals the reference's, and the port's
    model holds as many parameters as the reference's (the config's
    count leaves out the final norm in both)."""
    import jax
    from repro.models.zoo import build_model as jax_build
    from repro_torch.models.zoo import build_model
    edge = example("edge_to_hpc_training")
    ref = _reference_edge_config()
    assert dataclasses.asdict(edge.CONFIG) == dataclasses.asdict(ref)
    assert edge.CONFIG.param_count() == ref.param_count()
    shapes = jax.eval_shape(jax_build(ref).init_params, jax.random.key(0))
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    n_port = sum(p.numel() for p in build_model(edge.CONFIG, "meta")
                 .parameters())
    assert n_port == n_ref == ref.param_count() + ref.d_model
    assert round(n_port / 1e6) == 104


def test_edge_train_args_are_the_reference_namespace():
    """The arguments the example hands ``launch.train.run``: the
    reference's, plus ``device``."""
    ns = example("edge_to_hpc_training").train_args(200, "d", "cpu")
    assert vars(ns) == dict(
        arch="edge-100m", steps=200, batch=8, seq=128, lr=3e-4, seed=0,
        microbatches=1, data="stream", ckpt_dir="d", ckpt_every=50,
        resume=True, log_every=10, feedback_every=10, crash_consumer_at=66,
        device="cpu")


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_cuda_and_raise_without_it(name, tmp_path):
    """Each example runs on the GPU unless asked for the CPU, and raises
    without one before it prints or trains anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the CPU-only path")
    main = example(name).main
    argv = ["--ckpt-dir", str(tmp_path)] if name.startswith("edge") else []
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    assert not any(tmp_path.iterdir())


def test_examples_import_neither_jax_nor_the_reference():
    """The examples import ``repro_torch``, ``torch``, NumPy and the
    standard library only."""
    import ast
    for name in EXAMPLES:
        tree = ast.parse((ROOT / "examples_torch" / f"{name}.py").read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "repro"), (name, m)
