"""End-to-end edge->HPC example (the paper's motivating workflow): synthetic
detector producers stream Dstream-shaped events through the broker; a
~100M-parameter LM trains on the streamed tokens for a few hundred steps
with checkpointing and steering feedback; a consumer is crashed mid-run to
demonstrate redelivery-based fault tolerance.  The ``repro_torch``
counterpart of ``examples/edge_to_hpc_training.py``.

    PYTHONPATH=src python examples_torch/edge_to_hpc_training.py [--steps 200]
    PYTHONPATH=src python examples_torch/edge_to_hpc_training.py --device cpu

Trains on the GPU by default; ``--device cpu`` trains on the CPU, and
without a GPU the default raises.  As the reference does, the run
checkpoints at ``--steps`` and resumes from the newest checkpoint in
``--ckpt-dir``: a second run in the same directory trains no step and
then fails on the empty loss list, so give each run its own directory.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import repro_torch.configs as C
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch import train as T

# ~100M-parameter llama-style model (20L x 640d)
CONFIG = ArchConfig(name="edge-100m", family="dense", n_layers=20,
                    d_model=640, n_heads=10, n_kv_heads=5, d_ff=1792,
                    vocab_size=8192, remat=False)


def register() -> None:
    """Register ``edge-100m`` in the port's config registry, as the
    reference's example registers it in its own."""
    C._MODULES["edge-100m"] = type("M", (), {"CONFIG": CONFIG,
                                             "SMOKE_CONFIG": CONFIG})


def train_args(steps: int, ckpt_dir: str, device) -> argparse.Namespace:
    """The reference's arguments of ``launch.train.run``, plus ``device``."""
    return argparse.Namespace(
        arch="edge-100m", steps=steps, batch=8, seq=128, lr=3e-4,
        seed=0, microbatches=1, data="stream", ckpt_dir=ckpt_dir,
        ckpt_every=50, resume=True, log_every=10, feedback_every=10,
        crash_consumer_at=steps // 3, device=device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the example; returns ``launch.train.run``'s result with the
    summary line under ``"summary"``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default="/tmp/edge2hpc_ckpt")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args_in = ap.parse_args(argv)
    device = resolve_device(args_in.device)

    register()
    out = T.run(train_args(args_in.steps, args_in.ckpt_dir, device))
    n = CONFIG.param_count()
    out["summary"] = (f"model: {n/1e6:.0f}M params | first loss "
                      f"{out['losses'][0]:.3f} -> final "
                      f"{out['final_loss']:.3f}")
    print(f"\n{out['summary']}")
    if not out["final_loss"] < out["losses"][0]:
        raise AssertionError("training must make progress")
    return out


if __name__ == "__main__":
    main()
