"""End-to-end training driver of the port, the counterpart of the
reference's ``repro.launch.train``: the same flags and defaults, plus
``--device`` (the GPU unless the caller asks for the CPU).

Features exercised here and tested in ``tests/test_torch_train.py``:
  * the local synthetic pipeline (``--data local``, ``SyntheticTokens``)
  * f32 master weights, AdamW on a cosine schedule, microbatched steps
  * checkpoint/restart (async writer, atomic commit, resume-determinism)

The streamed data path (``--data stream``: edge producers -> broker ->
``StreamingDataLoader``, steering feedback, ``--crash-consumer-at``) is
not ported yet (ROADMAP §1 item 6); asking for it raises.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b-smoke \\
      --steps 100 --device cpu --ckpt-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.checkpoint import (
    AsyncCheckpointer, latest_checkpoint, restore_checkpoint)
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.launch.steps import build_train_step
from repro_torch.models.sharding import ModelContext
from repro_torch.models.zoo import build_model
from repro_torch.optim import AdamW, cosine_warmup

STREAM_NOT_PORTED = ("the streamed data path (--data stream, "
                     "--crash-consumer-at) is not ported yet: ROADMAP §1 "
                     "item 6 (streaming and edge-to-HPC training)")


def build_trainer(cfg, device, lr: float, steps: int,
                  microbatches: Optional[int], seed: int):
    """A trainer as the reference's driver assembles one: the model of
    ``cfg`` on ``device`` as f32 masters drawn from ``seed``, AdamW with
    the model's decayed set on a cosine schedule to ``lr`` (warmup
    ``max(steps // 20, 5)``, ``steps`` in all), and the microbatched
    train step under ``ModelContext()``.  Returns (model, train_step,
    optimiser state)."""
    model = build_model(cfg, device, trainable=True)
    optimizer = AdamW(learning_rate=cosine_warmup(
        lr, warmup_steps=max(steps // 20, 5), total_steps=steps),
        decayed=model.decayed())
    train_step = build_train_step(model, optimizer, ModelContext(),
                                  microbatches=microbatches)
    model.init_params(torch.Generator(model.device).manual_seed(seed))
    return model, train_step, optimizer.init(dict(model.named_parameters()))


def run(args) -> dict:
    """Train ``args.arch`` on ``args.device``; returns {"losses",
    "final_loss", "model", "opt_state"}."""
    if args.data == "stream" or args.crash_consumer_at >= 0:
        raise NotImplementedError(STREAM_NOT_PORTED)
    cfg = (get_smoke_config(args.arch.removesuffix("-smoke"))
           if args.arch.endswith("-smoke") else get_config(args.arch))
    model, train_step, opt_state = build_trainer(
        cfg, getattr(args, "device", "cuda"), args.lr, args.steps,
        args.microbatches, args.seed)
    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir, keep=3)
        latest = latest_checkpoint(args.ckpt_dir)
        if latest and args.resume:
            start_step, (params, opt_state) = restore_checkpoint(
                latest, (model.state_dict(), opt_state))
            model.load_state_dict(params)
            print(f"resumed from {latest} at step {start_step}")

    batches = iter(SyntheticTokens(cfg.vocab_size, args.seq, seed=args.seed,
                                   batch_size=args.batch))
    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in next(batches).items()}
        metrics = train_step(opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            rate = (step - start_step + 1) / (time.time() - t0)
            print(f"step {step:5d} loss {loss:7.4f} "
                  f"gnorm {float(metrics['grad_norm']):6.3f} "
                  f"({rate:.2f} steps/s)", flush=True)
        if ckpt and step > 0 and step % args.ckpt_every == 0:
            ckpt.save(step, (model.state_dict(), opt_state))
    if ckpt:
        ckpt.save(args.steps, (model.state_dict(), opt_state))
        ckpt.close()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "model": model, "opt_state": opt_state}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b-smoke",
                    help=f"one of {ARCH_NAMES} or '<name>-smoke'")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data", choices=["local", "stream"], default="local")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--feedback-every", type=int, default=10)
    ap.add_argument("--crash-consumer-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    out = run(args)
    print(f"done: first loss {out['losses'][0]:.4f} "
          f"final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
