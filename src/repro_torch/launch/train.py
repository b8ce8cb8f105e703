"""End-to-end training driver of the port, the counterpart of the
reference's ``repro.launch.train``: the same flags and defaults, plus
``--device`` (the GPU unless the caller asks for the CPU).

Features exercised here and tested in ``tests/test_torch_train.py`` and
``tests/test_torch_streaming.py``:
  * streamed data (edge producers -> broker -> ``StreamingDataLoader``,
    ``--data stream``) or the local synthetic pipeline (``--data local``,
    ``SyntheticTokens``)
  * f32 master weights, AdamW on a cosine schedule, microbatched steps
  * checkpoint/restart (async writer, atomic commit, resume-determinism)
  * steering feedback (work sharing with feedback) every
    ``--feedback-every`` steps
  * consumer-crash tolerance (fault injection via ``--crash-consumer-at``)

The stream's threads run on the host and hand over NumPy batches; each
batch moves to the model's device on the thread that runs the step.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b-smoke \\
      --steps 100 --device cpu --data stream --crash-consumer-at 6
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.checkpoint import (
    AsyncCheckpointer, latest_checkpoint, restore_checkpoint)
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core.workloads import DSTREAM
from repro_torch.data import SyntheticTokens
from repro_torch.launch.steps import build_train_step
from repro_torch.models.sharding import ModelContext
from repro_torch.models.zoo import build_model
from repro_torch.optim import AdamW, cosine_warmup
from repro_torch.streaming import (
    WORK_QUEUES, EdgeProducer, RealtimeBroker, SteeringFeedback,
    StreamingDataLoader)


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


def make_stream(cfg, batch, seq, n_producers=2, n_consumers=2):
    """The reference's streamed data plane for ``cfg``: a broker, a
    loader of ``n_consumers`` consumers assembling ``batch`` x ``seq``
    batches of Dstream payloads, reply queues for ``n_producers``
    producers ``edge-i``, started at 500 msgs/s each over the two work
    queues.  Returns (broker, loader, feedback, producers)."""
    broker = RealtimeBroker()
    loader = StreamingDataLoader(
        broker, DSTREAM, vocab_size=cfg.vocab_size, seq_len=seq,
        batch_size=batch, n_consumers=n_consumers)
    fb = SteeringFeedback(broker, [f"edge-{i}" for i in range(n_producers)])
    producers = []
    for i in range(n_producers):
        pid = f"edge-{i}"
        p = EdgeProducer(
            broker, DSTREAM,
            lambda j, i=i: f"work:{(i + j) % 2}",
            rate_msgs_s=500.0, producer_id=pid,
            reply_queue=fb.reply_queue(pid))
        producers.append(p.start())
    return broker, loader, fb, producers


def close_stream(stream) -> None:
    """Stop the producers and the loader's threads, and close the broker."""
    for p in stream[3]:
        p.stop(join=False)
    stream[1].close()


def train_loop(model, train_step, opt_state, batches, start_step: int,
               steps: int, stream=None, crash_consumer_at: int = -1,
               feedback_every: int = 10):
    """The training loop of :func:`run`: steps ``start_step`` to
    ``steps - 1`` on ``batches`` (NumPy dicts, moved to ``model.device``
    on this thread).  With a stream, step ``crash_consumer_at`` first
    crashes ``ingest-0`` (its unacked messages are redelivered) and
    spawns a new consumer, and every ``feedback_every`` steps each
    producer is told to slow down when ``work:0`` holds more than 64
    messages, else to speed up, and polls its reply once.  Yields one
    record a step: ``step``, ``loss``, ``metrics``, ``batch`` (on the
    device), ``wait_s`` (the time spent drawing the batch), the crash's
    ``redelivered`` count, and after a feedback ``feedback``: the work
    queues' depths at it and each producer's counts and rate after its
    poll."""
    for step in range(start_step, steps):
        rec = dict(step=step)
        if stream and crash_consumer_at == step:
            rec["redelivered"] = n = stream[1].crash_consumer("ingest-0")
            stream[1].add_consumer()
            print(f"[fault] crashed ingest-0 at step {step}; "
                  f"{n} messages redelivered; respawned")
        t0 = time.perf_counter()
        host = next(batches)
        rec["wait_s"] = time.perf_counter() - t0
        rec["batch"] = batch = {k: torch.from_numpy(v).to(model.device)
                                for k, v in host.items()}
        rec["metrics"] = metrics = train_step(opt_state, batch)
        rec["loss"] = float(metrics["loss"])
        if stream and step % feedback_every == 0:
            broker, _, fb, producers = stream
            depths = {q: broker.queue_depth(q) for q in WORK_QUEUES}
            fb.publish_step(step, rec["loss"],
                            backpressure=depths["work:0"] > 64)
            for p in producers:
                p.poll_feedback(timeout=0.01)
            rec["feedback"] = dict(
                step=step, depths=depths,
                producers=[dict(id=p.id, sent=p.sent, rejected=p.rejected,
                                rate=p.rate) for p in producers])
        yield rec


def run(args) -> dict:
    """Train ``args.arch`` on ``args.device``; returns {"losses",
    "final_loss", "model", "opt_state", "stream", "redelivered"}: the
    stream (broker, loader, feedback, producers; ``None`` for local
    data), closed, and the crash's redelivered count (``None`` without
    one)."""
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

    stream = None
    if args.data == "stream":
        stream = make_stream(cfg, args.batch, args.seq)
        batches = iter(stream[1])
    else:
        batches = iter(SyntheticTokens(cfg.vocab_size, args.seq,
                                       seed=args.seed,
                                       batch_size=args.batch))
    losses = []
    redelivered = None
    t0 = time.time()
    try:
        for rec in train_loop(model, train_step, opt_state, batches,
                              start_step, args.steps, stream,
                              args.crash_consumer_at, args.feedback_every):
            step, loss = rec["step"], rec["loss"]
            redelivered = rec.get("redelivered", redelivered)
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                rate = (step - start_step + 1) / (time.time() - t0)
                print(f"step {step:5d} loss {loss:7.4f} "
                      f"gnorm {float(rec['metrics']['grad_norm']):6.3f} "
                      f"({rate:.2f} steps/s)", flush=True)
            if ckpt and step > 0 and step % args.ckpt_every == 0:
                ckpt.save(step, (model.state_dict(), opt_state))
        if ckpt:
            ckpt.save(args.steps, (model.state_dict(), opt_state))
            ckpt.close()
    finally:
        if stream:
            close_stream(stream)
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "model": model, "opt_state": opt_state, "stream": stream,
            "redelivered": redelivered}


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
