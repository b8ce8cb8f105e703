"""Time the chip smoke's train phase alone in a fresh process: the
kernels are built first (the phase's guard launches each under
``no_grad``), then the full-width runs of ``TRAIN_RUNS``, the
``TRAIN_DOTS`` pair (musicgen-large's first steps again under
``remat_policy="dots"``), the GPU-against-CPU check, the entry point's
resume and the guard, with every kernel's launches over the phase
printed (all 0).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_probes/train_phase.py [--new] [--steps N] [--policies]

``--new`` runs the MoE, audio and VLM families alone (qwen3-moe-30b-a3b,
moonshot-v1-16b-a3b, musicgen-large with the dots pair, pixtral-12b),
without the checks; ``--steps N`` gives every run N steps (to find the
fewest that lower the loss by ``TRAIN_DROP``: with the 5-step warmup, the
losses of the first 7 steps are those of any run of 6 steps or more).
``--policies`` runs instead ``TRAIN_DOTS``'s run under each remat policy
in turns (full, dots, dots, full): a timed step's wall and the ops the
dots policy was asked about, and one profiled step of each policy
(device busy, idle share, time by kernel kind).
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, ".")
import torch

import chip_smoke as cs
from repro_torch.kernels import KERNELS, _build

NEW = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "musicgen-large",
       "pixtral-12b")

ap = argparse.ArgumentParser()
ap.add_argument("--new", action="store_true")
ap.add_argument("--steps", type=int, default=0)
ap.add_argument("--policies", action="store_true")
args = ap.parse_args()
runs = [(arch, cut, args.steps or steps, M)
        for arch, cut, steps, M in cs.TRAIN_RUNS
        if not args.new or arch in NEW]

dev = torch.device("cuda")
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip(), flush=True)
print(sys.version.split()[0], torch.__version__, torch.version.cuda,
      torch.cuda.get_device_name(0), flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
phase_s, t_prev = {}, time.perf_counter()


def done(phase: str) -> None:
    global t_prev
    now = time.perf_counter()
    phase_s[phase], t_prev = now - t_prev, now


def profile_policies() -> list:
    """``TRAIN_DOTS``'s run under ``"full"`` and ``"dots"`` in turns (full,
    dots, dots, full), each from the same weights and batches: one warm
    step, one timed step (wall, and the ops the dots policy was asked
    about) and, at each policy's first turn, one profiled step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import remat
    arch, cut, steps, M = next(r for r in cs.TRAIN_RUNS
                               if r[0] == cs.TRAIN_DOTS)
    asked = []
    policy_fn = remat.dots_policy

    def counted(ctx, func, *a, **kw):
        asked.append(func)
        return policy_fn(ctx, func, *a, **kw)
    remat.dots_policy = counted
    out = []
    for turn, policy in enumerate(("full", "dots", "dots", "full")):
        cfg = dataclasses.replace(get_config(arch), remat_policy=policy,
                                  **cut)
        model, step, state = build_trainer(cfg, dev, cs.TRAIN_LR, steps, M,
                                           seed=0)
        batches = cs._train_batches(cfg, 3, cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                                    dev)
        float(step(state, batches[0])["loss"])
        asked.clear()
        t0 = time.perf_counter()
        float(step(state, batches[1])["loss"])
        row = dict(policy=policy, step_wall_s=time.perf_counter() - t0,
                   policy_calls=len(asked))
        if turn < 2:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                float(step(state, batches[2])["loss"])
                wall = time.perf_counter() - t0
            row["profile"] = cs._device_rows(
                prof, wall, f"train step {cfg.name} {policy}", kinds=True)
            del prof
        out.append(row)
        del model, step, state, batches
        torch.cuda.empty_cache()
    remat.dots_policy = policy_fn
    return out


with ThreadPoolExecutor(len(KERNELS)) as pool:
    list(pool.map(_build.build, KERNELS))
done("build")
if args.policies:
    for row in profile_policies():
        print("train policy:", json.dumps(row), flush=True)
    done("policies")
else:
    print("launches by path:", json.dumps({"train": cs.drive_train_phase(
        dev, done, runs, checks=not args.new)[0]}))
print("phase seconds:", json.dumps(phase_s), flush=True)
