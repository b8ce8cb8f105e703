"""Time the smoke's serving decode at context alone, in a fresh process and
again after some of the smoke's earlier phases: is a slower decode step
the code's or the process's?

For the models ``--arch`` names (granite-8b and zamba2-7b unless told)
at full size (random weights), the smoke's ``drive_decode_ctx`` (flash
decode against full caches, each shape's step timed and profiled), with
the host time of one small CUDA op (``micro_us``), the objects the
garbage collector tracks and the collection pauses during the timed
steps.  ``--after`` names smoke phases to run first, then the decode is
timed again in the same process: ``wave`` (the wave cells), ``profiles``
(the wave and cohort profiles), ``chaos`` (the chaos cells).  ``--world``
times the decode with a one-rank NCCL process group open (given its
address on ``localhost``) and its communicator made by one all-reduce,
as it stands while a mesh path runs.

Run from the root of a checkout on a machine with one NVIDIA GPU; the
checkout's own ``chip_smoke.py`` and ``src/`` are used, so a parent
commit unpacked elsewhere is timed by running this file from its root::

    python3 chip_probes/serve_decode.py [--after wave,profiles] \
        [--arch qwen3-moe-30b-a3b pixtral-12b] [--world]
"""
import argparse
import gc
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, ".")
import torch

import chip_smoke as cs
from repro_torch.kernels import KERNELS, _build

dev = torch.device("cuda")


def micro() -> float:
    """Host microseconds of one small CUDA op (two ops a loop turn)."""
    a = torch.zeros(3, 1, dtype=torch.float64, device=dev)
    b = torch.ones(3, 1, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20000):
        a = torch.maximum(a, b) + b
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / 40000 * 1e6


def decode(tag: str, archs: list) -> None:
    """``drive_decode_ctx`` for each of ``archs``; one line a shape."""
    pause, t0 = [0.0], [0.0]

    def on_gc(phase: str, info: dict) -> None:
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            pause[0] += time.perf_counter() - t0[0]

    for arch in archs:
        model, _ = cs.build_lm(arch, dev)
        pause[0] = 0.0
        gc.callbacks.append(on_gc)
        try:
            rows, _ = cs.drive_decode_ctx(model)
        finally:
            gc.callbacks.remove(on_gc)
        for r in rows:
            print("decode:", json.dumps(dict(
                tag=tag, arch=arch, batch=r["batch"],
                cache_len=r["cache_len"], step_ms=r["step_ms"],
                einsum_step_ms=r["einsum_step_ms"],
                busy_s=r["profile"].get("device_busy_s"),
                idle=r["profile"].get("idle_share"),
                gc_pause_s=pause[0], gc_objects=len(gc.get_objects()),
                micro_us=micro())), flush=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--after", default="",
                    help="comma-separated smoke phases to run before a "
                         "second timing: wave, profiles, chaos")
    ap.add_argument("--arch", nargs="+", default=["granite-8b", "zamba2-7b"])
    ap.add_argument("--world", action="store_true",
                    help="time with a one-rank NCCL world open")
    args = ap.parse_args()
    if args.world:
        import socket
        import torch.distributed as dist
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
        # one collective, so that the communicator and its threads exist,
        # as after a mesh path's first exchange
        dist.all_reduce(torch.ones(1, device=dev))
        torch.cuda.synchronize()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.build, KERNELS))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = "fresh, world open" if args.world else "fresh"
    decode(tag, args.arch)
    phases = [p for p in args.after.split(",") if p]
    for p in phases:
        t = time.perf_counter()
        if p == "wave":
            cs.drive_main_path(dev)
        elif p == "profiles":
            cs.profile_cell(dev)
            cs.profile_cohort(dev)
        elif p == "chaos":
            cs.drive_chaos(dev)
        else:
            raise SystemExit(f"unknown phase {p!r}")
        print(f"ran {p} in {time.perf_counter() - t} s", flush=True)
    if phases:
        decode("after " + "+".join(phases), args.arch)
    if args.world:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
