"""Run the chip smoke's examples path alone in a fresh process
(``chip_smoke.drive_examples``: the comparison and edge-to-HPC examples
of ``examples_torch`` in child processes started together, then the
steering example here, each checked, every kernel's launches over the
path printed, all 0), then heap parity (d), the quickstart
through ``examples_torch/quickstart.py`` (``chip_smoke.heap_quickstart``).
No kernel runs on this path, so none is built.

With ``--scale`` it also runs ``examples_torch/cross_facility_comparison.py
--scale`` (the work-sharing sweep extended to 256 consumers) and prints
its lines and wall.  With ``--edge-breakdown`` it runs the edge-to-HPC
training twice more through ``launch.train.run``, on the stream without
checkpoints and on local data (``SyntheticTokens``) without them, each
with its own steps/s, wall and the process's host CPU seconds; then
``cProfile`` over 10 steps of the trainer on local data, and a
``torch.profiler`` trace of 5 more (the device's busy time and idle
share, and the top operators by host time).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_probes/examples_phase.py [--scale] [--edge-breakdown]
"""
import argparse
import json
import subprocess
import sys
import time

sys.path.insert(0, ".")
import torch

import chip_smoke as cs
from examples_torch import cross_facility_comparison

ap = argparse.ArgumentParser()
ap.add_argument("--scale", action="store_true")
ap.add_argument("--edge-breakdown", action="store_true")
args = ap.parse_args()
dev = torch.device("cuda")
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip(), flush=True)
print(sys.version.split()[0], torch.__version__, torch.version.cuda,
      torch.cuda.get_device_name(0), flush=True)
phase_s, t_prev = {}, time.perf_counter()


def done(phase: str) -> None:
    global t_prev
    now = time.perf_counter()
    phase_s[phase], t_prev = now - t_prev, now


print("launches by path:",
      json.dumps({"examples": cs.drive_examples(dev, done)}), flush=True)
print("heap parity (d) quickstart:", json.dumps(cs.heap_quickstart(dev)),
      flush=True)
done("heap parity (d)")
if args.scale:
    t0 = time.perf_counter()
    lines = cross_facility_comparison.main(["--scale", "--device",
                                            str(dev)])
    print("examples comparison --scale:", json.dumps(dict(
        wall_s=time.perf_counter() - t0, lines=lines)), flush=True)
    done("examples comparison --scale")
if args.edge_breakdown:
    import contextlib
    import io
    import re
    from examples_torch import edge_to_hpc_training as edge
    from repro_torch.launch.train import run
    edge.register()
    for name, over in (("stream, no checkpoint", dict(ckpt_dir="")),
                       ("local data, no checkpoint",
                        dict(ckpt_dir="", data="local"))):
        ns = edge.train_args(cs.EDGE_STEPS, "", dev)
        vars(ns).update(over)
        text = io.StringIO()
        t0, c0 = time.perf_counter(), cs._cpu_s()
        with contextlib.redirect_stdout(text):
            out = run(ns)
        wall, cpu = time.perf_counter() - t0, cs._cpu_s() - c0
        rate = re.findall(r"\(([0-9.]+) steps/s\)", text.getvalue())[-1]
        print(f"edge breakdown: {name}:", json.dumps(dict(
            wall_s=wall, steps_per_s=float(rate), host_cpu_s=cpu,
            first_loss=out["losses"][0], final_loss=out["final_loss"])),
            flush=True)
        del out
        done(f"edge breakdown: {name}")
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.train import build_trainer
    model, step, state = build_trainer(edge.CONFIG, dev, 3e-4, 200, 1, 0)
    data = iter(SyntheticTokens(edge.CONFIG.vocab_size, 128, seed=0,
                                batch_size=8))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
               for _ in range(20)]
    for b in batches[:5]:
        float(step(state, b)["loss"])
    with cProfile.Profile() as cp:
        t0 = time.perf_counter()
        for b in batches[5:15]:
            float(step(state, b)["loss"])
        cp_wall = time.perf_counter() - t0
    text = io.StringIO()
    pstats.Stats(cp, stream=text).sort_stats("tottime").print_stats(15)
    print(f"edge breakdown: cProfile of 10 local steps ({cp_wall} s):")
    print(text.getvalue())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[15:]:
            float(step(state, b)["loss"])
        wall = time.perf_counter() - t0
    print("edge breakdown: profile of 5 local steps:", json.dumps(
        cs._device_rows(prof, wall, "edge-100m train step", kinds=True)))
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=15), flush=True)
    done("edge breakdown: profiles")
print("phase seconds:", json.dumps(phase_s), flush=True)
