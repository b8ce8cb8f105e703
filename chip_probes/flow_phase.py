"""Time the chip smoke's flow phase alone, each flow cell run once, in a
fresh process; then the flow cross-check, a device-only profile of the
parity cell (busy time, idle share, top kernels) and a host profile
(``cProfile``) of one run of it: where its host time goes.

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_probes/flow_phase.py
"""
import cProfile
import io
import json
import pstats
import sys
import time

sys.path.insert(0, ".")
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs

dev = torch.device("cuda")
print(sys.version.split()[0], torch.__version__, torch.version.cuda,
      torch.cuda.get_device_name(0), flush=True)
t0 = time.perf_counter()
cs.COHORT_REPEATS = 1
rows, counts = cs.drive_flow(dev)
for r in rows:
    print("flow cells:", json.dumps(r), flush=True)
print("counts", counts, "phase s", time.perf_counter() - t0, flush=True)
t1 = time.perf_counter()
print("flow cross-check:", json.dumps(cs.flow_cross_check(dev)),
      "s", time.perf_counter() - t1, flush=True)
name, n, msgs, cap, over = cs.FLOW_CELLS[0]
specs = cs._flow_specs("feedback", n, msgs, cap, over)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    _, wall, counts = cs._cohort_run(specs, dev)
out = cs._device_rows(prof, wall, f"flow {name}")
out["host_reads"] = counts["host_reads"]
print("flow profile:", json.dumps(out), flush=True)
pr = cProfile.Profile()
pr.enable()
_, wall, _ = cs._cohort_run(specs, dev)
pr.disable()
buf = io.StringIO()
pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(20)
print(f"flow host profile ({name}, wall {wall} s under cProfile):")
print(buf.getvalue(), flush=True)
