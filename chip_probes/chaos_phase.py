"""Time the chip smoke's chaos phase alone (``patterns.chaos_campaign`` at
full size, each chaos cell run once) in a fresh process; then the chaos
cross-check and a device-only profile of the broker-outage cell on dts
(busy time, idle share, top kernels).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_probes/chaos_phase.py
"""
import json
import sys
import time

sys.path.insert(0, ".")
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from repro_torch.core.patterns import chaos_cell

dev = torch.device("cuda")
print(sys.version.split()[0], torch.__version__, torch.version.cuda,
      torch.cuda.get_device_name(0), flush=True)
t0 = time.perf_counter()
rows, counts, phase = cs.drive_chaos(dev)
for r in rows:
    print("chaos cells:", json.dumps(r), flush=True)
print("chaos campaign:", json.dumps(phase), flush=True)
print("counts", counts, "phase s", time.perf_counter() - t0, flush=True)
t1 = time.perf_counter()
print("chaos cross-check:", json.dumps(cs.chaos_cross_check(dev)),
      "s", time.perf_counter() - t1, flush=True)
spec = chaos_cell("dts", "broker")
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    _, wall, counts = cs._cohort_run([spec], dev)
out = cs._device_rows(prof, wall, "chaos dts/broker")
out["host_reads"] = counts["host_reads"]
print("chaos profile:", json.dumps(out), flush=True)
