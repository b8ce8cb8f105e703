"""Time the chip smoke's cohort phase alone (and the pump's check), each
cohort cell run once, in a fresh process.

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_probes/cohort_phase.py
"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from repro_torch.kernels import KERNELS, _build
dev = torch.device("cuda")
t0 = time.perf_counter()
_build.build("pump_assign")
print("pump:", json.dumps(cs.check_pump(dev)), flush=True)
cs.COHORT_REPEATS = 1
rows, counts = cs.drive_cohort(dev)
for r in rows:
    print("cohort cells:", json.dumps(r), flush=True)
print("counts", counts, "phase s", time.perf_counter() - t0, flush=True)
t1 = time.perf_counter()
print("cohort cross-check:", json.dumps(cs.cohort_cross_check(dev)), flush=True)
print("cohort profile:", json.dumps(cs.profile_cohort(dev)), "s", time.perf_counter() - t1, flush=True)
