"""Time the chip smoke's heap parity phase alone in a fresh process, with
the phases it reads: the flow parity cell and the chaos campaign, whose
card runs parts (b) and (c) hold against the heap engine; then the cohort
cells phase at its cut depth and the Fig 7b dts profile, the phases cut
to make room for it.

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_probes/heap_phase.py
"""
import json
import sys
import time

sys.path.insert(0, ".")
import torch

import chip_smoke as cs

dev = torch.device("cuda")
print(sys.version.split()[0], torch.__version__, torch.version.cuda,
      torch.cuda.get_device_name(0), flush=True)
phase_s, t0 = {}, time.perf_counter()
cs.FLOW_CELLS = cs.FLOW_CELLS[:1]
flow_rows, _, flow_results = cs.drive_flow(dev)
print("flow cells:", json.dumps(flow_rows), flush=True)
phase_s["flow parity cell"] = time.perf_counter() - t0
t0 = time.perf_counter()
chaos_rows, _, phase, chaos_results = cs.drive_chaos(dev)
print("chaos campaign:", json.dumps(phase), flush=True)
phase_s["chaos cells"], t0 = time.perf_counter() - t0, time.perf_counter()
for part, row in cs.drive_heap_parity(
        dev, chaos_rows, chaos_results, phase["wall_s"],
        flow_results["parity"], flow_rows[0]["wall_s"]).items():
    print(f"heap parity {part}:", json.dumps(row), flush=True)
phase_s["heap parity"], t0 = time.perf_counter() - t0, time.perf_counter()
rows, _ = cs.drive_cohort(dev)
for r in rows:
    print("cohort cells:", json.dumps(r), flush=True)
phase_s["cohort cells"], t0 = time.perf_counter() - t0, time.perf_counter()
print("cohort profile:", json.dumps(cs.profile_cohort(dev)), flush=True)
phase_s["cohort profile"] = time.perf_counter() - t0
print("phase seconds:", json.dumps(phase_s), flush=True)
