"""Time the chip smoke's new phases alone in a fresh process: the chaos
campaign (``patterns.chaos_campaign`` at full size), the experiment layer
(``run_pattern`` on the main path's feedback cell beside that cell's
stacked run, ``run_campaign`` of Fig 6 at 64 consumers,
``deployment_feasibility``) and the availability crossover.

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_probes/experiment_phase.py
"""
import json
import sys
import time

sys.path.insert(0, ".")
import torch

import chip_smoke as cs
from repro_torch.kernels import _build

dev = torch.device("cuda")
print(sys.version.split()[0], torch.__version__, torch.version.cuda,
      torch.cuda.get_device_name(0), flush=True)
t0 = time.perf_counter()
_build.build("pump_assign")
print("pump:", json.dumps(cs.check_pump(dev)), flush=True)
cs.MAIN_CELLS = tuple(c for c in cs.MAIN_CELLS if c[0] == "feedback")
cs.WALL_REPEATS = 1
main_rows, _ = cs.drive_main_path(dev)
for r in main_rows:
    print("main path:", json.dumps(r), flush=True)
phase_s = {"build, pump and main feedback cell": time.perf_counter() - t0}
for name, run in (("chaos cells", lambda: cs.drive_chaos(dev)),
                  ("experiment layer",
                   lambda: cs.drive_experiment_layer(dev, main_rows)),
                  ("availability", lambda: cs.drive_availability(dev))):
    t1 = time.perf_counter()
    out = run()
    phase_s[name] = time.perf_counter() - t1
    print(f"{name}:", json.dumps(out), flush=True)
print("phase seconds:", json.dumps(phase_s), flush=True)
