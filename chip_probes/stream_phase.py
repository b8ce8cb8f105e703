"""Time the chip smoke's stream phase alone in a fresh process: the
kernels are built first, as the smoke builds them, then
``launch.train.run`` with ``--data stream`` and a consumer crash at the
reference's test size, and the full-width granite-8b run on the stream
(its local-data yardstick is the smoke's train phase, not run here),
with every kernel's launches over the phase printed (all 0).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_probes/stream_phase.py
"""
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


with ThreadPoolExecutor(len(KERNELS)) as pool:
    list(pool.map(_build.build, KERNELS))
done("build")
print("launches by path:",
      json.dumps({"stream": cs.drive_stream_phase(dev, done)}))
print("phase seconds:", json.dumps(phase_s), flush=True)
