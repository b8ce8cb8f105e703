"""Time the chip smoke's MoE, audio and VLM serving phases alone in a
fresh process: the kernels are built first, as the smoke builds them,
then qwen3-moe-30b-a3b, moonshot-v1-16b-a3b, musicgen-large and
pixtral-12b at full width and depth (``chip_smoke.FAMILY_SERVE``), each
with its prefill, walk (the MoE models), profile, ``generate`` and
decode at context, with every kernel's launches by path.

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_probes/serve_families.py
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
print("launches by path:", json.dumps(cs.serve_families(dev, done)))
print("phase seconds:", json.dumps(phase_s), flush=True)
