"""Time the chip smoke's mesh path alone in a fresh process: the kernels
are built first, as the smoke builds them; then
``chip_smoke.MESH_SERVE`` (qwen3-moe-30b-a3b) at full width and depth
with random weights from a seed, its prefill under ``pallas`` off the
mesh (the serving phase's first step, which the smoke runs before the
mesh path) and ``chip_smoke.mesh_moe`` in a one-rank NCCL world on a
(1, 1) mesh; then ``chip_smoke.MESH_TRAIN``'s train run at the train
phase's cut with the mesh train step after it
(``drive_train(..., mesh=True)``, which opens its own world).  Prints the
mesh serve row, the mesh launches, and the seconds of each part: the
mesh path's own are ``qwen3 mesh`` and the train row's ``mesh`` wall.

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_probes/mesh_phase.py [--no-train]
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
model, init_s = cs.build_lm(cs.MESH_SERVE, dev)
prefill, tokens, _ = cs.drive_prefill(model, init_s)
print("serve prefill:", json.dumps({k: prefill[k] for k in (
    "arch", "wall_s", "tokens_s", "peak_mem_gb")}), flush=True)
done("qwen3 build and prefill")
with cs._mesh_world():
    row, counts = cs.mesh_moe(model, tokens, prefill["wall_s"])
print("mesh serve:", json.dumps(row), flush=True)
print("launches by path:", json.dumps({"mesh": counts}), flush=True)
done("qwen3 mesh")
del model, tokens
torch.cuda.empty_cache()
if "--no-train" not in sys.argv:
    arch, cut, steps, M = cs.TRAIN_RUNS[0]
    assert arch == cs.MESH_TRAIN
    cs.drive_train(arch, cut, steps, M, dev,
                   profiled=arch in cs.TRAIN_PROFILED, mesh=True)
    done("granite train and mesh step")
print("phase seconds:", json.dumps(phase_s), flush=True)
