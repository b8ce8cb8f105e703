"""Time the chip smoke's xLSTM phases alone in a fresh process: the
kernels are built first, as the smoke builds them, then the RMSNorm
kernel check (every ``chip_smoke.RMS_CASES`` shape, xlstm-1.3b's
among them), xlstm-1.3b served at full width and depth
(``chip_smoke.XLSTM_SERVE``: prefill, its walk block by block with the
recurrence check and the sLSTM blocks' share, profile, ``generate``,
decode at 32 requests and its walk), then
its full-width train run at the smoke's depth cut and the smoke config's
GPU-against-CPU train check, with every kernel's launches by path.

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_probes/serve_xlstm.py [--no-train]
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
print("kernel check:", json.dumps(cs.check_rmsnorm(dev)), flush=True)
done("rmsnorm check")
by_path = cs.serve("xlstm-1.3b", dev, done, cs.walk_xlstm,
                   cs.walk_decode_xlstm)
if "--no-train" not in sys.argv:
    cs._reset_launches()
    arch, cut, steps, M = next(r for r in cs.TRAIN_RUNS
                               if r[0] == "xlstm-1.3b")
    cs.drive_train(arch, cut, steps, M, dev)
    done(f"train {arch}")
    cs.TRAIN_XDEV = dict(cs.TRAIN_XDEV, archs=(arch,))
    print("train cross-check:", json.dumps(cs.train_cross_check(dev)))
    done("train cross-check")
    by_path["train"] = cs._launches()
print("launches by path:", json.dumps(by_path))
print("phase seconds:", json.dumps(phase_s), flush=True)
