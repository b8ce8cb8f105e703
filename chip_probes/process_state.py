"""Does the cohort engine's wall depend on what ran before it in the
process?  The Fig 7b dts cohort cell twice in a fresh process, then after
the smoke's wave cells, then after its kernel checks, each with the host
time of one small CUDA op and the allocator's reserved memory.

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_probes/process_state.py
"""
import json, sys, time
from concurrent.futures import ThreadPoolExecutor
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from repro_torch.kernels import KERNELS, _build
dev = torch.device("cuda")
cell = cs.COHORT_CELLS[3]

def micro():
    a = torch.zeros(3, 1, dtype=torch.float64, device=dev); b = torch.ones(3, 1, dtype=torch.float64, device=dev)
    torch.cuda.synchronize(); t = time.perf_counter()
    for _ in range(20000):
        a = torch.maximum(a, b) + b
    torch.cuda.synchronize(); return (time.perf_counter() - t) / 40000 * 1e6

def cohort(tag):
    specs = cs._cohort_specs(*cell)
    res, wall, counts = cs._cohort_run(specs, dev)
    print(json.dumps(dict(tag=tag, wall_s=wall, us_per_op=micro(), reserved_gb=torch.cuda.memory_reserved() / 1e9, host_reads=counts["host_reads"])), flush=True)

_build.build("pump_assign")
cohort("fresh")
cohort("fresh again")
rows, _ = cs.drive_main_path(dev)
cohort("after wave cells")
with ThreadPoolExecutor(len(KERNELS)) as pool:
    list(pool.map(_build.build, KERNELS))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
for check in (cs.check_pump, cs.check_flash, cs.check_rmsnorm, cs.check_decode, cs.check_ssd):
    check(dev); torch.cuda.empty_cache()
cohort("after kernel checks")
