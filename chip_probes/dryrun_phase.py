"""Run the chip smoke's dryrun path alone in a fresh process: granite-8b
(``chip_smoke.DRYRUN_SERVE``) at full width and depth with random
weights from a seed, its serving prefill batch counted on the card and
on the meta device and timed under ``attention_impl="auto"``
(``chip_smoke.dryrun_count``), then the dry run's CLI on
``chip_smoke.DRYRUN_CELLS`` in child processes (``chip_smoke.dryrun_cli``).
Prints the ``dryrun card:`` row, the ``dryrun cell:`` lines and the
seconds of each part.

With ``--sweep`` it also runs every architecture's (or those named,
``--sweep A,B``) every cell at one scan unit (``dryrun._scan_unit_info``)
on both meshes, one child process an architecture, eight at a time, and
prints each cell's status and seconds, and a failed cell's traceback:
the dry run against this machine's PyTorch.

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_probes/dryrun_phase.py [--sweep [ARCH,...]]
"""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, ".")
import torch

import chip_smoke as cs
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import dryrun as dr

dev = torch.device("cuda")
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip(), flush=True)
print(sys.version.split()[0], torch.__version__, torch.version.cuda,
      torch.cuda.get_device_name(0), flush=True)
phase_s, t_prev = {}, time.perf_counter()


def done(phase: str) -> None:
    global t_prev
    now = time.perf_counter()
    phase_s[phase], t_prev = now - t_prev, now


model, init_s = cs.build_lm(cs.DRYRUN_SERVE, dev)
tokens = cs._prefill_batch(model.cfg, *cs.PREFILL[cs.DRYRUN_SERVE], dev)
done("granite build")
row, counts = cs.dryrun_count(model, tokens)
print("dryrun card:", json.dumps(row), flush=True)
print("launches by path:", json.dumps({"dryrun": counts}), flush=True)
done("granite dryrun count")
del model, tokens
torch.cuda.empty_cache()
out = Path("build") / "dryrun"
cs.dryrun_cli(out)
done("dryrun cells")


def _sweep(arch: str) -> str:
    cfg = get_config(arch)
    unit = dict(dr._scan_unit_info(cfg)[1](1))
    unit.pop("scan_layers")
    sets = ",".join(f"{k}={v}" for k, v in unit.items())
    log = out / f"sweep_{arch}.log"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--mesh", "both", "--set", sets, "--no-probes", "--out",
             str(out / f"sweep_{arch}.json"), "--force"],
            env=dict(os.environ, PYTHONPATH="src"), stdout=f,
            stderr=subprocess.STDOUT, timeout=1500).returncode
    lines = [ln for ln in log.read_text().splitlines()
             if ln.startswith(("[ ok ]", "[FAIL]"))]
    recs = json.loads((out / f"sweep_{arch}.json").read_text())
    lines += [r["traceback"][-2000:] for r in recs.values() if not r["ok"]]
    return (f"{arch} ({sets}) exit {rc} in "
            f"{time.perf_counter() - t0:.1f} s\n" + "\n".join(lines))


if "--sweep" in sys.argv:
    i = sys.argv.index("--sweep")
    archs = (sys.argv[i + 1].split(",") if len(sys.argv) > i + 1
             else ARCH_NAMES)
    with ThreadPoolExecutor(8) as pool:
        for text in pool.map(_sweep, archs):
            print(text, flush=True)
    done("sweep")
print("phase seconds:", json.dumps(phase_s), flush=True)
