#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, one line each: the card; the kernel build from the sources in
the checkout; every kernel against its plain PyTorch version on the
card (bitwise), with its time beside its bound; the main path —
``run_many`` at deployment scale (1024x1024 work-sharing on dts,
prs-haproxy and mss, 256x256 feedback on dts, three seed-lanes each) —
with the kernel launch counts it made; the same Fig 4 cell run on the
GPU and on the CPU, compared; and a ``torch.profiler`` breakdown of one
main-path cell (device busy time, top kernels).  The line before the last holds the
kernels' numbers as JSON, and the last line the device.  Any failure
exits nonzero; without CUDA it exits 1 before printing a result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peak memory rate (NVIDIA data sheet), bytes/s
HBM_BPS = 3.35e12
#: cross-device tolerance: CUDA's cumsum associates differently from the
#: CPU's sequential sum, so clocks may differ in the last bits
XDEV_RTOL = 1e-9

MAIN_CELLS = (
    ("work_sharing", "dts", 1024, 262144),
    ("work_sharing", "prs-haproxy", 1024, 262144),
    ("work_sharing", "mss", 1024, 262144),
    ("feedback", "dts", 256, 65536),
)
SEEDS = (0, 1000, 2000)
#: warm timed runs of each main-path cell (median and spread reported)
WALL_REPEATS = 3


def _cuda_ms(fn, n_iter: int, repeats: int = 7) -> float:
    """Median over ``repeats`` of the mean time of ``n_iter`` calls,
    from CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n_iter):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / n_iter)
    return statistics.median(times)


def _graph_ms(fn, n_iter: int, repeats: int = 7) -> float:
    """Device time per call: ``n_iter`` calls captured in one CUDA graph,
    replayed and timed with CUDA events, so the host's per-call
    overhead drops out; median over ``repeats`` replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_iter):
            fn()
    return _cuda_ms(graph.replay, 1, repeats) / n_iter


def _pump_inputs(rng, R: int, P: int, L: int, Np: int, case: str, dev):
    import torch
    ring = rng.uniform(0.0, 50.0, size=(R, P, L))
    t = rng.uniform(0.0, 50.0, size=(Np, L))
    gid = rng.integers(0, R, size=Np)
    idx = rng.integers(0, 4 * P, size=Np)
    valid = rng.random(Np) < 0.9
    if case == "all_below_P":
        idx = rng.integers(0, P, size=Np)
    elif case == "all_invalid":
        valid[:] = False
    elif case == "dummy_row":
        gid[:] = R - 1
    t[~valid] = float("inf")
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (ring, t, gid, idx, valid))


def check_kernels(dev) -> dict:
    """Phase 3: the pump kernel against ``pump_assign_ref`` on the card,
    bitwise, at the main-path shapes and the edge cases; its time, the
    plain version's time and the bound at the main-path shape."""
    import numpy as np
    import torch
    from repro_torch.kernels.pump_assign import pump_assign, pump_assign_ref
    rng = np.random.default_rng(0)
    cases = [("main", 1025, 64, 3, 8192), ("L1", 1025, 64, 1, 8192),
             ("ragged", 257, 64, 3, 8192 - 37), ("all_below_P", 1025, 64, 3, 8192),
             ("all_invalid", 1025, 64, 3, 8192), ("dummy_row", 1025, 64, 3, 8192),
             ("reply_pump", 257, 64, 3, 2048)]
    for case, R, P, L, Np in cases:
        args = _pump_inputs(rng, R, P, L, Np, case, dev)
        got = pump_assign(*args)
        torch.cuda.synchronize()
        want = pump_assign_ref(*args)
        if not torch.equal(got, want):
            err = (got - want).abs().max().item()
            raise AssertionError(f"pump_assign differs from its plain "
                                 f"version on case {case}: {err}")
    ring, t, gid, idx, valid = _pump_inputs(rng, 1025, 64, 3, 8192, "main", dev)
    got, want = pump_assign(ring, t, gid, idx, valid), pump_assign_ref(
        ring, t, gid, idx, valid)
    fin = torch.isfinite(want)
    max_err = float((got[fin] - want[fin]).abs().max().item())
    ms = _graph_ms(lambda: pump_assign(ring, t, gid, idx, valid), 200)
    plain_ms = _graph_ms(lambda: pump_assign_ref(ring, t, gid, idx, valid), 200)
    call_ms = _cuda_ms(lambda: pump_assign(ring, t, gid, idx, valid), 200)
    plain_call_ms = _cuda_ms(
        lambda: pump_assign_ref(ring, t, gid, idx, valid), 200)
    # bytes the function must move: t_ready, gid, idx_on, valid read
    # once, out written once, and the ring rows this data gates on
    gated = int(((idx >= 64) & valid).sum().item())
    nbytes = (t.numel() * 8 * 2 + gid.numel() * 8 + idx.numel() * 8
              + valid.numel() + gated * 3 * 8)
    return dict(name="pump_assign", route="cuda",
                source="src/repro_torch/kernels/csrc/pump_assign.cu",
                replaces="src/repro/core/jax_device_loop.py:837",
                launches=0, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BPS * 1e3, bound_by="bytes",
                library_ms=None, cases=len(cases), call_ms=call_ms,
                plain_call_ms=plain_call_ms)


def _specs(pattern: str, arch: str, n: int, msgs: int):
    from repro_torch import ExperimentSpec, SimParams, get_workload
    return [ExperimentSpec(pattern=pattern, workload=get_workload("dstream"),
                           arch=arch, n_producers=n, n_consumers=n,
                           total_messages=msgs, params=SimParams(seed=s))
            for s in SEEDS]


def drive_main_path(dev) -> tuple[list, int]:
    """Phase 4: every main-path cell through ``run_many`` on the card,
    warm (after one untimed run), timed ``WALL_REPEATS`` times, each
    run with the pump launches counted from 0.  Returns the per-cell rows and the total launches."""
    import torch
    from repro_torch import run_many, summarize
    from repro_torch.core import torch_device_loop as dl
    from repro_torch.core.cell import WaveCell
    from repro_torch.kernels import pump_assign
    rows, total = [], 0
    for pattern, arch, n, msgs in MAIN_CELLS:
        specs = _specs(pattern, arch, n, msgs)
        t0 = time.perf_counter()
        cell = WaveCell(specs[0], stack_seeds=list(SEEDS))
        ws = dl.build_static(cell)
        dl.draw_jitter(cell, ws)
        host_s = time.perf_counter() - t0
        n_steps = ws.meta["nSteps"]
        run_many(specs, device=dev)
        torch.cuda.synchronize()
        need = (2 if pattern == "feedback" else 1) * n_steps
        walls, counts = [], []
        for _ in range(WALL_REPEATS):
            pump_assign.launches = 0
            t0 = time.perf_counter()
            res = run_many(specs, device=dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts.append(pump_assign.launches)
            if counts[-1] < need:
                raise AssertionError(
                    f"{pattern}/{arch}: {counts[-1]} pump launches < {need}: "
                    f"the main path missed the kernel")
        launches = counts[0]
        total += launches
        for r in res:
            if r.n_consumed != msgs:
                raise AssertionError(f"{pattern}/{arch} seed "
                                     f"{r.spec.params.seed}: consumed "
                                     f"{r.n_consumed} of {msgs}")
        sm = [summarize(r) for r in res]
        rows.append(dict(
            cell=f"{pattern}/{arch}/c{n}", msgs=msgs, lanes=len(res),
            steps=n_steps, wall_s=statistics.median(walls),
            wall_s_runs=walls, host_build_s=host_s, pump_launches=launches,
            throughput_msgs_s=[s.throughput_msgs_s for s in sm],
            median_rtt_s=([s.median_rtt_s for s in sm]
                          if pattern == "feedback" else None)))
    return rows, total


def cross_check(dev) -> dict:
    """Phase 5: the 64-consumer Fig 4 cell on the card and on the CPU,
    traces and summaries compared at ``XDEV_RTOL``."""
    import numpy as np
    from repro_torch import run_many, summarize
    from repro_torch.core import torch_device_loop as dl
    from repro_torch.core.cell import WaveCell
    specs = _specs("work_sharing", "dts", 64, 4096)
    cell = WaveCell(specs[0], stack_seeds=list(SEEDS))
    ws = dl.build_static(cell)
    jit = dl.draw_jitter(cell, ws)
    yg = dl.run_wave_trace(ws, jit, device=dev)
    yc = dl.run_wave_trace(ws, jit, device="cpu")
    worst = 0.0
    for k in yc:
        fin = np.isfinite(yc[k])
        if not np.array_equal(fin, np.isfinite(yg[k])):
            raise AssertionError(f"trace {k}: finite masks differ")
        if fin.any():
            rel = np.abs(yg[k][fin] - yc[k][fin]) / np.abs(yc[k][fin]).clip(1e-300)
            worst = max(worst, float(rel.max()))
    sg = [summarize(r) for r in run_many(specs, device=dev)]
    sc = [summarize(r) for r in run_many(specs, device="cpu")]
    for a, b in zip(sg, sc):
        rel = abs(a.throughput_msgs_s - b.throughput_msgs_s) / b.throughput_msgs_s
        worst = max(worst, rel)
        if a.n_messages != b.n_messages:
            raise AssertionError("cross-check: consumed counts differ")
    if worst > XDEV_RTOL:
        raise AssertionError(f"cuda vs cpu: max relative deviation {worst} "
                             f"> {XDEV_RTOL}")
    return dict(cell="work_sharing/dts/c64/4096msgs", lanes=len(SEEDS),
                max_rel_dev=worst, rtol=XDEV_RTOL,
                throughput_msgs_s=[s.throughput_msgs_s for s in sg])


def profile_cell(dev) -> dict:
    """Device busy time and the top kernels of one warm main-path run
    (work_sharing/dts/c1024), from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import run_many
    specs = _specs(*MAIN_CELLS[0])
    run_many(specs, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_many(specs, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): the CPU-side op
        # events carry the same device time again
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = ev.self_device_time_total
        if dt:
            rows.append((dt, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    return dict(cell="work_sharing/dts/c1024", wall_s=wall,
                device_busy_s=busy if rows else "not measured",
                idle_share=1.0 - busy / wall if rows else "not measured",
                device_events=sum(r[1] for r in rows),
                top=[dict(us=r[0], count=r[1], name=r[2][:80])
                     for r in rows[:8]])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import KERNELS, _build
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {kind}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    for name in KERNELS:
        _build.build(name)
    print(f"build: {sorted(KERNELS)} in {time.perf_counter() - t0:.2f} s")
    kern = check_kernels(dev)
    print("kernel check:", json.dumps(kern))
    rows, launches = drive_main_path(dev)
    for r in rows:
        print("main path:", json.dumps(r))
    kern["launches"] = launches
    print("cross-check:", json.dumps(cross_check(dev)))
    print("profile:", json.dumps(profile_cell(dev)))
    for k in ("cases", "call_ms", "plain_call_ms"):
        kern.pop(k)
    print(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
