"""Try depth cuts of the chip smoke's host-bound parity phases: heap
parity (a)'s Fig 4/6/7 grid at given message counts, each cell on the
cohort engine and on the heap engine with its deviations beside the
reference's bands, or one flow cell at a given message count with each
lane's rejected publishes and withheld confirms (and, for the parity
cell, heap parity (c)'s deviations and factors).  It reports and does
not hold: a band missed prints ``MISS``.

Run from the root of a checkout::

    python3 chip_probes/depth_cuts.py grid WS_FB_MSGS GATHER_MSGS [--device cpu]
    python3 chip_probes/depth_cuts.py flow "parity"|"scale smoke" MSGS [--device cpu]

The cohort engine on the CPU gives the card's results (the smoke's
cross-checks hold the two at 1e-9), so a cut can be tried without the
card; its walls there are the CPU's, not the card's.
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")
import torch

import chip_smoke as cs

ap = argparse.ArgumentParser()
ap.add_argument("what", choices=["grid", "flow"])
ap.add_argument("args", nargs="+")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
if args.device == "cpu":
    # the smoke's counters synchronise the card; there is none here
    torch.cuda.synchronize = lambda *a, **k: None


def grid(ws_fb: int, gather: int) -> None:
    from repro_torch import run_pattern, summarize
    from repro_torch.core.parity import band
    held = {"work_sharing": (("throughput_msgs_s", "work_sharing.{}.throughput"),),
            "feedback": (("median_rtt_s", "feedback.{}.median_rtt"),
                         ("throughput_msgs_s", "feedback.all.throughput")),
            "broadcast_gather": (
                ("throughput_msgs_s", "broadcast_gather.all.throughput"),
                ("median_rtt_s", "broadcast_gather.{}.gather_rtt"))}
    for pattern, wl, msgs in (("work_sharing", "dstream", ws_fb),
                              ("feedback", "dstream", ws_fb),
                              ("broadcast_gather", "generic", gather)):
        for arch in cs.HEAP_ARCHS:
            kw = dict(total_messages=msgs, n_runs=1, seed=0, jitter=0.0,
                      device=args.device)
            t0 = time.perf_counter()
            (v,) = run_pattern(pattern, arch, wl, cs.HEAP_NC,
                               engine="vectorized", **kw)
            wall = time.perf_counter() - t0
            (h,) = run_pattern(pattern, arch, wl, cs.HEAP_NC, engine="heap",
                               **kw)
            hs, vs = summarize(h), summarize(v)
            devs = {}
            for field, key in held[pattern]:
                key = key.format(arch)
                got, want = getattr(vs, field), getattr(hs, field)
                devs[key] = dict(dev=abs(got - want) / abs(want),
                                 band=band(key))
            miss = any(d["dev"] > d["band"] for d in devs.values())
            print(json.dumps(dict(cell=f"{pattern}/{wl}/{arch}", msgs=msgs,
                                  cohort_wall_s=wall, held=devs,
                                  verdict="MISS" if miss else "ok")),
                  flush=True)


def flow(name: str, msgs: int) -> None:
    from repro_torch import run_experiment, summarize
    from repro_torch.core.parity import band, factor_band
    _, n, _, cap, over = next(c for c in cs.FLOW_CELLS if c[0] == name)
    specs = cs._flow_specs("feedback", n, msgs, cap, over)
    res, wall, counts = cs._cohort_run(specs, args.device)
    row = dict(cell=name, msgs=msgs, cap_msgs=cap, cohort_wall_s=wall,
               consumed=[r.n_consumed for r in res],
               rejected=[r.rejected_publishes for r in res],
               blocked=[r.blocked_confirms for r in res],
               withheld=counts["withheld"])
    if name == "parity":
        tol = band("stacked_overflow.lanes.summary")
        row["heap"] = []
        for v in res:
            h = run_experiment(cs._heap_of(v.spec), device=args.device)
            hs, vs = summarize(h), summarize(v)
            row["heap"].append(dict(
                seed=v.spec.params.seed, band=tol,
                throughput_dev=abs(vs.throughput_msgs_s - hs.throughput_msgs_s)
                / hs.throughput_msgs_s,
                median_rtt_dev=abs(vs.median_rtt_s - hs.median_rtt_s)
                / hs.median_rtt_s,
                rejected=[h.rejected_publishes, v.rejected_publishes],
                blocked=[h.blocked_confirms, v.blocked_confirms],
                rejected_band=factor_band("stacked_overflow.lanes.rejected"),
                blocked_band=factor_band("stacked_overflow.lanes.blocked")))
    print(json.dumps(row), flush=True)


if args.what == "grid":
    grid(int(args.args[0]), int(args.args[1]))
else:
    flow(args.args[0], int(args.args[1]))
