"""Try depth cuts of the chip smoke's host-bound parity phases: heap
parity (a)'s Fig 4/6/7 grid at given message counts, each cell on the
cohort engine and on the heap engine with its deviations beside the
reference's bands, or one flow cell at a given message count with each
lane's rejected publishes and withheld confirms (and, for the parity
cell, heap parity (c)'s deviations and factors), or the availability
crossover at a given message count a cell with each cell's outage
against its run's end, its losses and redeliveries, and the crossover
against the sweep, or the chaos campaign at a given message count a
cell with the chaos phase's holds and heap parity (b)'s bands, or the
experiment layer's campaign and deployment study at given message
counts with the engine each campaign group ran (cohort runs counted)
and the deployment crossover against the sweep.  It reports and does not hold: a band missed, an
outage past its run's end, a loss or a crossover outside the sweep
prints ``MISS``.

Run from the root of a checkout::

    python3 chip_probes/depth_cuts.py grid WS_FB_MSGS GATHER_MSGS [--device cpu]
    python3 chip_probes/depth_cuts.py flow "parity"|"scale smoke" MSGS [--device cpu]
    python3 chip_probes/depth_cuts.py avail MSGS [--device cpu]
    python3 chip_probes/depth_cuts.py chaos MSGS [--device cpu]
    python3 chip_probes/depth_cuts.py exp CAMPAIGN_MSGS TENANT_MSGS [--device cpu]

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
ap.add_argument("what", choices=["grid", "flow", "avail", "chaos", "exp"])
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


def avail(msgs: int) -> None:
    from repro_torch import availability_crossover, chaos_metrics
    t0 = time.perf_counter()
    with cs._recorded_runs() as calls:
        study = availability_crossover(device=args.device,
                                       total_messages=msgs)
    wall = time.perf_counter() - t0
    (results,) = calls
    miss = False
    for r in results:
        sched = r.spec.params.chaos
        start, end = sched.outage_span()
        m = chaos_metrics(r, sched).as_row()
        inside = start < r.sim_time
        bad = (not inside or m["lost"] or m["duplicates"] > r.redelivered
               or r.n_consumed != r.spec.total_messages + m["duplicates"])
        miss |= bad
        print(json.dumps(dict(arch=r.spec.arch, outage=[start, end],
                              run_end_s=r.sim_time, outage_inside=inside,
                              lost=m["lost"], duplicates=m["duplicates"],
                              redelivered=r.redelivered,
                              verdict="MISS" if bad else "ok")), flush=True)
    x = study.crossover_duration_s
    lo, hi = 5.0, 120.0
    inside = x is not None and lo <= x <= hi
    print(json.dumps(dict(msgs=msgs, cells=len(results), wall_s=wall,
                          crossover_duration_s=x, headline=study.headline(),
                          verdict="ok" if inside and not miss else "MISS")),
          flush=True)


def chaos(msgs: int) -> None:
    cs.CHAOS_MSGS = msgs
    t0 = time.perf_counter()
    try:
        rows, _, phase, results = cs.drive_chaos(args.device)
        for r in rows:
            print(json.dumps({k: r[k] for k in (
                "cell", "sim_time_s", "stretch_s", "redelivered",
                "storm_rejects")}), flush=True)
        part = cs.heap_chaos(args.device, rows, results, phase["wall_s"])
        for c in part["cells"]:
            print(json.dumps(c), flush=True)
        verdict = "ok"
    except AssertionError as e:
        verdict = f"MISS: {e}"
    print(json.dumps(dict(msgs=msgs, wall_s=time.perf_counter() - t0,
                          verdict=verdict)), flush=True)


def exp(camp_msgs: int, tenant_msgs: int) -> None:
    import math
    from repro_torch import (CampaignSpec, deployment_feasibility,
                             run_campaign)
    miss = False
    for one in cs.EXP_CAMPAIGN["architectures"]:
        grid = CampaignSpec(**dict(cs.EXP_CAMPAIGN, architectures=(one,),
                                   total_messages=camp_msgs))
        camp, wall, counts = cs._counted(
            lambda: run_campaign(grid, device=args.device))
        consumed = all(s.n_messages == camp_msgs and s.engine == "jax"
                       for s in camp.summaries)
        # dts must take the wave program (no cohort run), mss the cohort
        # engine (one stacked run)
        route = counts["runs"] == (0 if one == "dts" else 1)
        bad = not (consumed and route) or any(c.n_fallback for c in [camp])
        miss |= bad
        print(json.dumps(dict(group=one, msgs=camp_msgs, wall_s=wall,
                              cohort_runs=counts["runs"],
                              verdict="MISS" if bad else "ok")), flush=True)
    t0 = time.perf_counter()
    study = deployment_feasibility(tenant_counts=cs.EXP_TENANTS,
                                   messages_per_tenant=tenant_msgs,
                                   device=args.device)
    finite = all(p.feasible and all(map(math.isfinite, (
        p.tenant_throughput_msgs_s, p.tenant_median_rtt_s, p.fairness,
        p.degradation, p.ingress_utilization)))
        for pts in study.curves.values() for p in pts)
    x = study.crossover_tenants
    inside = (x is not None and math.isfinite(x)
              and min(cs.EXP_TENANTS) <= x <= max(cs.EXP_TENANTS))
    miss |= not (finite and inside)
    print(json.dumps(dict(tenant_msgs=tenant_msgs,
                          wall_s=time.perf_counter() - t0,
                          crossover_tenants=x, headline=study.headline(),
                          verdict="MISS" if miss else "ok")), flush=True)


if args.what == "grid":
    grid(int(args.args[0]), int(args.args[1]))
elif args.what == "flow":
    flow(args.args[0], int(args.args[1]))
elif args.what == "avail":
    avail(int(args.args[0]))
elif args.what == "chaos":
    chaos(int(args.args[0]))
else:
    exp(int(args.args[0]), int(args.args[1]))
