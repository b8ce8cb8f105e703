"""The paper's full evaluation in miniature: all three patterns x three
architectures, printing a compact version of Figs 4/6/7 plus the headline
overhead ratios (§6 conclusions).  The ``repro_torch`` counterpart of
``examples/cross_facility_comparison.py``.

    PYTHONPATH=src python examples_torch/cross_facility_comparison.py
    PYTHONPATH=src python examples_torch/cross_facility_comparison.py --engine heap
    PYTHONPATH=src python examples_torch/cross_facility_comparison.py --scale
    PYTHONPATH=src python examples_torch/cross_facility_comparison.py --device cpu

Runs on the port's per-cohort engine on the GPU by default; ``--engine
heap`` is the escape hatch to the exact one-event-per-hop reference (on
the host).  ``--scale`` extends the sweep to 256 consumers (interactive
only on the per-cohort engine).  ``--device cpu`` runs on the CPU;
without a GPU the default raises.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch import run_pattern, summarize
from repro_torch.core.metrics import overhead_table
from repro_torch.device import resolve_device

ARCHS = ("dts", "prs-haproxy", "mss")


def comparison(engine: str, scale: bool, device) -> list:
    """The three figures and the overhead table on ``engine``, each line
    printed as it is made.  Returns the lines."""
    lines = []

    def out(line: str) -> None:
        lines.append(line)
        print(line)

    def one(pattern: str, arch: str, workload: str, nc: int, msgs: int):
        return summarize(run_pattern(pattern, arch, workload, nc,
                                     total_messages=msgs, n_runs=1,
                                     engine=engine, device=device)[0])

    ws_consumers = (1, 8, 32, 256) if scale else (1, 8, 32)
    out(f"== Fig4 (mini): work-sharing throughput, dstream [{engine}] ==")
    ws = []
    for arch in ARCHS:
        for nc in ws_consumers:
            s = one("work_sharing", arch, "dstream", nc, max(2048, 16 * nc))
            ws.append(s)
            out(f"  {arch:13s} c={nc:3d}  {s.throughput_msgs_s:8.0f} msgs/s")
    out(f"== Fig6 (mini): feedback median RTT, dstream [{engine}] ==")
    for arch in ARCHS:
        for nc in (1, 8):
            s = one("feedback", arch, "dstream", nc, 1536)
            out(f"  {arch:13s} c={nc:3d}  {s.median_rtt_s * 1e3:8.0f} ms")
    out(f"== Fig7a (mini): broadcast throughput, generic [{engine}] ==")
    for arch in ARCHS:
        s = one("broadcast", arch, "generic", 8, 256)
        out(f"  {arch:13s} c=  8  {s.throughput_msgs_s:8.0f} msgs/s")
    out("== overhead vs DTS (work sharing) ==")
    for (arch, wl, nc), ov in sorted(overhead_table(ws).items()):
        out(f"  {arch:13s} c={nc:3d}  {ov:.2f}x")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Run the comparison; returns the lines it printed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("heap", "vectorized"),
                    default="vectorized", help="StreamSim backend")
    ap.add_argument("--scale", action="store_true",
                    help="extend the work-sharing sweep to 256 consumers")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return comparison(args.engine, args.scale, resolve_device(args.device))


if __name__ == "__main__":
    main()
