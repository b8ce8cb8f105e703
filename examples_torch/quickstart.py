"""Quickstart: the paper's three cross-facility streaming architectures in
60 seconds — deploy each control plane, run a small work-sharing
experiment, and print the throughput/overhead comparison (paper Fig 4 in
miniature).  The ``repro_torch`` counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples_torch/quickstart.py
    PYTHONPATH=src python examples_torch/quickstart.py --engine heap
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

Runs on the port's per-cohort StreamSim engine on the GPU by default;
``--engine heap`` selects the exact one-event-per-hop reference (on the
host).  ``--device cpu`` runs on the CPU; without a GPU the default
raises.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch import (
    ResourceSettings, S3MService, establish_prs_session, make_architecture,
    overhead_table, run_pattern, summarize)
from repro_torch.device import resolve_device

ARCHS = ("dts", "prs-haproxy", "prs-stunnel", "mss")


def deploy_lines() -> list:
    """Deploy the three control planes; one line each."""
    # DTS: NodePort-exposed RabbitMQ (helm release, direct connectivity)
    dts = make_architecture("dts")
    # PRS: SciStream S2UC -> S2CS handshake builds the overlay session
    sess = establish_prs_session(num_conn=1, tunnel="haproxy")
    # MSS: S3M token-authenticated provisioning returns an FQDN URL
    s3m = S3MService()
    s3m.register_project("abc123")
    token = s3m.issue_token("abc123")
    cluster = s3m.provision_cluster(token, settings=ResourceSettings(
        cpus=12, ram_gbs=32, nodes=3))
    return [f"DTS : {dts.deployment_feasibility}",
            f"PRS : overlay {' -> '.join(sess.hops)} (uid={sess.uid})",
            f"MSS : provisioned {cluster.amqps_url}"]


def work_sharing(engine: str, device) -> tuple:
    """The work-sharing table (dstream, 8 x 8, 2048 messages, one seed)
    on ``engine``: (its lines, the overhead lines, the ``RunResult``s)."""
    table, summaries, results = [], [], []
    for arch in ARCHS:
        r = run_pattern("work_sharing", arch, "dstream", 8,
                        total_messages=2048, n_runs=1, engine=engine,
                        device=device)[0]
        s = summarize(r)
        results.append(r)
        summaries.append(s)
        if s.feasible:
            table.append(f"{arch:14s} {s.throughput_msgs_s:8.0f} msgs/s "
                         f"({s.goodput_gbps:.2f} Gbps)")
        else:
            table.append(f"{arch:14s} INFEASIBLE")
    overhead = [f"  {arch:14s} {ov:.2f}x"
                for (arch, wl, nc), ov in overhead_table(summaries).items()]
    return table, overhead, results


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Run the quickstart; returns the lines it printed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("heap", "vectorized"),
                    default="vectorized", help="StreamSim backend")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    lines = ["== deploying the three architectures ==", *deploy_lines(), "",
             "== work-sharing throughput, Dstream, 8 producers/consumers =="]
    for line in lines:
        print(line)
    table, overhead, _ = work_sharing(args.engine, device)
    tail = [*table, "", "overhead vs DTS (paper: PRS/MSS up to ~2.5x):",
            *overhead]
    for line in tail:
        print(line)
    return lines + tail


if __name__ == "__main__":
    main()
