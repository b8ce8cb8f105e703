"""Metrics the paper reports (§5.2): aggregate consumer throughput
(messages/second) and per-message round-trip time (median, p95, min).

A framework-free copy of the reference package's summary metrics, with
the same fields and the same warm-up rule."""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.simulator import RunResult


@dataclasses.dataclass
class Summary:
    arch: str
    pattern: str
    workload: str
    n_producers: int
    n_consumers: int
    feasible: bool
    throughput_msgs_s: float = float("nan")
    median_rtt_s: float = float("nan")
    p95_rtt_s: float = float("nan")
    min_rtt_s: float = float("nan")
    goodput_gbps: float = float("nan")
    rejected: float = 0
    blocked: float = 0
    n_messages: int = 0
    n_runs: int = 1
    tenants: int = 1
    #: the engine that ran the cell: always the wave program here
    engine: str = "torch"


def throughput_msgs_per_s(result: RunResult, warmup_frac: float = 0.05) -> float:
    """Aggregate message rate across all consumers, excluding warm-up."""
    ts = np.sort(result.consume_times)
    if ts.size < 2:
        return float("nan")
    k = int(ts.size * warmup_frac)
    ts = ts[k:]
    span = ts[-1] - ts[0]
    if span <= 0:
        return float("nan")
    return float((ts.size - 1) / span)


def summarize(result: RunResult) -> Summary:
    spec = result.spec
    s = Summary(arch=spec.arch, pattern=spec.pattern,
                workload=spec.workload.name,
                n_producers=spec.n_producers, n_consumers=spec.n_consumers,
                feasible=result.feasible,
                rejected=result.rejected_publishes,
                blocked=result.blocked_confirms,
                n_messages=result.n_consumed,
                tenants=spec.tenants)
    if not result.feasible:
        return s
    thr = throughput_msgs_per_s(result)
    s.throughput_msgs_s = thr
    s.goodput_gbps = thr * spec.workload.message_bits / 1e9
    if result.rtts.size:
        s.median_rtt_s = float(np.median(result.rtts))
        s.p95_rtt_s = float(np.percentile(result.rtts, 95))
        s.min_rtt_s = float(result.rtts.min())
    return s
