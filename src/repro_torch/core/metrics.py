"""Metrics the paper reports (§5.2): aggregate consumer throughput
(messages/second), per-message round-trip time (median + CDF), the
streaming *overhead* of PRS/MSS relative to the DTS baseline, and the
per-tenant rates and fairness of the multi-tenant study (§6).

A framework-free copy of the reference package's metrics, with the same
fields, the same warm-up rule and the same results."""

from __future__ import annotations

import dataclasses
from typing import Sequence

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
    #: reject-publish / credit-flow-block counts; float because
    #: multi-run cells report the mean over seeds
    rejected: float = 0
    blocked: float = 0
    n_messages: int = 0
    #: how many (feasible) runs a multi-seed mean covers; 1 for a single
    #: run, set by patterns.average_summaries
    n_runs: int = 1
    #: the cell's tenancy (paper §6 deployment study); 1 = single-user
    tenants: int = 1
    #: the engine that actually ran the cell, ``spec.params.engine`` of
    #: the result: ``run_many`` records its jax -> vectorized fallback of
    #: chaos cells there
    engine: str = ""


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
                tenants=spec.tenants,
                engine=spec.params.engine)
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


def rtt_cdf(result: RunResult, n_points: int = 200) -> tuple[np.ndarray, np.ndarray]:
    """Empirical CDF of per-message RTTs (paper Figs 5, 8)."""
    r = np.sort(result.rtts)
    if r.size == 0:
        return np.zeros(0), np.zeros(0)
    q = np.linspace(0.0, 1.0, n_points, endpoint=True)
    x = np.quantile(r, q)
    return x, q


def rtt_fraction_under(result: RunResult, threshold_s: float) -> float:
    """e.g. the paper's "PRS keeps 80% of message RTTs under 0.7 s"."""
    if result.rtts.size == 0:
        return float("nan")
    return float((result.rtts <= threshold_s).mean())


def jain_fairness(values: Sequence[float]) -> float:
    """Jain's fairness index over per-tenant (or per-flow) rates:
    ``(sum x)^2 / (n * sum x^2)``.  1.0 = perfectly even shares, ``1/n``
    = one tenant starves all others.  NaN when no finite positive data."""
    v = np.asarray(values, dtype=float)
    v = v[np.isfinite(v)]
    if v.size == 0 or not np.any(v):
        return float("nan")
    return float(v.sum() ** 2 / (v.size * (v ** 2).sum()))


def tenant_throughputs(result: RunResult) -> np.ndarray:
    """Per-tenant consumed-message rate (msgs/s) over the run's active
    span, from the result's producer-attribution arrays.  Shape
    ``(spec.tenants,)``."""
    T = max(1, result.spec.tenants)
    ts = result.consume_times
    if ts.size < 2 or result.consume_producers.size != ts.size:
        return np.full(T, float("nan"))
    span = float(ts.max() - ts.min())
    if span <= 0:
        return np.full(T, float("nan"))
    tenant = result.tenant_of_producer(result.consume_producers)
    counts = np.bincount(tenant, minlength=T)[:T]
    return counts / span


def tenant_median_rtts(result: RunResult) -> np.ndarray:
    """Per-tenant median round-trip time (s); NaN for tenants with no
    RTT samples.  Shape ``(spec.tenants,)``."""
    T = max(1, result.spec.tenants)
    out = np.full(T, float("nan"))
    if result.rtts.size == 0 or \
            result.rtt_producers.size != result.rtts.size:
        return out
    tenant = result.tenant_of_producer(result.rtt_producers)
    for t in range(T):
        sel = result.rtts[tenant == t]
        if sel.size:
            out[t] = float(np.median(sel))
    return out


def overhead_vs_baseline(value: float, baseline: float,
                         higher_is_better: bool) -> float:
    """Paper §5.2: overhead of an architecture relative to DTS.

    For throughput (higher better): baseline/value; for RTT (lower better):
    value/baseline. 1.0 = parity, 2.5 = "2.5x overhead"."""
    if not np.isfinite(value) or not np.isfinite(baseline) or value <= 0 or baseline <= 0:
        return float("nan")
    return baseline / value if higher_is_better else value / baseline


def overhead_table(summaries: Sequence[Summary],
                   metric: str = "throughput_msgs_s") -> dict[tuple, float]:
    """Map (arch, workload, n_consumers) -> overhead vs the DTS run with the
    same (workload, pattern, n_consumers)."""
    higher_better = metric == "throughput_msgs_s"
    base: dict[tuple, float] = {}
    for s in summaries:
        if s.arch == "dts":
            base[(s.pattern, s.workload, s.n_consumers)] = getattr(s, metric)
    out: dict[tuple, float] = {}
    for s in summaries:
        if s.arch == "dts" or not s.feasible:
            continue
        b = base.get((s.pattern, s.workload, s.n_consumers))
        if b is None:
            continue
        out[(s.arch, s.workload, s.n_consumers)] = overhead_vs_baseline(
            getattr(s, metric), b, higher_better)
    return out
