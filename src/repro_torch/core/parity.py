"""Engine-parity tolerance bands: a copy of the reference package's
``parity`` table.

The port's tests and ``chip_smoke.py`` read their modeling bands from
here instead of literal constants: the ``device_loop.*`` bands hold the
wave program against the per-cohort engine, the others are the
reference's bands of its batched engines against its heap engine.  A
test holds this table equal to the reference's.

Keys are ``<cell>.<arch-or-scope>.<metric>``; values are *fractional*
relative deviations (``0.03`` = "<= 3%").  ``FACTOR_BANDS`` holds the
knife-edge counter bands, expressed as ``(lo, hi)`` multiplicative
factors vs the reference realization.
"""

from __future__ import annotations

#: relative-deviation bounds of the batched engines (vectorized + jax)
#: vs the heap reference, as enforced by the parity suites
PARITY_BANDS: dict[str, float] = {
    # Fig 4: aggregate work-sharing throughput
    "work_sharing.dts.throughput": 0.03,
    "work_sharing.prs-haproxy.throughput": 0.02,
    "work_sharing.mss.throughput": 0.02,
    # Fig 6: feedback median RTT (throughput rides along for all archs)
    "feedback.dts.median_rtt": 0.035,
    "feedback.prs-haproxy.median_rtt": 0.02,
    "feedback.mss.median_rtt": 0.02,
    "feedback.all.throughput": 0.02,
    # Fig 7: broadcast throughput + gather RTT
    "broadcast_gather.all.throughput": 0.02,
    "broadcast_gather.dts.gather_rtt": 0.02,
    "broadcast_gather.prs-haproxy.gather_rtt": 0.03,
    "broadcast_gather.mss.gather_rtt": 0.02,
    # overflow stress cell (reject-publish + credit-flow both active)
    "overflow.dts.summary": 0.05,
    "overflow.dts.counters": 0.25,
    # multi-tenant cells, all three deployment archs, both isolations
    "multi_tenant.all.summary": 0.05,
    "multi_tenant.all.tenant_throughput": 0.08,
    # whole-run device program (jax_device_loop=True) vs the
    # vectorized cohort loop: the wave schedule is a static pipeline,
    # so these are modeling bands, not arithmetic-noise bands.  They
    # apply only inside the supported regime (the
    # ``_device_loop_ok`` gate in repro.core.jax_device_loop);
    # gated cells fall back to the per-cohort path and carry the
    # ordinary engine bands instead
    "device_loop.all.throughput": 0.06,
    "device_loop.all.median_rtt": 0.05,
    # stacked seed-lanes (campaign layer): non-pilot lanes vs solo runs
    "stacked.lanes.summary": 0.02,
    # stacked overflow-regime lanes vs their own solo *heap* runs
    "stacked_overflow.lanes.summary": 0.05,
    # chaos campaign cells (topology-epoch failure injection,
    # tests/test_chaos.py): throughput/sim-time summaries per scenario,
    # and the recovery-time catch-up clock where finite
    "chaos.link.summary": 0.05,
    "chaos.broker.summary": 0.05,
    "chaos.consumer.summary": 0.05,
    "chaos.autoscale.summary": 0.05,
    "chaos.all.recovery": 0.25,
}

#: knife-edge reject/block counters in stacked overflow lanes: the
#: threshold counts swing with the jitter realization in both engines,
#: so they are held to (lo, hi) factor bands vs the lane's heap run
#: (plus a hard nonzero requirement asserted in the tests)
FACTOR_BANDS: dict[str, tuple[float, float]] = {
    "stacked_overflow.lanes.rejected": (0.3, 3.0),
    "stacked_overflow.lanes.blocked": (0.5, 2.0),
    # chaos cells: redelivery counts depend on exactly which deliveries
    # are broker-unacked at the outage boundary, and re-publish-storm
    # reject counts on the retry-cadence phase — knife-edge in both
    # engines, held to factor bands (nonzero asserted by the tests)
    "chaos.all.redelivered": (0.5, 2.0),
    "chaos.broker.rejects": (0.3, 3.0),
}


def band(key: str) -> float:
    """Look up a parity band, with the known keys in the error."""
    try:
        return PARITY_BANDS[key]
    except KeyError:
        raise KeyError(
            f"unknown parity band {key!r}; known: "
            f"{sorted(PARITY_BANDS)}") from None


def factor_band(key: str) -> tuple[float, float]:
    """Look up a counter factor band, with the known keys in the error."""
    try:
        return FACTOR_BANDS[key]
    except KeyError:
        raise KeyError(
            f"unknown factor band {key!r}; known: "
            f"{sorted(FACTOR_BANDS)}") from None
