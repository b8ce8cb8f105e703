"""Chaos schedules: topology-epoch failure injection for the cohort
engine.

A :class:`ChaosSchedule` attached to ``SimParams.chaos`` turns a run into
a sequence of *topology epochs*: piecewise-static hop graphs separated by
scheduled failure/recovery boundaries, with full state carry-over
(in-flight messages, queue backlogs, credit/confirm state, clocks)
across each boundary.  The per-cohort engine
(:class:`~repro_torch.core.torch_engine.TorchStreamSim`) pushes each
boundary as a sentinel entry into its batch event heap, so the horizon
logic stops cohorts from being served across an epoch boundary, and
applies the state change between batches.  Chaos cells run solo (one
seed-lane) on that engine; the wave program's gate refuses them.

A framework-free copy of the reference package's ``chaos`` module: the
names, defaults, validation messages and metrics are the reference's.

Event grammar (``Injection``)
-----------------------------

``kind="link"``
    ``target`` names a resource key (``"ttun:1"``, ``"tunnel"``,
    ``"lb"``) or a resource-class prefix (``"ttun"``).  During
    ``[t0, t1)`` the matched resources accept no new service: work
    already started completes, everything else waits until ``t1``
    (messages are delayed, never dropped).

``kind="broker"``
    ``target`` selects broker queues: ``"queue:<name>"`` (one queue),
    ``"node:<k>"`` (every queue homed on DSN node ``k``) or
    ``"vhost:<v>"`` (a tenant vhost's queues).  During ``[t0, t1)`` the
    queues reject publishes (producers enter their re-publish backoff
    loop — the re-publish storm) and deliver nothing; at ``t0`` every
    delivery that is unacked at the broker re-enters the queue FIFO
    (at-least-once redelivery), so consumed-but-unacked messages are
    duplicated, and nothing is lost.

``kind="consumer"``
    ``target`` is a consumer id (``"c3"``).  At ``t0`` the consumer's
    channel is dropped (its unacked deliveries requeue, as above) and it
    leaves the round-robin rotation; at ``t1`` it re-registers with a
    fresh channel.

Autoscaling (``AutoscalePolicy``) adds backlog-reactive consumer
elasticity: every ``interval_s`` of sim time the engine compares the
total undelivered work-queue backlog against ``high_backlog`` /
``low_backlog`` and adds/retires ``step`` consumers (never beyond
``max_consumers``, never below the configured fleet).

Chaos runs are supported on the ``work_sharing`` pattern (the paper's
steady-state ingest scenario).  This module needs only NumPy and must
not import ``repro_torch.core.simulator``.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Optional

import numpy as np

VALID_KINDS = ("link", "broker", "consumer")


@dataclass(frozen=True)
class Injection:
    """One failure/recovery pair: ``target`` is down during ``[t0, t1)``."""

    kind: str
    target: str
    t0: float
    t1: float

    def __post_init__(self) -> None:
        if self.kind not in VALID_KINDS:
            raise ValueError(f"unknown injection kind {self.kind!r}; "
                             f"expected one of {VALID_KINDS}")
        if not self.target:
            raise ValueError("injection target must be non-empty")
        if not (0.0 <= self.t0 < self.t1):
            raise ValueError("injection window must satisfy 0 <= t0 < t1 "
                             f"(got t0={self.t0}, t1={self.t1})")


@dataclass(frozen=True)
class AutoscalePolicy:
    """Backlog-reactive consumer elasticity, checked every ``interval_s``."""

    interval_s: float = 0.25
    high_backlog: int = 64
    low_backlog: int = 8
    max_consumers: int = 16
    step: int = 1

    def __post_init__(self) -> None:
        if self.interval_s <= 0.0:
            raise ValueError("autoscale interval_s must be > 0")
        if self.low_backlog < 0 or self.high_backlog <= self.low_backlog:
            raise ValueError("autoscale thresholds must satisfy "
                             "0 <= low_backlog < high_backlog")
        if self.max_consumers < 1 or self.step < 1:
            raise ValueError("autoscale max_consumers and step must be >= 1")


@dataclass(frozen=True)
class ChaosSchedule:
    """The full chaos schedule for one run (injections + autoscaling)."""

    injections: tuple[Injection, ...] = ()
    autoscale: Optional[AutoscalePolicy] = None

    def __post_init__(self) -> None:
        if not self.injections and self.autoscale is None:
            raise ValueError("a ChaosSchedule needs at least one injection "
                             "or an autoscale policy")
        object.__setattr__(self, "injections", tuple(self.injections))

    @staticmethod
    def from_dict(d: dict) -> "ChaosSchedule":
        """Build a schedule from plain JSON data (campaign spec files)."""
        inj = tuple(Injection(**i) if isinstance(i, dict) else i
                    for i in d.get("injections", ()))
        auto = d.get("autoscale")
        if isinstance(auto, dict):
            auto = AutoscalePolicy(**auto)
        return ChaosSchedule(injections=inj, autoscale=auto)

    def boundaries(self) -> list[float]:
        """Every epoch-boundary time, sorted (injection edges only —
        autoscale ticks are self-scheduling)."""
        ts: list[float] = []
        for i in self.injections:
            bisect.insort(ts, i.t0)
            bisect.insort(ts, i.t1)
        return ts

    def outage_span(self) -> tuple[float, float]:
        """(earliest t0, latest t1) over injections; (0, 0) when none."""
        if not self.injections:
            return 0.0, 0.0
        return (min(i.t0 for i in self.injections),
                max(i.t1 for i in self.injections))


def coerce_chaos(value) -> Optional[ChaosSchedule]:
    """Coerce ``SimParams.chaos`` input (None / dict / schedule)."""
    if value is None or isinstance(value, ChaosSchedule):
        return value
    if isinstance(value, dict):
        return ChaosSchedule.from_dict(value)
    raise TypeError("SimParams.chaos must be a ChaosSchedule, a dict, "
                    f"or None (got {type(value).__name__})")


# ---------------------------------------------------------------------------
# Recovery metrics (engine-independent, computed from RunResult arrays)
# ---------------------------------------------------------------------------


def recovery_time(consume_times: np.ndarray, t_fail: float,
                  t_restore: float) -> float:
    """Seconds after ``t_restore`` until consumption has *caught up* with
    the pre-failure rate.

    The pre-failure consumption rate ``r0`` is estimated from completions
    in ``[0, t_fail)``; recovery is the first completion time ``t`` at or
    after ``t_restore`` whose cumulative completion count reaches
    ``r0 * t`` — i.e. the backlog accumulated during the outage has been
    worked off and the run is back on its nominal trajectory.  Returns
    ``inf`` when the run never catches up before its last completion,
    and 0.0 when there is nothing to recover from."""
    ts = np.sort(np.asarray(consume_times, dtype=float))
    ts = ts[np.isfinite(ts)]
    if ts.size == 0 or t_fail <= 0.0:
        return 0.0
    n_before = int(np.searchsorted(ts, t_fail, side="left"))
    if n_before == 0:
        return 0.0
    r0 = n_before / t_fail
    k0 = int(np.searchsorted(ts, t_restore, side="left"))
    counts = np.arange(1, ts.size + 1, dtype=float)
    caught = np.flatnonzero(counts[k0:] >= r0 * ts[k0:])
    if caught.size == 0:
        return float("inf")
    return max(0.0, float(ts[k0 + caught[0]] - t_restore))


@dataclass(frozen=True)
class ChaosMetrics:
    """Per-run chaos scoreboard, derived from one RunResult."""

    recovery_s: float
    duplicates: int
    lost: int
    redelivered: int
    storm_rejects: int

    def as_row(self) -> dict:
        return {"recovery_s": self.recovery_s, "duplicates": self.duplicates,
                "lost": self.lost, "redelivered": self.redelivered,
                "storm_rejects": self.storm_rejects}


def chaos_metrics(result, schedule: ChaosSchedule,
                  baseline_rejected: int = 0) -> ChaosMetrics:
    """Score one chaos run.

    ``duplicates`` — consumed completions beyond the unique message count
    (at-least-once redelivery consumed twice); ``lost`` — messages that
    never completed at all (structurally zero in the cohort engine —
    asserted by the tests, reported so regressions surface); ``storm_rejects``
    — publish rejections beyond the failure-free baseline's, i.e. the
    re-publish storm the outage induced."""
    total = result.spec.total_messages
    consumed = result.n_consumed
    dup = max(0, consumed - total)
    lost = max(0, total - (consumed - dup))
    t0, t1 = schedule.outage_span()
    rec = recovery_time(np.asarray(result.consume_times), t0, t1)
    return ChaosMetrics(
        recovery_s=rec, duplicates=dup, lost=lost,
        redelivered=result.redelivered,
        storm_rejects=max(0, result.rejected_publishes - baseline_rejected))
