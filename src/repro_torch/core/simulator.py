"""Experiment types of StreamSim (paper §5.2): the parameters, the
experiment spec, the per-run result, and the deployment feasibility
gate every engine applies.

A framework-free copy of the types of the reference package's
``simulator`` module.  :class:`SimParams` keeps the fields the wave
program and the per-cohort engine read, the chaos schedule and the
engine selector among them, with the reference's names, defaults and
validation.  ``repro_torch.core.run`` routes each cell by its engine
name as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.architectures import Architecture
from repro_torch.core.chaos import ChaosSchedule, coerce_chaos
from repro_torch.core.workloads import Workload

#: the reference's engine names.  ``"vectorized"`` and ``"jax"`` run on
#: the port's per-cohort engine, and ``"jax"`` with ``jax_device_loop``
#: on its wave program; the heap engine is not ported yet
ENGINE_NAMES = ("heap", "jax", "vectorized")


def check_engine(name: str) -> None:
    """Validate an engine name as the reference's ``get_engine`` does."""
    if name not in ENGINE_NAMES:
        raise ValueError(
            f"unknown engine {name!r}; options: {sorted(ENGINE_NAMES)}")


@dataclasses.dataclass
class SimParams:
    confirm_window: int = 128       # unconfirmed publishes per producer
    window_bytes: int = 48 * 1024 * 1024   # in-flight byte cap per producer
    prefetch: int = 64              # basic.qos per consumer
    ack_batch: int = 8              # ack-multiple every N deliveries
    n_work_queues: int = 2          # paper: two shared work queues
    reply_factor: float = 1.0       # reply size = factor * request size
    publish_retry_s: float = 10e-3  # backoff after reject-publish
    jitter: float = 0.03            # +/- service-time jitter (CDF spread)
    seed: int = 0
    #: the cohort engine's safety caps: it stops serving past this many
    #: message-hops or this simulated time
    max_events: int = 30_000_000
    max_sim_time: float = 36_000.0
    consumer_proc_s: Optional[float] = None   # override per-workload default
    #: per-data-queue byte cap (None = the broker's RAM-budget default).
    #: Small caps push the run into the reject-publish overflow regime,
    #: which the cohort engine takes (the wave program's gate refuses it).
    queue_max_bytes: Optional[int] = None
    engine: str = "vectorized"  # "vectorized" (default) | "heap" | "jax"
    #: per-producer messages per publish round; must be a sub-multiple of
    #: the confirm window.  None auto-tunes (8, shrunk to 2 when a shared
    #: DSN-side pipe is saturated and few flows are in play).  The wave
    #: program bounds its generation size by this round.
    vec_round: Optional[int] = None
    #: cohort engine: how far (seconds) past the next event's key a
    #: cohort may be served in one batch; 0 enforces strict global time
    #: ordering at every shared resource.  None auto-scales with the
    #: client count and shrinks alongside ``vec_round`` under detected
    #: saturation.
    vec_horizon_s: Optional[float] = None
    #: jax engine: *request* the whole-run wave program (one step per
    #: message generation instead of the per-cohort event loop; see
    #: :mod:`repro_torch.core.torch_device_loop`).  True uses it when the
    #: cell is wave-formulated (work_sharing/feedback, no flow-control
    #: events reachable) and silently keeps the per-cohort engine
    #: otherwise; None/False (default) never uses it.  Wave results match
    #: the cohort engine within the ``device_loop.*`` parity bands (on the
    #: cells the reference validates them on) rather than bit-for-bit.
    jax_device_loop: Optional[bool] = None
    #: chaos schedule: topology-epoch failure injection (link, broker and
    #: consumer outages) and backlog-reactive consumer autoscaling; see
    #: :mod:`repro_torch.core.chaos`.  Dicts (JSON campaign specs) are
    #: coerced to a :class:`~repro_torch.core.chaos.ChaosSchedule`.  Chaos
    #: cells run solo on the cohort engine (the wave gate refuses them).
    chaos: Optional[ChaosSchedule] = None

    def __post_init__(self) -> None:
        # resolve the engine name early so a typo fails at construction,
        # not deep inside a sweep
        check_engine(self.engine)
        self.chaos = coerce_chaos(self.chaos)
        if self.confirm_window < 2:
            raise ValueError(
                f"confirm_window must be >= 2, got {self.confirm_window}")
        for name in ("prefetch", "ack_batch", "n_work_queues"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"{name} must be >= 1, got {getattr(self, name)}")
        if self.queue_max_bytes is not None and self.queue_max_bytes <= 0:
            raise ValueError(
                f"queue_max_bytes must be positive, got {self.queue_max_bytes}")
        if self.vec_round is not None:
            if self.vec_round < 1:
                raise ValueError(
                    f"vec_round must be >= 1 (got {self.vec_round}); use "
                    f"None for auto-tuning")
            if self.vec_round > self.confirm_window:
                raise ValueError(
                    f"vec_round={self.vec_round} exceeds the confirm window "
                    f"({self.confirm_window}): publish rounds could never "
                    f"be gated by confirms")
            if self.confirm_window % self.vec_round != 0:
                raise ValueError(
                    f"vec_round={self.vec_round} must be a sub-multiple of "
                    f"confirm_window={self.confirm_window} so every round "
                    f"is gated by whole earlier rounds")
        if self.vec_horizon_s is not None and self.vec_horizon_s < 0:
            raise ValueError(
                f"vec_horizon_s must be >= 0, got {self.vec_horizon_s}")


@dataclasses.dataclass
class ExperimentSpec:
    pattern: str            # work_sharing | feedback | broadcast(_gather)
    workload: Workload
    arch: str                       # architecture name for make_architecture
    n_producers: int
    n_consumers: int
    total_messages: int
    params: SimParams = dataclasses.field(default_factory=SimParams)
    #: multi-tenant mode: partition the producers/consumers into this
    #: many independent workflows sharing one broker deployment.  Tenant
    #: of producer/consumer ``k`` is ``k // (count // tenants)``.
    tenants: int = 1
    #: ``"shared"`` — all tenants publish into the same work queues;
    #: ``"vhost"`` — per-tenant queues in per-tenant vhosts.
    tenant_isolation: str = "shared"

    def __post_init__(self) -> None:
        if self.tenants < 1:
            raise ValueError(f"tenants must be >= 1, got {self.tenants}")
        if self.tenant_isolation not in ("shared", "vhost"):
            raise ValueError(
                f"tenant_isolation must be 'shared' or 'vhost', got "
                f"{self.tenant_isolation!r}")
        if self.tenants > 1:
            if self.pattern not in ("work_sharing", "feedback"):
                raise ValueError(
                    "multi-tenant mode supports the work_sharing/feedback "
                    f"patterns, not {self.pattern!r}")
            if (self.n_producers % self.tenants
                    or self.n_consumers % self.tenants):
                raise ValueError(
                    f"tenants={self.tenants} must evenly divide producers "
                    f"({self.n_producers}) and consumers "
                    f"({self.n_consumers})")


@dataclasses.dataclass
class RunResult:
    spec: ExperimentSpec
    feasible: bool
    infeasible_reason: str = ""
    consume_times: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    rtts: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    publish_starts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    rejected_publishes: int = 0
    blocked_confirms: int = 0
    redelivered: int = 0
    sim_time: float = 0.0
    n_events: int = 0
    #: producer index of each ``consume_times`` / ``rtts`` entry (same
    #: order), for per-producer / per-tenant attribution
    consume_producers: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    rtt_producers: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))

    @property
    def n_consumed(self) -> int:
        return int(self.consume_times.size)

    def tenant_of_producer(self, producer_idx: np.ndarray) -> np.ndarray:
        """Map producer indices to tenant indices (contiguous blocks)."""
        per = max(1, self.spec.n_producers // max(1, self.spec.tenants))
        return np.asarray(producer_idx, dtype=np.int64) // per


class InfeasibleConfiguration(RuntimeError):
    pass


def check_feasibility(arch: Architecture, spec: ExperimentSpec) -> None:
    """Deployment gates (e.g. Stunnel's hard 16-connection cap, the
    paper's missing PRS data points)."""
    limit = arch.producer_conn_limit()
    if limit is not None and spec.n_producers > limit:
        raise InfeasibleConfiguration(
            f"{arch.name}: {spec.n_producers} producer "
            f"connections exceed tunnel connection limit {limit}")
    qcap = spec.params.queue_max_bytes
    if qcap is not None:
        need = spec.workload.payload_bytes
        if spec.pattern in ("feedback", "broadcast_gather"):
            need = max(need, max(1, int(need * spec.params.reply_factor)))
        if qcap < need:
            raise InfeasibleConfiguration(
                f"queue_max_bytes={qcap} cannot hold a single "
                f"{need}-byte message; every publish would be rejected")
