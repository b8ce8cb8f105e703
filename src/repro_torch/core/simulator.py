"""Discrete-event streaming simulator (paper §5.2 — "StreamSim"): the
parameters, the experiment spec, the per-run result, the deployment
feasibility gate every engine applies, and the heap engine.

The heap engine, :class:`StreamSim`, steps every message hop by hop
through its architecture's path elements; each shared resource (client
NIC, DSN NIC, broker CPU pool, overlay tunnel, ingress pipe/worker) is a
FIFO server or server pool whose busy intervals are tracked analytically
— one heap event per hop — against the RabbitMQ broker model of
:mod:`repro_torch.core.broker`: publisher-confirm windows, consumer
prefetch (basic.qos), batch acknowledgements, credit-flow confirm
withholding, reject-publish overflow with producer re-publish, and the
chaos schedules' outages.  It is the model the parity bands of
:mod:`repro_torch.core.parity` are defined against.

The heap engine runs on the host, as its counterpart in the reference
package does: it processes one event per message-hop and puts no tensor
in its event loop (a device tensor per event would cost a launch per
hop), and it draws its jitter from ``np.random.default_rng(seed)`` in
the reference's order, so its results equal the reference's bit for
bit.  The card runs the other engines: ``"vectorized"`` and ``"jax"``
cells go to the per-cohort engine
(:class:`repro_torch.core.torch_engine.TorchStreamSim`), and ``"jax"``
cells with ``jax_device_loop`` to the wave program where its gate
accepts them; :mod:`repro_torch.core.run` routes each cell by
``SimParams.engine`` (alias :data:`SimConfig`) as the reference does.

A framework-free copy of the reference package's ``simulator`` module,
with its names, defaults, validation and error messages.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Optional, Protocol

import numpy as np

from repro_torch.core.architectures import (
    Architecture, PathElement, ResourceSpec, make_architecture)
from repro_torch.core.broker import BrokerCluster, Delivery, Message
from repro_torch.core.chaos import ChaosSchedule, coerce_chaos
from repro_torch.core.ds2hpc import ClusterInventory
from repro_torch.core.workloads import Workload

#: the reference's engine names.  ``"heap"`` runs on :class:`StreamSim`
#: (the host); ``"vectorized"`` and ``"jax"`` run on the port's
#: per-cohort engine, and ``"jax"`` with ``jax_device_loop`` on its wave
#: program
ENGINE_NAMES = ("heap", "jax", "vectorized")

#: registered engine names -> constructor: the heap engine at the bottom
#: of this module, the per-cohort engine by :func:`get_engine` on first use
ENGINES: dict[str, type["Engine"]] = {}


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


#: the user-facing name for selecting an engine: SimConfig(engine=...)
SimConfig = SimParams


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


class Engine(Protocol):
    """What an engine must provide: construct from (spec, inventory, arch)
    — raising :class:`InfeasibleConfiguration` for configs the deployment
    cannot host — then produce a :class:`RunResult` from :meth:`run`."""

    def __init__(self, spec: ExperimentSpec,
                 inventory: Optional[ClusterInventory] = None,
                 arch: Optional[Architecture] = None) -> None: ...

    def run(self) -> RunResult: ...


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


# ---------------------------------------------------------------------------
# Virtual-time resources
# ---------------------------------------------------------------------------


class _Resource:
    __slots__ = ("spec", "_free_pipe", "_free_pool")

    def __init__(self, spec: ResourceSpec) -> None:
        self.spec = spec
        self._free_pipe = 0.0
        self._free_pool: list[float] = [0.0] * max(1, spec.servers)
        heapq.heapify(self._free_pool)

    def hold_time(self, nbytes: float) -> float:
        s = self.spec
        if s.kind == "pipe":
            return s.service_s + (nbytes / s.rate_Bps if s.rate_Bps else 0.0)
        return s.service_s + nbytes * s.per_byte_s

    def acquire(self, t: float, nbytes: float, jitter: float) -> float:
        hold = self.hold_time(nbytes) * (1.0 + jitter)
        if self.spec.kind == "pipe":
            start = t if t > self._free_pipe else self._free_pipe
            end = start + hold
            self._free_pipe = end
            return end
        free = heapq.heappop(self._free_pool)
        start = t if t > free else free
        end = start + hold
        heapq.heappush(self._free_pool, end)
        return end


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class StreamSim:
    """One experiment run. Deterministic given (spec, inventory, cal)."""

    def __init__(self, spec: ExperimentSpec,
                 inventory: Optional[ClusterInventory] = None,
                 arch: Optional[Architecture] = None) -> None:
        self.spec = spec
        self.p = spec.params
        self.inv = inventory or ClusterInventory()
        self.arch = arch or make_architecture(spec.arch, self.inv)
        self.arch.configure(spec.n_producers, spec.n_consumers,
                            tenants=spec.tenants)
        # tenant of producer/consumer k is k // per-tenant-count
        # (contiguous blocks); tenant-aware architectures route each
        # client through its own tenant's resources (e.g. DTS tunnels)
        self._ppt = max(1, spec.n_producers // spec.tenants)
        self._cpt = max(1, spec.n_consumers // spec.tenants)
        self.rng = np.random.default_rng(self.p.seed)
        self.now = 0.0
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._eseq = itertools.count()
        self.n_events = 0
        self.resources = {k: _Resource(s)
                          for k, s in self.arch.resources.items()}
        self.broker = BrokerCluster(n_nodes=self.inv.n_dsn,
                                    default_prefetch=self.p.prefetch)
        # metrics
        self.consume_times: list[float] = []
        self.rtts: list[float] = []
        self.publish_starts: list[float] = []
        self.consume_producers: list[int] = []
        self.rtt_producers: list[int] = []
        self._reply_q: dict[int, str] = {}
        self.rejected = 0
        self.blocked = 0
        # flow state
        self._blocked_confirms: dict[str, list[Callable[[], None]]] = {}
        self._done = False
        self._replies_expected = 0
        self._replies_received = 0
        self._consumed = 0
        self._expected_consumed = 0
        self._proc_s = (self.p.consumer_proc_s
                        if self.p.consumer_proc_s is not None
                        else spec.workload.proc_time_s())
        # chaos (topology-epoch failure injection): duplicates are
        # consumed completions of redelivered messages; the unique-id set
        # keeps the termination condition exact under at-least-once
        # redelivery.  None (the fast path) outside chaos runs.
        self._duplicates = 0
        self._seen_msg_ids: Optional[set] = None
        self._check_feasibility()
        self._setup_pattern()
        if self.p.chaos is not None:
            self._setup_chaos(self.p.chaos)

    # -- scheduling -------------------------------------------------------------
    def _at(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (t, next(self._eseq), fn))

    def _after(self, dt: float, fn: Callable[[], None]) -> None:
        self._at(self.now + dt, fn)

    def _jit(self) -> float:
        j = self.p.jitter
        return float(self.rng.uniform(-j, j)) if j else 0.0

    # -- transit: step a message through path elements ----------------------------
    def _transit(self, t0: float, elements: list[PathElement], size: int,
                 done: Callable[[float], None]) -> None:
        def step(i: int, t: float) -> None:
            while i < len(elements) and elements[i].resource is None:
                t += elements[i].latency_s
                i += 1
            if i >= len(elements):
                done(t)
                return
            el = elements[i]
            res = self.resources[el.resource]
            nbytes = size * el.byte_factor + el.extra_bytes
            t_end = res.acquire(t, nbytes, self._jit()) + el.latency_s
            self._at(t_end, lambda: step(i + 1, t_end))
        self._at(t0, lambda: step(0, t0))

    # -- feasibility (e.g. Stunnel's 16-connection cap) ----------------------------
    def _check_feasibility(self) -> None:
        check_feasibility(self.arch, self.spec)

    # -- topology per pattern --------------------------------------------------------
    def _setup_pattern(self) -> None:
        spec, p = self.spec, self.p
        nP, nC = spec.n_producers, spec.n_consumers
        per_producer = spec.total_messages // nP
        self._expected_consumed = per_producer * nP
        pat = spec.pattern
        qcap = p.queue_max_bytes          # None = broker RAM-budget default
        if pat in ("work_sharing", "feedback"):
            T = spec.tenants
            vhosted = T > 1 and spec.tenant_isolation == "vhost"
            if vhosted:
                # per-tenant vhost queues: tenant t's producers publish
                # only into t's queues, consumed only by t's consumers
                ppt, cpt = nP // T, nC // T
                nq_t = min(p.n_work_queues, cpt)
                self._work_queues = []
                for t in range(T):
                    for i in range(nq_t):
                        q = self.broker.declare_queue(
                            f"work:{i}", vhost=f"t{t}", max_bytes=qcap)
                        self._work_queues.append(q.name)
                for c in range(nC):
                    t, cl = c // cpt, c % cpt
                    qn = self._work_queues[t * nq_t + cl % nq_t]
                    self.broker.register_consumer(
                        f"c{c}", qn, prefetch=p.prefetch,
                        connected_node=(c + 1) % self.inv.n_dsn)
            else:
                nq = min(p.n_work_queues, nC)
                self._work_queues = [f"work:{i}" for i in range(nq)]
                for q in self._work_queues:
                    self.broker.declare_queue(q, max_bytes=qcap)
                for c in range(nC):
                    q = self._work_queues[c % nq]
                    self.broker.register_consumer(
                        f"c{c}", q, prefetch=p.prefetch,
                        connected_node=(c + 1) % self.inv.n_dsn)
            if pat == "feedback":
                self._replies_expected = self._expected_consumed
                for pr in range(nP):
                    vh = f"t{pr // (nP // T)}" if vhosted else None
                    rq = self.broker.declare_queue(
                        f"reply:{pr}", vhost=vh, control=False,
                        max_bytes=qcap)
                    self._reply_q[pr] = rq.name
                    self.broker.register_consumer(
                        f"p{pr}", rq.name, prefetch=p.prefetch,
                        connected_node=pr % self.inv.n_dsn)
            for pr in range(nP):
                if vhosted:
                    t = pr // ppt
                    qs = self._work_queues[t * nq_t:(t + 1) * nq_t]
                else:
                    qs = self._work_queues
                self._start_producer(pr, per_producer,
                                     queue_of=self._ws_queue_of(pr, qs))
        elif pat in ("broadcast", "broadcast_gather"):
            assert nP == 1, "broadcast patterns use a single producer"
            self._expected_consumed = per_producer * nC
            qs = []
            for c in range(nC):
                qn = f"bq:{c}"
                self.broker.declare_queue(qn, max_bytes=qcap)
                self.broker.register_consumer(
                    f"c{c}", qn, prefetch=p.prefetch,
                    connected_node=(c + 1) % self.inv.n_dsn)
                qs.append(qn)
            self.broker.declare_fanout("bcast", qs)
            if pat == "broadcast_gather":
                self._replies_expected = per_producer * nC
                self.broker.declare_queue("gather", max_bytes=qcap)
                self.broker.register_consumer("p0", "gather",
                                              prefetch=p.prefetch,
                                              connected_node=0)
            self._start_producer(0, per_producer,
                                 queue_of=lambda i: "fanout:bcast")
        else:
            raise ValueError(f"unknown pattern {pat!r}")

    def _ws_queue_of(self, pr: int, qs: list) -> Callable[[int], str]:
        return lambda i: qs[(pr + i) % len(qs)]

    # -- chaos: topology-epoch failure injection ---------------------------------
    def _setup_chaos(self, sched: ChaosSchedule) -> None:
        """Schedule every epoch boundary as an ordinary heap event; the
        run is then a sequence of piecewise-static topologies with full
        broker/resource state carried across each boundary."""
        spec, p = self.spec, self.p
        if spec.pattern != "work_sharing":
            raise ValueError(
                "chaos schedules support pattern='work_sharing' only, "
                f"got {spec.pattern!r}")
        self._seen_msg_ids = set()
        for inj in sched.injections:
            if inj.kind == "link":
                keys = [k for k in self.resources
                        if k == inj.target or k.startswith(inj.target + ":")]
                if not keys:
                    raise ValueError(
                        f"link injection target {inj.target!r} matches no "
                        f"resource of architecture {self.arch.name!r}")
                self._at(inj.t0, lambda ks=keys, t1=inj.t1:
                         self._chaos_link_down(ks, t1))
            elif inj.kind == "broker":
                names = self._chaos_queue_names(inj.target)
                self._at(inj.t0, lambda ns=names, t1=inj.t1:
                         self._chaos_broker_down(ns, t1))
            else:  # consumer
                if spec.tenants > 1:
                    raise ValueError(
                        "consumer injections require tenants=1")
                tgt = inj.target
                if not (tgt.startswith("c") and tgt[1:].isdigit()
                        and int(tgt[1:]) < spec.n_consumers):
                    raise ValueError(
                        f"consumer injection target {tgt!r} must name a "
                        f"configured consumer (c0..c{spec.n_consumers - 1})")
                self._at(inj.t0, lambda c=int(tgt[1:]), t1=inj.t1:
                         self._chaos_consumer_down(c, t1))
        pol = sched.autoscale
        if pol is not None:
            if spec.tenants > 1:
                raise ValueError("autoscale policies require tenants=1")
            self._as_extra: list[str] = []
            self._as_next = spec.n_consumers
            self._at(pol.interval_s, self._autoscale_tick)

    def _chaos_queue_names(self, target: str) -> list[str]:
        """Resolve a broker-injection target to broker queue names."""
        kind, _, val = target.partition(":")
        if kind == "queue":
            if val not in self.broker.queues:
                raise ValueError(
                    f"broker injection target queue {val!r} does not exist")
            return [val]
        if kind == "node":
            node = int(val)
            if not 0 <= node < self.inv.n_dsn:
                raise ValueError(
                    f"broker injection target {target!r} names no DSN "
                    f"node (cluster has {self.inv.n_dsn})")
            # a node that homes no work queue is a valid no-op fault —
            # the redundancy the availability sweep measures
            return self.broker.node_failure(node)
        if kind == "vhost":
            names = self.broker.vhost_queues(val)
        else:
            raise ValueError(
                f"broker injection target {target!r} must be "
                f"'queue:<name>', 'node:<k>' or 'vhost:<v>'")
        if not names:
            raise ValueError(
                f"broker injection target {target!r} matches no queue")
        return list(names)

    def _chaos_link_down(self, keys: list[str], t1: float) -> None:
        # the matched resources accept no new service until t1: holds
        # already started complete, everything else waits (messages are
        # delayed, never dropped)
        for k in keys:
            res = self.resources[k]
            if res._free_pipe < t1:
                res._free_pipe = t1
            res._free_pool = [max(f, t1) for f in res._free_pool]
            heapq.heapify(res._free_pool)

    def _chaos_broker_down(self, names: list[str], t1: float) -> None:
        for qn in names:
            self.broker.queues[qn].paused = True
            # every delivery unacked at the broker re-enters the FIFO
            # front (at-least-once redelivery) — the in-flight originals
            # still land and consume, so they are counted as duplicates
            self.broker.interrupt_queue(qn)
        self._at(t1, lambda ns=tuple(names): self._chaos_broker_up(ns))

    def _chaos_broker_up(self, names: tuple) -> None:
        for qn in names:
            self.broker.queues[qn].paused = False
        for qn in names:
            self._pump(qn, self.now)

    def _chaos_consumer_down(self, cidx: int, t1: float) -> None:
        cid = f"c{cidx}"
        qn = self._work_queues[cidx % len(self._work_queues)]
        if self.broker.channels.get(cid) is not None:
            self.broker.consumer_crash(cid)
            st = self._consumer_state(cid)
            st["since_ack"] = 0
            st["last_tag"] = 0
            self._pump(qn, self.now)
        self._at(t1, lambda: self._chaos_consumer_up(cidx))

    def _chaos_consumer_up(self, cidx: int) -> None:
        cid = f"c{cidx}"
        qn = self._work_queues[cidx % len(self._work_queues)]
        st = self._consumer_state(cid)
        st["since_ack"] = 0
        st["last_tag"] = 0
        self.broker.register_consumer(
            cid, qn, prefetch=self.p.prefetch,
            connected_node=(cidx + 1) % self.inv.n_dsn)
        self._pump(qn, self.now)

    def _autoscale_tick(self) -> None:
        if self._done:
            return
        pol = self.p.chaos.autoscale
        backlog = sum(len(self.broker.queues[qn].ready)
                      for qn in self._work_queues)
        nq = len(self._work_queues)
        cur = self.spec.n_consumers + len(self._as_extra)
        if backlog > pol.high_backlog and cur < pol.max_consumers:
            for _ in range(min(pol.step, pol.max_consumers - cur)):
                c = self._as_next
                self._as_next += 1
                cid = f"c{c}"
                self._as_extra.append(cid)
                qn = self._work_queues[c % nq]
                self.broker.register_consumer(
                    cid, qn, prefetch=self.p.prefetch,
                    connected_node=(c + 1) % self.inv.n_dsn)
                self._pump(qn, self.now)
        elif backlog < pol.low_backlog and self._as_extra:
            for _ in range(min(pol.step, len(self._as_extra))):
                cid = self._as_extra.pop()
                # graceful scale-in: leave the rotation, keep the channel
                # so in-flight deliveries ack and drain normally
                qn = self._work_queues[int(cid[1:]) % nq]
                self.broker.queues[qn].remove_consumer(cid)
        self._after(pol.interval_s, self._autoscale_tick)

    # -- producers ---------------------------------------------------------------
    def _start_producer(self, pr: int, n_msgs: int,
                        queue_of: Callable[[int], str]) -> None:
        spec, p = self.spec, self.p
        pnode = self.inv.producer_node_of(pr)
        bnode = pr % self.inv.n_dsn
        tnt = pr // self._ppt
        state = {"sent": 0, "inflight": 0}
        size = spec.workload.payload_bytes
        flush = self.arch.client_flush_s()
        # effective publisher window: message-count cap AND byte cap
        window = max(2, min(p.confirm_window, p.window_bytes // size))

        def maybe_send() -> None:
            while (state["sent"] < n_msgs
                   and state["inflight"] < window):
                i = state["sent"]
                state["sent"] += 1
                state["inflight"] += 1
                rk = queue_of(i)
                msg = Message(routing_key=rk, size=size,
                              producer_id=f"p{pr}",
                              reply_to=(self._reply_q.get(pr, f"reply:{pr}")
                                        if spec.pattern == "feedback" else
                                        ("gather" if spec.pattern ==
                                         "broadcast_gather" else None)))
                t_start = self.now + flush
                msg.publish_time = t_start
                self.publish_starts.append(t_start)
                home = self._home_of(rk)
                path = self.arch.publish_path(pnode, bnode, home,
                                              tenant=tnt)
                self._transit(t_start, path, size,
                              lambda t, m=msg: arrive(t, m))

        def arrive(t: float, msg: Message) -> None:
            ok, queued = self.broker.publish(msg)
            if not ok:
                self.rejected += 1
                self._at(t + p.publish_retry_s,
                         lambda: retry(msg))
                return
            for qn in queued:
                self._pump(qn, t)
            # credit-based flow control (RabbitMQ): if any target queue's
            # backlog exceeds its credit, the channel is blocked — withhold
            # the publisher confirm until the queue drains.
            blocked_on = next(
                (qn for qn in queued if self.broker.queues[qn].flow_blocked),
                None)
            if blocked_on is not None:
                self.blocked += 1
                self._blocked_confirms.setdefault(blocked_on, []).append(confirm)
            else:
                self._at(t + self.arch.control_latency_s(), confirm)

        def retry(msg: Message) -> None:
            home = self._home_of(msg.routing_key)
            path = self.arch.publish_path(pnode, bnode, home, tenant=tnt)
            self._transit(self.now, path, size,
                          lambda t, m=msg: arrive(t, m))

        def confirm() -> None:
            state["inflight"] -= 1
            maybe_send()

        self._at(0.0, maybe_send)

    def _home_of(self, routing_key: str) -> int:
        if routing_key.startswith("fanout:"):
            return 0
        return self.broker.queues[routing_key].home_node

    # -- delivery pump --------------------------------------------------------------
    def _pump(self, queue_name: str, t: float) -> None:
        while True:
            d = self.broker.next_delivery(queue_name)
            if d is None:
                break
            self._dispatch_delivery(d, t)
        # release flow-blocked publishers once the queue has drained
        blocked = self._blocked_confirms.get(queue_name)
        if blocked and self.broker.queues[queue_name].flow_resume:
            self._blocked_confirms[queue_name] = []
            dt = self.arch.control_latency_s()
            for confirm in blocked:
                self._after(dt, confirm)

    def _dispatch_delivery(self, d: Delivery, t: float) -> None:
        cid = d.consumer_id
        if cid.startswith("p"):          # producer consuming replies
            self._deliver_to_producer(d, t)
        else:
            self._deliver_to_consumer(d, t)

    # -- consumers --------------------------------------------------------------------
    def _consumer_state(self, cid: str) -> dict:
        if not hasattr(self, "_cstates"):
            self._cstates: dict[str, dict] = {}
        st = self._cstates.get(cid)
        if st is None:
            st = {"free_at": 0.0, "since_ack": 0, "last_tag": 0}
            self._cstates[cid] = st
        return st

    def _deliver_to_consumer(self, d: Delivery, t: float) -> None:
        cidx = int(d.consumer_id[1:])
        cnode = self.inv.consumer_node_of(cidx)
        home = self.broker.queues[d.queue].home_node
        bnode = (cidx + 1) % self.inv.n_dsn   # node this consumer connects to
        # autoscaled consumers (indices past the configured fleet) belong
        # to the last tenant block; chaos autoscale requires tenants=1
        tenant = min(cidx // self._cpt, self.spec.tenants - 1)
        path = self.arch.delivery_path(bnode, home, cnode, tenant=tenant)
        size = d.message.size

        def landed(t_arr: float) -> None:
            st = self._consumer_state(d.consumer_id)
            start = max(t_arr + self.arch.recv_latency_s(size), st["free_at"])
            t_done = start + self._proc_s * (1.0 + self._jit())
            st["free_at"] = t_done
            self._at(t_done, lambda: consumed(t_done))

        def consumed(t_done: float) -> None:
            self.consume_times.append(t_done)
            pid = d.message.producer_id
            self.consume_producers.append(
                int(pid[1:]) if pid and pid[1:].isdigit() else 0)
            if self._seen_msg_ids is None:
                self._consumed += 1
            else:
                # chaos runs redeliver: only the first completion of a
                # message id advances the termination count
                mid = d.message.msg_id
                if mid in self._seen_msg_ids:
                    self._duplicates += 1
                else:
                    self._seen_msg_ids.add(mid)
                    self._consumed += 1
            self._ack(d, t_done)
            if d.message.reply_to is not None:
                self._send_reply(d, cidx, cnode, t_done)
            self._check_done()

        self._transit(t, path, size, landed)

    def _ack(self, d: Delivery, t: float) -> None:
        """Batch acks: flush every ack_batch deliveries (ack-multiple)."""
        st = self._consumer_state(d.consumer_id)
        st["since_ack"] += 1
        st["last_tag"] = max(st["last_tag"], d.delivery_tag)
        ch = self.broker.channels.get(d.consumer_id)
        if ch is None:
            # the channel was dropped by a chaos event after this delivery
            # landed: nothing to ack (the broker already requeued)
            return
        pending_all = len(ch.unacked)
        if st["since_ack"] >= self.spec.params.ack_batch or \
                pending_all >= self.spec.params.prefetch or \
                self._consumed >= self._expected_consumed:
            tag = st["last_tag"]
            st["since_ack"] = 0
            cid = d.consumer_id
            qn = d.queue

            def ack_arrives() -> None:
                # a chaos event may have dropped or replaced the channel
                # while this ack was in flight; a stale-incarnation ack is
                # RabbitMQ's "unknown delivery tag" no-op
                if self.broker.channels.get(cid) is not ch:
                    return
                self.broker.ack(cid, tag, multiple=True)
                self._pump(qn, self.now)
            self._at(t + self.arch.control_latency_s(), ack_arrives)

    def _send_reply(self, d: Delivery, cidx: int, cnode: int,
                    t: float) -> None:
        spec = self.spec
        size = int(spec.workload.payload_bytes * spec.params.reply_factor)
        reply = Message(routing_key=d.message.reply_to, size=size,
                        producer_id=f"c{cidx}",
                        correlation_id=d.message.msg_id,
                        headers={"req_publish": d.message.publish_time})
        bnode = (cidx + 1) % self.inv.n_dsn
        home = self._home_of(reply.routing_key)
        path = self.arch.reply_publish_path(cnode, bnode, home,
                                            tenant=cidx // self._cpt)

        def arrive(t_arr: float) -> None:
            ok, queued = self.broker.publish(reply)
            if not ok:
                self.rejected += 1
                self._at(t_arr + spec.params.publish_retry_s,
                         lambda: self._transit(
                             self.now, path, size, arrive))
                return
            for qn in queued:
                self._pump(qn, t_arr)

        self._transit(t, path, size, arrive)

    # -- producers consuming replies ----------------------------------------------------
    def _deliver_to_producer(self, d: Delivery, t: float) -> None:
        pidx = int(d.consumer_id[1:])
        pnode = self.inv.producer_node_of(pidx)
        home = self.broker.queues[d.queue].home_node
        bnode = pidx % self.inv.n_dsn
        path = self.arch.reply_delivery_path(home, bnode, pnode,
                                             tenant=pidx // self._ppt)
        size = d.message.size

        def landed(t_arr: float) -> None:
            t_seen = t_arr + self.arch.recv_latency_s(size)
            req_t = d.message.headers.get("req_publish")
            if req_t is not None:
                self.rtts.append(t_seen - req_t)
                self.rtt_producers.append(pidx)
            self._replies_received += 1
            self._ack(d, t_seen)
            self._check_done()

        self._transit(t, path, size, landed)

    # -- termination ----------------------------------------------------------------------
    def _check_done(self) -> None:
        if self._consumed >= self._expected_consumed and \
                self._replies_received >= self._replies_expected:
            self._done = True

    # -- main loop -------------------------------------------------------------------------
    def run(self) -> RunResult:
        p = self.p
        while self._heap and not self._done:
            t, _, fn = heapq.heappop(self._heap)
            self.now = t
            self.n_events += 1
            if self.n_events > p.max_events or t > p.max_sim_time:
                break
            fn()
        redeliv = sum(q.stats.redelivered for q in self.broker.queues.values())
        return RunResult(
            spec=self.spec, feasible=True,
            consume_times=np.asarray(self.consume_times),
            rtts=np.asarray(self.rtts),
            publish_starts=np.asarray(self.publish_starts),
            rejected_publishes=self.rejected,
            blocked_confirms=self.blocked,
            redelivered=redeliv,
            sim_time=self.now, n_events=self.n_events,
            consume_producers=np.asarray(self.consume_producers,
                                         dtype=np.int64),
            rtt_producers=np.asarray(self.rtt_producers, dtype=np.int64))


ENGINES["heap"] = StreamSim


def get_engine(name: str) -> type["Engine"]:
    """Resolve an engine name to its class: ``"heap"`` to
    :class:`StreamSim`, ``"vectorized"`` and ``"jax"`` to the per-cohort
    engine, :class:`~repro_torch.core.torch_engine.TorchStreamSim`
    (imported on first use)."""
    check_engine(name)
    if name not in ENGINES:
        from repro_torch.core.torch_engine import TorchStreamSim
        ENGINES["vectorized"] = ENGINES["jax"] = TorchStreamSim
    return ENGINES[name]
