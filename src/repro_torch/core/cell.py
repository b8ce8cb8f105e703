"""The host-side cell: one experiment, with its stacked seed-lanes, as
both of the port's StreamSim engines read it.

:class:`Cell` is the part of the reference's vectorized engine that the
wave program and the per-cohort engine share: the architecture
configured for the cell, tenant columns, the per-lane jitter streams,
the consumer processing time, the publish round with the saturation
rule (and the cohort engine's event horizon), the work-pattern queue
topology, the static flow-event probe, the bottleneck cost model, and
the per-lane result contract (with each lane's flow-control counters).
Values and rules are the reference's, so either engine sees the same
cell.  :class:`WaveCell` is the cell the
wave program builds from (``core/torch_device_loop.py``); the cohort
engine (``core/torch_engine.py``) subclasses :class:`Cell` directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.architectures import (
    Architecture, PathElement, make_architecture)
from repro_torch.core.ds2hpc import ClusterInventory
from repro_torch.core.simulator import ExperimentSpec, RunResult, check_feasibility

#: RabbitMQ credit_flow_default_credit: a publishing channel is blocked
#: when its un-drained backlog exceeds ~400 messages per publisher
FLOW_CREDIT = 400

#: the publish round shrinks to 2 (auto mode) when a shared DSN-side pipe
#: is estimated at >= this fraction of the run's bottleneck...
SATURATION_UTIL = 0.85
#: ...and no more than this many concurrent flows are in play
SATURATION_MAX_CLIENTS = 64

#: the patterns the wave program formulates
WAVE_PATTERNS = ("work_sharing", "feedback")
#: every pattern of the cohort engine
PATTERNS = WAVE_PATTERNS + ("broadcast", "broadcast_gather")


def _res_class(el: Optional[PathElement]) -> Optional[str]:
    if el is None or el.resource is None:
        return None
    return el.resource.split(":", 1)[0]


def _align_paths(paths: dict) -> tuple[dict, int]:
    """Pad each path's *middle* (between the longest common prefix and
    suffix of resource classes) with Nones so shared bottlenecks land on
    the same slot across path variants.  Returns ({key: padded}, n_slots).
    """
    sigs = {k: [_res_class(e) for e in p] for k, p in paths.items()}
    sig_list = list(sigs.values())
    min_len = min(len(s) for s in sig_list)
    lcp = 0
    while lcp < min_len and len({s[lcp] for s in sig_list}) == 1:
        lcp += 1
    lcs = 0
    while (lcs < min_len - lcp
           and len({s[len(s) - 1 - lcs] for s in sig_list}) == 1):
        lcs += 1
    max_mid = max(len(s) - lcp - lcs for s in sig_list)
    out = {}
    for k, p in paths.items():
        mid = list(p[lcp:len(p) - lcs])
        out[k] = (list(p[:lcp]) + mid + [None] * (max_mid - len(mid))
                  + list(p[len(p) - lcs:]))
    return out, lcp + max_mid + lcs


def _stack_key(spec: ExperimentSpec, i: int) -> tuple:
    """Cells that differ only in ``params.seed`` stack into one run; a
    chaos cell (``i``, its place in the batch) never stacks: its epoch
    state is the run's own."""
    if spec.params.chaos is not None:
        return ("solo", i)
    return (spec.pattern, spec.arch, spec.workload, spec.n_producers,
            spec.n_consumers, spec.total_messages, spec.tenants,
            spec.tenant_isolation,
            repr(sorted(dataclasses.replace(
                spec.params, seed=0).__dict__.items())))


class Cell:
    """One experiment with its stacked seed-lanes.

    ``stack_seeds[0]`` is the pilot lane and must equal ``params.seed``;
    each lane draws its jitter from its own ``np.random.default_rng``
    stream, so a lane's realization does not depend on the others."""

    def __init__(self, spec: ExperimentSpec,
                 inventory: Optional[ClusterInventory] = None,
                 arch: Optional[Architecture] = None,
                 stack_seeds: Optional[list[int]] = None) -> None:
        if spec.pattern not in PATTERNS:
            raise ValueError(f"unknown pattern {spec.pattern!r}")
        self.spec = spec
        self.p = spec.params
        self.inv = inventory or ClusterInventory()
        self.arch = arch or make_architecture(spec.arch, self.inv)
        self.arch.configure(spec.n_producers, spec.n_consumers,
                            tenants=spec.tenants)
        # tenant-aware hop graphs (DTS per-tenant tunnels): path
        # constructors take the client's tenant as a trailing argument
        self._tenant_cols = bool(self.arch.tenant_paths)
        self._ppt = max(1, spec.n_producers // spec.tenants)
        self._cpt = max(1, spec.n_consumers // spec.tenants)
        check_feasibility(self.arch, spec)
        self.stack_seeds = (list(stack_seeds) if stack_seeds is not None
                            else [self.p.seed])
        self._lanes = len(self.stack_seeds)
        if self._lanes < 1:
            raise ValueError("stack_seeds must name at least one seed")
        if self.stack_seeds[0] != self.p.seed:
            raise ValueError("stack_seeds[0] (the pilot lane) must equal "
                             "params.seed")
        self._rngs = [np.random.default_rng(s) for s in self.stack_seeds]
        self._res_specs = self.arch.resources
        self._proc_s = (self.p.consumer_proc_s
                        if self.p.consumer_proc_s is not None
                        else spec.workload.proc_time_s())
        self.n_events = 0
        # how far past the next event's key a cohort batch may serve
        # ahead (the cohort engine's horizon): auto mode widens it with
        # the client count
        if self.p.vec_horizon_s is not None:
            self._slack = self.p.vec_horizon_s
        else:
            self._slack = max(1e-3, 1e-3 * (spec.n_producers
                                            + spec.n_consumers) / 16.0)
        # the saturation rule: at low flow counts with a saturated shared
        # DSN-side pipe, interleave near per-message granularity (a
        # publish round of 2, a quarter of the horizon, and the pump's
        # per-message window-aware release)
        self._round = self.p.vec_round if self.p.vec_round is not None else 8
        self._fine_pump = False
        self.dsn_utilization, self.publish_surplus = self._cost_model()
        n_clients = spec.n_producers + spec.n_consumers
        if (n_clients <= SATURATION_MAX_CLIENTS
                and self.dsn_utilization >= SATURATION_UTIL):
            self._fine_pump = True
            if self.p.vec_round is None:
                self._round = 2
            if self.p.vec_horizon_s is None:
                self._slack *= 0.25

    def _work_topology(self) -> tuple[int, list[np.ndarray],
                                      list[list[int]], list[int]]:
        """Queue topology: ``(nq, q_consumers, prod_queues,
        q_publishers)``.  ``q_consumers[qi]`` — consumer indices on queue
        ``qi``; ``prod_queues[pr]`` — the queues producer ``pr``
        round-robins over; ``q_publishers[qi]`` — how many producers
        publish to ``qi``.  With ``tenants > 1`` and vhost isolation,
        tenant ``t`` owns queues ``[t*nq_t, (t+1)*nq_t)``."""
        spec, p = self.spec, self.p
        nP, nC = spec.n_producers, spec.n_consumers
        if spec.tenants > 1 and spec.tenant_isolation == "vhost":
            T = spec.tenants
            ppt, cpt = nP // T, nC // T
            nq_t = min(p.n_work_queues, cpt)
            nq = T * nq_t
            q_consumers = [
                t * cpt + np.flatnonzero(np.arange(cpt) % nq_t == qi)
                for t in range(T) for qi in range(nq_t)]
            prod_queues = [
                [(pr // ppt) * nq_t + qi for qi in range(nq_t)]
                for pr in range(nP)]
            q_publishers = [ppt] * nq
        else:
            nq = min(p.n_work_queues, nC)
            q_consumers = [np.flatnonzero(np.arange(nC) % nq == qi)
                           for qi in range(nq)]
            prod_queues = [list(range(nq))] * nP
            q_publishers = [nP] * nq
        return nq, q_consumers, prod_queues, q_publishers

    def flow_events_possible(self) -> bool:
        """Static reachability test for broker flow-control events
        (credit-flow confirm withholding / reject-publish overflow):
        True when producers can pile a queue's backlog past its credit
        threshold, or a byte cap sits below the per-queue volume."""
        spec, p = self.spec, self.p
        size = spec.workload.payload_bytes
        cap = (p.queue_max_bytes // size) if p.queue_max_bytes else None
        per_producer = spec.total_messages // max(1, spec.n_producers)
        if spec.pattern in WAVE_PATTERNS:
            nq, _, _, q_pubs = self._work_topology()
            per_q = per_producer * spec.n_producers / nq
            credit = FLOW_CREDIT * min(q_pubs)
        else:
            per_q = per_producer
            credit = FLOW_CREDIT
        return ((cap is not None and cap < per_q)
                or credit < self.publish_surplus * per_q)

    def _cost_model(self) -> tuple[float, float]:
        """Returns ``(dsn_utilization, publish_surplus)``.

        Accumulates, per resource, the busy seconds one consumed message
        induces.  ``dsn_utilization`` is the busiest shared DSN-side pipe
        as a fraction of the bottleneck; ``publish_surplus`` is
        ``1 - (publish-leg bottleneck / overall bottleneck)``."""
        spec, p, inv = self.spec, self.p, self.inv
        nP, nC = spec.n_producers, spec.n_consumers
        size = spec.workload.payload_bytes
        rsize = max(1, int(size * p.reply_factor))
        legs: list[tuple[str, tuple, float, int]] = []
        tcols = self._tenant_cols
        p_t = (lambda pr: ((pr // self._ppt,) if tcols else ()))
        c_t = (lambda c: ((c // self._cpt,) if tcols else ()))
        if spec.pattern in WAVE_PATTERNS:
            nq, q_consumers, prod_queues, _ = self._work_topology()
            q_home = [q % inv.n_dsn for q in range(nq)]
            reply_home = [(nq + pr) % inv.n_dsn for pr in range(nP)]
            for pr in range(nP):
                for qi in prod_queues[pr]:
                    legs.append(("publish_path",
                                 (pr % inv.n_producer_nodes, pr % inv.n_dsn,
                                  q_home[qi]) + p_t(pr),
                                 1.0 / (nP * len(prod_queues[pr])), size))
            for qi in range(nq):
                members = q_consumers[qi]
                for c in members:
                    legs.append(("delivery_path",
                                 ((int(c) + 1) % inv.n_dsn, q_home[qi],
                                  int(c) % inv.n_consumer_nodes)
                                 + c_t(int(c)),
                                 1.0 / (nq * len(members)), size))
            if spec.pattern == "feedback":
                # collapse the (consumer x producer) cross product over the
                # <= n_dsn distinct reply homes, tenant by tenant
                T = (spec.tenants if spec.tenant_isolation == "vhost" else 1)
                ppt, cpt = nP // T, nC // T
                for t in range(T):
                    home_w: dict[int, float] = {}
                    for pr in range(t * ppt, (t + 1) * ppt):
                        h = reply_home[pr]
                        home_w[h] = home_w.get(h, 0.0) + 1.0 / ppt
                    for c in range(t * cpt, (t + 1) * cpt):
                        for h, w in home_w.items():
                            legs.append(("reply_publish_path",
                                         (c % inv.n_consumer_nodes,
                                          (c + 1) % inv.n_dsn, h) + c_t(c),
                                         w / nC, rsize))
                for pr in range(nP):
                    legs.append(("reply_delivery_path",
                                 (reply_home[pr], pr % inv.n_dsn,
                                  pr % inv.n_producer_nodes) + p_t(pr),
                                 1.0 / nP, rsize))
        else:
            gather_home = nC % inv.n_dsn
            legs.append(("publish_path", (0, 0, 0), 1.0 / nC, size))
            for c in range(nC):
                legs.append(("delivery_path",
                             ((c + 1) % inv.n_dsn, c % inv.n_dsn,
                              c % inv.n_consumer_nodes), 1.0 / nC, size))
            if spec.pattern == "broadcast_gather":
                for c in range(nC):
                    legs.append(("reply_publish_path",
                                 (c % inv.n_consumer_nodes,
                                  (c + 1) % inv.n_dsn, gather_home),
                                 1.0 / nC, rsize))
                legs.append(("reply_delivery_path", (gather_home, 0, 0),
                             1.0, rsize))
        cost: dict[str, float] = {}
        pub_cost: dict[str, float] = {}
        for flow, combo, w, sz in legs:
            for el in getattr(self.arch, flow)(*combo):
                if el.resource is None:
                    continue
                rs = self._res_specs[el.resource]
                nb = sz * el.byte_factor + el.extra_bytes
                if rs.kind == "pipe":
                    sec = rs.service_s + (nb / rs.rate_Bps
                                          if rs.rate_Bps else 0.0)
                else:
                    sec = ((rs.service_s + nb * rs.per_byte_s)
                           / max(1, rs.servers))
                cost[el.resource] = cost.get(el.resource, 0.0) + w * sec
                if flow == "publish_path":
                    pub_cost[el.resource] = (pub_cost.get(el.resource, 0.0)
                                             + w * sec)
        c_max = max(max(cost.values(), default=0.0),
                    self._proc_s / max(1, nC))
        #: per-resource busy seconds per system message and the
        #: bottleneck, kept for external probes
        #: (``patterns._ingress_utilization`` reads the shared facility
        #: ingress off a built cell)
        self.resource_cost = dict(cost)
        self.bottleneck_cost = c_max
        if c_max <= 0.0:
            return 0.0, 0.0
        shared = [v for k, v in cost.items()
                  if k.startswith(("dsn_in", "dsn_out", "dsn_int", "tunnel",
                                   "dts_gw", "ttun"))]
        pub_max = max(pub_cost.values(), default=0.0)
        return (max(shared, default=0.0) / c_max,
                max(0.0, 1.0 - pub_max / c_max))

    def _recv_latency(self, size: int) -> float:
        return self.arch.recv_latency_s(size)

    def _result(self, spec: ExperimentSpec, consume_t: np.ndarray,
                rtts: Optional[np.ndarray],
                pub_start: np.ndarray, rejected: int = 0,
                blocked: int = 0, redelivered: int = 0,
                dups: Optional[tuple] = None) -> RunResult:
        # arrays are indexed pr*per_producer + i (work patterns) or
        # c*per_producer + i (broadcast, one producer), so producer
        # attribution falls out of the finite-entry indices.  ``dups`` is
        # a chaos run's redelivered completions, ``(times, message
        # indices)``: at-least-once, they join the consume stream
        fin_c = np.isfinite(consume_t)
        consume_t = consume_t[fin_c]
        fin_r = np.isfinite(rtts) if rtts is not None else None
        r = rtts[fin_r] if rtts is not None else np.zeros(0)
        per_producer = max(1, spec.total_messages // spec.n_producers)
        if spec.pattern in WAVE_PATTERNS:
            cp = np.flatnonzero(fin_c) // per_producer
            rp = (np.flatnonzero(fin_r) // per_producer
                  if fin_r is not None else np.zeros(0, dtype=np.int64))
        else:
            cp = np.zeros(consume_t.size, dtype=np.int64)
            rp = np.zeros(r.size, dtype=np.int64)
        if dups is not None:
            dup_t, dup_m = dups
            fin_d = np.isfinite(dup_t)
            consume_t = np.concatenate([consume_t, dup_t[fin_d]])
            cp = np.concatenate([cp, dup_m[fin_d] // per_producer])
        top = float(consume_t.max()) if consume_t.size else 0.0
        if r.size:
            top = max(top, float(r.max()))
        return RunResult(
            spec=spec, feasible=True,
            consume_times=consume_t,
            rtts=r,
            publish_starts=np.sort(pub_start),
            rejected_publishes=rejected, blocked_confirms=blocked,
            redelivered=redelivered, sim_time=top, n_events=self.n_events,
            consume_producers=cp, rtt_producers=rp)


class WaveCell(Cell):
    """A work-sharing/feedback cell, as the wave program builds it."""

    def __init__(self, spec: ExperimentSpec,
                 inventory: Optional[ClusterInventory] = None,
                 arch: Optional[Architecture] = None,
                 stack_seeds: Optional[list[int]] = None) -> None:
        if spec.pattern not in WAVE_PATTERNS:
            raise ValueError(f"pattern {spec.pattern!r} is not wave-formulated")
        super().__init__(spec, inventory, arch, stack_seeds)
