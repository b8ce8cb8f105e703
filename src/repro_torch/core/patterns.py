"""Experiment drivers for the paper's three messaging patterns (§5.1).

* **work sharing** — embarrassingly parallel fan-out (hyperparameter
  searches, Monte-Carlo ensembles): producers push to shared work queues,
  messages round-robin across consumers. Metric: aggregate throughput.
* **work sharing with feedback** — distribute-with-reply (TF-PS/MXNet-style
  data-parallel DL, master-worker task farms): requests via the work-queue
  model, replies via per-producer direct reply queues. Metric: RTT.
* **broadcast & gather** — DDP motif (NCCL/Gloo: weight fan-out +
  gradient reduce): one producer fans out via pub-sub to every consumer and
  gathers all replies from a single gather queue. Metrics: broadcast
  throughput + gather RTT.

Each driver returns (RunResult, Summary) pairs across a consumer sweep.

A copy of the reference package's ``patterns`` module, with the same
drivers, names, defaults and results.  Every driver that runs cells
takes ``device=`` (the GPU unless the caller asks for ``"cpu"``) and
raises without a GPU; ``engine="jax", jax_device_loop=True`` sends the
cells the wave program's gate accepts to the wave program, as in the
reference (see :mod:`repro_torch.core.run`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.architectures import Calibration, make_architecture
from repro_torch.core.cell import FLOW_CREDIT, WaveCell
from repro_torch.core.chaos import (
    AutoscalePolicy, ChaosSchedule, Injection, chaos_metrics)
from repro_torch.core.ds2hpc import ClusterInventory
from repro_torch.core.metrics import (
    Summary, jain_fairness, summarize, tenant_median_rtts,
    tenant_throughputs)
from repro_torch.core.run import run_experiment, run_many
from repro_torch.core.simulator import (
    ExperimentSpec, InfeasibleConfiguration, RunResult, SimParams)
from repro_torch.core.workloads import Workload, get_workload

#: the paper's consumer sweep (Figs 4-8)
CONSUMER_SWEEP = (1, 2, 4, 8, 16, 32, 64)

#: broadcast&gather replies are aggregation/metric payloads, much smaller
#: than the 4 MiB broadcast body (paper §5.1: "all workers send back metrics
#: to be reduced at the initiator"): 4 MiB / 256 = 16 KiB replies. The sharp
#: RTT increase beyond 4 consumers (Fig 7b) then emerges from broker-egress
#: saturation on the broadcast leg plus the single producer gathering and
#: broadcasting concurrently.
GATHER_REPLY_FACTOR = 1.0 / 256.0


def _params(seed: int, **overrides: Any) -> SimParams:
    # construct in one shot so SimParams.__post_init__ validates the
    # overrides (engine name, vec_round sub-multiple, positive knobs)
    return SimParams(seed=seed, **overrides)


#: Overflow-regime stress scenario: a regime the paper's configurations
#: never trigger, exercisable at scale on the per-cohort engine.  A small
#: confirm window, slow consumers and a tight per-queue byte cap push the
#: work queues through repeated credit-flow blocking episodes
#: (publisher confirms withheld above ``FLOW_CREDIT x producers`` backlog)
#: into reject-publish overflow (producers observe rejects and re-publish
#: after the backoff).  ``queue_cap_msgs`` sits just above the credit
#: threshold so *both* mechanisms fire: the queue blocks at the threshold,
#: and the in-flight window landing on top of it overflows the cap.
#: the stress scenario's SimParams overrides (exported so benchmark cache
#: fingerprints can cover exactly what the runs used)
OVERFLOW_STRESS_DEFAULTS = dict(confirm_window=64, prefetch=16,
                                ack_batch=4, consumer_proc_s=2e-3)


def overflow_stress(arch: str, n_consumers: int, *,
                    workload: str | Workload = "dstream",
                    total_messages: Optional[int] = None,
                    queue_cap_msgs: Optional[int] = None,
                    n_runs: int = 1, seed: int = 0,
                    engine: Optional[str] = None,
                    device: "torch.device | str" = "cuda",
                    **param_overrides: Any) -> list[RunResult]:
    """Run the overflow-regime stress cell (feedback pattern, equal
    producers/consumers, up to 1024 consumers on the per-cohort engine).

    ``queue_cap_msgs`` defaults to ~6% above the credit threshold
    (``FLOW_CREDIT x producers``) so both mechanisms fire; pass a small
    explicit cap for large consumer counts to get a pure reject-publish
    regime at affordable message volumes (the credit threshold itself
    scales with producers).  Returns the per-seed :class:`RunResult`
    list; results report nonzero ``rejected_publishes`` (and, in the
    default both-mechanisms regime, ``blocked_confirms``)."""
    wl = get_workload(workload) if isinstance(workload, str) else workload
    if queue_cap_msgs is None:
        queue_cap_msgs = int(FLOW_CREDIT * n_consumers * 1.06)
    if total_messages is None:
        # enough volume for repeated blocking/overflow episodes per queue
        total_messages = max(8192, 4 * queue_cap_msgs)
    for k, v in OVERFLOW_STRESS_DEFAULTS.items():
        param_overrides.setdefault(k, v)
    param_overrides.setdefault("queue_max_bytes",
                               queue_cap_msgs * wl.payload_bytes)
    return run_pattern("feedback", arch, wl, n_consumers,
                       total_messages=total_messages, n_runs=n_runs,
                       seed=seed, engine=engine, device=device,
                       **param_overrides)


#: the multi-tenant sweep (paper §6's MSS multi-user scalability claim,
#: made quantitative): number of independent workflows on one broker
TENANT_SWEEP = (1, 2, 4, 8, 16, 32, 64)


@dataclasses.dataclass
class TenantPoint:
    """One point of the multi-tenant contention curve: ``tenants``
    independent workflows sharing one deployment of ``arch``."""

    tenants: int
    isolation: str                   # "shared" | "vhost"
    arch: str
    workload: str
    feasible: bool
    #: mean per-tenant consumed-message rate (msgs/s per tenant)
    tenant_throughput_msgs_s: float = float("nan")
    #: mean of the per-tenant median request->reply RTTs (s)
    tenant_median_rtt_s: float = float("nan")
    #: Jain fairness index over the per-tenant throughputs (1.0 = even)
    fairness: float = float("nan")
    #: worst-off tenant's share of the best-off tenant's rate
    min_max_ratio: float = float("nan")
    #: per-tenant throughput relative to the explicit baseline cell
    #: (``multi_tenant(baseline_tenants=...)``, default the 1-tenant
    #: deployment; 1.0 = no degradation as tenants are added)
    degradation: float = float("nan")
    #: the busiest shared facility-ingress resource (DTS gateway NIC,
    #: PRS tunnel, MSS ingress, DSN NodePort NICs) as a fraction of the
    #: cell's bottleneck, from the static cost model: ~1.0 means the
    #: shared ingress is what every tenant is queueing on
    ingress_utilization: float = float("nan")
    rejected: float = 0.0
    blocked: float = 0.0
    n_runs: int = 0


#: resource-key prefixes that count as "shared facility ingress" for
#: :attr:`TenantPoint.ingress_utilization`.  Deliberately excluded:
#: per-tenant ``ttun:*`` pairs (dedicated, not shared) and the
#: broker-internal ``dsn_int:*`` SDN links (hence the colon-terminated
#: NodePort prefixes, which would otherwise prefix-match them).
INGRESS_RESOURCE_PREFIXES = (
    "dts_gw", "ingress_in", "ingress_out", "tunnel", "dsn_in:", "dsn_out:")


def _ingress_utilization(spec: ExperimentSpec,
                         inventory: Optional[ClusterInventory]) -> float:
    """Shared facility-ingress utilization of one cell, off the cell's
    static bottleneck analysis (a construction-time probe on the host — no
    run needed, engine-choice independent)."""
    try:
        sim = WaveCell(spec, inventory)
    except InfeasibleConfiguration:
        return float("nan")
    vals = [v for k, v in sim.resource_cost.items()
            if k.startswith(INGRESS_RESOURCE_PREFIXES)]
    if not vals or sim.bottleneck_cost <= 0:
        return float("nan")
    return float(np.max(vals) / sim.bottleneck_cost)


def multi_tenant(arch: str = "mss",
                 tenant_counts: Sequence[int] = TENANT_SWEEP, *,
                 isolation: str = "vhost",
                 producers_per_tenant: int = 1,
                 consumers_per_tenant: int = 1,
                 workload: str | Workload = "dstream",
                 messages_per_tenant: int = 256,
                 n_runs: int = 3, seed: int = 0,
                 engine: Optional[str] = None,
                 inventory: Optional[ClusterInventory] = None,
                 baseline_tenants: int = 1,
                 device: "torch.device | str" = "cuda",
                 **param_overrides: Any) -> list[TenantPoint]:
    """Multi-tenant contention sweep: N independent feedback workflows
    (1 producer + 1 consumer each by default) share one deployment of
    ``arch``, as tenant count grows ``1 -> 64``.

    This quantifies the paper's §6 deployment-feasibility argument.
    What "sharing one deployment" means is architecture-specific:

    * ``mss`` — every tenant funnels through the same LB + ingress +
      broker fabric (the paper's "greater deployment feasibility and
      scalability across multiple users" claim);
    * ``dts`` — each tenant gets its own dedicated minimal-hop S2DS
      tunnel pair; contention appears at the shared facility gateway
      NIC the tunnels terminate on (see
      :class:`repro_torch.core.architectures.DirectStreaming`);
    * ``prs-*`` — tenants multiplex the one shared proxy pair ahead of
      per-tenant queues (Stunnel's 16-connection cap makes large tenant
      counts infeasible, as in the paper's missing data points).

    ``isolation`` picks the broker layout: ``"vhost"`` gives each
    tenant its own queues in its own vhost (RabbitMQ namespacing — the
    S3M provisioning model's per-project isolation), ``"shared"`` drops
    every tenant into the same work queues (messages mix across
    tenants).

    Offered load scales with the tenant count (``messages_per_tenant``
    each), so a flat curve means perfect scaling.  All cells (every
    tenant count x ``n_runs`` seeds) go through one
    :func:`~repro_torch.core.run.run_many` call, so each cell's seeds
    stack as lanes of one batched engine run.  Returns one
    :class:`TenantPoint` per entry of ``tenant_counts``, with
    ``degradation`` relative to the explicit ``baseline_tenants`` cell
    — which is run even when the sweep itself starts at a higher
    tenant count, so a ``(4, 16, 64)`` sweep still reports degradation
    against the single-tenant deployment."""
    wl = get_workload(workload) if isinstance(workload, str) else workload
    if engine is not None:
        param_overrides.setdefault("engine", engine)

    def spec_of(T: int, r: int) -> ExperimentSpec:
        return ExperimentSpec(
            pattern="feedback", workload=wl, arch=arch,
            n_producers=T * producers_per_tenant,
            n_consumers=T * consumers_per_tenant,
            total_messages=T * messages_per_tenant,
            params=_params(seed + 1000 * r, **param_overrides),
            tenants=T, tenant_isolation=isolation)

    counts = list(tenant_counts)
    run_counts = list(counts)
    if baseline_tenants not in run_counts:
        run_counts.append(baseline_tenants)
    specs = [spec_of(T, r) for T in run_counts for r in range(n_runs)]
    results = run_many(specs, device=device, inventory=inventory)
    by_count = {T: results[i * n_runs:(i + 1) * n_runs]
                for i, T in enumerate(run_counts)}

    def stats_of(T: int) -> Optional[dict]:
        feas = [r for r in by_count[T] if r.feasible]
        if not feas:
            return None
        thr = np.stack([tenant_throughputs(r) for r in feas])
        rtt = np.stack([tenant_median_rtts(r) for r in feas])
        ratios = [float(row.min() / row.max())
                  for row in thr if np.isfinite(row).all() and row.max() > 0]
        return dict(
            per_thr=float(np.nanmean(thr)),
            rtt=float(np.nanmean(rtt)),
            fairness=float(np.nanmean([jain_fairness(row) for row in thr])),
            min_max=(float(np.mean(ratios)) if ratios else float("nan")),
            rejected=float(np.mean([r.rejected_publishes for r in feas])),
            blocked=float(np.mean([r.blocked_confirms for r in feas])),
            n_runs=len(feas))

    all_stats = {T: stats_of(T) for T in run_counts}
    base_st = all_stats.get(baseline_tenants)
    base = base_st["per_thr"] if base_st else None
    points: list[TenantPoint] = []
    for T in counts:
        st = all_stats[T]
        if st is None:
            points.append(TenantPoint(T, isolation, arch, wl.name, False))
            continue
        points.append(TenantPoint(
            tenants=T, isolation=isolation, arch=arch, workload=wl.name,
            feasible=True,
            tenant_throughput_msgs_s=st["per_thr"],
            tenant_median_rtt_s=st["rtt"],
            fairness=st["fairness"],
            min_max_ratio=st["min_max"],
            degradation=(st["per_thr"] / base if base else float("nan")),
            ingress_utilization=_ingress_utilization(spec_of(T, 0),
                                                     inventory),
            rejected=st["rejected"],
            blocked=st["blocked"],
            n_runs=st["n_runs"]))
    return points


# ---------------------------------------------------------------------------
# Cross-architecture deployment feasibility (paper §6, quantified)
# ---------------------------------------------------------------------------

#: the three deployment models of the §6 comparison (prs-haproxy rather
#: than prs-stunnel: the Stunnel tunnel's 16-connection cap makes most
#: of the tenant sweep infeasible, exactly the paper's missing points)
DEPLOYMENT_ARCHS = ("dts", "prs-haproxy", "mss")


@dataclasses.dataclass
class FeasibilityStudy:
    """Result of :func:`deployment_feasibility`: one multi-tenant curve
    per architecture plus the DTS-vs-MSS crossover headline."""

    archs: tuple
    tenant_counts: tuple
    #: arch name -> one TenantPoint per tenant count
    curves: dict[str, list[TenantPoint]]
    #: interpolated tenant count where MSS's shared-broker per-tenant
    #: throughput first meets per-tenant-tunnel DTS (NaN = no crossover
    #: inside the sweep)
    crossover_tenants: float = float("nan")
    #: DTS's shared facility-ingress utilization at the crossover
    crossover_utilization: float = float("nan")

    def headline(self) -> str:
        if self.crossover_tenants != self.crossover_tenants:   # NaN
            return ("no DTS-vs-MSS crossover inside the sweep "
                    f"(tenants {min(self.tenant_counts)}"
                    f"-{max(self.tenant_counts)})")
        return (f"MSS's shared broker overtakes per-tenant DTS tunnels "
                f"at ~{self.crossover_tenants:.1f} tenants "
                f"(DTS ingress utilization "
                f"{self.crossover_utilization:.2f})")


def crossover_point(a_pts: Sequence[TenantPoint],
                    b_pts: Sequence[TenantPoint]
                    ) -> tuple[float, float]:
    """First tenant count where curve ``b``'s per-tenant throughput
    meets/overtakes curve ``a``'s, interpolated in ``log2(tenants)``
    between the bracketing sweep points.  Returns ``(tenants,
    a_ingress_utilization_at_crossover)``; ``(nan, nan)`` when the
    curves never cross inside the sweep (or share no feasible tenant
    counts)."""
    a_by = {p.tenants: p for p in a_pts if p.feasible}
    b_by = {p.tenants: p for p in b_pts if p.feasible}
    common = sorted(set(a_by) & set(b_by))
    if not common:
        return float("nan"), float("nan")
    diffs = [b_by[T].tenant_throughput_msgs_s
             - a_by[T].tenant_throughput_msgs_s for T in common]
    if diffs[0] >= 0:
        return float(common[0]), float(a_by[common[0]].ingress_utilization)
    for (T0, d0), (T1, d1) in zip(zip(common, diffs),
                                  zip(common[1:], diffs[1:])):
        if d0 < 0 <= d1:
            f = -d0 / (d1 - d0) if d1 != d0 else 0.0
            lT = np.log2(T0) + f * (np.log2(T1) - np.log2(T0))
            u0 = a_by[T0].ingress_utilization
            u1 = a_by[T1].ingress_utilization
            return float(2.0 ** lT), float(u0 + f * (u1 - u0))
    return float("nan"), float("nan")


def deployment_feasibility(archs: Sequence[str] = DEPLOYMENT_ARCHS,
                           tenant_counts: Sequence[int] = TENANT_SWEEP, *,
                           isolation: str = "vhost",
                           workload: str | Workload = "dstream",
                           messages_per_tenant: int = 256,
                           n_runs: int = 3, seed: int = 0,
                           engine: Optional[str] = None,
                           inventory: Optional[ClusterInventory] = None,
                           baseline_tenants: int = 1,
                           device: "torch.device | str" = "cuda",
                           **param_overrides: Any) -> FeasibilityStudy:
    """The paper's §6 deployment-feasibility argument, quantified: the
    same 1 -> N tenant sweep across all three architecture deployment
    models (per-tenant DTS tunnels vs PRS shared-proxy ingress vs the
    MSS managed broker), one :class:`TenantPoint` curve per
    architecture (each arch's cells batched through ``run_many``
    stacked execution — see :func:`multi_tenant`).

    The headline is the **crossover point**: DTS's dedicated per-tenant
    tunnels win at low tenant counts (minimal hops, no shared-fabric
    tax), but every tunnel terminates on the facility's gateway NIC —
    as that shared ingress saturates and the gateway's per-tenant
    endpoint overhead grows, MSS's wider managed ingress overtakes it.
    ``crossover_tenants`` / ``crossover_utilization`` report where, and
    at what DTS ingress utilization, that happens."""
    curves = {arch: multi_tenant(
                  arch, tenant_counts, isolation=isolation,
                  workload=workload,
                  messages_per_tenant=messages_per_tenant,
                  n_runs=n_runs, seed=seed, engine=engine,
                  inventory=inventory, baseline_tenants=baseline_tenants,
                  device=device, **param_overrides)
              for arch in archs}
    ct, cu = float("nan"), float("nan")
    if "dts" in curves and "mss" in curves:
        ct, cu = crossover_point(curves["dts"], curves["mss"])
    return FeasibilityStudy(archs=tuple(archs),
                            tenant_counts=tuple(tenant_counts),
                            curves=curves, crossover_tenants=ct,
                            crossover_utilization=cu)


# ---------------------------------------------------------------------------
# Chaos campaign (topology-epoch failure injection)
# ---------------------------------------------------------------------------

#: the chaos scenarios of the campaign scoreboard (the reference's
#: ``benchmarks/bench_chaos.py``): each one failure/recovery story on the
#: work-sharing pattern, compared against the same cell failure-free
CHAOS_SCENARIOS = ("tunnel", "broker", "consumer", "autoscale")

#: chaos cells run with explicit consumer processing (so the recovery
#: clock has a steady pre-failure rate to catch up to) and zero jitter
#: (scenario differences, not noise, drive the scoreboard)
CHAOS_CELL_DEFAULTS = dict(consumer_proc_s=2e-3, jitter=0.0)

#: each architecture's facility-ingress link resource (the chaos link
#: injection target): DTS's dedicated S2DS tunnel pairs (``ttun``
#: prefix-matches every tenant's pair), the PRS variants' one shared
#: proxy, MSS's managed-fabric load balancer
CHAOS_LINK_TARGETS = {
    "dts": "ttun", "prs-stunnel": "tunnel", "prs-haproxy": "tunnel",
    "mss": "lb"}


def chaos_link_target(arch: str) -> str:
    try:
        return CHAOS_LINK_TARGETS[arch]
    except KeyError:
        raise ValueError(f"no chaos link target known for arch {arch!r}; "
                         f"known: {sorted(CHAOS_LINK_TARGETS)}") from None


def chaos_cell(arch: str, scenario: str, *,
               n_producers: int = 4, n_consumers: int = 8,
               total_messages: int = 4096,
               workload: str | Workload = "generic",
               t0: float = 5.0, t1: float = 10.0,
               autoscale_from: int = 2,
               seed: int = 0, engine: Optional[str] = None,
               **param_overrides: Any) -> ExperimentSpec:
    """One chaos-campaign cell: the work-sharing pattern on ``arch``
    with one failure/recovery story attached.

    * ``"baseline"`` — the same cell failure-free (the scoreboard's
      reference for availability and re-publish-storm counts);
    * ``"tunnel"`` — the architecture's ingress link goes down during
      ``[t0, t1)``; on DTS the cell runs two vhost-isolated tenants and
      kills tenant 1's dedicated ``ttun:1`` pair (the paper's per-tenant
      tunnel story), elsewhere the one shared ingress;
    * ``"broker"`` — broker outage of ``queue:work:0`` during
      ``[t0, t1)``: publishes rejected (the producer re-publish storm),
      broker-unacked deliveries redelivered at ``t0``;
    * ``"consumer"`` — consumer ``c1`` crashes at ``t0``, its unacked
      deliveries redeliver to the survivors, and it re-registers at
      ``t1``;
    * ``"autoscale"`` — the cell starts at ``autoscale_from`` consumers
      with a backlog-reactive policy allowed to grow to
      ``n_consumers`` (its availability score is how much of the full
      fleet's throughput the policy recovers).
    """
    wl = get_workload(workload) if isinstance(workload, str) else workload
    for k, v in CHAOS_CELL_DEFAULTS.items():
        param_overrides.setdefault(k, v)
    if engine is not None:
        param_overrides.setdefault("engine", engine)
    tenants, isolation = 1, "shared"
    chaos: Any = None
    nc = n_consumers
    if scenario == "tunnel":
        if arch == "dts":
            tenants, isolation = 2, "vhost"
            target = "ttun:1"
        else:
            target = chaos_link_target(arch)
        chaos = ChaosSchedule(injections=(Injection("link", target,
                                                    t0, t1),))
    elif scenario == "broker":
        chaos = ChaosSchedule(injections=(Injection("broker",
                                                    "queue:work:0",
                                                    t0, t1),))
    elif scenario == "consumer":
        chaos = ChaosSchedule(injections=(Injection("consumer", "c1",
                                                    t0, t1),))
    elif scenario == "autoscale":
        nc = autoscale_from
        chaos = ChaosSchedule(autoscale=AutoscalePolicy(
            interval_s=0.25, high_backlog=32, low_backlog=4,
            max_consumers=n_consumers, step=2))
    elif scenario != "baseline":
        raise ValueError(f"unknown chaos scenario {scenario!r}; known: "
                         f"{('baseline',) + CHAOS_SCENARIOS}")
    return ExperimentSpec(
        pattern="work_sharing", arch=arch, workload=wl,
        n_producers=n_producers, n_consumers=nc,
        total_messages=total_messages,
        tenants=tenants, tenant_isolation=isolation,
        params=_params(seed, chaos=chaos, **param_overrides))


@dataclasses.dataclass
class ChaosPoint:
    """One row of the chaos scoreboard: ``arch`` under ``scenario``."""

    arch: str
    scenario: str
    feasible: bool
    #: unique-message delivery rate (total_messages / sim_time — the
    #: redelivered duplicates do not inflate it)
    throughput_msgs_s: float = float("nan")
    #: effective-throughput ratio vs the arch's failure-free baseline
    #: cell (for the autoscale scenario: vs the full fleet)
    availability: float = float("nan")
    #: seconds after restore until consumption catches the pre-failure
    #: trajectory (:func:`repro_torch.core.chaos.recovery_time`)
    recovery_s: float = float("nan")
    duplicates: int = 0
    lost: int = 0
    redelivered: int = 0
    #: publish rejections beyond the baseline's (the re-publish storm)
    storm_rejects: int = 0
    engine: str = ""


def chaos_campaign(archs: Sequence[str] = DEPLOYMENT_ARCHS,
                   scenarios: Sequence[str] = CHAOS_SCENARIOS, *,
                   seed: int = 0, engine: Optional[str] = None,
                   inventory: Optional[ClusterInventory] = None,
                   device: "torch.device | str" = "cuda",
                   **cell_overrides: Any) -> list[ChaosPoint]:
    """The chaos scoreboard: every scenario on every architecture, each
    scored against that architecture's failure-free baseline cell
    (availability ratio, re-publish storm beyond baseline).  All cells
    go through one :func:`~repro_torch.core.run.run_many` call, so
    ``engine="jax"`` cells fall back per cell exactly like the campaign
    layer (chaos cells are vectorized; baselines may stay on jax)."""
    names = ["baseline"] + [s for s in scenarios if s != "baseline"]
    specs = [chaos_cell(arch, sc, seed=seed, engine=engine,
                        **cell_overrides)
             for arch in archs for sc in names]
    results = run_many(specs, device=device, inventory=inventory)
    points: list[ChaosPoint] = []
    it = iter(results)
    for arch in archs:
        by = {sc: next(it) for sc in names}
        base = by["baseline"]
        base_ok = base.feasible and base.sim_time > 0
        base_tp = (base.spec.total_messages / base.sim_time
                   if base_ok else float("nan"))
        for sc in names:
            r = by[sc]
            if not r.feasible:
                points.append(ChaosPoint(arch, sc, False))
                continue
            tp = (r.spec.total_messages / r.sim_time
                  if r.sim_time > 0 else float("nan"))
            sched = r.spec.params.chaos
            m = (chaos_metrics(r, sched,
                               baseline_rejected=(base.rejected_publishes
                                                  if base_ok else 0))
                 if sched is not None else None)
            points.append(ChaosPoint(
                arch=arch, scenario=sc, feasible=True,
                throughput_msgs_s=tp,
                availability=(tp / base_tp if base_tp > 0 else float("nan")),
                recovery_s=(m.recovery_s if m else 0.0),
                duplicates=(m.duplicates if m else 0),
                lost=(m.lost if m else 0),
                redelivered=(m.redelivered if m else 0),
                storm_rejects=(m.storm_rejects if m else 0),
                engine=r.spec.params.engine))
    return points


#: the single-fault availability scenario per architecture (the
#: :func:`availability_crossover` sweep), as ``(kind, target,
#: tenants)``: one ingress-class host dies, chosen uniformly among that
#: architecture's candidate hosts, and the curve carries the *expected*
#: effective throughput over the choice.  DTS's minimal-hop path rides
#: dedicated S2DS tunnel pairs on one gateway host — there is exactly
#: one candidate, the fault kills the whole ``ttun`` prefix and the
#: stream stalls (the gateway only appears as a modeled resource in the
#: per-tenant deployment, so the DTS cell runs two vhost tenants); PRS
#: likewise funnels through its one proxy.  MSS's ingress is the
#: managed broker fabric itself — ``node:*`` expands to one cell per
#: DSN node, and nodes homing no work queue are no-op faults (with the
#: default 2 queues on 3 nodes, a third of single-node faults cost
#: nothing) — the redundancy the crossover measures.
CHAOS_SINGLE_FAULTS = {
    "dts": ("link", "ttun", 2),
    "prs-stunnel": ("link", "tunnel", 1),
    "prs-haproxy": ("link", "tunnel", 1),
    "mss": ("broker", "node:*", 1)}


@dataclasses.dataclass
class AvailabilityStudy:
    """Result of :func:`availability_crossover`: effective-throughput
    curves over outage duration plus the DTS-vs-MSS crossover headline
    (the availability companion to :class:`FeasibilityStudy`)."""

    archs: tuple
    durations: tuple
    #: arch name -> one ChaosPoint per outage duration
    curves: dict[str, list[ChaosPoint]]
    #: interpolated outage duration (s) where MSS's redundant managed
    #: fabric first beats DTS's dedicated tunnel on effective
    #: throughput (NaN = no crossover inside the sweep)
    crossover_duration_s: float = float("nan")

    def headline(self) -> str:
        if self.crossover_duration_s != self.crossover_duration_s:  # NaN
            return ("no DTS-vs-MSS availability crossover inside the "
                    f"sweep (outages {min(self.durations):g}"
                    f"-{max(self.durations):g} s)")
        return ("MSS's redundant managed fabric overtakes DTS's "
                "dedicated tunnel for single-fault ingress outages "
                f">~ {self.crossover_duration_s:.1f} s")


def availability_crossover(archs: Sequence[str] = ("dts", "mss"),
                           durations: Sequence[float] = (5.0, 20.0, 40.0,
                                                         80.0, 120.0), *,
                           t0: float = 5.0, seed: int = 0,
                           engine: Optional[str] = None,
                           inventory: Optional[ClusterInventory] = None,
                           device: "torch.device | str" = "cuda",
                           **cell_overrides: Any) -> AvailabilityStudy:
    """The §6 feasibility argument's availability companion: sweep the
    duration of a *single-fault* ingress outage
    (:data:`CHAOS_SINGLE_FAULTS`) and compare expected effective
    throughput (total messages over the stretched run, averaged over
    which candidate host died).  DTS wins failure-free and at short
    outages (minimal hops), but its one gateway is a single point of
    failure — every fault stalls the whole stream; MSS's managed fabric
    spreads the same fault class over its broker nodes, a share of
    which home no work queue and cost nothing — past the crossover
    duration the redundant fabric delivers more.  Interpolated linearly
    between the bracketing sweep durations."""
    durations = tuple(durations)
    inv = inventory or ClusterInventory()

    def fault_specs(arch: str, d: float) -> list[ExperimentSpec]:
        base = chaos_cell(arch, "baseline", seed=seed, engine=engine,
                          **cell_overrides)
        kind, target, tenants = CHAOS_SINGLE_FAULTS[arch]
        if tenants > 1:
            base = dataclasses.replace(base, tenants=tenants,
                                       tenant_isolation="vhost")
        targets = ([f"node:{k}" for k in range(inv.n_dsn)]
                   if target == "node:*" else [target])
        return [dataclasses.replace(
                    base, params=dataclasses.replace(
                        base.params,
                        chaos=ChaosSchedule(injections=(
                            Injection(kind, tgt, t0, t0 + d),))))
                for tgt in targets]

    grouped = [[fault_specs(arch, d) for d in durations]
               for arch in archs]
    flat = [s for per_arch in grouped for cell in per_arch for s in cell]
    results = iter(run_many(flat, device=device, inventory=inv))
    curves: dict[str, list[ChaosPoint]] = {}
    for arch, per_arch in zip(archs, grouped):
        pts = []
        for d, cell in zip(durations, per_arch):
            rs = [next(results) for _ in cell]
            ok = [r for r in rs if r.feasible]
            if not ok:
                pts.append(ChaosPoint(arch, f"fault@{d:g}s", False))
                continue
            # expectation over the uniformly-chosen failed host
            tp = float(np.mean([r.spec.total_messages / r.sim_time
                                for r in ok if r.sim_time > 0]))
            pts.append(ChaosPoint(
                arch=arch, scenario=f"fault@{d:g}s", feasible=True,
                throughput_msgs_s=tp,
                redelivered=int(round(np.mean([r.redelivered
                                               for r in ok]))),
                engine=ok[0].spec.params.engine))
        curves[arch] = pts
    cd = float("nan")
    if "dts" in curves and "mss" in curves:
        pairs = [(d, m.throughput_msgs_s - a.throughput_msgs_s)
                 for d, a, m in zip(durations, curves["dts"],
                                    curves["mss"])
                 if a.feasible and m.feasible]
        if pairs and pairs[0][1] >= 0:
            cd = float(pairs[0][0])
        else:
            for (d0, x0), (d1, x1) in zip(pairs, pairs[1:]):
                if x0 < 0 <= x1:
                    f = -x0 / (x1 - x0) if x1 != x0 else 0.0
                    cd = float(d0 + f * (d1 - d0))
                    break
    return AvailabilityStudy(archs=tuple(archs), durations=durations,
                             curves=curves, crossover_duration_s=cd)


def pattern_spec(pattern: str, arch: str, workload: str | Workload,
                 n_consumers: int, *,
                 total_messages: int = 8192,
                 seed: int = 0,
                 engine: Optional[str] = None,
                 **param_overrides: Any) -> ExperimentSpec:
    """The fully-resolved :class:`ExperimentSpec` for one (pattern, arch,
    workload, consumer-count) run — the single spec construction behind
    :func:`run_pattern` and the bench cache's engine resolution
    (``benchmarks.common``), so pattern-implied defaults (single
    broadcast producer, gather reply factor) resolve identically in the
    run and in its cache key (``campaign.cell_key``)."""
    wl = get_workload(workload) if isinstance(workload, str) else workload
    if engine is not None:
        param_overrides.setdefault("engine", engine)
    n_producers = 1 if pattern.startswith("broadcast") else n_consumers
    if pattern == "broadcast_gather" and "reply_factor" not in param_overrides:
        param_overrides["reply_factor"] = GATHER_REPLY_FACTOR
    return ExperimentSpec(
        pattern=pattern, workload=wl, arch=arch,
        n_producers=n_producers, n_consumers=n_consumers,
        total_messages=total_messages,
        params=_params(seed, **param_overrides))


def run_pattern(pattern: str, arch: str, workload: str | Workload,
                n_consumers: int, *,
                total_messages: int = 8192,
                n_runs: int = 3,
                seed: int = 0,
                engine: Optional[str] = None,
                inventory: Optional[ClusterInventory] = None,
                cal: Optional[Calibration] = None,
                device: "torch.device | str" = "cuda",
                **param_overrides: Any) -> list[RunResult]:
    """Run one (pattern, architecture, workload, consumer-count) cell.

    The paper averages three runs per data point; we run ``n_runs`` seeds.
    Work-sharing patterns use equal producer/consumer counts; broadcast
    patterns use a single producer (paper §5.2).  ``engine`` selects the
    simulator backend: ``"vectorized"`` (the default, the per-cohort
    engine) or ``"jax"`` (the same engine, or with ``jax_device_loop=True``
    the wave program where its gate accepts the cell); the heap engine is
    not ported.  ``None`` uses ``SimParams.engine``'s default.  Each seed
    runs solo through :func:`~repro_torch.core.run.run_experiment`.
    """
    results = []
    for r in range(n_runs):
        spec = pattern_spec(pattern, arch, workload, n_consumers,
                            total_messages=total_messages,
                            seed=seed + 1000 * r, engine=engine,
                            **param_overrides)
        if cal is not None or inventory is not None:
            inv = inventory or ClusterInventory()
            a = make_architecture(arch, inv, cal)
            results.append(run_experiment(spec, inv, a, device=device))
        else:
            results.append(run_experiment(spec, device=device))
    return results


def sweep(pattern: str, archs: Sequence[str], workload: str,
          consumers: Sequence[int] = CONSUMER_SWEEP, *,
          total_messages: int = 8192, n_runs: int = 3, seed: int = 0,
          engine: Optional[str] = None,
          inventory: Optional[ClusterInventory] = None,
          cal: Optional[Calibration] = None,
          device: "torch.device | str" = "cuda",
          **param_overrides: Any) -> list[Summary]:
    """Full paper-style sweep; returns averaged summaries per cell."""
    out: list[Summary] = []
    for arch in archs:
        for nc in consumers:
            rs = run_pattern(pattern, arch, workload, nc,
                             total_messages=total_messages, n_runs=n_runs,
                             seed=seed, engine=engine,
                             inventory=inventory, cal=cal, device=device,
                             **param_overrides)
            out.append(average_summaries([summarize(r) for r in rs]))
    return out


def average_summaries(ss: Sequence[Summary]) -> Summary:
    """Average the metric fields over repeated runs (paper: 3-run mean).

    Averages over the *feasible subset* and records how many runs went
    into the mean in ``Summary.n_runs`` — a mixed-feasibility cell (some
    seeds infeasible) must not silently report a single seed's full
    metrics as a multi-run mean.  With no feasible run at all, the cell
    is reported infeasible with ``n_runs=0``."""
    feas = [s for s in ss if s.feasible]
    if not feas:
        out = Summary(**{**ss[0].__dict__})
        out.feasible = False
        out.n_runs = 0
        return out
    out = Summary(**{**feas[0].__dict__})
    out.n_runs = len(feas)
    for f in ("throughput_msgs_s", "median_rtt_s", "p95_rtt_s",
              "min_rtt_s", "goodput_gbps"):
        vals = [getattr(s, f) for s in feas]
        vals = [v for v in vals if np.isfinite(v)]
        setattr(out, f, float(np.mean(vals)) if vals else float("nan"))
    # float means: int(np.mean(...)) floored rare-overflow cells (e.g. a
    # mean of 0.33 rejects across seeds) to an invisible 0
    out.rejected = float(np.mean([s.rejected for s in feas]))
    out.blocked = float(np.mean([s.blocked for s in feas]))
    out.n_messages = int(np.mean([s.n_messages for s in feas]))
    # surface a mixed-engine mean (e.g. some seeds fell back from jax)
    engines = sorted({s.engine for s in feas if s.engine})
    out.engine = engines[0] if len(engines) == 1 else "+".join(engines)
    return out
