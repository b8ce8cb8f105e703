"""Batched sweep campaigns: whole experiment grids through the engine.

A copy of the reference package's ``campaign`` module, with the same
grid, keys and results; its runner takes ``device=`` (the GPU unless
the caller asks for ``"cpu"``) and raises without a GPU.

``patterns.sweep`` runs every (pattern x architecture x workload x
consumer-count x seed) cell as a serial Python loop over the engine —
so the very sweeps the vectorized engine made fast are bottlenecked by
cell-at-a-time orchestration.  This module executes whole grids as
*batched work*:

* a declarative :class:`CampaignSpec` names the grid axes plus optional
  per-cell :class:`~repro_torch.core.simulator.SimParams` overrides;
* the runner groups structurally-identical cells — same hop graph,
  different seeds — and pushes each group through
  :func:`repro_torch.core.run.run_many`, which stacks the seeds as
  cohort lanes of **one** batched engine run (a 3-seed cell costs barely
  more than one run);
* the groups run in-process, largest first, one after another (the
  reference fans them out over a process pool; a worker process cannot
  share the parent's CUDA context, and one card gains nothing from
  several processes);
* every finished group is written through a fingerprinted cache (an
  object with a ``data`` dict and a ``save()`` method), so an
  interrupted campaign resumes where it stopped and
  an engine/params change can never serve stale numbers;
* overflow-regime cells (explicit ``queue_max_bytes`` caps,
  credit-flow-reachable publish surpluses) batch like everything else —
  flow control is lane-resolved in the stacked engine, so every seed
  lane carries its own reject/block accounting.

Quick start::

    from repro_torch.core.campaign import CampaignSpec, run_campaign

    spec = CampaignSpec(name="fig6-mini", patterns=("feedback",),
                        architectures=("dts", "mss"), workloads=("dstream",),
                        consumers=(4, 8), n_runs=3, total_messages=2048)
    res = run_campaign(spec, device="cuda")  # 12 cells, batched
    for s in res.averaged:
        print(s.arch, s.n_consumers, round(s.throughput_msgs_s, 1))
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core.metrics import Summary, summarize
from repro_torch.core.patterns import GATHER_REPLY_FACTOR, average_summaries
from repro_torch.core.run import jax_supported, run_many
from repro_torch.core.simulator import ExperimentSpec, SimParams, check_engine
from repro_torch.core.workloads import get_workload
from repro_torch.device import resolve_device

#: the version tag of the port's cache keys.  It differs from the
#: reference package's (``"v2"``), so that a cache file written by one
#: package never serves the other: the two agree only within the
#: ``device_loop.*`` bands on the wave program's cells
CACHE_KEY_VERSION = "torch-v2"


def params_fingerprint(params: SimParams) -> str:
    """Short stable hash of a fully-resolved :class:`SimParams` — the
    fingerprint behind campaign :func:`cell_key`\\ s, so any change to
    simulator defaults (not just explicit overrides) invalidates them."""
    blob = repr(sorted(params.__dict__.items()))
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def resolved_engine(spec: ExperimentSpec) -> str:
    """The engine a spec will *actually* run on, after the ``run_many``
    fallback: a requested ``"jax"`` cell that ``jax_supported`` rejects
    (a chaos cell) executes on the vectorized engine, and must be cached
    as such.

    Every cache key MUST be built from this, never from the requested
    ``spec.params.engine`` — keying a fallback cell under ``jax`` both
    poisons the jax namespace and forks it from the identical
    vectorized cell (same computation measured twice)."""
    eng = spec.params.engine
    if eng == "jax" and not jax_supported(spec)[0]:
        return "vectorized"
    return eng


# ---------------------------------------------------------------------------
# Declarative campaign grids
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One fully-resolved campaign cell (a single seeded engine run)."""

    pattern: str
    arch: str
    workload: str
    n_consumers: int
    total_messages: int
    seed: int
    tenants: int = 1
    tenant_isolation: str = "shared"
    #: sorted (name, value) SimParams overrides, seed excluded
    overrides: tuple = ()

    def experiment(self) -> ExperimentSpec:
        n_producers = (1 if self.pattern.startswith("broadcast")
                       else self.n_consumers)
        ov = dict(self.overrides)
        if (self.pattern == "broadcast_gather"
                and "reply_factor" not in ov):
            ov["reply_factor"] = GATHER_REPLY_FACTOR
        return ExperimentSpec(
            pattern=self.pattern, workload=get_workload(self.workload),
            arch=self.arch, n_producers=n_producers,
            n_consumers=self.n_consumers,
            total_messages=self.total_messages,
            params=SimParams(seed=self.seed, **ov),
            tenants=self.tenants, tenant_isolation=self.tenant_isolation)

    def group_key(self) -> tuple:
        """Cells equal under this key differ only by seed — the runner
        stacks them through one batched run."""
        return (self.pattern, self.arch, self.workload, self.n_consumers,
                self.total_messages, self.tenants, self.tenant_isolation,
                self.overrides)


@dataclasses.dataclass
class CampaignSpec:
    """A declarative sweep grid: the cross product of the axes below,
    repeated over ``n_runs`` seeds per cell.

    ``cell_params`` applies targeted SimParams overrides: a list of
    ``(match, overrides)`` pairs where ``match`` is a dict over the axis
    names (``pattern``/``arch``/``workload``/``n_consumers``/
    ``tenants``); every cell whose axes match all entries gets the
    overrides (later pairs win on conflicts).  ``params`` applies to
    every cell."""

    name: str
    patterns: Sequence[str] = ("work_sharing",)
    architectures: Sequence[str] = ("dts",)
    workloads: Sequence[str] = ("dstream",)
    consumers: Sequence[int] = (8,)
    n_runs: int = 3
    seed: int = 0
    total_messages: int = 8192
    tenants: Sequence[int] = (1,)
    tenant_isolation: str = "shared"
    params: dict = dataclasses.field(default_factory=dict)
    cell_params: list = dataclasses.field(default_factory=list)

    #: axis names a cell_params match may constrain
    AXES = ("pattern", "arch", "workload", "n_consumers", "tenants")

    def __post_init__(self) -> None:
        self._validate_engines()

    def _validate_engines(self) -> None:
        """Resolve every engine name the grid can select — ``params`` and
        each ``cell_params`` override — at construction, so a typo like
        ``engine="jaxx"`` fails here with the offending override named,
        not as a bare SimParams error from deep inside the grid walk."""
        sources = [("params", self.params)]
        sources += [(f"cell_params[{i}] (match={dict(m)!r})", o)
                    for i, (m, o) in enumerate(self.cell_params)]
        for where, ov in sources:
            eng = ov.get("engine") if isinstance(ov, dict) else None
            if eng is None:
                continue
            try:
                check_engine(eng)
            except ValueError as err:
                raise ValueError(
                    f"campaign {self.name!r}: {where} sets an invalid "
                    f"engine: {err}") from None

    def _validate_tenant_grid(self) -> None:
        """A tenant sweep crosses *every* (pattern, arch, consumers)
        combination — reject the cross products that cannot mean
        anything before any cell runs, with the offending combo named
        (an :class:`ExperimentSpec` error deep inside a 100-cell grid
        is much harder to act on)."""
        if max(self.tenants, default=1) <= 1:
            return
        bad_pat = [p for p in self.patterns
                   if p not in ("work_sharing", "feedback")]
        if bad_pat:
            raise ValueError(
                f"campaign {self.name!r} sweeps tenants="
                f"{tuple(self.tenants)} but includes pattern(s) "
                f"{bad_pat}: multi-tenant cells support only "
                f"work_sharing/feedback.  Split the broadcast patterns "
                f"into their own campaign, or drop tenants > 1.")
        bad = [(nc, t) for nc in self.consumers
               for t in self.tenants if t > 1 and nc % t]
        if bad:
            raise ValueError(
                f"campaign {self.name!r} crosses consumers x tenants "
                f"into ambiguous cells {bad}: each tenant count must "
                f"evenly divide each consumer count (producers/"
                f"consumers partition into contiguous tenant blocks).  "
                f"Align the axes (e.g. powers of two), or use separate "
                f"campaigns per tenant count.")

    def cells(self) -> list[CellSpec]:
        self._validate_tenant_grid()
        for match, _ in self.cell_params:
            unknown = set(match) - set(self.AXES)
            if unknown:
                raise ValueError(
                    f"cell_params match uses unknown axis name(s) "
                    f"{sorted(unknown)}; known axes: {list(self.AXES)}")
        out = []
        for pat in self.patterns:
            for arch in self.architectures:
                for wl in self.workloads:
                    for nc in self.consumers:
                        for t in self.tenants:
                            ov = dict(self.params)
                            axes = {"pattern": pat, "arch": arch,
                                    "workload": wl, "n_consumers": nc,
                                    "tenants": t}
                            for match, extra in self.cell_params:
                                if all(axes.get(k) == v
                                       for k, v in match.items()):
                                    ov.update(extra)
                            for r in range(self.n_runs):
                                out.append(CellSpec(
                                    pattern=pat, arch=arch, workload=wl,
                                    n_consumers=nc,
                                    total_messages=self.total_messages,
                                    seed=self.seed + 1000 * r,
                                    tenants=t,
                                    tenant_isolation=self.tenant_isolation,
                                    overrides=tuple(sorted(ov.items()))))
        return out

    # -- (de)serialization: campaign specs as JSON ---------------------------
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["cell_params"] = [list(p) for p in self.cell_params]
        return json.dumps(d, indent=1)

    @staticmethod
    def from_json(blob: str) -> "CampaignSpec":
        d = json.loads(blob)
        d["cell_params"] = [(dict(m), dict(o))
                            for m, o in d.get("cell_params", [])]
        return CampaignSpec(**d)


def cell_key(cell: CellSpec) -> str:
    """Versioned, engine+params-fingerprinted cache key for one cell (a
    simulator-default change or engine switch can never serve a stale
    campaign cell).
    Fingerprints the *fully-resolved* experiment params, including
    pattern-implied defaults like the broadcast-gather reply factor.

    Keys on the :func:`resolved_engine`, not the requested one: a jax
    cell that falls back to vectorized shares its key (tag *and*
    fingerprint) with the identical genuine-vectorized cell — it ran
    the same computation — and never occupies the jax namespace."""
    exp = cell.experiment()
    p = exp.params
    eng = resolved_engine(exp)
    if eng != p.engine:
        p = dataclasses.replace(p, engine=eng)
    fp = params_fingerprint(p)
    return (f"{CACHE_KEY_VERSION}|engine={eng}|p={fp}|campaign|"
            f"{cell.pattern}|{cell.arch}|{cell.workload}|"
            f"c{cell.n_consumers}|m{cell.total_messages}|"
            f"t{cell.tenants}.{cell.tenant_isolation}|s{cell.seed}")


# ---------------------------------------------------------------------------
# The batched runner
# ---------------------------------------------------------------------------


def _run_group(cells: Sequence[CellSpec],
               device: "torch.device | str") -> list[dict]:
    """Execute one structurally-identical group: the seeds stack into
    one batched engine run via ``run_many``."""
    results = run_many([c.experiment() for c in cells], device=device)
    return [dataclasses.asdict(summarize(r)) for r in results]


@dataclasses.dataclass
class CampaignResult:
    spec: CampaignSpec
    cells: list            # CellSpec per executed/cached cell
    summaries: list        # Summary per cell (same order)
    averaged: list         # Summary per unique cell group (seed-averaged)
    wall_s: float
    n_cached: int          # cells served from the cache
    #: cells that requested one engine but ran another (the ``run_many``
    #: jax→vectorized fallback of chaos cells); surfaced in the JSON so a
    #: "jax campaign" whose numbers are actually vectorized is never silent
    n_fallback: int = 0

    def to_json(self) -> str:
        return json.dumps({
            "name": self.spec.name,
            "spec": json.loads(self.spec.to_json()),
            "wall_s": self.wall_s,
            "n_cells": len(self.cells),
            "n_cached": self.n_cached,
            "n_fallback": self.n_fallback,
            "cells": [{"key": cell_key(c),
                       "summary": dataclasses.asdict(s)}
                      for c, s in zip(self.cells, self.summaries)],
            "averaged": [dataclasses.asdict(s) for s in self.averaged],
        }, indent=1)


def run_campaign(spec: CampaignSpec, *, cache: Optional[Any] = None,
                 workers: Optional[int] = None,
                 progress: Optional[Callable[[str], None]] = None,
                 device: "torch.device | str" = "cuda"
                 ) -> CampaignResult:
    """Execute a campaign grid as batched work.

    ``cache`` is a cache object (a ``data`` dict of ``key -> dict`` plus
    a ``save()`` method): each freshly-computed group is written through
    and saved as it completes, so an interrupted campaign resumes.  The
    cache unit is the *group*: hits are only served when every cell of
    a group is present, otherwise the whole group re-runs (and
    overwrites any partial entries) — a group's seeds always stack
    behind the same pilot lane, so a cached cell's numbers never depend
    on which cells happened to be computed before an interruption.  Every group runs
    in-process, one after another; ``workers``, the reference's bound on
    its process fan-out, is accepted for call compatibility and ignored
    (a forked child of a process that holds a CUDA context cannot use
    the card, and one card gains nothing from several processes).  Seeds
    within a group never fan out — they run stacked in one engine loop,
    which is where the batching win comes from."""
    device = resolve_device(device)
    # wall_s is campaign telemetry (how long the run took), reported
    # alongside results, never fed into them
    t0 = time.time()
    cells = spec.cells()
    for c in cells:
        c.experiment()   # validate the whole grid before burning time
    say = progress or (lambda msg: None)
    summaries: dict[int, Summary] = {}
    n_cached = 0
    by_group: dict[tuple, list[int]] = {}
    for i, c in enumerate(cells):
        by_group.setdefault(c.group_key(), []).append(i)
    fields = {f.name for f in dataclasses.fields(Summary)}

    def rehydrate(h: object) -> Optional[Summary]:
        # a cached dict from another Summary schema generation (field
        # added/removed/renamed) is a cache miss, not a crash or a
        # silently-defaulted mixture
        if not isinstance(h, dict) or set(h) != fields:
            return None
        return Summary(**h)

    todo: dict[tuple, list[int]] = {}
    for gkey, idxs in by_group.items():
        hits = ([rehydrate(cache.data.get(cell_key(cells[i])))
                 for i in idxs] if cache is not None else [None])
        if all(h is not None for h in hits):
            for i, h in zip(idxs, hits):
                summaries[i] = h
            n_cached += len(idxs)
        else:
            todo[gkey] = idxs
    say(f"{len(cells)} cells: {n_cached} cached, "
        f"{len(todo)} group(s) to run")

    # largest groups first, as the reference orders its fan-out
    groups = sorted(todo.values(),
                    key=lambda idxs: -cells[idxs[0]].total_messages
                    * len(idxs) * cells[idxs[0]].n_consumers)
    for idxs in groups:
        dicts = _run_group([cells[i] for i in idxs], device)
        for i, d in zip(idxs, dicts):
            summaries[i] = Summary(**d)
            if cache is not None:
                cache.data[cell_key(cells[i])] = d
        if cache is not None:
            cache.save()         # one write per finished group
        say(f"group {cells[idxs[0]].group_key()[:4]} done")

    ordered = [summaries[i] for i in range(len(cells))]
    n_fallback = sum(
        1 for c, s in zip(cells, ordered)
        if s.engine and s.engine != c.experiment().params.engine)
    if n_fallback:
        import warnings
        warnings.warn(
            f"campaign {spec.name!r}: {n_fallback}/{len(cells)} cell(s) "
            f"fell back from the requested engine (see Summary.engine); "
            f"reported numbers are NOT from the engine you asked for",
            RuntimeWarning, stacklevel=2)
    grouped: dict[tuple, list[Summary]] = {}
    for c, s in zip(cells, ordered):
        grouped.setdefault(c.group_key(), []).append(s)
    averaged = [average_summaries(ss) for ss in grouped.values()]
    return CampaignResult(spec=spec, cells=cells, summaries=ordered,
                          averaged=averaged, wall_s=time.time() - t0,
                          n_cached=n_cached, n_fallback=n_fallback)
