"""The port's experiment layer (``repro_torch.core.patterns``, the metrics
of ``repro_torch.core.metrics`` and the band table
``repro_torch.core.parity``) against the reference's
``repro.core.patterns`` on its ``VectorizedStreamSim``, on the CPU.

* **chaos drivers**: ``chaos_cell`` field by field for every (arch,
  scenario), with the reference's refusals; ``chaos_campaign`` and
  ``availability_crossover`` at the bench's smoke size, every field of
  every point, ``inf == inf`` for ``recovery_s``, and the crossover
  duration at 1e-9; ``engine="jax"`` falls back on the chaos cells alone;
* **tenancy drivers**: ``deployment_feasibility`` and ``multi_tenant``
  at two tenant counts, every ``TenantPoint`` field, the ingress
  utilization (the cost model kept on the port's cell) included;
* **``overflow_stress``, ``run_pattern`` and ``sweep``** at the default
  engine: the reference's results at rtol 1e-12, counters exact, with a
  custom calibration threaded through ``run_experiment``;
* **the wave path**: the same drivers with ``engine="jax",
  jax_device_loop=True`` take the wave program (asserted), equal the
  reference's wave pipeline at 1e-12, and work sharing sits inside the
  ``device_loop.*`` bands of the reference's cohort engine;
* **metrics**: ``average_summaries`` and the seven metrics the drivers
  use equal the reference's on the same results;
* **devices**: every driver raises without a GPU unless called with
  ``device="cpu"``.

Cohort results must match at rtol 1e-12 (the CPU port is the reference's
arithmetic); the reference's ``engine="jax"`` cannot run here (its
compiled programs need ``jax.experimental.enable_x64``), so wave runs are
held to its NumPy wave pipeline, and to its cohort engine within the
modeling bands where the wave model holds them.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import jax_engine  # noqa: F401  (registers "jax" in ENGINES)
from repro.core import metrics as ref_metrics
from repro.core import jax_device_loop as jdl
from repro.core import parity as ref_parity
from repro.core import patterns as ref_pat
from repro.core import vectorized as ref_vec
from repro.core.architectures import Calibration as RefCalibration
from repro.core.simulator import ExperimentSpec as RefSpec
from repro.core.simulator import RunResult as RefResult
from repro.core.simulator import SimParams as RefParams
from repro.core.workloads import get_workload as ref_workload
from repro_torch.core import metrics as port_metrics
from repro_torch.core import parity as port_parity
from repro_torch.core import patterns as port_pat
from repro_torch.core import run as port_run
from repro_torch.core.architectures import Calibration
from repro_torch.core.simulator import RunResult
from repro_torch.core.torch_engine import TorchStreamSim
from test_torch_chaos import _port_spec
from test_torch_cohort_engine import _assert_results_match

RTOL = 1e-12
#: the bench's smoke size (``bench_chaos.py``'s ``CHAOS_BENCH_SMOKE``)
CHAOS_SMALL = dict(total_messages=512, t0=1.0, t1=3.0)
AVAIL_SMALL = dict(total_messages=512, durations=(2.0, 8.0), t0=1.0)
TENANT_SMALL = dict(tenant_counts=(1, 4), messages_per_tenant=64, n_runs=2)
WAVE = dict(engine="jax", jax_device_loop=True)
#: every arch with a chaos link target, each scenario and the baseline
CHAOS_CELLS = [(a, s) for a in sorted(ref_pat.CHAOS_LINK_TARGETS)
               for s in ("baseline",) + ref_pat.CHAOS_SCENARIOS]


def _same(a, b, what, rtol=RTOL):
    """Two dataclass points field by field: floats at ``rtol`` (NaN equal
    to NaN, inf to inf), everything else exactly."""
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, float):
            assert isinstance(x, (float, int)), (what, f.name)
            if math.isnan(y) or math.isinf(y):
                assert x == y or (math.isnan(x) and math.isnan(y)), \
                    (what, f.name, x, y)
            else:
                assert x == pytest.approx(y, rel=rtol, abs=0), \
                    (what, f.name, x, y)
        else:
            assert x == y, (what, f.name, x, y)


def _same_list(got, want, rtol=RTOL):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        _same(a, b, i, rtol)


@functools.lru_cache(maxsize=None)
def _ref_campaign():
    return ref_pat.chaos_campaign(**CHAOS_SMALL)


# ---------------------------------------------------------------------------
# Chaos drivers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,scenario", CHAOS_CELLS,
                         ids=[f"{a}-{s}" for a, s in CHAOS_CELLS])
def test_chaos_cell_matches_the_reference(arch, scenario):
    want = ref_pat.chaos_cell(arch, scenario, seed=7, jitter=0.01)
    got = port_pat.chaos_cell(arch, scenario, seed=7, jitter=0.01)
    assert got == _port_spec(want)
    assert got.workload.name == want.workload.name == "generic"


@pytest.mark.parametrize("call", [
    lambda m: m.chaos_cell("dts", "meteor"),
    lambda m: m.chaos_cell("nowhere", "tunnel"),
    lambda m: m.chaos_link_target("nowhere"),
    lambda m: m.chaos_cell("dts", "broker", engine="warp"),
], ids=["scenario", "arch", "link target", "engine"])
def test_chaos_cell_refuses_as_the_reference(call):
    msgs = []
    for m in (ref_pat, port_pat):
        with pytest.raises(ValueError) as e:
            call(m)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_chaos_campaign_matches_the_reference():
    got = port_pat.chaos_campaign(device="cpu", **CHAOS_SMALL)
    want = _ref_campaign()
    assert len(got) == 15
    _same_list(got, want)
    assert {p.engine for p in got} == {"vectorized"}
    assert any(p.recovery_s == math.inf for p in got)


def test_jax_chaos_campaign_falls_back_on_the_chaos_cells_alone():
    """``engine="jax"``: the broker cell is rewritten to the vectorized
    engine (as the reference's ``run_many`` rewrites it), the baseline
    stays a jax cell on the per-cohort engine; the numbers are the
    default campaign's."""
    got = port_pat.chaos_campaign(("dts",), ("broker",), engine="jax",
                                  device="cpu", **CHAOS_SMALL)
    want = [p for p in _ref_campaign()
            if p.arch == "dts" and p.scenario in ("baseline", "broker")]
    assert [p.engine for p in got] == ["jax", "vectorized"]
    _same_list([dataclasses.replace(p, engine="vectorized") for p in got],
               want)


def test_availability_crossover_matches_the_reference():
    got = port_pat.availability_crossover(device="cpu", **AVAIL_SMALL)
    want = ref_pat.availability_crossover(**AVAIL_SMALL)
    assert (got.archs, got.durations) == (want.archs, want.durations)
    assert set(got.curves) == set(want.curves) == {"dts", "mss"}
    for arch in want.curves:
        _same_list(got.curves[arch], want.curves[arch])
    assert got.crossover_duration_s == pytest.approx(
        want.crossover_duration_s, rel=1e-9)
    assert 2.0 < got.crossover_duration_s < 8.0
    assert got.headline() == want.headline()


# ---------------------------------------------------------------------------
# Tenancy drivers
# ---------------------------------------------------------------------------


def test_deployment_feasibility_matches_the_reference():
    got = port_pat.deployment_feasibility(device="cpu", **TENANT_SMALL)
    want = ref_pat.deployment_feasibility(**TENANT_SMALL)
    assert (got.archs, got.tenant_counts) == (want.archs, want.tenant_counts)
    for arch in want.archs:
        _same_list(got.curves[arch], want.curves[arch])
    for a, b in ((got.crossover_tenants, want.crossover_tenants),
                 (got.crossover_utilization, want.crossover_utilization)):
        assert a == pytest.approx(b, rel=RTOL, nan_ok=True)
    assert got.headline() == want.headline()
    assert all(0 < p.ingress_utilization <= 1
               for pts in got.curves.values() for p in pts)


def test_multi_tenant_shared_queues_match_the_reference():
    """Shared work queues mix the tenants' messages; the baseline tenant
    count lies outside the sweep and is run besides."""
    kw = dict(isolation="shared", messages_per_tenant=64, n_runs=2,
              jitter=0.05)
    got = port_pat.multi_tenant("prs-haproxy", (2, 4), device="cpu", **kw)
    want = ref_pat.multi_tenant("prs-haproxy", (2, 4), **kw)
    _same_list(got, want)
    assert [p.tenants for p in got] == [2, 4]
    assert all(0 < p.fairness <= 1 and 0 < p.degradation for p in got)


def test_crossover_point_matches_the_reference():
    def pts(m, thr):
        return [m.TenantPoint(T, "vhost", "x", "dstream", True,
                              tenant_throughput_msgs_s=v,
                              ingress_utilization=0.1 * T)
                for T, v in zip((1, 4, 16, 64), thr)]
    for a, b in (((9, 7, 5, 3), (6, 6, 6, 6)), ((1, 1, 1, 1), (2, 2, 2, 2)),
                 ((9, 9, 9, 9), (1, 1, 1, 1))):
        got = port_pat.crossover_point(pts(port_pat, a), pts(port_pat, b))
        want = ref_pat.crossover_point(pts(ref_pat, a), pts(ref_pat, b))
        np.testing.assert_allclose(got, want, rtol=RTOL)


# ---------------------------------------------------------------------------
# Cohort path: overflow_stress, run_pattern, sweep
# ---------------------------------------------------------------------------


def test_overflow_stress_matches_the_reference():
    kw = dict(total_messages=1024, queue_cap_msgs=24, n_runs=2)
    got = port_pat.overflow_stress("dts", 2, device="cpu", **kw)
    want = ref_pat.overflow_stress("dts", 2, **kw)
    _assert_results_match(got, want)
    assert all(r.rejected_publishes > 0 for r in got)
    assert got[0].spec.params.queue_max_bytes == \
        24 * repro_torch.get_workload("dstream").payload_bytes


PATTERN_CELLS = [("work_sharing", "dts", "dstream", 4, 1024),
                 ("feedback", "mss", "lstream", 2, 256),
                 ("broadcast", "prs-haproxy", "generic", 3, 32),
                 ("broadcast_gather", "dts", "generic", 2, 48)]


@pytest.mark.parametrize("cell", PATTERN_CELLS,
                         ids=[c[0] for c in PATTERN_CELLS])
def test_run_pattern_matches_the_reference(cell):
    pattern, arch, wl, nc, msgs = cell
    got = port_pat.run_pattern(pattern, arch, wl, nc, total_messages=msgs,
                               n_runs=2, device="cpu")
    want = ref_pat.run_pattern(pattern, arch, wl, nc, total_messages=msgs,
                               n_runs=2)
    _assert_results_match(got, want)
    _same_list([repro_torch.summarize(r) for r in got],
               [ref_metrics.summarize(r) for r in want])
    assert {r.spec.params.engine for r in got} == {"vectorized"}


def test_run_pattern_threads_a_calibration_as_the_reference():
    kw = dict(total_messages=512, n_runs=1, seed=3)
    cal = dict(dsn_link_gbps=0.9, frame_bytes=4000)
    got = port_pat.run_pattern("feedback", "dts", "dstream", 2, device="cpu",
                               cal=Calibration(**cal), **kw)
    want = ref_pat.run_pattern("feedback", "dts", "dstream", 2,
                               cal=RefCalibration(**cal), **kw)
    _assert_results_match(got, want)
    plain = ref_pat.run_pattern("feedback", "dts", "dstream", 2, **kw)
    assert got[0].sim_time != pytest.approx(plain[0].sim_time, rel=1e-3)


def test_sweep_matches_the_reference():
    kw = dict(consumers=(1, 4), total_messages=512, n_runs=2)
    got = port_pat.sweep("feedback", ("dts", "prs-haproxy"), "dstream",
                         device="cpu", **kw)
    want = ref_pat.sweep("feedback", ("dts", "prs-haproxy"), "dstream", **kw)
    _same_list(got, want)
    assert [s.n_runs for s in got] == [2] * 4
    assert {s.engine for s in got} == {"vectorized"}


# ---------------------------------------------------------------------------
# The wave path
# ---------------------------------------------------------------------------


@pytest.fixture
def wave_spy(monkeypatch):
    """Records the cells ``run_wave_cells`` gets and the cohort runs."""
    waves = []
    real = port_run.dl.run_wave_cells

    def spy(cells, device):
        waves.extend(cells)
        return real(cells, device)

    monkeypatch.setattr(port_run.dl, "run_wave_cells", spy)
    runs = TorchStreamSim.stats["runs"]
    yield waves, lambda: TorchStreamSim.stats["runs"] - runs


def _ref_wave(spec):
    """The reference's wave pipeline for one solo spec: build_static ->
    NumPy trace -> assemble."""
    sim = ref_vec.VectorizedStreamSim(spec)
    ws = jdl.build_static(sim)
    return jdl._assemble(sim, ws, jdl.run_wave_trace(
        ws, jdl.draw_jitter(sim, ws), backend="numpy"))[0]


WAVE_CELLS = {
    # 64 messages a producer lie in the feedback corridor W < M <= 2W at
    # a confirm window of 32; the publish round of 8 is stated, since at
    # 8 clients the saturation rule would shrink it to 2, below the
    # gate's floor
    "feedback": dict(confirm_window=32, vec_round=8),
    "work_sharing": dict(confirm_window=32),
}


@pytest.mark.parametrize("pattern", sorted(WAVE_CELLS))
def test_run_pattern_on_the_wave_program(pattern, wave_spy):
    """Each seed runs solo through ``run_experiment`` on the wave program
    and equals the reference's wave pipeline at 1e-12.  Work sharing sits
    inside the ``device_loop.*`` bands of the reference's cohort run;
    feedback with as many producers as consumers (the cells
    ``run_pattern`` builds) is accepted by the gate of both packages but
    departs from the cohort engine by more than its band, so it is held
    to the reference's wave pipeline alone."""
    waves, cohort_runs = wave_spy
    kw = dict(total_messages=256, n_runs=2, **WAVE_CELLS[pattern])
    got = port_pat.run_pattern(pattern, "dts", "dstream", 4, device="cpu",
                               **WAVE, **kw)
    assert len(waves) == 2 and cohort_runs() == 0
    assert [c.stack_seeds for c in waves] == [[0], [1000]]
    wave = [_ref_wave(ref_pat.pattern_spec(
        pattern, "dts", "dstream", 4, total_messages=256,
        seed=r.spec.params.seed, **WAVE_CELLS[pattern])) for r in got]
    _assert_results_match(got, wave)
    sg = [repro_torch.summarize(r) for r in got]
    assert {s.engine for s in sg} == {"jax"}
    if pattern == "work_sharing":
        want = ref_pat.run_pattern(pattern, "dts", "dstream", 4, **kw)
        for a, b in zip(sg, map(ref_metrics.summarize, want)):
            dev = abs(a.throughput_msgs_s - b.throughput_msgs_s) / \
                b.throughput_msgs_s
            assert dev <= port_parity.band("device_loop.all.throughput")


def test_sweep_on_the_wave_program_routes_each_cell(wave_spy):
    """Feedback on dts takes the wave program (the reference's wave
    pipeline at 1e-12); on mss the gate refuses feedback, so that cell
    runs the per-cohort engine, still reported as the jax engine, and
    equals the reference's cohort run."""
    waves, cohort_runs = wave_spy
    kw = dict(total_messages=256, n_runs=1, **WAVE_CELLS["feedback"])
    got = port_pat.sweep("feedback", ("dts", "mss"), "dstream", (4,),
                         device="cpu", **WAVE, **kw)
    want = ref_pat.sweep("feedback", ("dts", "mss"), "dstream", (4,), **kw)
    assert [c.spec.arch for c in waves] == ["dts"] and cohort_runs() == 1
    wave = ref_metrics.summarize(_ref_wave(ref_pat.pattern_spec(
        "feedback", "dts", "dstream", 4, total_messages=256,
        **WAVE_CELLS["feedback"])))
    for a, b in zip(got, (wave, want[1])):
        assert a.engine == "jax"
        _same(dataclasses.replace(a, engine="vectorized"), b, a.arch)


# ---------------------------------------------------------------------------
# Metrics and bands
# ---------------------------------------------------------------------------


def _results(seed):
    """The same random results in both packages: a 3-tenant feedback
    cell and an infeasible one."""
    rng = np.random.default_rng(seed)
    kw = dict(pattern="feedback", arch="mss", n_producers=6, n_consumers=6,
              total_messages=600, tenants=3, tenant_isolation="vhost")
    ct = np.sort(rng.uniform(0, 9, 600))
    rt = rng.gamma(2.0, 0.3, 600)
    cp, rp = rng.integers(0, 6, 600), rng.integers(0, 6, 600)
    arrays = dict(consume_times=ct, rtts=rt, consume_producers=cp,
                  rtt_producers=rp, rejected_publishes=int(seed),
                  blocked_confirms=2)
    ref = RefSpec(workload=ref_workload("dstream"),
                  params=RefParams(seed=seed), **kw)
    port = repro_torch.ExperimentSpec(
        workload=repro_torch.get_workload("dstream"),
        params=repro_torch.SimParams(seed=seed), **kw)
    return ([RefResult(spec=ref, feasible=True, **arrays),
             RefResult(spec=ref, feasible=False)],
            [RunResult(spec=port, feasible=True, **arrays),
             RunResult(spec=port, feasible=False)])


def test_metrics_match_the_reference_exactly():
    for seed in (0, 1, 2):
        (rr, rbad), (pr, pbad) = _results(seed)
        for name in ("tenant_throughputs", "tenant_median_rtts"):
            np.testing.assert_array_equal(
                getattr(port_metrics, name)(pr),
                getattr(ref_metrics, name)(rr), err_msg=name)
        for a, b in zip(port_metrics.rtt_cdf(pr), ref_metrics.rtt_cdf(rr)):
            np.testing.assert_array_equal(a, b)
        for thr in (0.1, 0.7, 5.0):
            assert port_metrics.rtt_fraction_under(pr, thr) == \
                ref_metrics.rtt_fraction_under(rr, thr)
        v = ref_metrics.tenant_throughputs(rr)
        for vals in (v, [0.0, 0.0], [1.0, np.nan, 3.0], []):
            a = port_metrics.jain_fairness(vals)
            b = ref_metrics.jain_fairness(vals)
            assert a == b or (math.isnan(a) and math.isnan(b))
        for args in ((3.0, 6.0, True), (3.0, 6.0, False), (0.0, 1.0, True),
                     (np.nan, 1.0, False)):
            a = port_metrics.overhead_vs_baseline(*args)
            b = ref_metrics.overhead_vs_baseline(*args)
            assert a == b or (math.isnan(a) and math.isnan(b))
        _same(port_metrics.summarize(pbad), ref_metrics.summarize(rbad),
              "infeasible", rtol=0)


def test_average_summaries_and_overhead_table_match_the_reference():
    ss = {"ref": [], "port": []}
    for arch in ("dts", "mss"):
        for seed in (0, 1, 2):
            (rr, rbad), (pr, pbad) = _results(seed)
            rr.spec.arch = pr.spec.arch = arch
            ss["ref"] += [ref_metrics.summarize(rr)]
            ss["port"] += [port_metrics.summarize(pr)]
    ss["port"][4].engine = ss["ref"][4].engine = "jax"
    for lo, hi in ((0, 3), (3, 6)):
        _same(port_pat.average_summaries(ss["port"][lo:hi]),
              ref_pat.average_summaries(ss["ref"][lo:hi]), (lo, hi), rtol=0)
    (rr, rbad), (pr, pbad) = _results(5)
    _same(port_pat.average_summaries([port_metrics.summarize(pbad)]),
          ref_pat.average_summaries([ref_metrics.summarize(rbad)]),
          "infeasible", rtol=0)
    for metric in ("throughput_msgs_s", "median_rtt_s"):
        assert port_metrics.overhead_table(ss["port"], metric) == \
            ref_metrics.overhead_table(ss["ref"], metric)


def test_parity_bands_are_the_reference_table():
    assert port_parity.PARITY_BANDS == ref_parity.PARITY_BANDS
    assert port_parity.FACTOR_BANDS == ref_parity.FACTOR_BANDS
    assert port_parity.band("device_loop.all.throughput") == \
        ref_parity.band("device_loop.all.throughput")
    assert port_parity.factor_band("chaos.all.redelivered") == \
        ref_parity.factor_band("chaos.all.redelivered")
    for m in (port_parity, ref_parity):
        with pytest.raises(KeyError, match="unknown parity band"):
            m.band("nope")
        with pytest.raises(KeyError, match="unknown factor band"):
            m.factor_band("nope")


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------


DRIVERS = {
    "run_pattern": lambda: port_pat.run_pattern(
        "work_sharing", "dts", "dstream", 1, total_messages=16, n_runs=1),
    "sweep": lambda: port_pat.sweep("work_sharing", ("dts",), "dstream",
                                    (1,), total_messages=16, n_runs=1),
    "overflow_stress": lambda: port_pat.overflow_stress("dts", 1),
    "multi_tenant": lambda: port_pat.multi_tenant("mss", (1,), n_runs=1),
    "deployment_feasibility": lambda: port_pat.deployment_feasibility(
        tenant_counts=(1,), n_runs=1),
    "chaos_campaign": lambda: port_pat.chaos_campaign(("dts",), ("broker",)),
    "availability_crossover": lambda: port_pat.availability_crossover(
        durations=(2.0,)),
    "run_campaign": lambda: repro_torch.run_campaign(
        repro_torch.CampaignSpec(name="x", n_runs=1, total_messages=16)),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_drivers_default_to_cuda_and_raise_without_it(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DRIVERS[name]()
