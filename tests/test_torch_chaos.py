"""Chaos schedules in the port's per-cohort engine
(``repro_torch.core.chaos``, ``repro_torch.core.torch_engine``) against the
reference's ``repro.core.chaos`` and its NumPy ``VectorizedStreamSim``, on
the CPU.

* **module copy**: the reference's validation cases raise in both
  packages; ``from_dict``, ``boundaries``, ``outage_span``,
  ``coerce_chaos`` (and ``SimParams(chaos=dict)``) agree;
  ``recovery_time`` and ``chaos_metrics`` equal the reference's on its
  own cases and on seeded random arrays;
* **validation and routing**: chaos cells do not stack; bad link,
  consumer and broker targets raise as the reference does; a chaos cell
  the wave gate would take without its schedule runs the cohort engine,
  and two seeds of one chaos cell run as two solo runs (a cell that asks
  for the wave program is rewritten to the vectorized engine, as the
  reference's ``run_many`` rewrites it);
* **whole runs**: the campaign's 12 chaos cells (tunnel, broker,
  consumer, autoscale on dts, prs-haproxy and mss) at the bench's smoke
  size (512 messages, outage [1, 3) s) through ``run_many`` give the
  reference's clocks at rtol 1e-12 and its counters exactly, with
  nothing lost and every duplicate a redelivery; the three baselines,
  which the wave gate would take at this size (128 messages a producer),
  run the cohort engine through ``run_many`` at the default engine; a
  broker fault on a node that homes no queue is the baseline;
* **seams**: the broker-target grammar, a link outage on a pool and on a
  pipe, and admission during an outage (the fast path, the walk and a
  non-pilot lane's retry cadence) leave the reference's state;
* **the smoke's specs**: the 15 full-size cells of ``chip_smoke.py``'s
  chaos campaign and its cross-check cells, built by the port's
  ``patterns.chaos_cell``, equal the reference's;
* on the card (``gpu`` marker), the smoke's chaos cross-check cells on
  the GPU against the CPU at the cross-device tolerance, counters exact.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

# the reference runs on the CPU also where a GPU is present: the
# tolerances here are set against its CPU results
jax.config.update("jax_platforms", "cpu")

import repro_torch
from repro.core import chaos as ref_chaos
from repro.core import vectorized as ref_vec
from repro.core.architectures import ResourceSpec as RefResourceSpec
from repro.core.patterns import CHAOS_SCENARIOS, chaos_cell
from repro.core.simulator import RunResult as RefResult
from repro.core.simulator import SimParams as RefParams
from repro_torch.core import chaos as port_chaos
from repro_torch.core import patterns as port_pat
from repro_torch.core import run as port_run
from repro_torch.core import torch_device_loop as dl
from repro_torch.core import torch_engine as te
from repro_torch.core.architectures import ResourceSpec
from repro_torch.core.cell import WaveCell
from repro_torch.core.simulator import RunResult
from repro_torch.core.torch_engine import Times, TorchStreamSim
from test_torch_cohort_engine import XDEV_RTOL, _assert_results_match

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("dts", "prs-haproxy", "mss")
#: the bench's smoke size (``bench_chaos.py``, ``CHAOS_BENCH_SMOKE``)
MSGS, T0, T1 = 512, 1.0, 3.0
#: the campaign's chaos cells (each arch's baseline beside them)
CELLS = [(a, s) for a in ARCHS for s in CHAOS_SCENARIOS]


def _port_chaos(sched):
    """The reference's schedule as the port's type (None stays None)."""
    if sched is None:
        return None
    return repro_torch.ChaosSchedule.from_dict(dataclasses.asdict(sched))


def _port_spec(ref, **params):
    """The reference's spec as the port's, ``params`` overriding."""
    fields = {f.name for f in dataclasses.fields(repro_torch.SimParams)}
    kw = {k: v for k, v in vars(ref.params).items() if k in fields}
    kw["chaos"] = _port_chaos(ref.params.chaos)
    kw.update(params)
    return repro_torch.ExperimentSpec(
        pattern=ref.pattern, workload=repro_torch.get_workload(
            ref.workload.name), arch=ref.arch, n_producers=ref.n_producers,
        n_consumers=ref.n_consumers, total_messages=ref.total_messages,
        tenants=ref.tenants, tenant_isolation=ref.tenant_isolation,
        params=repro_torch.SimParams(**kw))


def _cell(arch, scenario, **kw):
    kw.setdefault("total_messages", MSGS)
    return chaos_cell(arch, scenario, t0=T0, t1=T1, **kw)


@functools.lru_cache(maxsize=None)
def _ref_sim(arch, scenario):
    """The reference engine after its run, and the run's result."""
    sim = ref_vec.VectorizedStreamSim(_cell(arch, scenario))
    return sim, sim.run()


def _ref_run(arch, scenario):
    return _ref_sim(arch, scenario)[1]


def _with_chaos(ref, sched):
    return dataclasses.replace(ref, params=dataclasses.replace(
        ref.params, chaos=sched))


# ---------------------------------------------------------------------------
# The module copy
# ---------------------------------------------------------------------------

BAD = {
    "kind": (lambda m: m.Injection("disk", "x", 1.0, 2.0),
             "unknown injection kind"),
    "empty target": (lambda m: m.Injection("link", "", 1.0, 2.0),
                     "non-empty"),
    "t0 == t1": (lambda m: m.Injection("link", "ttun", 2.0, 2.0), "t0 < t1"),
    "t0 < 0": (lambda m: m.Injection("link", "ttun", -1.0, 2.0), "t0 < t1"),
    "thresholds": (lambda m: m.AutoscalePolicy(high_backlog=4,
                                               low_backlog=8),
                   "high_backlog"),
    "interval": (lambda m: m.AutoscalePolicy(interval_s=0.0), "interval_s"),
    "step": (lambda m: m.AutoscalePolicy(step=0), "max_consumers and step"),
    "nothing": (lambda m: m.ChaosSchedule(), "at least one"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validation_raises_as_the_reference(case):
    make, match = BAD[case]
    msgs = []
    for mod in (ref_chaos, port_chaos):
        with pytest.raises(ValueError, match=match) as e:
            make(mod)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


SCHED = {
    "injections": [{"kind": "link", "target": "ttun", "t0": 3.0, "t1": 7.0},
                   {"kind": "broker", "target": "queue:work:1",
                    "t0": 1.0, "t1": 9.0},
                   {"kind": "consumer", "target": "c2", "t0": 3.0,
                    "t1": 4.0}],
    "autoscale": {"interval_s": 0.5, "high_backlog": 32, "low_backlog": 4,
                  "max_consumers": 8, "step": 2}}


def test_schedule_helpers_match_the_reference():
    r, p = (m.ChaosSchedule.from_dict(SCHED) for m in (ref_chaos, port_chaos))
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert p.boundaries() == r.boundaries() == [1.0, 3.0, 3.0, 4.0, 7.0, 9.0]
    assert p.outage_span() == r.outage_span() == (1.0, 9.0)
    auto = {"autoscale": SCHED["autoscale"]}
    assert (port_chaos.ChaosSchedule.from_dict(auto).outage_span()
            == ref_chaos.ChaosSchedule.from_dict(auto).outage_span()
            == (0.0, 0.0))
    assert port_chaos.VALID_KINDS == ref_chaos.VALID_KINDS
    assert repro_torch.ChaosSchedule is port_chaos.ChaosSchedule


def test_coerce_chaos_and_sim_params_as_the_reference():
    s = port_chaos.coerce_chaos(SCHED)
    assert dataclasses.asdict(s) == dataclasses.asdict(
        ref_chaos.coerce_chaos(SCHED))
    assert port_chaos.coerce_chaos(s) is s
    assert port_chaos.coerce_chaos(None) is None
    for mod in (ref_chaos, port_chaos):
        with pytest.raises(TypeError):
            mod.coerce_chaos("ttun")
    assert repro_torch.SimParams(chaos=SCHED).chaos == s
    assert repro_torch.SimParams(chaos=s).chaos is s
    assert dataclasses.asdict(repro_torch.SimParams(chaos=SCHED).chaos) == \
        dataclasses.asdict(RefParams(chaos=SCHED).chaos)


RECOVERY = {
    "catches up": ([1.0, 2.0, 3.0, 4.0, 7.5, 8.0, 8.5, 9.0, 9.5], 1.5),
    "never": ([1.0, 2.0, 3.0, 4.0, 9.0, 14.0], float("inf")),
    "nothing before": ([8.0, 9.0], 0.0),
    "empty": ([], 0.0),
}


@pytest.mark.parametrize("case", sorted(RECOVERY) + ["random-0", "random-1",
                                                     "random-2"])
def test_recovery_time_matches_the_reference(case):
    if case in RECOVERY:
        ts, want = RECOVERY[case]
        ts, t_fail, t_rest = np.array(ts), 5.0, 7.0
    else:
        rng = np.random.default_rng(int(case[-1]))
        ts = rng.uniform(0, 20, 400)
        ts[rng.uniform(size=400) < 0.05] = np.inf
        t_fail = float(rng.uniform(2, 8))
        t_rest = t_fail + float(rng.uniform(0.5, 6))
        want = None
    got = port_chaos.recovery_time(ts, t_fail, t_rest)
    assert got == ref_chaos.recovery_time(ts, t_fail, t_rest)
    if want is not None:
        assert got == pytest.approx(want)


@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_metrics_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    ref = _cell("mss", "broker", total_messages=300)
    n = 300 + int(rng.integers(0, 20))
    kw = dict(feasible=True, consume_times=rng.uniform(0, 12, n),
              redelivered=int(rng.integers(20, 30)),
              rejected_publishes=int(rng.integers(0, 500)))
    rr = RefResult(spec=ref, **kw)
    pr = RunResult(spec=_port_spec(ref), **kw)
    for base in (0, 7):
        got = port_chaos.chaos_metrics(pr, pr.spec.params.chaos, base)
        want = ref_chaos.chaos_metrics(rr, ref.params.chaos, base)
        assert got.as_row() == want.as_row()


# ---------------------------------------------------------------------------
# Validation and routing
# ---------------------------------------------------------------------------


def test_chaos_cells_do_not_stack():
    spec = _port_spec(_cell("dts", "broker", total_messages=64))
    with pytest.raises(ValueError, match="do not stack"):
        TorchStreamSim(spec, stack_seeds=[0, 1], device="cpu")


BAD_TARGETS = {
    "link": ("dts", 1, ref_chaos.Injection("link", "warp_core", 1.0, 2.0)),
    "queue": ("dts", 1, ref_chaos.Injection("broker", "queue:nope", 1.0,
                                            2.0)),
    "queue index": ("mss", 1, ref_chaos.Injection("broker", "queue:work:7",
                                                  1.0, 2.0)),
    "node": ("dts", 1, ref_chaos.Injection("broker", "node:99", 1.0, 2.0)),
    "grammar": ("dts", 1, ref_chaos.Injection("broker", "disk:0", 1.0, 2.0)),
    "consumer": ("dts", 1, ref_chaos.Injection("consumer", "c99", 1.0, 2.0)),
    "consumer tenants": ("prs-haproxy", 2,
                         ref_chaos.Injection("consumer", "c1", 1.0, 2.0)),
}


@pytest.mark.parametrize("case", sorted(BAD_TARGETS))
def test_bad_targets_raise_as_the_reference(case):
    arch, tenants, inj = BAD_TARGETS[case]
    ref = dataclasses.replace(
        _cell(arch, "baseline", total_messages=64), tenants=tenants)
    ref = _with_chaos(ref, ref_chaos.ChaosSchedule(injections=(inj,)))
    msgs = []
    for run in (lambda: ref_vec.VectorizedStreamSim(ref).run(),
                lambda: repro_torch.run_many([_port_spec(ref)],
                                             device="cpu")):
        with pytest.raises(ValueError) as e:
            run()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_chaos_cell_the_wave_gate_would_take_runs_the_cohort_engine(
        monkeypatch):
    """Without its schedule the cell is the wave program's; with it, the
    gate refuses it with the reason and ``run_many`` runs it solo on the
    cohort engine, which equals the reference.  The cell asks for the
    wave program (``engine="jax", jax_device_loop=True``): ``run_many``
    rewrites it to the vectorized engine, as the reference's does."""
    ref = _cell("dts", "consumer")
    spec = _port_spec(ref, engine="jax", jax_device_loop=True)
    assert dl._device_loop_ok(WaveCell(_port_spec(ref, chaos=None)))[0]
    ok, why = dl._device_loop_ok(WaveCell(spec))
    assert not ok and "chaos" in why
    waves = []
    real = port_run.dl.run_wave_cells
    monkeypatch.setattr(port_run.dl, "run_wave_cells",
                        lambda cells, device: (waves.extend(cells),
                                               real(cells, device))[1])
    runs = TorchStreamSim.stats["runs"]
    got = repro_torch.run_many([spec], device="cpu")
    assert not waves and TorchStreamSim.stats["runs"] == runs + 1
    assert got[0].spec.params.engine == "vectorized"
    _assert_results_match(got, [_ref_run("dts", "consumer")])


def test_two_seeds_of_a_chaos_cell_run_solo():
    """Chaos cells never stack: two seeds give two solo runs, each the
    reference's (jitter on, so the seeds differ)."""
    refs = [_cell("prs-haproxy", "broker", seed=s, jitter=0.03)
            for s in (0, 1000)]
    runs = TorchStreamSim.stats["runs"]
    got = repro_torch.run_many([_port_spec(r) for r in refs], device="cpu")
    assert TorchStreamSim.stats["runs"] == runs + 2
    want = [ref_vec.VectorizedStreamSim(r).run() for r in refs]
    _assert_results_match(got, want)
    assert not np.array_equal(got[0].consume_times, got[1].consume_times)


# ---------------------------------------------------------------------------
# Whole runs
# ---------------------------------------------------------------------------


def _conserves(r, scenario):
    m = port_chaos.chaos_metrics(r, r.spec.params.chaos)
    assert m.lost == 0
    assert r.n_consumed == MSGS + m.duplicates
    assert m.duplicates <= r.redelivered
    if scenario == "broker":
        assert r.redelivered > 0 and r.rejected_publishes > 0
    if scenario in ("tunnel", "autoscale"):
        assert r.redelivered == 0


@pytest.mark.parametrize("arch,scenario", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_campaign_cell_matches_the_reference(arch, scenario):
    got = repro_torch.run_many([_port_spec(_cell(arch, scenario))],
                               device="cpu")
    _assert_results_match(got, [_ref_run(arch, scenario)])
    _conserves(got[0], scenario)
    if scenario == "autoscale":
        # the reference's fleet: grown past 2 consumers on dts and
        # prs-haproxy; on mss the backlog never passes the threshold
        sim = TorchStreamSim(got[0].spec, device="cpu")
        sim.run()
        ref = _ref_sim(arch, scenario)[0]
        assert (sim._as_next, sim._as_extra) == (ref._as_next, ref._as_extra)
        assert (sim._as_next > 2) == (arch != "mss")
        assert sim._nch >= sim._as_next


@pytest.mark.parametrize("arch", ARCHS)
def test_baseline_on_the_cohort_engine_matches_the_reference(arch):
    spec = _port_spec(_cell(arch, "baseline"))
    # at 128 messages a producer the wave gate would take the baseline;
    # at the default engine it runs the cohort engine
    assert dl._device_loop_ok(WaveCell(spec))[0]
    runs = TorchStreamSim.stats["runs"]
    got = repro_torch.run_many([spec], device="cpu")[0]
    assert TorchStreamSim.stats["runs"] == runs + 1
    want = _ref_run(arch, "baseline")
    _assert_results_match([got], [want])
    hit = repro_torch.run_many([_port_spec(_cell(arch, "tunnel"))],
                               device="cpu")[0]
    assert 0.0 < hit.sim_time - got.sim_time < T1 - T0


def test_noop_node_fault_matches_the_baseline():
    """A broker node homing no work queue is a no-op fault: the run ends
    when the failure-free one does (its publish rounds are per message,
    as for any broker injection, so its clocks differ in between), and
    it is the reference's."""
    ref = _cell("mss", "baseline", total_messages=256)
    hit = _with_chaos(ref, ref_chaos.ChaosSchedule(
        injections=(ref_chaos.Injection("broker", "node:2", 2.0, 4.0),)))
    got = repro_torch.run_many([_port_spec(hit)], device="cpu")
    _assert_results_match(got, [ref_vec.VectorizedStreamSim(hit).run()])
    base = TorchStreamSim(_port_spec(ref), device="cpu").run()
    assert got[0].sim_time == pytest.approx(base.sim_time, rel=1e-12)
    assert got[0].n_consumed == base.n_consumed == 256
    assert got[0].redelivered == got[0].rejected_publishes == 0


# ---------------------------------------------------------------------------
# Seams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nq,nq_t", [(2, 2), (4, 2), (3, 3)])
def test_queue_indices_follow_the_reference_grammar(nq, nq_t):
    q_home = np.arange(nq) % 3
    targets = (["queue:work:0", f"queue:work:{nq - 1}", "queue:t1/work:1",
                "vhost:t0", "vhost:t1", "queue:work:9", "queue:nope",
                "disk:1", "node:7"]
               + [f"node:{k}" for k in range(3)])
    for tgt in targets:
        out = []
        for cls in (ref_vec.VectorizedStreamSim, TorchStreamSim):
            try:
                out.append(cls._chaos_queue_indices(tgt, nq, nq_t, q_home, 3))
            except ValueError as e:
                out.append(("raises", str(e)))
        assert out[0] == out[1], tgt


@pytest.mark.parametrize("kind", ["pool", "pipe"])
def test_link_outage_holds_a_resource_as_the_reference(kind):
    """Serve, hold until t1 (ties among a pool's servers included), serve
    again: the same end times and carries as the reference's resource
    under its link outage."""
    spec = (dict(key="cpu", kind="pool", servers=4, per_byte_s=1e-10,
                 service_s=3e-5) if kind == "pool"
            else dict(key="nic", kind="pipe", rate_Bps=1.25e9,
                      service_s=2e-5))
    ref = ref_vec.VectorizedStreamSim(_cell("dts", "baseline",
                                            total_messages=64))
    ref.resources = {"r": ref_vec._VecResource(RefResourceSpec(**spec))}
    port = te._VecResource(ResourceSpec(**spec), 1, torch.device("cpu"))
    rng = np.random.default_rng(5)
    for n, t1 in ((6, 0.004), (1, None), (9, 0.0061), (3, None)):
        t = np.sort(rng.uniform(0, 3e-3, n)) + (0 if t1 else 4e-3)
        want = ref.resources["r"].serve(t, 4096.0, np.zeros(n))
        hold = np.full(n, port.hold_times(4096.0))
        end, e0 = port.serve(Times(torch.tensor(t[None]), t.copy()),
                             Times(torch.tensor(hold[None]), hold),
                             torch.from_numpy)
        if e0 is None:
            port.settle(end.numpy()[0])
        np.testing.assert_array_equal(end.numpy()[0], want)
        if t1 is not None:
            ref._chaos_link_down(["r"], t1)
            port.hold_until(t1)
    res = ref.resources["r"]
    if kind == "pool":
        np.testing.assert_array_equal(port.free0, res._free_pool)
        np.testing.assert_array_equal(port.free.numpy()[0, port.rows],
                                      res._free_pool)
    else:
        assert port.free0[0] == port.free.numpy()[0, 0] == res._free_pipe


def _outage_engines(lanes):
    ref_spec = _cell("dts", "baseline", total_messages=600)
    seeds = [0, 1000, 2000][:lanes]
    return (ref_vec.VectorizedStreamSim(ref_spec, stack_seeds=seeds),
            TorchStreamSim(_port_spec(ref_spec), stack_seeds=seeds,
                           device="cpu"))


def _outage_queues(ref, port, lanes):
    qr = ref._queue_state(("w",), [0], 4096, credit=50)
    qp = port._queue_state(("w",), [0], 4096, credit=50, track=True)
    assert qp["track"]
    for q in (qr, qp):
        q["outages"] = [(2.0, 2.5)]
    departs = np.arange(0.5, 4.5, 0.25)[:, None] + 0.01 * np.arange(lanes)
    ref._record_departs(qr, departs)
    qp_t = Times(torch.tensor(departs.T.copy()), departs[:, 0].copy())
    port._record_departs(qp, qp_t)
    qr["n_enq"][:] = qp["n_enq"][:] = 20
    return qr, qp


@pytest.mark.parametrize("arrivals", ["before", "across", "inside"])
def test_admission_during_an_outage_matches_the_reference(arrivals):
    """A solo cohort arriving before, across and inside an outage: the
    fast path where it misses the window, else the walk, which rejects
    every member that arrives while the queue is paused."""
    t = {"before": [0.6, 0.7, 0.8], "across": [1.9, 2.1, 2.6, 2.7],
         "inside": [2.0, 2.2, 2.4]}[arrivals]
    t = np.array(t)[:, None]
    ref, port = _outage_engines(1)
    qr, qp = _outage_queues(ref, port, 1)
    acc, blk = ref._enqueue_batch([qr], t)
    got, got_blk, _ = port._enqueue_batch(
        [qp], Times(torch.tensor(t.T.copy()), t[:, 0].copy()))
    np.testing.assert_array_equal(got, acc)
    assert (got_blk is None) == (blk is None)
    assert acc.all() == (arrivals == "before")
    port._flush(qp)
    np.testing.assert_array_equal(qp["n_enq"], qr["n_enq"])
    assert qp["c0"].departed == qr["departed"][0]
    assert sorted(qp["c0"].heap) == sorted(qr["depart_heap"][0])


@pytest.mark.parametrize("t_rej", [1.995, 2.2, 2.6])
def test_lane_admit_jumps_an_outage_as_the_reference(t_rej):
    """A non-pilot lane's retry cadence jumps past a paused queue's
    outage in one step, as the reference's does."""
    ref, port = _outage_engines(3)
    qr, qp = _outage_queues(ref, port, 3)
    for lane in (1, 2):
        want = ref._lane_admit([qr], lane, t_rej)
        got = port._lane_admit([qp], lane, t_rej)
        assert got[:2] == want[:2]
        assert (got[2] is None) == (want[2] is None)
    port._flush(qp)
    np.testing.assert_array_equal(qp["n_enq"], qr["n_enq"])
    np.testing.assert_array_equal(qp["departed"].numpy(), qr["departed"])


# ---------------------------------------------------------------------------
# The smoke's full-size specs
# ---------------------------------------------------------------------------


def test_smoke_chaos_specs_are_the_reference_cells():
    """The 15 full-size cells of the smoke's chaos campaign (the port's
    ``chaos_campaign`` at its defaults, built by its ``chaos_cell``) equal
    the reference's ``patterns.chaos_cell`` field for field, and so do
    the smoke's cross-check cells at the bench's smoke size."""
    sp = importlib.util.spec_from_file_location("chip_smoke",
                                                ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(smoke)
    names = ("baseline",) + port_pat.CHAOS_SCENARIOS
    pairs = [(port_pat.chaos_cell(a, s), chaos_cell(a, s))
             for a in port_pat.DEPLOYMENT_ARCHS for s in names]
    pairs += [(smoke._chaos_xcheck_spec(a, s), _cell(a, s))
              for a, s in smoke.CHAOS_XCHECK]
    assert len(pairs) == 17
    assert set(names) == {"baseline", *CHAOS_SCENARIOS}
    assert port_pat.DEPLOYMENT_ARCHS == ARCHS
    for got, want in pairs:
        assert got == _port_spec(want), (want.arch, want.params.chaos)
        assert got.workload.name == want.workload.name == "generic"


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_chaos_cross_check_cells_on_gpu_match_cpu():
    """The broker and consumer cells on prs-haproxy at 512 messages on the
    card and on the CPU: clocks at the cross-device tolerance, counters
    exact (needs a card; skipped elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for scenario in ("broker", "consumer"):
        spec = _port_spec(_cell("prs-haproxy", scenario))
        got = repro_torch.run_many([spec], device="cuda")
        want = repro_torch.run_many([spec], device="cpu")
        _assert_results_match(got, want, rtol=XDEV_RTOL)
        _conserves(got[0], scenario)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_campaign_on_gpu_matches_the_reference(arch):
    """The smoke's full-size cells of one arch (4096 messages, outage
    [5, 10) s; the baselines, past 256 messages a producer, on the cohort
    engine too) on the card against the reference: clocks at the
    cross-device tolerance, counters exact (needs a card; skipped
    elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    refs = [chaos_cell(arch, s) for s in ("baseline",) + CHAOS_SCENARIOS]
    got = repro_torch.run_many([_port_spec(r) for r in refs], device="cuda")
    want = [ref_vec.VectorizedStreamSim(r).run() for r in refs]
    _assert_results_match(got, want, rtol=XDEV_RTOL)
