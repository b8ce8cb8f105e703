"""The port's heap engine (``repro_torch.core.simulator.StreamSim``)
against the reference's ``StreamSim``, on the CPU, exactly.

* **whole runs** — the same spec through both engines gives the same
  consume times, RTTs, publish starts and producer attributions
  (``np.array_equal``) and the same counters, event count and simulated
  time: every pattern on dts, prs-haproxy, prs-stunnel and mss with
  jitter on, two tenants under each isolation, an overflow cell where
  both flow-control mechanisms fire, and every chaos scenario on every
  deployment architecture at the chip smoke's cross-check size;
* **feasibility** — prs-stunnel past its 16 connections is infeasible
  with the reference's reason;
* **routing** — ``engine="heap"`` runs through ``run_experiment``,
  ``run_many`` (solo, never stacked, never on the cohort engine),
  ``run_pattern``, ``sweep``, ``overflow_stress``, ``multi_tenant``,
  ``deployment_feasibility``, ``chaos_campaign`` and ``run_campaign``,
  each equal to the reference's driver, with ``Summary.engine ==
  "heap"``; ``device="cuda"`` still raises without a GPU; ``get_engine``
  resolves every engine name.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import campaign as ref_campaign
from repro.core import patterns as ref_patterns
from repro.core.simulator import ExperimentSpec as RefSpec
from repro.core.simulator import SimParams as RefParams
from repro.core.simulator import StreamSim as RefStreamSim
from repro.core.simulator import run_experiment as ref_run_experiment
from repro.core.workloads import get_workload as ref_workload
from repro_torch.core import patterns as port_patterns
from repro_torch.core.simulator import StreamSim
from repro_torch.core.torch_engine import TorchStreamSim

HEAP = dict(engine="heap")
ARCHS = ("dts", "prs-haproxy", "prs-stunnel", "mss")
#: (pattern, producers, consumers, messages, workload) at small sizes
PATTERN_CELLS = {
    "work_sharing": (4, 4, 512, "dstream"),
    "feedback": (4, 4, 256, "dstream"),
    "broadcast": (1, 4, 32, "generic"),
    "broadcast_gather": (1, 4, 32, "generic"),
}
#: the gather leg's reply size, as the reference's ``pattern_spec`` sets it
GATHER_REPLY_FACTOR = 1.0 / 256.0
#: the chip smoke's chaos cross-check size: 512 messages, outage [1, 3) s
CHAOS_MSGS, CHAOS_WINDOW = 512, (1.0, 3.0)
ARRAYS = ("consume_times", "rtts", "publish_starts", "consume_producers",
          "rtt_producers")
COUNTERS = ("feasible", "infeasible_reason", "rejected_publishes",
            "blocked_confirms", "redelivered", "n_events", "sim_time")


def _pair(pattern, arch, npr, nc, msgs, workload="dstream", seed=0,
          tenants=1, isolation="shared", **params):
    """The same heap cell in both packages."""
    if pattern == "broadcast_gather":
        params.setdefault("reply_factor", GATHER_REPLY_FACTOR)
    kw = dict(pattern=pattern, arch=arch, n_producers=npr, n_consumers=nc,
              total_messages=msgs, tenants=tenants,
              tenant_isolation=isolation)
    ref = RefSpec(workload=ref_workload(workload),
                  params=RefParams(seed=seed, **HEAP, **params), **kw)
    port = repro_torch.ExperimentSpec(
        workload=repro_torch.get_workload(workload),
        params=repro_torch.SimParams(seed=seed, **HEAP, **params), **kw)
    return ref, port


def _assert_same(got, want):
    """Bit for bit: every array equal, every counter equal."""
    for f in ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    for f in COUNTERS:
        assert getattr(got, f) == getattr(want, f), f


def _run_both(ref, port):
    want = RefStreamSim(ref).run()
    got = StreamSim(port).run()
    _assert_same(got, want)
    return got


def _same_summaries(got, want):
    """Port and reference summaries field by field (NaN equals NaN)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        a, b = dataclasses.asdict(g), dataclasses.asdict(w)
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], float) and np.isnan(a[k]):
                assert np.isnan(b[k]), k
            else:
                assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# Whole runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pattern", sorted(PATTERN_CELLS))
def test_patterns_match_reference_exactly(pattern, arch):
    npr, nc, msgs, wl = PATTERN_CELLS[pattern]
    r = _run_both(*_pair(pattern, arch, npr, nc, msgs, workload=wl, seed=7))
    copies = nc if pattern.startswith("broadcast") else 1
    assert r.n_consumed == msgs * copies
    assert (r.rtts.size > 0) == (pattern in ("feedback", "broadcast_gather"))


@pytest.mark.parametrize("arch", ["dts", "mss"])
@pytest.mark.parametrize("isolation", ["shared", "vhost"])
def test_two_tenants_match_reference_exactly(isolation, arch):
    r = _run_both(*_pair("feedback", arch, 4, 4, 256, seed=3, tenants=2,
                         isolation=isolation))
    assert r.n_consumed == 256
    assert set(r.tenant_of_producer(r.rtt_producers)) == {0, 1}


def test_overflow_cell_matches_reference_exactly():
    """A byte cap 6% over the credit threshold (``overflow_stress``'s
    default regime, two producers): both reject-publish and credit-flow
    confirm withholding fire."""
    wl = ref_workload("dstream")
    cap = int(repro_torch.ClassicQueue.FLOW_CREDIT * 2 * 1.06)
    r = _run_both(*_pair("feedback", "dts", 2, 2, 2048, confirm_window=64,
                         prefetch=16, ack_batch=4, consumer_proc_s=2e-3,
                         queue_max_bytes=cap * wl.payload_bytes))
    assert r.n_consumed == 2048
    assert r.rejected_publishes > 0 and r.blocked_confirms > 0


@pytest.mark.parametrize("arch", ["dts", "prs-haproxy", "mss"])
@pytest.mark.parametrize("scenario", ["baseline"] + list(
    ref_patterns.CHAOS_SCENARIOS))
def test_chaos_cells_match_reference_exactly(scenario, arch):
    t0, t1 = CHAOS_WINDOW
    kw = dict(total_messages=CHAOS_MSGS, t0=t0, t1=t1, engine="heap")
    ref = ref_patterns.chaos_cell(arch, scenario, **kw)
    port = port_patterns.chaos_cell(arch, scenario, **kw)
    r = _run_both(ref, port)
    if scenario == "broker":
        assert r.redelivered > 0 and r.rejected_publishes > 0
    if scenario in ("baseline", "tunnel", "autoscale"):
        assert r.redelivered == 0 and r.n_consumed == CHAOS_MSGS


def test_stunnel_past_its_connection_cap_is_infeasible():
    ref, port = _pair("work_sharing", "prs-stunnel", 17, 17, 170)
    want = ref_run_experiment(ref)
    got = repro_torch.run_experiment(port, device="cpu")
    assert not got.feasible and not want.feasible
    assert got.infeasible_reason == want.infeasible_reason
    assert "connection limit 16" in got.infeasible_reason


def test_unknown_pattern_raises_the_reference_error():
    ref, port = _pair("scatter", "dts", 2, 2, 8)
    msgs = []
    for make in (lambda: RefStreamSim(ref), lambda: StreamSim(port)):
        with pytest.raises(ValueError) as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


@pytest.fixture
def cohort_runs():
    """The cohort engine's run count since the test began."""
    before = TorchStreamSim.stats["runs"]
    return lambda: TorchStreamSim.stats["runs"] - before


def test_run_experiment_and_run_many_route_heap_cells(cohort_runs):
    """``run_many`` runs each heap cell solo (seeds never stack) beside a
    vectorized cell, which keeps the cohort engine; the engine named by
    each cell is the one recorded."""
    pairs = [_pair("work_sharing", "dts", 2, 2, 128, seed=s)
             for s in (0, 1000, 2000)]
    _, vec = _pair("work_sharing", "dts", 2, 2, 128)
    vec = dataclasses.replace(vec, params=repro_torch.SimParams())
    got = repro_torch.run_many([p for _, p in pairs] + [vec], device="cpu")
    assert cohort_runs() == 1
    for (ref, _), g in zip(pairs, got):
        _assert_same(g, ref_run_experiment(ref))
        assert g.spec.params.engine == "heap"
    assert got[-1].spec.params.engine == "vectorized"
    one = repro_torch.run_experiment(pairs[1][1], device="cpu")
    _assert_same(one, got[1])
    assert cohort_runs() == 1
    assert repro_torch.summarize(one).engine == "heap"


def test_heap_cells_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, port = _pair("work_sharing", "dts", 2, 2, 64)
    for run in (lambda: repro_torch.run_many([port]),
                lambda: repro_torch.run_experiment(port),
                lambda: repro_torch.run_pattern(
                    "work_sharing", "dts", "dstream", 2, total_messages=64,
                    n_runs=1, engine="heap")):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()


def test_get_engine_resolves_every_name():
    assert repro_torch.get_engine("heap") is StreamSim
    assert repro_torch.get_engine("vectorized") is TorchStreamSim
    assert repro_torch.get_engine("jax") is TorchStreamSim
    assert repro_torch.ENGINES["heap"] is StreamSim
    assert repro_torch.SimConfig is repro_torch.SimParams
    with pytest.raises(ValueError, match="unknown engine 'warp'"):
        repro_torch.get_engine("warp")


def test_run_pattern_and_sweep_match_reference():
    kw = dict(total_messages=128, n_runs=2, engine="heap")
    got = repro_torch.run_pattern("feedback", "prs-haproxy", "dstream", 2,
                                  device="cpu", **kw)
    want = ref_patterns.run_pattern("feedback", "prs-haproxy", "dstream",
                                    2, **kw)
    for g, w in zip(got, want):
        _assert_same(g, w)
    got = repro_torch.sweep("broadcast_gather", ["dts", "mss"], "generic",
                            (2, 4), total_messages=16, n_runs=1,
                            engine="heap", device="cpu")
    want = ref_patterns.sweep("broadcast_gather", ["dts", "mss"], "generic",
                              (2, 4), total_messages=16, n_runs=1,
                              engine="heap")
    _same_summaries(got, want)
    assert {s.engine for s in got} == {"heap"}


def test_overflow_stress_matches_reference():
    kw = dict(total_messages=1024, queue_cap_msgs=200, engine="heap")
    got = repro_torch.overflow_stress("dts", 2, device="cpu", **kw)
    want = ref_patterns.overflow_stress("dts", 2, **kw)
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert got[0].rejected_publishes > 0


def test_deployment_study_matches_reference():
    kw = dict(tenant_counts=(1, 2, 4), messages_per_tenant=32, n_runs=1,
              engine="heap")
    got = repro_torch.multi_tenant("mss", device="cpu", **kw)
    want = ref_patterns.multi_tenant("mss", **kw)
    _same_summaries(got, want)
    got = repro_torch.deployment_feasibility(device="cpu", **kw)
    want = ref_patterns.deployment_feasibility(**kw)
    assert got.headline() == want.headline()
    assert list(got.curves) == list(want.curves)
    for arch in got.curves:
        _same_summaries(got.curves[arch], want.curves[arch])


def test_chaos_campaign_matches_reference():
    kw = dict(archs=("prs-haproxy",), total_messages=256, t0=0.5, t1=1.5,
              engine="heap")
    got = repro_torch.chaos_campaign(device="cpu", **kw)
    want = ref_patterns.chaos_campaign(**kw)
    _same_summaries(got, want)
    assert {p.engine for p in got} == {"heap"}


def test_run_campaign_matches_reference(cohort_runs):
    grid = dict(name="heap", patterns=("work_sharing", "feedback"),
                architectures=("dts", "mss"), workloads=("dstream",),
                consumers=(2,), n_runs=2, total_messages=128,
                params={"engine": "heap"})
    got = repro_torch.run_campaign(repro_torch.CampaignSpec(**grid),
                                   device="cpu")
    want = ref_campaign.run_campaign(ref_campaign.CampaignSpec(**grid))
    assert cohort_runs() == 0
    _same_summaries(got.summaries, want.summaries)
    _same_summaries(got.averaged, want.averaged)
    assert {s.engine for s in got.summaries} == {"heap"}
    assert got.n_fallback == want.n_fallback == 0
