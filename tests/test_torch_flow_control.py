"""Lane-resolved credit flow and reject-publish overflow in the port's
per-cohort engine (``repro_torch.core.torch_engine``), against the
reference's NumPy ``VectorizedStreamSim``, on the CPU.

* **seams**: ``_enqueue_batch`` (with ``skip``, under byte caps, credit
  thresholds and an atomic fanout, on 1-3 lanes) leaves the reference's
  accept mask, blocking queues, enqueue counts, high-water marks and
  depart cursors; ``_lane_admit`` (its optimistic ``forced`` admission
  included), ``_lane_resume_time`` and ``_try_resume`` with pending
  resolvers give the reference's clocks and counts;
* a **property** over drawn cohorts and drains (drawn from what each
  lane has enqueued and not yet released): both engines admit the same
  members, and no lane's backlog or high-water mark passes the cap;
* **whole runs**: ``run_many(..., device="cpu")`` on overflow cells
  (reject-publish alone, with credit blocking, forced admissions, a
  broadcast fanout and a gather) gives the reference's clocks at rtol
  1e-12 and its counters exactly in every seed-lane;
* **invariants** of a stacked overflow run: lane 0 is the solo run bit
  for bit, the pilot's backlog stays within the cap and the other lanes'
  within the cap plus their forced admissions, no confirm stays
  withheld and every enqueue was released;
* on the card (``gpu`` marker), a both-mechanisms cell on the GPU
  against the CPU at the cross-device tolerance, counters exact.
"""

import jax
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

# the reference runs on the CPU also where a GPU is present: the
# tolerances here are set against its CPU results
jax.config.update("jax_platforms", "cpu")

import repro_torch
from repro.core import vectorized as ref_vec
from repro.core.patterns import OVERFLOW_STRESS_DEFAULTS
from repro.core.workloads import get_workload as ref_workload
from repro_torch.core.torch_engine import Times, TorchStreamSim
from test_torch_cohort_engine import (
    RTOL, SEEDS, XDEV_RTOL, _assert_results_match, _pair)

DSTREAM_B = ref_workload("dstream").payload_bytes
GENERIC_B = ref_workload("generic").payload_bytes


def _ov(**over):
    """``OVERFLOW_STRESS_DEFAULTS`` with overrides."""
    return dict(OVERFLOW_STRESS_DEFAULTS, **over)


def _engines(lanes):
    ref_spec, port_spec = _pair("work_sharing", "dts", 2, 2, 600)
    seeds = list(SEEDS[:lanes])
    return (ref_vec.VectorizedStreamSim(ref_spec, stack_seeds=seeds),
            TorchStreamSim(port_spec, stack_seeds=seeds, device="cpu"))


def _queues(ref, port, limits):
    """The same tracked queues in both engines, one per limit dict."""
    qs = []
    for i, lim in enumerate(limits):
        qs.append((ref._queue_state(("t", i), [i], 4096, **lim),
                   port._queue_state(("t", i), [i], 4096, volume=10 ** 6,
                                     **lim)))
    return qs


def _record(ref, port, qr, qp, departs):
    """The same releases into both stores (departs: (m, lanes))."""
    ref._record_departs(qr, departs)
    port._record_departs(qp, Times(torch.tensor(departs.T.copy()),
                                   departs[:, 0].copy()))


def _same_queue(qr, qp, port):
    """Counters and depart cursors equal, the device store included
    (after the host cursors' pops are written back)."""
    port._flush(qp)
    for f in ("n_enq", "hwm", "forced"):
        np.testing.assert_array_equal(qp[f], qr[f], f)
    assert qp["released"] == qr["released"]
    np.testing.assert_array_equal(qp["departed"].numpy(), qr["departed"])
    np.testing.assert_array_equal(qp["last_pop_t"].numpy(), qr["last_pop_t"])
    assert qp["c0"].departed == qr["departed"][0]
    assert sorted(qp["c0"].heap) == sorted(qr["depart_heap"][0])


def _cohort(t):
    return Times(torch.tensor(t.T.copy()), t[:, 0].copy())


def _blocked_names(blocked, names):
    if blocked is None:
        return None
    return np.vectorize(lambda q: None if q is None else names[id(q)],
                        otypes=[object])(blocked)


# ---------------------------------------------------------------------------
# Seams
# ---------------------------------------------------------------------------

LIMITS = {
    "cap": [dict(cap_msgs=11)],
    "credit": [dict(credit=10)],
    "both": [dict(credit=10, cap_msgs=11)],
    # an atomic fanout: the second target fills first in some lanes
    "fanout": [dict(credit=12), dict(cap_msgs=10)],
}


@pytest.mark.parametrize("lanes", [1, 2, 3])
@pytest.mark.parametrize("limit", sorted(LIMITS))
def test_enqueue_batch_matches_reference(limit, lanes):
    """Three cohorts in a row, with drains recorded between them and the
    members the first attempt admitted skipped on a retry: each lane's
    accept mask, blocking queues, counters and depart cursors equal the
    reference's."""
    ref, port = _engines(lanes)
    qs = _queues(ref, port, LIMITS[limit])
    names = {}
    for i, (qr, qp) in enumerate(qs):
        names[id(qr)] = names[id(qp)] = i
        qr["n_enq"][:] = 6 + i
        qp["n_enq"][:] = 6 + i
    spread = np.linspace(0.0, 0.02, lanes)
    # later drains in the later lanes: lanes part between the fast path
    # and the walk
    lag = np.linspace(0.0, 1.5, lanes)
    rng = np.random.default_rng(lanes)
    skip = None
    for step in range(3):
        departs = (np.sort(rng.uniform(step, step + 3, 6))[:, None]
                   + lag)
        for qr, qp in qs:
            _record(ref, port, qr, qp, departs)
        t = np.sort(rng.uniform(step, step + 1.5, 9))[:, None] + spread
        want, want_blk = ref._enqueue_batch([q[0] for q in qs], t,
                                            skip=skip)
        got, got_blk, th = port._enqueue_batch([q[1] for q in qs],
                                               _cohort(t), skip=skip)
        want = want.reshape(9, lanes)
        np.testing.assert_array_equal(got, want)
        if want_blk is None:
            assert got_blk is None
        else:
            np.testing.assert_array_equal(_blocked_names(got_blk, names),
                                          _blocked_names(want_blk, names))
        read = ~np.isnan(th)
        np.testing.assert_array_equal(th[read], t[read])
        for qr, qp in qs:
            _same_queue(qr, qp, port)
        # the next cohort retries what this one rejected in lane 0
        skip = want.copy() if not want[:, 0].all() else None


def _lane_at_cap(lanes, drains):
    """A byte-capped queue in both engines with every lane at its cap,
    ``drains`` recorded past the cap's arrival time."""
    ref, port = _engines(lanes)
    ((qr, qp),) = _queues(ref, port, [dict(credit=4, cap_msgs=6)])
    t = np.arange(1.0, 7.0)[:, None] + np.linspace(0, 0.01, lanes)
    ref._enqueue_batch([qr], t)
    port._enqueue_batch([qp], _cohort(t))
    if drains is not None:
        _record(ref, port, qr, qp, drains)
    return ref, port, qr, qp


@pytest.mark.parametrize("forced", [False, True], ids=["drain", "forced"])
def test_lane_admit_matches_reference(forced):
    """A non-pilot lane's retry cadence: jumped past each known drain,
    or, with no known future drain, one more retry admitted
    optimistically and counted in ``forced``."""
    lanes = 3
    drains = (None if forced else
              np.array([[7.013], [7.021], [7.5]]) + np.array([0, 1e-3, 2e-3]))
    ref, port, qr, qp = _lane_at_cap(lanes, drains)
    _same_queue(qr, qp, port)
    for lane, t_rej in ((1, 6.5), (2, 7.0), (1, 7.4)):
        want = ref._lane_admit([qr], lane, t_rej)
        got = port._lane_admit([qp], lane, t_rej)
        assert got[:2] == want[:2]
        assert (got[2] is None) == (want[2] is None)
    _same_queue(qr, qp, port)
    if forced:
        assert qp["forced"][1:].sum() > 0


def test_resume_clocks_and_resolvers_match_reference():
    """``_lane_resume_time`` per lane, and ``_try_resume`` holding its
    resolvers until lane 0 has released enough, then firing them in
    order at the reference's clock (forced at the tail)."""
    lanes = 3
    drains = np.sort(np.random.default_rng(5).uniform(7, 9, (5, 1)),
                     axis=0) + np.linspace(0, 0.01, lanes)
    ref, port, qr, qp = _lane_at_cap(lanes, drains)
    for lane in (1, 2):
        assert (port._lane_resume_time(qp, lane)
                == ref._lane_resume_time(qr, lane))
    fired = {"ref": [], "port": []}
    for name, eng, q in (("ref", ref, qr), ("port", port, qp)):
        for i in range(3):
            q["deferred"].append(lambda t, i=i, name=name:
                                 fired[name].append((i, t)))
        q["n_enq"][0] += 10     # lane 0 far above flow_resume
        assert not eng._try_resume(q)
        assert len(q["deferred"]) == 3
        assert eng._try_resume(q, force=True)
        assert not q["deferred"]
    assert fired["port"] == fired["ref"] and len(fired["ref"]) == 3
    _same_queue(qr, qp, port)


# ---------------------------------------------------------------------------
# Property: admission under drawn cohorts and drains
# ---------------------------------------------------------------------------


def _feed(cap, lanes, batches, drain_frac):
    """Feed the same cohorts through both engines' ``_enqueue_batch``,
    recording between cohorts a fraction of what every lane has enqueued
    and not yet released; check agreement and the cap at every step."""
    ref, port = _engines(lanes)
    ((qr, qp),) = _queues(ref, port, [dict(credit=3 * cap, cap_msgs=cap)])
    rng = np.random.default_rng(0)
    admitted = np.zeros(lanes, dtype=int)
    attempted = 0
    for times in batches:
        base = np.sort(np.asarray(times, dtype=float))
        t = base[:, None] * (1.0 + 0.05 * np.arange(lanes))
        want, _ = ref._enqueue_batch([qr], t)
        got, _, _ = port._enqueue_batch([qp], _cohort(t))
        np.testing.assert_array_equal(got, want.reshape(len(times), lanes))
        admitted += got.sum(0)
        attempted += len(times)
        _same_queue(qr, qp, port)
        np.testing.assert_array_equal(qp["n_enq"], admitted)
        assert (qp["hwm"] <= cap).all()
        assert (admitted - qp["departed"].numpy() <= cap).all()
        # drain only what was enqueued and not yet released
        n_drain = int(drain_frac * (qp["n_enq"] - qp["released"]).min())
        if n_drain:
            d = (np.cumsum(rng.uniform(0.1, 2.0, (n_drain, lanes)), axis=0)
                 + float(t.max()))
            _record(ref, port, qr, qp, d)
        assert (qp["released"] <= qp["n_enq"]).all()
    assert attempted * lanes >= admitted.sum()


@settings(max_examples=25, deadline=None)
@given(cap=st.integers(min_value=2, max_value=12),
       lanes=st.integers(min_value=1, max_value=3),
       batches=st.lists(
           st.lists(st.floats(min_value=0.0, max_value=50.0),
                    min_size=1, max_size=12),
           min_size=1, max_size=6),
       drain_frac=st.floats(min_value=0.0, max_value=1.0))
def test_enqueue_batch_cap_and_conservation_property(cap, lanes, batches,
                                                     drain_frac):
    _feed(cap, lanes, batches, drain_frac)


@pytest.mark.parametrize("lanes", [1, 2, 3])
def test_enqueue_batch_property_example_drains_only_what_was_enqueued(lanes):
    """The reference property's stored example (cap 2, cohorts at 0, 0 |
    0 | 2, every backlog drained): here drains are drawn from what was
    enqueued and not yet released, never from what was merely recorded."""
    _feed(2, lanes, [[0.0, 0.0], [0.0], [2.0]], 1.0)


# ---------------------------------------------------------------------------
# Whole runs
# ---------------------------------------------------------------------------

FLOW_CELLS = {
    # feedback with forced admissions in lanes 1-2 (reject-publish alone)
    "feedback-c2-cap48": dict(pattern="feedback", arch="dts", npr=2, nc=2,
                              msgs=512, queue_max_bytes=48 * DSTREAM_B,
                              **_ov()),
    # both mechanisms: rejected publishes and withheld confirms
    "work_sharing-c1-cap424": dict(
        pattern="work_sharing", arch="dts", npr=1, nc=1, msgs=1536,
        queue_max_bytes=424 * DSTREAM_B, **_ov(consumer_proc_s=5e-3)),
    # an atomic fanout onto two byte-capped queues
    "broadcast-c2-cap16": dict(
        pattern="broadcast", arch="dts", npr=1, nc=2, msgs=256,
        workload="generic", queue_max_bytes=16 * GENERIC_B,
        **_ov(consumer_proc_s=0.2)),
    # the fanout and the gather leg's byte cap
    "broadcast_gather-c4-cap16": dict(
        pattern="broadcast_gather", arch="dts", npr=1, nc=4, msgs=256,
        queue_max_bytes=16 * DSTREAM_B, **_ov(consumer_proc_s=5e-3)),
}


@pytest.mark.parametrize("name", sorted(FLOW_CELLS))
def test_run_many_flow_cell_matches_vectorized_engine(name):
    cell = FLOW_CELLS[name]
    pairs = [_pair(seed=s, jitter=0.03, **cell) for s in SEEDS]
    got = repro_torch.run_many([p for _, p in pairs], device="cpu")
    want = ref_vec.VectorizedStreamSim(
        pairs[0][0], stack_seeds=list(SEEDS)).run_stacked()
    _assert_results_match(got, want, rtol=RTOL)
    per = cell["nc"] if cell["pattern"].startswith("broadcast") else 1
    assert all(r.n_consumed == cell["msgs"] * per for r in got)
    assert all(r.rejected_publishes > 0 for r in got)
    if name.startswith("work_sharing"):
        assert all(r.blocked_confirms > 0 for r in got)


def test_stacked_overflow_lane_invariants():
    """Lane 0 of a stacked overflow run is the solo run bit for bit; per
    tracked queue, the pilot's backlog never passed the cap and the
    other lanes' only by their forced admissions, nothing stays
    withheld and every enqueue was released."""
    cell = FLOW_CELLS["feedback-c2-cap48"]
    _, port = _pair(seed=0, jitter=0.03, **cell)
    sim = TorchStreamSim(port, stack_seeds=list(SEEDS), device="cpu")
    lanes = sim.run_stacked()
    solo = TorchStreamSim(port, device="cpu").run()
    for f in ("consume_times", "rtts", "publish_starts"):
        np.testing.assert_array_equal(getattr(lanes[0], f),
                                      getattr(solo, f))
    for f in ("rejected_publishes", "blocked_confirms", "n_events"):
        assert getattr(lanes[0], f) == getattr(solo, f)
    tracked = [q for q in sim._queues.values() if q["track"]]
    assert tracked and sum(int(q["forced"].sum()) for q in tracked) > 0
    for q in tracked:
        assert not q["deferred"]
        assert (q["n_enq"] == q["released"]).all()
        assert (q["departed"].numpy() <= q["released"]).all()
        if q["cap"] is not None:
            assert q["hwm"][0] <= q["cap"]
            assert (q["hwm"] <= q["cap"] + q["forced"]).all()
    for r in lanes:
        assert r.n_consumed == cell["msgs"] and (r.rtts > 0).all()
        assert np.isfinite(r.publish_starts).all()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_flow_cell_on_gpu_matches_cpu():
    """work_sharing 1 x 1 with a 424-message cap (both mechanisms), three
    seed-lanes on the card and on the CPU: clocks at the cross-device
    tolerance, counters exact (needs a card; skipped elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = FLOW_CELLS["work_sharing-c1-cap424"]
    specs = [_pair(seed=s, jitter=0.03, **cell)[1] for s in SEEDS]
    got = repro_torch.run_many(specs, device="cuda")
    want = repro_torch.run_many(specs, device="cpu")
    _assert_results_match(got, want, rtol=XDEV_RTOL)
    assert all(r.rejected_publishes > 0 and r.blocked_confirms > 0
               for r in got)
