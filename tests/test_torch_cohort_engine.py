"""The port's per-cohort StreamSim engine (``repro_torch.core.torch_engine``)
against the reference's NumPy ``VectorizedStreamSim``, on the CPU.

* **seams** — the FIFO scan, the batched resources (a pipe, and k-server
  pools with more and with fewer servers than customers), the masked
  depart store and the admission walk equal the reference's functions
  (the flow-control seams in ``test_torch_flow_control.py``);
* **whole runs** — ``run_many(..., device="cpu")`` on cells the wave gate
  refuses and on the broadcast patterns gives the reference's consume
  times, RTTs and publish starts (rtol 1e-12; bit for bit in practice)
  and its counters exactly, on every seed-lane; lane 0 of a stacked run
  is the solo run bit for bit;
* **routing** — by ``params.engine`` as the reference routes: a default
  cell, and a ``"jax"`` cell without ``jax_device_loop``, run the cohort
  engine (``run_many`` and ``run_experiment`` equal the reference's
  ``run_many`` and ``run_experiment``); a ``"jax"`` cell with the flag
  that the wave gate accepts runs the wave program (and its pump), a
  refused one the cohort engine; a jax chaos cell is rewritten to
  ``"vectorized"``; ``"heap"`` runs the port's heap engine (held to the
  reference's in ``test_torch_heap_engine.py``) and an unknown name
  raises the reference's ``ValueError``; a cell with reachable
  flow-control events runs the cohort engine and matches the reference,
  and the default ``device="cuda"`` raises without a GPU;
* on the card (``gpu`` marker), a Fig 7b cell is held to the reference at
  the cross-device tolerance.
"""

import jax
import numpy as np
import pytest
import torch

# the reference runs on the CPU also where a GPU is present: the
# tolerances here are set against its CPU results
jax.config.update("jax_platforms", "cpu")

import repro_torch
from repro.core import jax_engine  # noqa: F401  (registers "jax" in ENGINES)
from repro.core import vectorized as ref_vec
from repro.core.architectures import ResourceSpec as RefResourceSpec
from repro.core.simulator import ExperimentSpec as RefSpec
from repro.core.simulator import SimParams as RefParams
from repro.core.simulator import run_experiment as ref_run_experiment
from repro.core.workloads import get_workload as ref_workload
from repro_torch.core import run as port_run
from repro_torch.core import torch_engine as te
from repro_torch.core.architectures import ResourceSpec
from repro_torch.core.torch_engine import Times, TorchStreamSim
from repro_torch.kernels.pump_assign import pump_assign

SEEDS = (0, 1000, 2000)
#: the CPU port against the NumPy reference
RTOL = 1e-12
#: a GPU run against a CPU one (CUDA's scans may associate differently)
XDEV_RTOL = 1e-9
#: the gather leg's reply size, as the reference's ``pattern_spec`` sets it
GATHER_REPLY_FACTOR = 1.0 / 256.0


def _pair(pattern, arch, npr, nc, msgs, workload="dstream", seed=0,
          tenants=1, isolation="shared", **params):
    """The same cell in both packages."""
    if pattern == "broadcast_gather":
        params.setdefault("reply_factor", GATHER_REPLY_FACTOR)
    kw = dict(pattern=pattern, arch=arch, n_producers=npr, n_consumers=nc,
              total_messages=msgs, tenants=tenants,
              tenant_isolation=isolation)
    ref = RefSpec(workload=ref_workload(workload),
                  params=RefParams(seed=seed, **params), **kw)
    port = repro_torch.ExperimentSpec(
        workload=repro_torch.get_workload(workload),
        params=repro_torch.SimParams(seed=seed, **params), **kw)
    return ref, port


def _assert_results_match(got, want, rtol=RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.feasible and w.feasible
        assert g.spec.params.seed == w.spec.params.seed
        assert g.n_consumed == w.n_consumed
        for f in ("consume_times", "rtts", "publish_starts"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=rtol, atol=0, err_msg=f)
        for f in ("consume_producers", "rtt_producers"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), f)
        for f in ("n_events", "rejected_publishes", "blocked_confirms",
                  "redelivered"):
            assert getattr(g, f) == getattr(w, f), f
        assert g.sim_time == pytest.approx(w.sim_time, rel=rtol)


# ---------------------------------------------------------------------------
# Seams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("n", [1, 9])
def test_fifo_scan_matches_reference(lanes, n):
    rng = np.random.default_rng(n + lanes)
    shape = (n,) if lanes == 1 else (n, lanes)
    a = np.sort(rng.uniform(0, 1, shape), axis=0)
    h = rng.uniform(0.01, 0.2, shape)
    carry = rng.uniform(0, 0.5, () if lanes == 1 else (lanes,))
    want = ref_vec._fifo_scan(a, h, carry)
    got = te._fifo_scan(torch.tensor(a.reshape(n, lanes).T),
                        torch.tensor(h.reshape(n, lanes).T),
                        torch.tensor(np.reshape(carry, (lanes, 1))))
    np.testing.assert_array_equal(got.numpy().T.reshape(shape), want)


RESOURCES = {
    "pipe": dict(key="nic", kind="pipe", rate_Bps=1.25e9, service_s=2e-5),
    "pool_k_gt_n": dict(key="cpu", kind="pool", servers=8, per_byte_s=1e-10,
                        service_s=3e-5),
    "pool_k_lt_n": dict(key="cpu", kind="pool", servers=3, per_byte_s=1e-10,
                        service_s=3e-5),
}


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("kind", sorted(RESOURCES))
def test_vec_resource_serve_matches_reference(kind, lanes):
    """Four batches in a row (unsorted arrivals, scalar and per-member
    sizes, one single-member batch) leave the same end times and the same
    carries as the reference's resource."""
    ref = ref_vec._VecResource(RefResourceSpec(**RESOURCES[kind]), lanes)
    port = te._VecResource(ResourceSpec(**RESOURCES[kind]), lanes,
                           torch.device("cpu"))
    rng = np.random.default_rng(7)
    t0 = 0.0
    for n, per_member in ((6, False), (1, False), (5, True), (11, False)):
        shape = (n,) if lanes == 1 else (n, lanes)
        t_arr = t0 + rng.uniform(0, 2e-3, shape)
        t0 += 1e-3
        nbytes = (rng.uniform(1e4, 1e6, n) if per_member else 4096.0)
        jit = rng.uniform(-0.03, 0.03, shape)
        want = ref.serve(t_arr, nbytes, jit)
        hold = (1.0 + jit.reshape(n, lanes).T) * port.hold_times(nbytes)
        ta = t_arr.reshape(n, lanes).T
        end, e0 = port.serve(Times(torch.tensor(ta), ta[0].copy()),
                             Times(torch.tensor(hold), hold[0].copy()),
                             torch.from_numpy)
        e = end.numpy()
        if e0 is None:
            port.settle(e[0])
        else:       # a lone member's end, repeated on the host
            assert n == 1
            np.testing.assert_array_equal(e0, e[0])
        np.testing.assert_array_equal(e.T.reshape(shape), want)
    if kind == "pipe":
        np.testing.assert_array_equal(
            port.free.numpy()[:, -1], np.reshape(ref._free_pipe, lanes))
        assert port.free0[0] == np.reshape(ref._free_pipe, lanes)[0]
    else:
        pool = ref._free_pool.reshape(-1, lanes)
        np.testing.assert_array_equal(port.free0, pool[:, 0])
        np.testing.assert_array_equal(
            port.free.numpy()[:, port.rows].T, pool)


def _engines(lanes=3):
    ref_spec, port_spec = _pair("work_sharing", "dts", 2, 2, 600)
    seeds = list(SEEDS[:lanes])
    return (ref_vec.VectorizedStreamSim(ref_spec, stack_seeds=seeds),
            TorchStreamSim(port_spec, stack_seeds=seeds, device="cpu"))


def _record(ref, port, qr, qp, departs):
    """The same releases into both stores (departs: (m, lanes))."""
    ref._record_departs(qr, departs)
    port._record_departs(qp, Times(torch.tensor(departs.T.copy()),
                                   departs[:, 0].copy()))


def _same_cursor(qr, qp):
    np.testing.assert_array_equal(qp["departed"].numpy(), qr["departed"])
    np.testing.assert_array_equal(qp["last_pop_t"].numpy(), qr["last_pop_t"])


def test_depart_store_matches_reference_heaps():
    """The masked store pops and pops to a target as the reference's
    per-lane heaps do, across interleaved records, and the host cursors
    read from it (lane 0's kept on the host) peek the same next drain."""
    ref, port = _engines()
    qr = ref._queue_state(("t",), [0], 4096, credit=400)
    qp = port._queue_state(("t",), [0], 4096, credit=400, volume=10 ** 6)
    assert qr["track"] and qp["track"]
    rng = np.random.default_rng(3)
    for step in range(4):
        _record(ref, port, qr, qp, rng.uniform(0, 10, (7 + step, 3)))
        thresh = rng.uniform(0, 10, 3)
        for lane in range(3):
            ref._pop_lane(qr, lane, float(thresh[lane]))
        port._pop_lane(qp, torch.tensor(thresh))
        qp["c0"].pop(float(thresh[0]))
        qp["c0"].synced = qp["c0"].departed
        _same_cursor(qr, qp)
        for lane in range(3):
            cur = port._cursor(qp, lane)
            assert cur.departed == qr["departed"][lane]
            assert cur.next_drain() == ref._next_drain(qr, lane)
    target = qr["departed"] + np.array([2, 5, 100])
    for lane in range(3):
        ref._pop_to_target(qr, lane, int(target[lane]))
    port._pop_to_target(qp, torch.tensor(target))
    _same_cursor(qr, qp)
    assert qp["released"] == qr["released"]


@pytest.mark.parametrize("limit", ["credit", "cap"])
def test_admission_walk_admits_or_raises_as_the_reference(limit):
    """Where the zero-drain bound fails but drains between arrivals keep
    every member within the limit, every lane admits the whole cohort and
    leaves the reference's cursor; where members cross the limit, every
    lane rejects (byte cap) or blocks on (credit threshold) the members
    the reference's walk does, and leaves its counters and cursor."""
    for arrivals in ([0.5, 1.5, 2.5, 3.5, 4.5], [0.5, 0.6, 0.7, 0.8, 0.9]):
        ref, port = _engines()
        lim = dict(credit=10) if limit == "credit" else dict(cap_msgs=11)
        qr = ref._queue_state(("t",), [0], 4096, **lim)
        qp = port._queue_state(("t",), [0], 4096, volume=10 ** 6, **lim)
        departs = np.arange(1.0, 9.0)[:, None] + np.array([0.0, 0.01, 0.02])
        _record(ref, port, qr, qp, departs)
        qr["n_enq"][:] = 8
        qp["n_enq"][:] = 8
        t = np.array(arrivals)[:, None] + np.array([0.0, 0.001, 0.002])
        acc, blocked = ref._enqueue_batch([qr], t)
        cohort = Times(torch.tensor(t.T.copy()), t[:, 0].copy())
        got, got_blk, _ = port._enqueue_batch([qp], cohort)
        np.testing.assert_array_equal(got, acc)
        if blocked is None:
            assert got_blk is None
        else:
            np.testing.assert_array_equal(
                np.not_equal(got_blk, None), np.not_equal(blocked, None))
            assert all(q is qp for q in got_blk[np.not_equal(got_blk, None)])
        if arrivals[1] == 1.5:
            assert acc.all() and blocked is None
        else:
            assert not acc.all() or blocked is not None
        port._flush(qp)
        np.testing.assert_array_equal(qp["n_enq"], qr["n_enq"])
        np.testing.assert_array_equal(qp["hwm"], qr["hwm"])
        _same_cursor(qr, qp)


# ---------------------------------------------------------------------------
# Whole runs
# ---------------------------------------------------------------------------

RUN_CELLS = (
    # more than 256 msgs/producer: refused by the wave gate
    [dict(pattern="work_sharing", arch=a, npr=2, nc=2, msgs=600)
     for a in ("dts", "prs-haproxy", "mss")]
    # feedback on mss: refused outright
    + [dict(pattern="feedback", arch="mss", npr=4, nc=4, msgs=256,
            confirm_window=32)]
    + [dict(pattern=p, arch=a, npr=1, nc=4, msgs=64, workload="generic")
       for p in ("broadcast", "broadcast_gather")
       for a in ("dts", "prs-haproxy", "mss")]
    # per-tenant vhost queues, 288 msgs/producer
    + [dict(pattern="work_sharing", arch="prs-haproxy", npr=8, nc=8,
            msgs=2304, tenants=4, isolation="vhost")]
    # a two-message basic.qos window: the pump often finds every window
    # closed with its re-opening not yet known, and waits for acks
    + [dict(pattern="feedback", arch="dts", npr=4, nc=4, msgs=256,
            confirm_window=32, prefetch=2),
       dict(pattern="broadcast", arch="mss", npr=1, nc=4, msgs=64,
            workload="generic", prefetch=2)]
    # strict time order (every cohort split at the next event) and the
    # event cap (the run stops part way)
    + [dict(pattern="work_sharing", arch="dts", npr=2, nc=2, msgs=600,
            vec_horizon_s=0.0),
       dict(pattern="broadcast_gather", arch="dts", npr=1, nc=4, msgs=64,
            workload="generic", max_events=1500)]
)


@pytest.mark.parametrize(
    "cell", RUN_CELLS,
    ids=[f"{c['pattern']}-{c['arch']}-c{c['nc']}-t{c.get('tenants', 1)}"
         + ("-h0" if "vec_horizon_s" in c else "")
         + ("-p2" if "prefetch" in c else "")
         + ("-capped" if "max_events" in c else "") for c in RUN_CELLS])
def test_run_many_matches_vectorized_engine(cell):
    pairs = [_pair(seed=s, jitter=0.03, **cell) for s in SEEDS]
    got = repro_torch.run_many([p for _, p in pairs], device="cpu")
    want = ref_vec.VectorizedStreamSim(
        pairs[0][0], stack_seeds=list(SEEDS)).run_stacked()
    _assert_results_match(got, want)
    per = (cell["nc"] if cell["pattern"].startswith("broadcast") else 1)
    full = cell["msgs"] * per
    if "max_events" in cell:
        assert all(0 < r.n_consumed < full for r in got)
        return
    assert all(r.n_consumed == full for r in got)
    if cell["pattern"] in ("feedback", "broadcast_gather"):
        assert all(r.rtts.size == r.n_consumed for r in got)


@pytest.mark.parametrize("pattern", ["broadcast_gather", "work_sharing"])
def test_stacked_lane_zero_is_the_solo_run(pattern):
    cell = (dict(pattern=pattern, arch="dts", npr=1, nc=4, msgs=96,
                 workload="generic") if pattern == "broadcast_gather"
            else dict(pattern=pattern, arch="prs-haproxy", npr=2, nc=2,
                      msgs=600))
    _, port = _pair(**cell)
    solo = TorchStreamSim(port, device="cpu").run()
    stacked = TorchStreamSim(port, stack_seeds=list(SEEDS),
                             device="cpu").run_stacked()[0]
    for f in ("consume_times", "rtts", "publish_starts"):
        np.testing.assert_array_equal(getattr(stacked, f), getattr(solo, f))
    assert stacked.n_events == solo.n_events


# ---------------------------------------------------------------------------
# Routing and refusals
# ---------------------------------------------------------------------------


def test_run_many_routes_wave_cells_to_the_wave_program(monkeypatch):
    """A ``"jax"`` cell with ``jax_device_loop`` that the wave gate accepts
    takes the wave program and its pump; a refused cell and a broadcast
    cell with the same flag take the cohort engine."""
    pumped = []
    real = port_run.dl.run_wave_cells

    def spy(cells, device):
        pumped.extend(cells)
        return real(cells, device)

    monkeypatch.setattr(port_run.dl, "run_wave_cells", spy)
    monkeypatch.setattr(
        port_run.dl, "pump_assign",
        lambda *a: (pumped.append("pump"), pump_assign(*a))[1])
    runs = TorchStreamSim.stats["runs"]
    _, wave = _pair("work_sharing", "dts", 4, 2, 256, **WAVE)
    repro_torch.run_many([wave], device="cpu")
    assert len(pumped) > 1 and "pump" in pumped
    assert TorchStreamSim.stats["runs"] == runs
    pumped.clear()
    _, refused = _pair("feedback", "mss", 4, 4, 256, confirm_window=32,
                       **WAVE)
    _, bcast = _pair("broadcast", "dts", 1, 2, 32, workload="generic",
                     **WAVE)
    out = repro_torch.run_many([refused, bcast], device="cpu")
    assert "pump" not in pumped and not [c for c in pumped if c != "pump"]
    assert TorchStreamSim.stats["runs"] == runs + 2
    assert [r.n_consumed for r in out] == [256, 64]


#: the reference's opt-in to the whole-run wave program
WAVE = dict(engine="jax", jax_device_loop=True)


@pytest.fixture
def routes(monkeypatch):
    """Counts the cells ``run_many`` hands the wave program and the cohort
    engine's runs."""
    waves = []
    real = port_run.dl.run_wave_cells
    monkeypatch.setattr(port_run.dl, "run_wave_cells",
                        lambda cells, device: (waves.extend(cells),
                                               real(cells, device))[1])
    runs = TorchStreamSim.stats["runs"]
    return lambda: (len(waves), TorchStreamSim.stats["runs"] - runs)


ROUTES = {
    "default": (dict(), (0, 1), "vectorized"),
    "jax without the flag": (dict(engine="jax"), (0, 1), "jax"),
    "jax with the flag": (WAVE, (1, 0), "jax"),
    "flag on the vectorized engine": (dict(jax_device_loop=True), (0, 1),
                                      "vectorized"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_run_many_routes_by_engine_as_the_reference(case, routes):
    """The wave program is opt-in, as in the reference: only ``"jax"``
    with ``jax_device_loop`` (on a cell the gate accepts) takes it; the
    rest run the cohort engine and equal the reference's ``run_many`` at
    rtol 1e-12 (a wave cell the gate accepts: 64 messages a producer)."""
    params, want_routes, engine = ROUTES[case]
    pairs = [_pair("work_sharing", "dts", 4, 4, 256, seed=s, **params)
             for s in SEEDS]
    got = repro_torch.run_many([p for _, p in pairs], device="cpu")
    assert routes() == want_routes
    assert {r.spec.params.engine for r in got} == {engine}
    assert {repro_torch.summarize(r).engine for r in got} == {engine}
    if want_routes == (0, 1):
        _assert_results_match(got, ref_vec.run_many([
            _pair("work_sharing", "dts", 4, 4, 256, seed=s)[0]
            for s in SEEDS]))


def test_run_experiment_equals_the_reference_on_a_default_spec(routes):
    ref, port = _pair("feedback", "prs-haproxy", 3, 3, 300, seed=4)
    got = repro_torch.run_experiment(port, device="cpu")
    assert routes() == (0, 1)
    _assert_results_match([got], [ref_run_experiment(ref)])
    ref, port = _pair("work_sharing", "prs-stunnel", 32, 32, 64)
    bad, want = (repro_torch.run_experiment(port, device="cpu"),
                 ref_run_experiment(ref))
    assert not bad.feasible and bad.infeasible_reason == \
        want.infeasible_reason


def test_jax_chaos_cell_is_rewritten_to_vectorized(routes):
    """``run_many`` rewrites a jax chaos cell to the vectorized engine, as
    the reference's does; ``run_experiment`` refuses it, as the
    reference's jax engine does."""
    sched = {"injections": [{"kind": "consumer", "target": "c1",
                             "t0": 0.05, "t1": 0.1}]}
    ref, port = _pair("work_sharing", "dts", 2, 2, 256, chaos=sched, **WAVE)
    got = repro_torch.run_many([port], device="cpu")
    assert routes() == (0, 1)
    assert got[0].spec.params.engine == "vectorized"
    assert port.params.engine == "jax"
    want = ref_vec.run_many([_pair("work_sharing", "dts", 2, 2, 256,
                                   chaos=sched)[0]])
    _assert_results_match(got, want)
    msgs = []
    for run in (lambda: ref_run_experiment(ref),
                lambda: repro_torch.run_experiment(port, device="cpu")):
        with pytest.raises(ValueError) as e:
            run()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_heap_engine_runs_and_equals_the_reference(routes):
    """A ``"heap"`` cell runs on the port's heap engine, through
    ``run_many`` and ``run_experiment``, and equals the reference's heap
    run bit for bit; neither the wave program nor the cohort engine
    runs."""
    ref, heap = _pair("work_sharing", "dts", 2, 2, 64, engine="heap")
    want = ref_run_experiment(ref)
    for run in (repro_torch.run_many, lambda s, device: [
            repro_torch.run_experiment(s[0], device=device)]):
        (got,) = run([heap], device="cpu")
        assert got.spec.params.engine == "heap"
        for f in ("consume_times", "rtts", "publish_starts",
                  "consume_producers", "rtt_producers"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        for f in ("n_events", "sim_time", "rejected_publishes",
                  "blocked_confirms", "redelivered"):
            assert getattr(got, f) == getattr(want, f), f
    assert routes() == (0, 0)


def test_unknown_engines_raise_the_reference_error():
    msgs = []
    for make in (RefParams, repro_torch.SimParams):
        with pytest.raises(ValueError) as e:
            make(engine="warp")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == (
        "unknown engine 'warp'; options: ['heap', 'jax', 'vectorized']")


def test_flow_events_cell_raises_with_the_reason():
    """Cells with reachable flow-control events (a byte cap of 4
    messages, below each queue's volume, and of 1, where one lane
    rejects publishes) no longer raise: they run through ``run_many`` on
    the cohort engine and give the reference's results, counters
    included."""
    for cap in (64 * 1024, 16 * 1024):
        pairs = [_pair("work_sharing", "dts", 2, 2, 600, seed=s,
                       queue_max_bytes=cap) for s in SEEDS]
        sim = TorchStreamSim(pairs[0][1], device="cpu")
        assert sim.flow_events_possible()
        runs = TorchStreamSim.stats["runs"]
        got = repro_torch.run_many([p for _, p in pairs], device="cpu")
        assert TorchStreamSim.stats["runs"] == runs + 1
        want = ref_vec.VectorizedStreamSim(
            pairs[0][0], stack_seeds=list(SEEDS)).run_stacked()
        _assert_results_match(got, want)
        assert all(r.n_consumed == 600 for r in got)
    assert any(r.rejected_publishes > 0 for r in got)


def test_infeasible_broadcast_cell_is_reported():
    _, port = _pair("broadcast", "dts", 1, 2, 32, workload="generic",
                    queue_max_bytes=1024)
    r = repro_torch.run_many([port], device="cpu")[0]
    assert not r.feasible and "cannot hold" in r.infeasible_reason


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port = _pair("broadcast", "dts", 1, 2, 32, workload="generic")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchStreamSim(port)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.run_many([port])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_fig7b_cell_on_gpu_matches_reference():
    """broadcast+gather of the generic workload, 4 consumers x 384
    messages on dts, three seed-lanes on the card, against the reference
    (needs a card; skipped elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pairs = [_pair("broadcast_gather", "dts", 1, 4, 384, workload="generic",
                   seed=s) for s in SEEDS]
    sim = TorchStreamSim(pairs[0][1], stack_seeds=list(SEEDS),
                         device="cuda")
    got = sim.run_stacked()
    want = ref_vec.VectorizedStreamSim(
        pairs[0][0], stack_seeds=list(SEEDS)).run_stacked()
    _assert_results_match(got, want, rtol=XDEV_RTOL)
    assert sim.host_reads > 0
