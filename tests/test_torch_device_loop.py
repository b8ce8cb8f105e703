"""The port's wave program (``repro_torch.core.torch_device_loop``) and its
entry point ``run_many``, against the reference's NumPy oracle.

* **host builders** — ``build_static`` and ``draw_jitter`` give the
  reference's arrays exactly, on every deployment arch, both patterns
  and a vhost multi-tenant cell;
* **trace** — fed a reference-built ``WaveStatic`` through
  ``static_to_torch``, the port's program emits the reference NumPy
  backend's per-step trace at rtol = atol = 1e-12, over the drawn
  shapes, seeds and jitter of the reference's own backend property;
* **whole runs** — ``run_many(..., device="cpu")`` on cells that opt in
  to the wave program (``engine="jax", jax_device_loop=True``, as in the
  reference) equals the reference's build -> NumPy trace -> assemble at
  1e-12, and throughput sits inside the ``device_loop`` parity band of
  the vectorized engine;
* **batching** — cell-axis pads are inert and lane 0 of a stacked run is
  the solo run, bitwise;
* **regime gate and device default** — the same ``(ok, why)`` as the
  reference, the cohort engine for a gated cell that opted in
  (flow-control cells included), and a raise for ``device="cuda"``
  without a GPU.

Cells stay small: the oracle's segmented max scan is a Python loop.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

import repro_torch
from repro.core import jax_device_loop as jdl
from repro.core.metrics import summarize as ref_summarize
from repro.core.simulator import ExperimentSpec as RefSpec
from repro.core.simulator import SimParams as RefParams
from repro.core.vectorized import VectorizedStreamSim
from repro.core.vectorized import run_many as ref_run_many
from repro.core.workloads import get_workload as ref_workload
from repro_torch.core import torch_device_loop as tdl
from repro_torch.core.cell import WaveCell
from repro_torch.core.parity import band

#: the port's spec opts in to the wave program as the reference's would
WAVE = dict(engine="jax", jax_device_loop=True)


def _pair(pattern="feedback", arch="dts", msgs=256, npr=4, nc=2, seed=0,
          tenants=1, isolation="shared", wave=False, **params):
    """The same cell in both packages.  ``confirm_window=32`` puts the
    default feedback cell inside the wave model's validated corridor
    (2G < W < msgs/producer <= 2W), as the reference's tests do.
    ``wave`` opts the port's spec in to the wave program (the reference's
    stays on its vectorized engine, which runs here)."""
    params.setdefault("confirm_window", 32)
    kw = dict(pattern=pattern, arch=arch, n_producers=npr, n_consumers=nc,
              total_messages=msgs, tenants=tenants,
              tenant_isolation=isolation)
    ref = RefSpec(workload=ref_workload("dstream"),
                  params=RefParams(seed=seed, **params), **kw)
    port = repro_torch.ExperimentSpec(
        workload=repro_torch.get_workload("dstream"),
        params=repro_torch.SimParams(seed=seed, **params,
                                     **(WAVE if wave else {})), **kw)
    return ref, port


def _assert_static_equal(a, b):
    assert a.meta == b.meta
    assert a.signature() == b.signature()
    for d in ("xs", "inv"):
        da, db = getattr(a, d), getattr(b, d)
        assert set(da) == set(db)
        for k in da:
            assert da[k].dtype == db[k].dtype, k
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)
    for k, v in a.sizes.items():
        np.testing.assert_array_equal(v, b.sizes[k], err_msg=k)


BUILD_CELLS = [
    dict(pattern=p, arch=a) for p in ("work_sharing", "feedback")
    for a in ("dts", "prs-haproxy", "mss")
] + [dict(pattern="work_sharing", arch="dts", npr=8, nc=8, msgs=512,
          tenants=4, isolation="vhost")]


@pytest.mark.parametrize(
    "cell", BUILD_CELLS,
    ids=[f"{c['pattern']}-{c['arch']}-t{c.get('tenants', 1)}"
         for c in BUILD_CELLS])
def test_host_builders_match_reference_exactly(cell):
    ref, port = _pair(jitter=0.02, **cell)
    seeds = [0, 7, 11]
    rs = VectorizedStreamSim(ref, stack_seeds=seeds)
    ps = WaveCell(port, stack_seeds=seeds)
    assert (rs._round, rs._proc_s) == (ps._round, ps._proc_s)
    assert (rs.dsn_utilization, rs.publish_surplus) == (
        ps.dsn_utilization, ps.publish_surplus)
    assert rs.flow_events_possible() == ps.flow_events_possible()
    assert jdl._device_loop_ok(rs) == tdl._device_loop_ok(ps)
    wr, wp = jdl.build_static(rs), tdl.build_static(ps)
    _assert_static_equal(wr, wp)
    jr, jp = jdl.draw_jitter(rs, wr), tdl.draw_jitter(ps, wp)
    assert set(jr) == set(jp)
    for k in jr:
        np.testing.assert_array_equal(jr[k], jp[k], err_msg=k)


@settings(max_examples=8, deadline=None, database=None)
@given(pattern=st.sampled_from(("work_sharing", "feedback")),
       npr=st.sampled_from((2, 4)),
       msgs_per=st.sampled_from((16, 32)),
       jitter=st.floats(min_value=0.0, max_value=0.05),
       seed=st.integers(min_value=0, max_value=999))
def test_trace_matches_numpy_oracle_step_for_step(pattern, npr, msgs_per,
                                                  jitter, seed):
    """A reference-built ``WaveStatic``, carried over by
    ``static_to_torch``, runs to the reference NumPy backend's trace —
    the same draws as the reference's own backend-equivalence property."""
    spec = RefSpec(
        pattern=pattern, workload=ref_workload("dstream"), arch="dts",
        n_producers=npr, n_consumers=2, total_messages=npr * msgs_per,
        params=RefParams(seed=seed, jitter=jitter))
    sim = VectorizedStreamSim(spec)
    ws = jdl.build_static(sim)
    jit = jdl.draw_jitter(sim, ws)
    yn = jdl.run_wave_trace(ws, jit, backend="numpy")
    yt = tdl.run_wave_trace(ws, jit, device="cpu")
    assert set(yn) == set(yt)
    for k in sorted(yn):
        assert yt[k].shape == yn[k].shape and yt[k].dtype == np.float64
        np.testing.assert_allclose(yt[k], yn[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def test_static_to_torch_carries_dtypes_and_a_cell_axis():
    ref, _ = _pair(pattern="feedback")
    sim = VectorizedStreamSim(ref)
    ws = jdl.build_static(sim)
    ts = tdl.static_to_torch(ws.meta, ws.xs, ws.inv, jdl.draw_jitter(sim, ws),
                             "cpu")
    assert ts.n_cells == 1
    assert ts.xs["pub_valid"].dtype == torch.bool
    assert ts.xs["pub_pr"].dtype == torch.int64
    assert ts.xs["pub_jit"].dtype == torch.float64
    assert ts.xs["pub_jit"].shape[:2] == (ws.meta["nSteps"], 1)
    assert ts.inv["scal"].shape == (1, 5)
    np.testing.assert_array_equal(ts.dly, ws.xs["dly"])


RUN_CELLS = [dict(pattern="feedback", arch="dts"),
             dict(pattern="work_sharing", arch="mss", msgs=128),
             dict(pattern="work_sharing", arch="prs-haproxy", npr=8, nc=8,
                  msgs=512, tenants=4, isolation="vhost")]


@pytest.mark.parametrize("cell", RUN_CELLS,
                         ids=[f"{c['pattern']}-{c['arch']}" for c in RUN_CELLS])
def test_run_many_matches_reference_pipeline(cell):
    """``run_many`` on the CPU, three stacked seed-lanes, against the
    reference's build_static -> NumPy trace -> _assemble."""
    seeds = (0, 1000, 2000)
    pairs = [_pair(seed=s, jitter=0.02, wave=True, **cell) for s in seeds]
    got = repro_torch.run_many([p for _, p in pairs], device="cpu")
    sim = VectorizedStreamSim(pairs[0][0], stack_seeds=list(seeds))
    ws = jdl.build_static(sim)
    want = jdl._assemble(sim, ws, jdl.run_wave_trace(
        ws, jdl.draw_jitter(sim, ws), backend="numpy"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.spec.params.seed == w.spec.params.seed
        assert g.n_consumed == w.n_consumed == g.spec.total_messages
        for f in ("consume_times", "rtts", "publish_starts"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=1e-12, atol=1e-12, err_msg=f)
        np.testing.assert_array_equal(g.consume_producers, w.consume_producers)
        np.testing.assert_array_equal(g.rtt_producers, w.rtt_producers)
        assert (g.sim_time, g.n_events) == pytest.approx(
            (w.sim_time, w.n_events), rel=1e-12)
        sg, sw = repro_torch.summarize(g), ref_summarize(w)
        for f in ("throughput_msgs_s", "median_rtt_s", "p95_rtt_s",
                  "min_rtt_s", "goodput_gbps"):
            assert getattr(sg, f) == pytest.approx(
                getattr(sw, f), rel=1e-12, nan_ok=True), f


@pytest.mark.parametrize("pattern", ["work_sharing", "feedback"])
def test_throughput_inside_device_loop_band_vs_vectorized(pattern):
    """End to end, the port sits inside the reference's wave-program
    parity bands against the vectorized cohort engine."""
    ref, port = _pair(pattern=pattern, wave=True)
    v = ref_run_many([ref])[0]
    t = repro_torch.run_many([port], device="cpu")[0]
    sv, st_ = ref_summarize(v), repro_torch.summarize(t)
    dev = abs(st_.throughput_msgs_s - sv.throughput_msgs_s) / sv.throughput_msgs_s
    assert dev <= band("device_loop.all.throughput"), dev
    if pattern == "feedback":
        rv, rt = np.median(v.rtts), np.median(t.rtts)
        assert abs(rt - rv) / rv <= band("device_loop.all.median_rtt")


def test_cell_axis_pads_are_inert():
    """Three cells of one signature pad to four (replicating cell 0);
    every real cell equals its solo run bit for bit."""
    seeds = (0, 1, 2)
    cells = [WaveCell(_pair(pattern="work_sharing", msgs=64, seed=s,
                            jitter=0.02)[1]) for s in seeds]
    batched = tdl.run_wave_cells(cells, device="cpu")
    for s, rs in zip(seeds, batched):
        solo = tdl.run_wave_results(
            WaveCell(_pair(pattern="work_sharing", msgs=64, seed=s,
                           jitter=0.02)[1]), device="cpu")
        assert len(rs) == len(solo) == 1
        np.testing.assert_array_equal(rs[0].consume_times,
                                      solo[0].consume_times)
        np.testing.assert_array_equal(rs[0].publish_starts,
                                      solo[0].publish_starts)


def test_stacked_lane_zero_is_the_solo_run():
    stacked = repro_torch.run_many(
        [_pair(seed=s, jitter=0.02, wave=True)[1] for s in (0, 1000, 2000)],
        device="cpu")
    solo = repro_torch.run_many([_pair(seed=0, jitter=0.02, wave=True)[1]],
                                device="cpu")[0]
    np.testing.assert_array_equal(stacked[0].consume_times, solo.consume_times)
    np.testing.assert_array_equal(stacked[0].rtts, solo.rtts)


def test_regime_gate_matches_reference():
    """The cases of the reference's regime-gate test give the same
    ``(ok, why)`` in both packages."""
    cases = [dict(arch="mss"), dict(npr=16, nc=16, msgs=2048, confirm_window=64),
             dict(confirm_window=16), dict(confirm_window=128), dict(msgs=1024),
             dict(pattern="work_sharing", npr=8, nc=8, msgs=4096),
             dict(pattern="work_sharing", npr=16, nc=16, msgs=2048),
             dict(queue_max_bytes=64 * 1024)]
    for kw in cases:
        ref, port = _pair(**kw)
        assert jdl._device_loop_ok(VectorizedStreamSim(ref)) == \
            tdl._device_loop_ok(WaveCell(port)), kw


def test_run_many_raises_on_a_gated_cell():
    """A cell the wave gate refuses no longer raises: it runs on the
    per-cohort engine and gives the reference's vectorized results (mss
    feedback, a broadcast+gather cell, and a cell with reachable
    flow-control events, a 4-message byte cap)."""
    seeds = (0, 1000)
    _, gated = _pair(arch="mss")
    assert not tdl._device_loop_ok(WaveCell(gated))[0]
    _, flow = _pair(queue_max_bytes=64 * 1024)
    assert "flow-control" in tdl._device_loop_ok(WaveCell(flow))[1]
    for kw in (dict(arch="mss"), dict(pattern="broadcast_gather", npr=1),
               dict(queue_max_bytes=64 * 1024)):
        pairs = [_pair(seed=s, jitter=0.02, wave=True, **kw) for s in seeds]
        got = repro_torch.run_many([p for _, p in pairs], device="cpu")
        want = VectorizedStreamSim(pairs[0][0],
                                   stack_seeds=list(seeds)).run_stacked()
        for g, w in zip(got, want):
            assert g.n_consumed == w.n_consumed > 0
            for f in ("consume_times", "rtts", "publish_starts"):
                np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                           rtol=1e-12, atol=0, err_msg=f)
            assert g.rejected_publishes == w.rejected_publishes
            assert g.blocked_confirms == w.blocked_confirms


def test_run_many_reports_infeasible_cells():
    _, port = _pair(pattern="work_sharing", arch="prs-stunnel", npr=32, nc=32,
                    msgs=1024, wave=True)
    r = repro_torch.run_many([port], device="cpu")[0]
    assert not r.feasible and "connection limit" in r.infeasible_reason


def test_run_many_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port = _pair(pattern="work_sharing")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.run_many([port])
