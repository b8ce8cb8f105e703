"""The port's campaign layer (``repro_torch.core.campaign``) against the
reference's ``repro.core.campaign``, on the CPU.

* **the grid**: ``CampaignSpec.cells()``, ``CellSpec.experiment()``,
  ``group_key`` and ``cell_key`` equal the reference's (the key apart
  from the port's own version tag), engine typos refused alike;
* **fingerprints**: ``params_fingerprint`` is stable, moves with every
  ``SimParams`` field and equals the reference's; ``resolved_engine``
  sends a jax chaos cell to the vectorized engine;
* **the runner**: ``run_campaign`` on the reference docstring's 12-cell
  grid (at 512 messages) gives the reference's summaries at rtol 1e-12,
  serves all of them from its cache on a second run, runs every group
  in-process whatever ``workers`` says, and counts and warns about jax
  chaos cells that fell back;
* on the card (``gpu`` marker): ``chaos_campaign`` and
  ``availability_crossover`` at full size against the reference at
  1e-9 with counters exact, and a campaign on the card in-process.
"""

import ast
import dataclasses
import warnings

import jax
import pytest
import torch

# the reference runs on the CPU also where a GPU is present: the
# tolerances here are set against its CPU results
jax.config.update("jax_platforms", "cpu")

import repro_torch
from repro.core import campaign as ref_camp
from repro.core import chaos as ref_chaos
from repro.core import jax_engine  # noqa: F401  (registers "jax" in ENGINES)
from repro.core import patterns as ref_pat
from repro.core.simulator import SimParams as RefParams
from repro_torch.core import campaign as port_camp
from repro_torch.core import patterns as port_pat
from test_torch_chaos import _port_chaos, _port_spec
from test_torch_patterns import _same, _same_list

#: the reference docstring's grid at a small size: 2 archs x 2 consumer
#: counts x 3 seeds
MINI = dict(name="fig6-mini", patterns=("feedback",),
            architectures=("dts", "mss"), workloads=("dstream",),
            consumers=(4, 8), n_runs=3, total_messages=512)
#: a grid over every axis, with targeted overrides
GRID = dict(name="grid", patterns=("work_sharing", "feedback"),
            architectures=("dts", "prs-haproxy"), workloads=("dstream",),
            consumers=(2, 4), tenants=(1, 2), n_runs=2, seed=5,
            tenant_isolation="vhost", params={"jitter": 0.01},
            cell_params=[({"arch": "dts"}, {"confirm_window": 64}),
                         ({"pattern": "feedback", "tenants": 2},
                          {"engine": "jax", "jax_device_loop": True})])
CHAOS = {"injections": [{"kind": "broker", "target": "queue:work:0",
                         "t0": 0.5, "t1": 1.0}]}


class _Cache:
    """A cache object as ``run_campaign`` takes it."""

    def __init__(self):
        self.data, self.saves = {}, 0

    def save(self):
        self.saves += 1


def _port_key(key):
    assert key.startswith(f"{ref_camp.CACHE_KEY_VERSION}|")
    return port_camp.CACHE_KEY_VERSION + key[len(ref_camp.CACHE_KEY_VERSION):]


@pytest.mark.parametrize("grid", [MINI, GRID,
                                  dict(MINI, patterns=("broadcast_gather",),
                                       n_runs=1)],
                         ids=["mini", "grid", "gather"])
def test_cells_experiments_and_keys_match_the_reference(grid):
    got = port_camp.CampaignSpec(**grid).cells()
    want = ref_camp.CampaignSpec(**grid).cells()
    assert [dataclasses.astuple(c) for c in got] == \
        [dataclasses.astuple(c) for c in want]
    for g, w in zip(got, want):
        assert g.group_key() == w.group_key()
        assert g.experiment() == _port_spec(w.experiment())
        assert port_camp.cell_key(g) == _port_key(ref_camp.cell_key(w))
    assert port_camp.CampaignSpec.from_json(
        port_camp.CampaignSpec(**grid).to_json()).cells() == got


def test_port_keys_never_serve_the_reference():
    assert port_camp.CACHE_KEY_VERSION != ref_camp.CACHE_KEY_VERSION
    cell = port_camp.CampaignSpec(**MINI).cells()[0]
    assert port_camp.cell_key(cell).startswith(
        port_camp.CACHE_KEY_VERSION + "|engine=vectorized|")


@pytest.mark.parametrize("where", ["params", "cell_params"])
def test_engine_typos_are_refused_as_the_reference(where):
    over = {"engine": "jaxx"}
    kw = (dict(params=over) if where == "params"
          else dict(cell_params=[({"arch": "dts"}, over)]))
    msgs = []
    for m in (ref_camp, port_camp):
        with pytest.raises(ValueError) as e:
            m.CampaignSpec(name="typo", **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "unknown engine 'jaxx'" in msgs[1]


def test_params_fingerprint_covers_every_field():
    """Stable across constructions, moved by each field, and the
    reference's for the same values (a chaos schedule included)."""
    changed = dict(confirm_window=64, window_bytes=1 << 20, prefetch=8,
                   ack_batch=4, n_work_queues=3, reply_factor=0.5,
                   publish_retry_s=0.02, jitter=0.0, seed=9,
                   max_events=1000, max_sim_time=60.0,
                   consumer_proc_s=1e-3, queue_max_bytes=1 << 20,
                   engine="jax", vec_round=4, vec_horizon_s=0.0,
                   jax_device_loop=True, chaos=CHAOS)
    fields = {f.name for f in dataclasses.fields(repro_torch.SimParams)}
    assert fields == set(changed) == {
        f.name for f in dataclasses.fields(RefParams)}
    base = port_camp.params_fingerprint(repro_torch.SimParams())
    assert base == port_camp.params_fingerprint(repro_torch.SimParams())
    assert base == ref_camp.params_fingerprint(RefParams())
    prints = {base}
    for name, value in changed.items():
        got = port_camp.params_fingerprint(
            repro_torch.SimParams(**{name: value}))
        assert got == ref_camp.params_fingerprint(RefParams(**{name: value}))
        prints.add(got)
    assert len(prints) == len(changed) + 1


def test_resolved_engine_sends_jax_chaos_cells_to_vectorized():
    for chaos, want in ((None, "jax"), (CHAOS, "vectorized")):
        ref = ref_pat.chaos_cell("dts", "baseline", engine="jax")
        ref = dataclasses.replace(ref, params=dataclasses.replace(
            ref.params, chaos=chaos))
        port = _port_spec(ref)
        assert port.params.chaos == _port_chaos(ref.params.chaos)
        assert port_camp.resolved_engine(port) == \
            ref_camp.resolved_engine(ref) == want


def test_run_campaign_matches_the_reference_and_caches():
    cache = _Cache()
    got = port_camp.run_campaign(port_camp.CampaignSpec(**MINI),
                                 cache=cache, workers=0, device="cpu")
    want = ref_camp.run_campaign(ref_camp.CampaignSpec(**MINI), workers=0)
    assert len(got.cells) == 12 and got.n_cached == 0
    _same_list(got.summaries, want.summaries)
    _same_list(got.averaged, want.averaged)
    assert [s.n_runs for s in got.averaged] == [3] * 4
    assert got.n_fallback == want.n_fallback == 0
    assert cache.saves == 4 and len(cache.data) == 12
    assert set(cache.data) == {_port_key(ref_camp.cell_key(c))
                               for c in want.cells}
    again = port_camp.run_campaign(port_camp.CampaignSpec(**MINI),
                                   cache=cache, workers=0, device="cpu")
    assert again.n_cached == 12 and cache.saves == 4
    _same_list(again.summaries, got.summaries, rtol=0)


def test_run_campaign_runs_every_group_in_process_whatever_workers_says(
        monkeypatch):
    """``workers`` is accepted for the reference's signature and ignored:
    no process pool is made, and every group reports its end in-process,
    largest first, with the numbers of ``workers=0``."""
    import concurrent.futures

    def no_pool(*a, **kw):
        raise AssertionError("run_campaign made a process pool")

    monkeypatch.setattr(concurrent.futures, "ProcessPoolExecutor", no_pool)
    grid = dict(MINI, consumers=(2, 4), n_runs=2, total_messages=128)
    runs = []
    for workers in (0, 2, None):
        said = []
        runs.append((port_camp.run_campaign(
            port_camp.CampaignSpec(**grid), workers=workers,
            progress=said.append, device="cpu"), said))
    (one, said), *rest = runs
    done = [m for m in said if m.startswith("group ")]
    assert [ast.literal_eval(m[len("group "):-len(" done")])[3]
            for m in done] == [4, 4, 2, 2]
    for other, other_said in rest:
        assert other_said == said
        _same_list(other.summaries, one.summaries, rtol=0)


def test_run_campaign_counts_the_jax_fallback_as_the_reference():
    """A jax campaign of chaos cells (each package's own schedule object:
    a dict is not a hashable override) runs vectorized, counted and
    warned about as in the reference."""
    def grid(m):
        return dict(name="chaos", patterns=("work_sharing",),
                    architectures=("dts",), workloads=("dstream",),
                    consumers=(2,), n_runs=2, total_messages=256,
                    params={"engine": "jax",
                            "chaos": m.ChaosSchedule.from_dict(CHAOS)})
    with pytest.warns(RuntimeWarning, match="2/2 cell"):
        got = port_camp.run_campaign(port_camp.CampaignSpec(**grid(
            repro_torch)), workers=0, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = ref_camp.run_campaign(ref_camp.CampaignSpec(**grid(
            ref_chaos)), workers=0)
    assert got.n_fallback == want.n_fallback == 2
    _same_list(got.summaries, want.summaries)
    assert {s.engine for s in got.summaries} == {"vectorized"}
    assert all(port_camp.cell_key(c) == _port_key(ref_camp.cell_key(w))
               for c, w in zip(got.cells, want.cells))
    assert all("engine=vectorized" in port_camp.cell_key(c)
               for c in got.cells)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_full_size_chaos_campaign_on_gpu_matches_the_reference():
    """The 15 scoreboard points at full size (4096 messages, outage
    [5, 10) s) on the card: every field at 1e-9, counters exact (needs a
    card; skipped elsewhere)."""
    _needs_card()
    got = port_pat.chaos_campaign(device="cuda")
    _same_list(got, ref_pat.chaos_campaign(), rtol=1e-9)


@pytest.mark.gpu
def test_full_size_availability_crossover_on_gpu_matches_the_reference():
    """The 20 single-fault cells at the reference's defaults on the card:
    every point at 1e-9, counters exact, the crossover duration at 1e-9
    (needs a card; skipped elsewhere)."""
    _needs_card()
    got = port_pat.availability_crossover(device="cuda")
    want = ref_pat.availability_crossover()
    for arch in want.curves:
        _same_list(got.curves[arch], want.curves[arch], rtol=1e-9)
    assert got.crossover_duration_s == pytest.approx(
        want.crossover_duration_s, rel=1e-9)


@pytest.mark.gpu
def test_campaign_on_gpu_runs_in_process():
    """Workers asked for, the groups still run in this process on the
    card, and equal the CPU's (needs a card; skipped elsewhere)."""
    _needs_card()
    spec = port_camp.CampaignSpec(**MINI)
    got = port_camp.run_campaign(spec, workers=4, device="cuda")
    want = port_camp.run_campaign(spec, workers=0, device="cpu")
    _same_list(got.summaries, want.summaries, rtol=1e-9)
