"""Package-level contracts of the PyTorch/CUDA port (``src/repro_torch``).

* **import hygiene** — the port imports neither ``jax`` nor anything of
  the reference package ``repro``, checked in a fresh interpreter and by
  a scan of every import statement in the port, ``chip_smoke.py`` and
  the chip probes;
* **its own copies agree** — the framework-free modules the port keeps
  its own copy of (workloads, architectures, parameters, metrics) give
  the reference's values;
* **the chip smoke refuses to pass off the card** — without CUDA, or in a
  directory with nothing of the repository beside it, ``chip_smoke.py``
  exits nonzero and prints no result.
"""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import architectures as ref_arch
from repro.core import workloads as ref_wl
from repro.core.metrics import summarize as ref_summarize
from repro.core.simulator import SimParams as RefParams
from repro_torch.core import architectures as port_arch
from repro_torch.core import workloads as port_wl
from repro_torch.core.simulator import RunResult

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "chip_probes").glob("*.py"))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_sources_import_no_jax_or_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


#: names of ``repro.core`` the port exports from ``repro_torch`` since its
#: heap engine and deployment study were ported
HEAP_SLICE_NAMES = (
    "BrokerCluster", "ClassicQueue", "Message", "StreamSim", "ENGINES",
    "Engine", "SimConfig", "get_engine", "RabbitMQRelease",
    "ResourceSettings", "S3MService", "S2CS", "S2UC",
    "establish_prs_session", "provision_tenant_tunnels",
    "make_architecture", "ALL_ARCHITECTURES")


@pytest.mark.parametrize("name", HEAP_SLICE_NAMES)
def test_port_exports_the_reference_names(name):
    import repro.core
    assert name in repro.core.__all__
    got = getattr(repro_torch, name)
    want = getattr(repro.core, name)
    assert type(got) is type(want)
    if isinstance(want, type) or callable(want):
        assert got.__name__ == want.__name__
        assert got.__module__.startswith("repro_torch.")


def test_workloads_match_reference():
    assert set(port_wl.WORKLOADS) == set(ref_wl.WORKLOADS)
    for name, w in ref_wl.WORKLOADS.items():
        p = port_wl.get_workload(name)
        for f in dataclasses.fields(w):
            a, b = getattr(w, f.name), getattr(p, f.name)
            assert (a.value if hasattr(a, "value") else a) == \
                (b.value if hasattr(b, "value") else b), f.name
        assert p.proc_time_s() == w.proc_time_s()
        assert p.message_bits == w.message_bits
    with pytest.raises(KeyError):
        port_wl.get_workload("nope")


def _paths(arch, tenants):
    combos = [(0, 0, 0), (3, 1, 2), (5, 2, 0)]
    out = []
    for c in combos:
        for t in range(tenants):
            for fn in ("publish_path", "delivery_path", "reply_publish_path",
                       "reply_delivery_path"):
                out.append([dataclasses.astuple(e)
                            for e in getattr(arch, fn)(*c, t)])
    return out


@pytest.mark.parametrize("name", ref_arch.ALL_ARCHITECTURES)
@pytest.mark.parametrize("tenants", [1, 4])
def test_architectures_match_reference(name, tenants):
    r, p = ref_arch.make_architecture(name), port_arch.make_architecture(name)
    for a in (r, p):
        a.configure(8, 8, tenants=tenants)
    assert r.name == p.name and r.tenant_paths == p.tenant_paths
    assert ({k: dataclasses.astuple(v) for k, v in r.resources.items()}
            == {k: dataclasses.astuple(v) for k, v in p.resources.items()})
    assert _paths(r, tenants) == _paths(p, tenants)
    for size in (16 * 1024, 1024 * 1024):
        assert r.recv_latency_s(size) == p.recv_latency_s(size)
    assert (r.control_latency_s(), r.client_flush_s(),
            r.producer_conn_limit()) == (
        p.control_latency_s(), p.client_flush_s(), p.producer_conn_limit())


def test_sim_params_keep_reference_defaults_and_validation():
    port = repro_torch.SimParams()
    ref = RefParams()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert {"vec_horizon_s", "max_events", "max_sim_time",
            "publish_retry_s"} <= {
        f.name for f in dataclasses.fields(port)}
    for bad in (dict(confirm_window=1), dict(prefetch=0),
                dict(queue_max_bytes=0), dict(vec_round=3),
                dict(vec_horizon_s=-1e-3)):
        with pytest.raises(ValueError):
            repro_torch.SimParams(**bad)
        with pytest.raises(ValueError):
            RefParams(**bad)


def test_summarize_matches_reference():
    from repro.core.simulator import ExperimentSpec as RefSpec
    from repro.core.simulator import RunResult as RefResult
    rng = np.random.default_rng(3)
    ct, rt = np.sort(rng.uniform(0, 9, 500)), rng.uniform(0.1, 2.0, 500)
    kw = dict(pattern="feedback", arch="dts", n_producers=4, n_consumers=4,
              total_messages=500)
    rs = RefSpec(workload=ref_wl.get_workload("dstream"), **kw)
    ps = repro_torch.ExperimentSpec(
        workload=repro_torch.get_workload("dstream"), **kw)
    a = ref_summarize(RefResult(spec=rs, feasible=True, consume_times=ct,
                                rtts=rt))
    b = repro_torch.summarize(RunResult(spec=ps, feasible=True,
                                        consume_times=ct, rtts=rt))
    for f in ("throughput_msgs_s", "median_rtt_s", "p95_rtt_s", "min_rtt_s",
              "goodput_gbps", "n_messages"):
        assert getattr(a, f) == getattr(b, f), f


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the CPU-only path")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
