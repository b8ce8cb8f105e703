"""The port's deployment machinery against the reference's: the S3M
provisioning service, the SciStream control plane, the DS2HPC inventory
and deployment descriptors, and the architectures' deployment arguments.

Each of the reference's own cases (``tests/test_core_system.py``'s
SciStream, S3M and DS2HPC tests, ``tests/test_multi_tenant.py``'s tunnel
provisioning) runs on both packages; where the packages' results are
compared, the fields compared do not depend on the module counters
(session UIDs, cluster numbers, NodePorts), which each package keeps
for itself.
"""

import dataclasses

import pytest

import repro_torch
from repro.core import architectures as ref_arch
from repro.core import ds2hpc as ref_ds2hpc
from repro.core import s3m as ref_s3m
from repro.core import scistream as ref_sci
from repro_torch.core import architectures as port_arch
from repro_torch.core import ds2hpc as port_ds2hpc
from repro_torch.core import s3m as port_s3m
from repro_torch.core import scistream as port_sci

BOTH = pytest.mark.parametrize("pkg", ["reference", "port"])
MODS = {
    "reference": dict(arch=ref_arch, ds2hpc=ref_ds2hpc, s3m=ref_s3m,
                      sci=ref_sci),
    "port": dict(arch=port_arch, ds2hpc=port_ds2hpc, s3m=port_s3m,
                 sci=port_sci),
}


def _session_fields(sess) -> tuple:
    """A session without its UID (each package counts its own)."""
    return (sess.num_conn, sess.bandwidth_gbps, sess.tunnel,
            sess.hops, [(a.rsplit("+", 1)[1], b.rsplit("+", 1)[1])
                        for a, b in sess.connection_map],
            [(p.side, p.gateway_ip, p.listen_port, p.forward_ports,
              p.num_conn) for p in (sess.producer_proxy,
                                    sess.consumer_proxy)])


# ---------------------------------------------------------------------------
# SciStream
# ---------------------------------------------------------------------------


@BOTH
def test_scistream_handshake_full_sequence(pkg):
    S = MODS[pkg]["sci"]
    sess = S.establish_prs_session(num_conn=4)
    assert sess.num_conn == 4
    assert len(sess.connection_map) == 4
    assert sess.hops[0] == "producer" and sess.hops[-1] == "consumer"
    assert sess.producer_proxy.side == "producer"
    assert sess.consumer_proxy.side == "consumer"
    lo, hi = S.STREAM_PORT_RANGE
    assert lo <= sess.consumer_proxy.listen_port <= hi
    assert sess.uid.startswith("uid-") and len(sess.uid) == 10


@pytest.mark.parametrize("num_conn,tunnel", [(1, "haproxy"), (4, "stunnel")])
def test_prs_session_matches_reference(num_conn, tunnel):
    want = ref_sci.establish_prs_session(num_conn=num_conn, tunnel=tunnel,
                                         bandwidth_gbps=2.5)
    got = port_sci.establish_prs_session(num_conn=num_conn, tunnel=tunnel,
                                         bandwidth_gbps=2.5)
    assert _session_fields(got) == _session_fields(want)
    assert got.producer_proxy.session_uid == got.uid


@BOTH
def test_scistream_rejects_bad_cert_uid_and_num_conn(pkg):
    S = MODS[pkg]["sci"]
    s2uc = S.S2UC()
    cons = S.S2CS("198.51.100.0")
    prod = S.S2CS("198.51.100.1")
    with pytest.raises(S.SciStreamError, match="certificate mismatch"):
        s2uc.inbound_request(server_cert=prod.cert, remote_ip="x",
                             s2cs=cons, receiver_ports=(5672,))
    port, uid = s2uc.inbound_request(server_cert=cons.cert, remote_ip="x",
                                     s2cs=cons, receiver_ports=(5672,),
                                     num_conn=2)
    with pytest.raises(S.SciStreamError, match="unknown session UID"):
        s2uc.outbound_request(server_cert=prod.cert, remote_ip="x",
                              s2cs=prod, receiver_port=port, uid="uid-zzz")
    with pytest.raises(S.SciStreamError, match="num_conn mismatch"):
        s2uc.outbound_request(server_cert=prod.cert, remote_ip="x",
                              s2cs=prod, receiver_port=port, uid=uid)
    with pytest.raises(S.SciStreamError, match="num_conn must be"):
        cons.launch_s2ds("consumer", (5672,), 0, "u")


@BOTH
def test_scistream_port_exhaustion_and_teardown(pkg):
    S = MODS[pkg]["sci"]
    s2cs = S.S2CS("10.0.0.1")
    lo, hi = S.STREAM_PORT_RANGE
    ports = [s2cs.launch_s2ds("consumer", (5672,), 1, "u").listen_port
             for _ in range(hi - lo + 1)]
    assert ports == list(range(lo, hi + 1))
    with pytest.raises(S.SciStreamError, match="exhausted"):
        s2cs.launch_s2ds("consumer", (5672,), 1, "u")
    s2uc = S.S2UC()
    cons = S.S2CS("198.51.100.0")
    prod = S.S2CS("198.51.100.1")
    port, uid = s2uc.inbound_request(server_cert=cons.cert, remote_ip="x",
                                     s2cs=cons, receiver_ports=(5672,))
    sess = s2uc.outbound_request(server_cert=prod.cert, remote_ip="x",
                                 s2cs=prod, receiver_port=port, uid=uid)
    s2uc.teardown(sess.uid, prod, cons)
    assert not cons.data_servers and not prod.data_servers
    assert not s2uc.sessions


def test_certificates_match_reference():
    for subject in ("198.51.100.0", "gw"):
        a = ref_sci.ProxyCertificate.self_signed(subject)
        b = port_sci.ProxyCertificate.self_signed(subject)
        assert (a.subject, a.fingerprint) == (b.subject, b.fingerprint)


def test_provision_tenant_tunnels_matches_reference():
    want = ref_sci.provision_tenant_tunnels(4, num_conn=2)
    got = port_sci.provision_tenant_tunnels(4, num_conn=2)
    assert ([_session_fields(s) for s in got]
            == [_session_fields(s) for s in want])
    assert len({s.uid for s in got}) == 4
    assert len({s.consumer_proxy.listen_port for s in got}) == 4
    cap = port_sci.STREAM_PORT_RANGE[1] - port_sci.STREAM_PORT_RANGE[0] + 1
    for S in (ref_sci, port_sci):
        with pytest.raises(S.SciStreamError, match="exhausted"):
            S.provision_tenant_tunnels(cap + 1)
        with pytest.raises(S.SciStreamError, match="tenants must be >= 1"):
            S.provision_tenant_tunnels(0)


# ---------------------------------------------------------------------------
# S3M
# ---------------------------------------------------------------------------


@BOTH
def test_s3m_provision_requires_valid_token(pkg):
    M = MODS[pkg]["s3m"]
    svc = M.S3MService()
    svc.register_project("abc123")
    tok = svc.issue_token("abc123")
    c = svc.provision_cluster(tok, settings=M.ResourceSettings(
        cpus=12, ram_gbs=32, nodes=3))
    assert c.amqps_url.startswith("amqps://") and ":443" in c.amqps_url
    assert c.dsn_placement == [0, 1, 2]
    assert c.fqdn.startswith("rabbitmq-abc123-")
    assert c.fqdn.endswith(".apps.olivine.ccs.ornl.gov")
    svc.deprovision(tok, c.fqdn)
    assert not svc.clusters


@BOTH
def test_s3m_rejects_expired_forged_and_overquota(pkg):
    M = MODS[pkg]["s3m"]
    now = [0.0]
    svc = M.S3MService(clock=lambda: now[0])
    svc.register_project("p", max_clusters=1)
    tok = svc.issue_token("p", ttl_s=10)
    now[0] = 100.0
    with pytest.raises(M.S3MAuthError, match="expired"):
        svc.provision_cluster(tok)
    tok2 = svc.issue_token("p")
    svc.provision_cluster(tok2)
    with pytest.raises(M.S3MError, match="quota"):
        svc.provision_cluster(tok2)
    forged = dataclasses.replace(tok2, secret="0" * 64)
    with pytest.raises(M.S3MAuthError, match="forged"):
        svc.provision_cluster(forged)
    with pytest.raises(M.S3MAuthError, match="lacks permission"):
        svc.submit_compute(tok2, system="frontier", job_spec={"n": 1})
    with pytest.raises(M.S3MAuthError, match="no allocation"):
        svc.issue_token("nobody")
    small = M.S3MService(n_dsn=2)
    small.register_project("q")
    with pytest.raises(M.S3MError, match="only 2 DSNs"):
        small.provision_cluster(small.issue_token("q"))


@pytest.mark.parametrize("settings", [
    dict(nodes=99), dict(nodes=0), dict(cpus=49), dict(ram_gbs=0),
    dict(cpus=12, ram_gbs=32, nodes=3)])
def test_s3m_policy_validation_matches_reference(settings):
    msgs = []
    for M in (ref_s3m, port_s3m):
        try:
            M.ResourceSettings(**settings).validate()
            msgs.append(None)
        except M.S3MError as e:
            msgs.append(str(e))
    assert msgs[0] == msgs[1]


def test_s3m_tokens_and_compute_match_reference():
    out = []
    for M in (ref_s3m, port_s3m):
        svc = M.S3MService(clock=lambda: 5.0)
        svc.register_project("abc123")
        tok = svc.issue_token("abc123", permissions=(
            "streaming:provision", "compute:submit"), ttl_s=60)
        job = svc.submit_compute(tok, system="andes",
                                 job_spec={"nodes": 4, "script": "x.sh"})
        out.append((tok.secret, sorted(tok.permissions), tok.issued_at,
                    tok.ttl_s, job))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# DS2HPC
# ---------------------------------------------------------------------------


@BOTH
def test_rabbitmq_release_and_nodeports(pkg):
    D = MODS[pkg]["ds2hpc"]
    rel = D.RabbitMQRelease()
    inv = D.ClusterInventory()
    assert rel.pod_placement(inv) == [0, 1, 2]
    with pytest.raises(ValueError, match="anti-affinity"):
        D.RabbitMQRelease(replicas=4).pod_placement(inv)
    assert "helm install rabbitmq" in rel.helm_command()
    with pytest.raises(ValueError, match="outside"):
        D.NodePortService.allocate("x", 0, port=99999)
    s = D.NodePortService.allocate("ok", 1)
    assert 30000 <= s.port <= 32767
    assert D.NodePortService.allocate("fixed", 2, port=30671).port == 30671


def test_ds2hpc_matches_reference():
    a, b = ref_ds2hpc.RabbitMQRelease(), port_ds2hpc.RabbitMQRelease()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.helm_command() == b.helm_command()
    assert (ref_ds2hpc.AMQP_NODEPORT, ref_ds2hpc.AMQPS_NODEPORT,
            ref_ds2hpc.NODEPORT_RANGE) == (
        port_ds2hpc.AMQP_NODEPORT, port_ds2hpc.AMQPS_NODEPORT,
        port_ds2hpc.NODEPORT_RANGE)
    for inv_r, inv_p in ((ref_ds2hpc.ClusterInventory(),
                          port_ds2hpc.ClusterInventory()),
                         (ref_ds2hpc.ClusterInventory().highspeed(),
                          port_ds2hpc.ClusterInventory().highspeed())):
        assert dataclasses.asdict(inv_r) == dataclasses.asdict(inv_p)
        assert inv_r.client_link_Bps() == inv_p.client_link_Bps()
        assert inv_r.dsn_link_Bps() == inv_p.dsn_link_Bps()
        for k in (0, 5, 16, 31, 1023):
            assert inv_r.producer_node_of(k) == inv_p.producer_node_of(k)
            assert inv_r.consumer_node_of(k) == inv_p.consumer_node_of(k)
    assert port_ds2hpc.ClusterInventory().highspeed().dsn_link_gbps == 100.0


# ---------------------------------------------------------------------------
# Architectures
# ---------------------------------------------------------------------------


def test_deployment_feasibility_texts_match_reference():
    assert port_arch.ALL_ARCHITECTURES == ref_arch.ALL_ARCHITECTURES
    assert repro_torch.ALL_ARCHITECTURES == ref_arch.ALL_ARCHITECTURES
    for name in ref_arch.ALL_ARCHITECTURES:
        want = ref_arch.make_architecture(name).deployment_feasibility
        got = port_arch.make_architecture(name).deployment_feasibility
        assert got == want and got
    assert port_arch.Architecture.deployment_feasibility == ""


def test_architectures_carry_their_deployment_handles():
    """A negotiated SciStream session rides on PRS and a provisioned S3M
    cluster on MSS, as in the reference; neither changes the hop graph."""
    sess = port_sci.establish_prs_session(num_conn=4, tunnel="stunnel")
    prs = port_arch.make_architecture("prs-stunnel-c4", session=sess)
    assert prs.session is sess
    assert port_arch.make_architecture("prs-haproxy").session is None
    svc = port_s3m.S3MService()
    svc.register_project("abc123")
    cluster = svc.provision_cluster(svc.issue_token("abc123"))
    mss = port_arch.make_architecture("mss", managed_cluster=cluster)
    assert mss.managed_cluster is cluster
    assert port_arch.make_architecture("mss").managed_cluster is None
    ref_sess = ref_sci.establish_prs_session(num_conn=4, tunnel="stunnel")
    ref_svc = ref_s3m.S3MService()
    ref_svc.register_project("abc123")
    ref_cluster = ref_svc.provision_cluster(ref_svc.issue_token("abc123"))
    for got, want in (
            (prs, ref_arch.make_architecture("prs-stunnel-c4",
                                             session=ref_sess)),
            (mss, ref_arch.make_architecture("mss",
                                             managed_cluster=ref_cluster))):
        assert got.name == want.name
        assert ({k: dataclasses.asdict(v) for k, v in got.resources.items()}
                == {k: dataclasses.asdict(v)
                    for k, v in want.resources.items()})
        assert ([dataclasses.asdict(e) for e in got.publish_path(0, 1, 2)]
                == [dataclasses.asdict(e)
                    for e in want.publish_path(0, 1, 2)])


def test_quickstart_deployment_through_the_port():
    """``examples/quickstart.py``'s deployment calls through
    ``repro_torch``'s exports give the reference's outputs (the URL and
    overlay but for their counters)."""
    dts = repro_torch.make_architecture("dts")
    sess = repro_torch.establish_prs_session(num_conn=1, tunnel="haproxy")
    s3m = repro_torch.S3MService()
    s3m.register_project("abc123")
    cluster = s3m.provision_cluster(
        s3m.issue_token("abc123"),
        settings=repro_torch.ResourceSettings(cpus=12, ram_gbs=32, nodes=3))
    assert dts.deployment_feasibility == ref_arch.make_architecture(
        "dts").deployment_feasibility
    assert _session_fields(sess) == _session_fields(
        ref_sci.establish_prs_session(num_conn=1, tunnel="haproxy"))
    assert cluster.amqps_url == f"amqps://{cluster.fqdn}:443"
    assert cluster.dsn_placement == [0, 1, 2]
    assert isinstance(repro_torch.RabbitMQRelease().helm_command(), str)


def test_chip_smoke_quickstart_is_the_reference_quickstart(monkeypatch,
                                                           capsys):
    """The chip smoke holds ``examples_torch/quickstart.py`` to the lines
    the reference prints: those lines are the reference's (its
    quickstart, run here on each engine), and the port's example makes
    them on the heap engine.  Module counters start fresh, as in a new
    process."""
    import itertools
    import runpy
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    monkeypatch.syspath_prepend(str(root))
    import chip_smoke
    for sci, s3m in ((ref_sci, ref_s3m), (port_sci, port_s3m)):
        monkeypatch.setattr(sci, "_uid_counter", itertools.count(1))
        monkeypatch.setattr(s3m, "_cluster_counter", itertools.count(1))
    printed = {}
    for engine in ("vectorized", "heap"):
        monkeypatch.setattr(ref_sci, "_uid_counter", itertools.count(1))
        monkeypatch.setattr(ref_s3m, "_cluster_counter", itertools.count(1))
        monkeypatch.setattr(sys, "argv", ["quickstart.py", "--engine",
                                          engine])
        capsys.readouterr()
        runpy.run_path(str(root / "examples" / "quickstart.py"),
                       run_name="__main__")
        printed[engine] = capsys.readouterr().out.splitlines()
    for engine, lines in printed.items():
        assert tuple(lines[1:4]) == chip_smoke.QUICKSTART_DEPLOY
        table = [ln for ln in lines[6:] if ln.strip() and not ln.startswith(
            "overhead")]
        assert tuple(table) == chip_smoke.QUICKSTART_TABLE[engine]
    from examples_torch import quickstart
    assert tuple(quickstart.deploy_lines()) == chip_smoke.QUICKSTART_DEPLOY
    table, overhead, results = quickstart.work_sharing("heap", "cpu")
    assert tuple(table + overhead) == chip_smoke.QUICKSTART_TABLE["heap"]
    assert {r.spec.params.engine for r in results} == {"heap"}
