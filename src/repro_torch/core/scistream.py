"""SciStream control plane (paper §3.2, §4.4 — the machinery behind the
PRS architecture).

* **S2UC** (user client, :class:`S2UC`) brokers requests and runs the
  inbound/outbound request sequence;
* **S2CS** (control server, :class:`S2CS`, one per gateway node)
  allocates local ports (5000 control + 5100-5110 streaming) and
  launches data servers;
* **S2DS** (data server, :class:`S2DS`) is the on-demand proxy bridging
  the internal network and the WAN, authenticating external peers by
  proxy certificate (:class:`ProxyCertificate`).

:func:`establish_prs_session` runs the §4.4 CLI sequence end to end on
the paper's topology (producer-side S2CS at 198.51.100.1, consumer-side
at 198.51.100.0), and :func:`provision_tenant_tunnels` the per-tenant
tunnel pairs of the multi-tenant DTS model.

A copy of the reference package's ``scistream`` module, with its names,
defaults and error messages.  The session UID counter is this module's
own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Optional

CONTROL_PORT = 5000
STREAM_PORT_RANGE = (5100, 5110)

_uid_counter = itertools.count(1)


class SciStreamError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class ProxyCertificate:
    subject: str
    fingerprint: str

    @staticmethod
    def self_signed(subject: str) -> "ProxyCertificate":
        fp = hashlib.sha256(f"cert:{subject}".encode()).hexdigest()[:32]
        return ProxyCertificate(subject, fp)


@dataclasses.dataclass
class S2DS:
    """A launched on-demand proxy instance."""

    side: str                 # "producer" | "consumer"
    gateway_ip: str
    listen_port: int
    forward_ports: tuple[int, ...]
    num_conn: int
    session_uid: str


class S2CS:
    """Control server on one gateway node: port allocation + S2DS launch."""

    def __init__(self, gateway_ip: str,
                 cert: Optional[ProxyCertificate] = None) -> None:
        self.gateway_ip = gateway_ip
        self.cert = cert or ProxyCertificate.self_signed(gateway_ip)
        self._allocated: set[int] = set()
        self.data_servers: list[S2DS] = []

    def _alloc_port(self) -> int:
        lo, hi = STREAM_PORT_RANGE
        for p in range(lo, hi + 1):
            if p not in self._allocated:
                self._allocated.add(p)
                return p
        raise SciStreamError(
            f"S2CS@{self.gateway_ip}: streaming port range "
            f"{STREAM_PORT_RANGE} exhausted")

    def launch_s2ds(self, side: str, forward_ports: tuple[int, ...],
                    num_conn: int, session_uid: str) -> S2DS:
        if num_conn < 1:
            raise SciStreamError("num_conn must be >= 1")
        ds = S2DS(side=side, gateway_ip=self.gateway_ip,
                  listen_port=self._alloc_port(),
                  forward_ports=forward_ports, num_conn=num_conn,
                  session_uid=session_uid)
        self.data_servers.append(ds)
        return ds

    def release(self, session_uid: str) -> None:
        kept = []
        for ds in self.data_servers:
            if ds.session_uid == session_uid:
                self._allocated.discard(ds.listen_port)
            else:
                kept.append(ds)
        self.data_servers = kept


@dataclasses.dataclass
class StreamingSession:
    """Negotiated end-to-end overlay: the connection map of §3.2."""

    uid: str
    num_conn: int
    bandwidth_gbps: float
    consumer_proxy: S2DS
    producer_proxy: S2DS
    connection_map: list[tuple[str, str]]   # (producer endpoint, consumer endpoint)
    tunnel: str = "haproxy"

    @property
    def hops(self) -> list[str]:
        """producer → local proxy → remote proxy → consumer (3 transparent hops)."""
        return [
            "producer",
            f"{self.producer_proxy.gateway_ip}:{self.producer_proxy.listen_port}",
            f"{self.consumer_proxy.gateway_ip}:{self.consumer_proxy.listen_port}",
            "consumer",
        ]


class S2UC:
    """User client: runs the inbound/outbound request sequence of §4.4."""

    def __init__(self) -> None:
        self._pending: dict[str, dict] = {}
        self.sessions: dict[str, StreamingSession] = {}

    def inbound_request(self, *, server_cert: ProxyCertificate,
                        remote_ip: str, s2cs: S2CS,
                        receiver_ports: tuple[int, ...],
                        num_conn: int = 1) -> tuple[int, str]:
        """Create the consumer-side proxy. Returns (PROXY port, UID) exactly
        as the paper's CLI does — both feed the outbound request."""
        if server_cert.fingerprint != s2cs.cert.fingerprint:
            raise SciStreamError("consumer-side certificate mismatch")
        uid = f"uid-{next(_uid_counter):06d}"
        ds = s2cs.launch_s2ds("consumer", receiver_ports, num_conn, uid)
        self._pending[uid] = {
            "consumer_proxy": ds, "remote_ip": remote_ip, "num_conn": num_conn,
        }
        return ds.listen_port, uid

    def outbound_request(self, *, server_cert: ProxyCertificate,
                         remote_ip: str, s2cs: S2CS,
                         receiver_port: int, uid: str,
                         num_conn: int = 1,
                         bandwidth_gbps: float = 1.0,
                         tunnel: str = "haproxy") -> StreamingSession:
        """Create the producer-side proxy and seal the session."""
        if server_cert.fingerprint != s2cs.cert.fingerprint:
            raise SciStreamError("producer-side certificate mismatch")
        if uid not in self._pending:
            raise SciStreamError(f"unknown session UID {uid}")
        pend = self._pending.pop(uid)
        if pend["num_conn"] != num_conn:
            raise SciStreamError(
                f"num_conn mismatch: inbound {pend['num_conn']} vs outbound {num_conn}")
        cons: S2DS = pend["consumer_proxy"]
        if receiver_port != cons.listen_port:
            raise SciStreamError("outbound receiver_port must be the inbound PROXY port")
        prod = s2cs.launch_s2ds("producer", (receiver_port,), num_conn, uid)
        cmap = [
            (f"{prod.gateway_ip}:{prod.listen_port}+{c}",
             f"{cons.gateway_ip}:{cons.listen_port}+{c}")
            for c in range(num_conn)
        ]
        sess = StreamingSession(
            uid=uid, num_conn=num_conn, bandwidth_gbps=bandwidth_gbps,
            consumer_proxy=cons, producer_proxy=prod,
            connection_map=cmap, tunnel=tunnel)
        self.sessions[uid] = sess
        return sess

    def teardown(self, uid: str, producer_s2cs: S2CS, consumer_s2cs: S2CS) -> None:
        self.sessions.pop(uid, None)
        producer_s2cs.release(uid)
        consumer_s2cs.release(uid)


def provision_tenant_tunnels(tenants: int, *, num_conn: int = 1,
                             bandwidth_gbps: float = 1.0,
                             tunnel: str = "stunnel"
                             ) -> list[StreamingSession]:
    """Provision the per-tenant dedicated tunnel pairs of the
    multi-tenant DTS deployment model (paper §6's feasibility argument,
    control-plane side): each tenant runs the full §3.2 handshake
    against the *same* facility gateway pair, getting its own S2DS
    data path (the ``ttun:{t}`` resources the tenant-aware
    :class:`~repro_torch.core.architectures.DirectStreaming` hop graph
    charges).

    This is where per-user DTS provisioning stops scaling in a very
    concrete way: every tenant's session allocates a streaming port on
    each gateway's S2CS, and the §3.2 port range (:data:`STREAM_PORT_RANGE`,
    11 ports) is exhausted after 11 tenants — the control plane refuses
    (:class:`SciStreamError`) long before the 64-tenant sweeps the
    shared-ingress architectures handle.  The data-plane simulator
    deliberately does *not* enforce this cap (so the §6 curves span the
    full sweep); the quantitative study reports it alongside the
    throughput crossover."""
    if tenants < 1:
        raise SciStreamError(f"tenants must be >= 1, got {tenants}")
    s2uc = S2UC()
    cons_s2cs = S2CS("198.51.100.0")
    prod_s2cs = S2CS("198.51.100.1")
    sessions = []
    for t in range(tenants):
        proxy_port, uid = s2uc.inbound_request(
            server_cert=cons_s2cs.cert, remote_ip=f"10.1.1.{100 + t}",
            s2cs=cons_s2cs, receiver_ports=(5672,), num_conn=num_conn)
        sessions.append(s2uc.outbound_request(
            server_cert=prod_s2cs.cert, remote_ip="198.51.100.0",
            s2cs=prod_s2cs, receiver_port=proxy_port, uid=uid,
            num_conn=num_conn, bandwidth_gbps=bandwidth_gbps,
            tunnel=tunnel))
    return sessions


def establish_prs_session(num_conn: int = 1, tunnel: str = "haproxy",
                          bandwidth_gbps: float = 1.0) -> StreamingSession:
    """Convenience: run the full §4.4 handshake on the paper's topology
    (producer-side S2CS at 198.51.100.1, consumer-side at 198.51.100.0)."""
    s2uc = S2UC()
    cons_s2cs = S2CS("198.51.100.0")
    prod_s2cs = S2CS("198.51.100.1")
    proxy_port, uid = s2uc.inbound_request(
        server_cert=cons_s2cs.cert, remote_ip="10.1.1.100",
        s2cs=cons_s2cs, receiver_ports=(5672,), num_conn=num_conn)
    return s2uc.outbound_request(
        server_cert=prod_s2cs.cert, remote_ip="198.51.100.0",
        s2cs=prod_s2cs, receiver_port=proxy_port, uid=uid,
        num_conn=num_conn, bandwidth_gbps=bandwidth_gbps, tunnel=tunnel)
