"""Cross-facility streaming architecture models: DTS, PRS, MSS (paper §2, §4).

Each architecture is an explicit *hop graph*: an ordered list of path
elements a message traverses from a producer into the streaming service
(publish path) and from the service out to a consumer (delivery path).
Elements reference *shared resources* (links, CPU pools, tunnels, ingress
workers) by key, so contention between flows is modeled where the
paper's deployments share hardware:

* **DTS**: producer —TLS/AMQPS→ NodePort on a DSN RabbitMQ node.
* **PRS** (SciStream): producer —AMQP→ producer-side S2DS proxy —mTLS
  overlay tunnel (Stunnel or HAProxy)→ consumer-side proxy —SDN→ RabbitMQ.
* **MSS**: producer —TLS:443→ hardware load balancer → OpenShift ingress
  → RabbitMQ; deliveries traverse the ingress in the opposite direction.

A framework-free copy of the reference package's ``architectures``
module.  Every resource, path, calibration constant and deployment
feasibility text is the reference's, so every engine of the port sees
the same hop graphs; PRS keeps an optional SciStream session and MSS an
optional S3M cluster handle, which no hop graph reads.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Optional

from repro_torch.core.ds2hpc import ClusterInventory
from repro_torch.core.workloads import GBIT

if TYPE_CHECKING:
    from repro_torch.core.s3m import ManagedCluster
    from repro_torch.core.scistream import StreamingSession


@dataclasses.dataclass(frozen=True)
class ResourceSpec:
    """A shared contention point. kind:
    - "pipe":   FIFO byte pipe; hold = service_s + size/rate_Bps
    - "pool":   k-server pool;  hold = service_s + size*per_byte_s
    """

    key: str
    kind: str
    rate_Bps: float = 0.0
    servers: int = 1
    service_s: float = 0.0
    per_byte_s: float = 0.0
    conn_limit: Optional[int] = None   # max distinct client connections


@dataclasses.dataclass(frozen=True)
class PathElement:
    """One traversal step: occupy ``resource`` (if any), then add
    ``latency_s`` of pure propagation/processing delay."""

    resource: Optional[str]
    latency_s: float = 0.0
    # multiplier on message size at this element (TLS record + framing)
    byte_factor: float = 1.0
    extra_bytes: int = 0


@dataclasses.dataclass
class Calibration:
    """Fit parameters that reproduce the paper's headline measurements."""

    # Client (Andes) 1 Gbps NICs: ~88% effective TCP goodput.
    client_link_eff: float = 0.88
    # DSN NodePort effective bandwidth.
    dsn_link_gbps: float = 1.87
    # OpenShift SDN internal (pod-to-pod) network between DSNs.
    dsn_internal_gbps: float = 10.0
    # Per-message wire overhead (TCP/IP + AMQP framing).
    frame_bytes: int = 1400
    # TLS per-byte inflation + per-message CPU at each TLS endpoint.
    tls_byte_factor: float = 1.02
    tls_msg_cpu_s: float = 18e-6
    # RabbitMQ per-message CPU (publish / deliver), 12-core pods -> pool.
    broker_publish_cpu_s: float = 22e-6
    broker_deliver_cpu_s: float = 18e-6
    broker_cpu_workers: int = 12
    broker_per_byte_s: float = 1.0 / (2.2e9)   # ~memcpy-bound per node
    # Client-library batching/flush delay per direction.
    client_flush_s: float = 0.4e-3
    # Small-message receive latency, applied for messages < 64 KiB.
    small_msg_latency_s: float = 8.0e-3
    small_msg_threshold: int = 64 * 1024
    # Intra-cluster (SDN) hop latency when crossing broker nodes.
    intercluster_hop_s: float = 0.25e-3
    # --- PRS (SciStream) ---
    proxy_msg_cpu_s: float = 20e-6          # S2DS per-message forward cost
    proxy_latency_s: float = 0.35e-3
    tunnel_gbps_haproxy: float = 5.0
    tunnel_msg_service_s: float = 26.5e-6
    tunnel_gbps_stunnel: float = 0.95
    stunnel_service_s: float = 25e-6        # single serialized TLS flow
    stunnel_conn_limit: int = 16            # hard cap from the paper
    haproxy_flow_penalty: float = 0.010
    haproxy_penalty_after: int = 8
    prs_client_flush_s: float = 0.3e-3
    # --- MSS ---
    lb_latency_s: float = 0.6e-3
    ingress_gbps: float = 2.05              # inbound
    ingress_out_gbps: float = 3.9           # outbound
    ingress_out_msg_service_s: float = 29e-6
    ingress_msg_cpu_s: float = 50e-6
    ingress_worker_MBps: float = 110.0      # per-connection worker rate
    ingress_workers: int = 8
    mss_extra_latency_s: float = 1.2e-3     # route controller / FQDN path
    prs_small_msg_latency_s: float = 6.5e-3
    # --- multi-tenant DTS (per-tenant S2DS tunnels, §6 deployment study) ---
    dts_tenant_tunnel_gbps: float = 10.0    # dedicated per-tenant pair
    dts_tenant_tunnel_service_s: float = 15e-6
    dts_gw_gbps: float = 3.74
    dts_gw_service_s: float = 6e-6          # per-message gateway forward
    dts_tenant_gw_penalty: float = 0.15
    dts_tenant_gw_after: int = 4


DEFAULT_CALIBRATION = Calibration()

# PRS proxy placement (paper §4.4: producer/consumer S2CS pods on two
# separate DSNs).
PPROXY_NODE = 0
CPROXY_NODE = 1


class Architecture:
    """Base: owns resource specs + path constructors.

    An architecture whose hop graph differs *per tenant* (DTS's dedicated
    per-tenant tunnels) sets :attr:`tenant_paths` in :meth:`configure`
    and reads the ``tenant`` argument of the path constructors."""

    name: str = "base"
    deployment_feasibility: str = ""
    tenant_paths: bool = False

    def __init__(self, inventory: Optional[ClusterInventory] = None,
                 cal: Optional[Calibration] = None) -> None:
        self.inv = inventory or ClusterInventory()
        self.cal = cal or DEFAULT_CALIBRATION
        self._specs: dict[str, ResourceSpec] = {}
        self._build_common()
        self._build()

    def _build_common(self) -> None:
        c, inv = self.cal, self.inv
        client_Bps = inv.client_link_gbps * GBIT / 8.0 * c.client_link_eff
        # client NICs are full duplex: TX and RX are separate resources
        for i in range(inv.n_producer_nodes):
            self._add(ResourceSpec(f"plink:{i}", "pipe", rate_Bps=client_Bps))
            self._add(ResourceSpec(f"plink_rx:{i}", "pipe", rate_Bps=client_Bps))
        for i in range(inv.n_consumer_nodes):
            self._add(ResourceSpec(f"clink:{i}", "pipe", rate_Bps=client_Bps))
            self._add(ResourceSpec(f"clink_tx:{i}", "pipe", rate_Bps=client_Bps))
        dsn_Bps = c.dsn_link_gbps * GBIT / 8.0
        int_Bps = c.dsn_internal_gbps * GBIT / 8.0
        for i in range(inv.n_dsn):
            self._add(ResourceSpec(f"dsn_in:{i}", "pipe", rate_Bps=dsn_Bps))
            self._add(ResourceSpec(f"dsn_out:{i}", "pipe", rate_Bps=dsn_Bps))
            self._add(ResourceSpec(f"dsn_int:{i}", "pipe", rate_Bps=int_Bps))
            self._add(ResourceSpec(
                f"bcpu:{i}", "pool", servers=c.broker_cpu_workers,
                per_byte_s=c.broker_per_byte_s))

    def _build(self) -> None:  # per-arch extra resources
        pass

    def configure(self, n_producers: int, n_consumers: int,
                  tenants: int = 1) -> None:
        """Experiment-size-dependent adjustments (idempotent)."""
        pass

    def _add(self, spec: ResourceSpec) -> None:
        self._specs[spec.key] = spec

    @property
    def resources(self) -> dict[str, ResourceSpec]:
        return dict(self._specs)

    def _tls(self, el: PathElement) -> PathElement:
        return dataclasses.replace(
            el, byte_factor=el.byte_factor * self.cal.tls_byte_factor,
            latency_s=el.latency_s + self.cal.tls_msg_cpu_s)

    def _broker_ingest(self, connected_node: int, home_node: int) -> list[PathElement]:
        """From the node a client is connected to, to the queue's home."""
        c = self.cal
        els = [PathElement(f"bcpu:{connected_node}",
                           latency_s=c.broker_publish_cpu_s)]
        if home_node != connected_node:
            els.append(PathElement(f"dsn_int:{connected_node}",
                                   latency_s=c.intercluster_hop_s))
            els.append(PathElement(f"bcpu:{home_node}",
                                   latency_s=c.broker_publish_cpu_s * 0.5))
        return els

    def _broker_egress(self, home_node: int, connected_node: int) -> list[PathElement]:
        """From the queue's home to the node the consumer is connected to."""
        c = self.cal
        els = [PathElement(f"bcpu:{home_node}",
                           latency_s=c.broker_deliver_cpu_s)]
        if home_node != connected_node:
            els.append(PathElement(f"dsn_int:{home_node}",
                                   latency_s=c.intercluster_hop_s))
            els.append(PathElement(f"bcpu:{connected_node}",
                                   latency_s=c.broker_deliver_cpu_s * 0.5))
        return els

    def publish_path(self, producer_node: int, broker_node: int,
                     home_node: int, tenant: int = 0) -> list[PathElement]:
        """producer client -> enqueued at the queue's home node."""
        raise NotImplementedError

    def delivery_path(self, broker_node: int, home_node: int,
                      consumer_node: int, tenant: int = 0) -> list[PathElement]:
        """queue home -> consumer client, exiting via ``broker_node``."""
        raise NotImplementedError

    @staticmethod
    def _swap_prefix(els: list[PathElement], frm: str, to: str) -> list[PathElement]:
        out = []
        for el in els:
            r = el.resource
            if r is not None and r.startswith(frm):
                r = to + r[len(frm):]
            out.append(dataclasses.replace(el, resource=r))
        return out

    def reply_publish_path(self, consumer_node: int, broker_node: int,
                           home_node: int, tenant: int = 0) -> list[PathElement]:
        """Consumer -> broker for replies: mirrors the publish path."""
        return self._swap_prefix(
            self.publish_path(consumer_node, broker_node, home_node,
                              tenant=tenant),
            "plink:", "clink_tx:")

    def reply_delivery_path(self, home_node: int, broker_node: int,
                            producer_node: int, tenant: int = 0) -> list[PathElement]:
        """Broker -> producer for replies: mirrors the delivery path."""
        return self._swap_prefix(
            self.delivery_path(broker_node, home_node, producer_node,
                               tenant=tenant),
            "clink:", "plink_rx:")

    def control_latency_s(self) -> float:
        """One-way latency for small control frames (acks/confirms)."""
        return 0.2e-3

    def producer_conn_limit(self) -> Optional[int]:
        return None

    def client_flush_s(self) -> float:
        return self.cal.client_flush_s

    def recv_latency_s(self, size: int) -> float:
        """Receive-side client latency: flush + small-message penalty."""
        extra = (self.cal.small_msg_latency_s
                 if size < self.cal.small_msg_threshold else 0.0)
        return self.client_flush_s() + extra


class DirectStreaming(Architecture):
    """DTS: NodePort-exposed brokers, AMQPS end-to-end.  With
    ``tenants > 1`` each tenant gets a dedicated S2DS tunnel pair
    terminating on the facility's shared edge gateway."""

    name = "dts"
    deployment_feasibility = (
        "requires firewall/iptables rules, NodePort + DNS admin; viable only "
        "within unified administrative domains")

    def configure(self, n_producers: int, n_consumers: int,
                  tenants: int = 1) -> None:
        c = self.cal
        self._tenants = tenants
        self.tenant_paths = tenants > 1
        if tenants <= 1:
            return
        over = max(0, tenants - c.dts_tenant_gw_after)
        infl = 1.0 + c.dts_tenant_gw_penalty * over
        self._add(ResourceSpec(
            "dts_gw_in", "pipe", rate_Bps=c.dts_gw_gbps * GBIT / 8.0,
            service_s=c.dts_gw_service_s * infl))
        self._add(ResourceSpec(
            "dts_gw_out", "pipe", rate_Bps=c.dts_gw_gbps * GBIT / 8.0,
            service_s=c.dts_gw_service_s * infl))
        svc = c.dts_tenant_tunnel_service_s * infl
        for t in range(tenants):
            self._add(ResourceSpec(
                f"ttun:{t}", "pool", servers=2, service_s=svc,
                per_byte_s=8.0 / (c.dts_tenant_tunnel_gbps * GBIT)))

    def publish_path(self, producer_node: int, broker_node: int,
                     home_node: int, tenant: int = 0) -> list[PathElement]:
        c = self.cal
        if self.tenant_paths:
            els = [
                self._tls(PathElement(f"plink:{producer_node}",
                                      extra_bytes=c.frame_bytes)),
                PathElement(f"ttun:{tenant}", latency_s=c.proxy_latency_s),
                self._tls(PathElement("dts_gw_in")),
                PathElement(f"dsn_int:{broker_node}"),
            ]
            els += self._broker_ingest(broker_node, home_node)
            return els
        els = [
            self._tls(PathElement(f"plink:{producer_node}",
                                  extra_bytes=c.frame_bytes)),
            self._tls(PathElement(f"dsn_in:{broker_node}")),
        ]
        els += self._broker_ingest(broker_node, home_node)
        return els

    def delivery_path(self, broker_node: int, home_node: int,
                      consumer_node: int, tenant: int = 0) -> list[PathElement]:
        c = self.cal
        els = self._broker_egress(home_node, broker_node)
        if self.tenant_paths:
            els += [
                PathElement(f"dsn_int:{broker_node}"),
                self._tls(PathElement("dts_gw_out",
                                      extra_bytes=c.frame_bytes)),
                PathElement(f"ttun:{tenant}", latency_s=c.proxy_latency_s),
                self._tls(PathElement(f"clink:{consumer_node}")),
            ]
            return els
        els += [
            self._tls(PathElement(f"dsn_out:{broker_node}",
                                  extra_bytes=c.frame_bytes)),
            self._tls(PathElement(f"clink:{consumer_node}")),
        ]
        return els


class ProxiedStreaming(Architecture):
    """PRS: S2DS proxies + overlay tunnel (Stunnel or HAProxy)."""

    name = "prs"
    deployment_feasibility = (
        "moderate: proxies on pre-authorized gateway nodes (DTNs/DSNs); "
        "overcomes NAT/firewalls with centralized rules")

    def __init__(self, inventory: Optional[ClusterInventory] = None,
                 cal: Optional[Calibration] = None,
                 tunnel: str = "haproxy", num_conns: int = 1,
                 session: Optional["StreamingSession"] = None) -> None:
        if tunnel not in ("haproxy", "stunnel"):
            raise ValueError(f"unknown tunnel {tunnel!r}")
        self.tunnel = tunnel
        self.num_conns = num_conns
        self.session = session      # optional scistream.StreamingSession
        super().__init__(inventory, cal)
        self.name = f"prs-{tunnel}" + (f"-c{num_conns}" if num_conns > 1 else "")

    def _build(self) -> None:
        c = self.cal
        if self.tunnel == "stunnel":
            # One long-lived TLS flow: a single-server pool serializes all
            # messages (no load balancing) + hard connection limit.
            self._add(ResourceSpec(
                "tunnel", "pool", servers=1,
                service_s=c.stunnel_service_s,
                per_byte_s=8.0 / (c.tunnel_gbps_stunnel * GBIT),
                conn_limit=c.stunnel_conn_limit))
        else:
            self._add(ResourceSpec(
                "tunnel", "pipe",
                rate_Bps=c.tunnel_gbps_haproxy * GBIT / 8.0,
                service_s=c.tunnel_msg_service_s))
        self._add(ResourceSpec("pproxy", "pool", servers=4,
                               service_s=c.proxy_msg_cpu_s))
        self._add(ResourceSpec("cproxy", "pool", servers=4,
                               service_s=c.proxy_msg_cpu_s))

    def configure(self, n_producers: int, n_consumers: int,
                  tenants: int = 1) -> None:
        self._tenants = tenants
        if self.tunnel != "haproxy":
            return
        c = self.cal
        # the single-process proxy's event loop serializes every
        # multiplexed flow
        over = max(0, n_producers - c.haproxy_penalty_after)
        svc = c.tunnel_msg_service_s * (1.0 + c.haproxy_flow_penalty * over)
        self._add(dataclasses.replace(self._specs["tunnel"], service_s=svc))

    def producer_conn_limit(self) -> Optional[int]:
        return self.cal.stunnel_conn_limit if self.tunnel == "stunnel" else None

    def client_flush_s(self) -> float:
        return self.cal.prs_client_flush_s

    def recv_latency_s(self, size: int) -> float:
        extra = (self.cal.prs_small_msg_latency_s
                 if size < self.cal.small_msg_threshold else 0.0)
        return self.client_flush_s() + extra

    def _tunnel_leg(self) -> list[PathElement]:
        return [self._tls(PathElement("tunnel"))]

    def publish_path(self, producer_node: int, broker_node: int,
                     home_node: int, tenant: int = 0) -> list[PathElement]:
        c = self.cal
        els = [
            PathElement(f"plink:{producer_node}", extra_bytes=c.frame_bytes),
            PathElement("pproxy", latency_s=c.proxy_latency_s),
        ]
        els += self._tunnel_leg()
        els += [
            PathElement("cproxy", latency_s=c.proxy_latency_s),
            PathElement(f"dsn_int:{CPROXY_NODE}"),
            PathElement(f"bcpu:{home_node}",
                        latency_s=c.broker_publish_cpu_s),
        ]
        return els

    def delivery_path(self, broker_node: int, home_node: int,
                      consumer_node: int, tenant: int = 0) -> list[PathElement]:
        # consumers are inside the facility: direct AMQP, no tunnel
        els = self._broker_egress(home_node, broker_node)
        els += [
            PathElement(f"dsn_out:{broker_node}", extra_bytes=self.cal.frame_bytes),
            PathElement(f"clink:{consumer_node}"),
        ]
        return els

    def reply_publish_path(self, consumer_node: int, broker_node: int,
                           home_node: int, tenant: int = 0
                           ) -> list[PathElement]:
        els = [
            PathElement(f"clink_tx:{consumer_node}",
                        extra_bytes=self.cal.frame_bytes),
            PathElement(f"dsn_in:{broker_node}"),
        ]
        els += self._broker_ingest(broker_node, home_node)
        return els

    def reply_delivery_path(self, home_node: int, broker_node: int,
                            producer_node: int, tenant: int = 0
                            ) -> list[PathElement]:
        """Replies back to external producers re-traverse the tunnel."""
        c = self.cal
        els = [
            PathElement(f"bcpu:{home_node}", latency_s=c.broker_deliver_cpu_s),
            PathElement(f"dsn_int:{home_node}"),
            PathElement("cproxy", latency_s=c.proxy_latency_s),
        ]
        els += self._tunnel_leg()
        els += [
            PathElement("pproxy", latency_s=c.proxy_latency_s),
            PathElement(f"plink_rx:{producer_node}", extra_bytes=c.frame_bytes),
        ]
        return els


class ManagedServiceStreaming(Architecture):
    """MSS: FQDN:443 via hardware LB + OpenShift ingress.  Producers *and*
    consumers traverse LB+ingress."""

    name = "mss"
    deployment_feasibility = (
        "highest: user needs only outbound 443; facility manages routing, "
        "DNS, TLS, provisioning (S3M API)")

    def __init__(self, inventory: Optional[ClusterInventory] = None,
                 cal: Optional[Calibration] = None,
                 managed_cluster: Optional["ManagedCluster"] = None) -> None:
        self.managed_cluster = managed_cluster   # from s3m.provision_cluster
        super().__init__(inventory, cal)

    def _build(self) -> None:
        c = self.cal
        self._add(ResourceSpec("lb", "pool", servers=16, service_s=15e-6))
        self._add(ResourceSpec(
            "ingress_in", "pipe", rate_Bps=c.ingress_gbps * GBIT / 8.0))
        self._add(ResourceSpec(
            "ingress_out", "pipe",
            rate_Bps=c.ingress_out_gbps * GBIT / 8.0,
            service_s=c.ingress_out_msg_service_s))
        # per-connection HTTP/TLS-terminating workers: one connection pins
        # to one worker (single-threaded termination)
        for d in ("in", "out"):
            for w in range(c.ingress_workers):
                self._add(ResourceSpec(
                    f"ingw_{d}:{w}", "pool", servers=1,
                    service_s=c.ingress_msg_cpu_s,
                    per_byte_s=1.0 / (c.ingress_worker_MBps * 1e6)))

    def _worker(self, node: int) -> int:
        return node % self.cal.ingress_workers

    def publish_path(self, producer_node: int, broker_node: int,
                     home_node: int, tenant: int = 0) -> list[PathElement]:
        c = self.cal
        els = [
            self._tls(PathElement(f"plink:{producer_node}",
                                  extra_bytes=c.frame_bytes)),
            PathElement("lb", latency_s=c.lb_latency_s),
            self._tls(PathElement(f"ingw_in:{self._worker(producer_node)}")),
            PathElement("ingress_in", latency_s=c.mss_extra_latency_s,
                        byte_factor=c.tls_byte_factor,
                        extra_bytes=c.frame_bytes),
            PathElement(f"dsn_int:{home_node}"),
            PathElement(f"bcpu:{home_node}", latency_s=c.broker_publish_cpu_s),
        ]
        return els

    def delivery_path(self, broker_node: int, home_node: int,
                      consumer_node: int, tenant: int = 0) -> list[PathElement]:
        c = self.cal
        els = [
            PathElement(f"bcpu:{home_node}", latency_s=c.broker_deliver_cpu_s),
            PathElement(f"dsn_int:{home_node}"),
            PathElement("ingress_out", latency_s=c.mss_extra_latency_s,
                        byte_factor=c.tls_byte_factor,
                        extra_bytes=c.frame_bytes),
            self._tls(PathElement(f"ingw_out:{self._worker(consumer_node)}")),
            PathElement("lb", latency_s=c.lb_latency_s),
            self._tls(PathElement(f"clink:{consumer_node}",
                                  extra_bytes=c.frame_bytes)),
        ]
        return els

    def control_latency_s(self) -> float:
        return 0.2e-3 + self.cal.lb_latency_s + self.cal.mss_extra_latency_s


def make_architecture(name: str, inventory: Optional[ClusterInventory] = None,
                      cal: Optional[Calibration] = None,
                      **kw: Any) -> Architecture:
    """``name``: dts | prs-stunnel | prs-haproxy | prs-haproxy-c4 | mss."""
    if name == "dts":
        return DirectStreaming(inventory, cal)
    if name == "mss":
        return ManagedServiceStreaming(inventory, cal, **kw)
    if name.startswith("prs"):
        parts = name.split("-")
        tunnel = parts[1] if len(parts) > 1 else "haproxy"
        num_conns = 1
        for p in parts[2:]:
            if p.startswith("c"):
                num_conns = int(p[1:])
        return ProxiedStreaming(inventory, cal, tunnel=tunnel,
                                num_conns=num_conns, **kw)
    raise ValueError(f"unknown architecture {name!r}")


ALL_ARCHITECTURES = ("dts", "prs-stunnel", "prs-haproxy", "prs-haproxy-c4", "mss")
