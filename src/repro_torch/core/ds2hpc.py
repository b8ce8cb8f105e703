"""DS2HPC / ACE testbed inventory (paper §3.1, §4.1, §4.3): the Data
Streaming Nodes (DSNs) at the facility edge and the Andes client nodes,
with the effective link rates the architecture models turn into shared
contention resources, the producer/consumer -> node maps both StreamSim
engines read, and the deployment descriptors of §4.3 (NodePort
allocation, range 30000-32767, AMQP 30672 / AMQPS 30671; the Bitnami
Helm release: 3 replicas with pod anti-affinity across DSNs, 12 CPUs +
32 GiB per pod, TLS, 512 MiB max message).

A copy of the reference package's ``ds2hpc`` module; names, defaults
and error messages are the reference's.  The NodePort counter is this
module's own.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from repro_torch.core.workloads import GBIT, MIB


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    name: str
    cores: int
    ghz: float
    ram_gib: int
    nic_gbps: float          # effective, not nameplate
    nic_capable_gbps: float


DSN_SPEC = NodeSpec("dsn", cores=64, ghz=2.70, ram_gib=512,
                    nic_gbps=1.0, nic_capable_gbps=100.0)
ANDES_SPEC = NodeSpec("andes", cores=32, ghz=3.0, ram_gib=256,
                      nic_gbps=1.0, nic_capable_gbps=1.0)

NODEPORT_RANGE = (30000, 32767)
AMQP_NODEPORT = 30672
AMQPS_NODEPORT = 30671


@dataclasses.dataclass
class ClusterInventory:
    """The emulated testbed: 3 DSNs (brokers/proxies) + Andes clients."""

    n_dsn: int = 3
    n_producer_nodes: int = 16
    n_consumer_nodes: int = 16
    dsn: NodeSpec = DSN_SPEC
    client: NodeSpec = ANDES_SPEC
    # §6: effective link between Andes and the DSNs
    client_link_gbps: float = 1.0
    dsn_link_gbps: float = 1.0

    def client_link_Bps(self) -> float:
        return self.client_link_gbps * GBIT / 8.0

    def dsn_link_Bps(self) -> float:
        return self.dsn_link_gbps * GBIT / 8.0

    def producer_node_of(self, producer_idx: int) -> int:
        return producer_idx % self.n_producer_nodes

    def consumer_node_of(self, consumer_idx: int) -> int:
        return consumer_idx % self.n_consumer_nodes

    def highspeed(self) -> "ClusterInventory":
        """Paper §6 projection: DSN 100 Gbps NICs fully usable."""
        return dataclasses.replace(
            self, dsn_link_gbps=100.0, client_link_gbps=10.0
        )


# --------------------------------------------------------------------------
# Deployment descriptors (Helm-chart / NodePort mechanics of §4.3)
# --------------------------------------------------------------------------

_nodeport_counter = itertools.count(30600)


@dataclasses.dataclass
class NodePortService:
    name: str
    node: int
    port: int

    @staticmethod
    def allocate(name: str, node: int, port: Optional[int] = None) -> "NodePortService":
        p = next(_nodeport_counter) if port is None else port
        lo, hi = NODEPORT_RANGE
        if not (lo <= p <= hi):
            raise ValueError(f"NodePort {p} outside {NODEPORT_RANGE}")
        return NodePortService(name, node, p)


@dataclasses.dataclass
class RabbitMQRelease:
    """Mirror of the Bitnami Helm values the paper deploys (§4.3):
    3 replicas, pod anti-affinity (one server per DSN), 12 CPUs + 32 GiB per
    pod, 15 GiB persistent storage, TLS with auto-generated certs, NodePorts
    30672 (AMQP) / 30671 (AMQPS)."""

    namespace: str = "abc123"
    replicas: int = 3
    cpus_per_pod: int = 12
    ram_gib_per_pod: int = 32
    storage_gib_per_pod: int = 15
    tls: bool = True
    amqp_nodeport: int = AMQP_NODEPORT
    amqps_nodeport: int = AMQPS_NODEPORT
    max_message_bytes: int = 512 * MIB   # 536870912, from the S3M example

    def pod_placement(self, inventory: ClusterInventory) -> list[int]:
        """Anti-affinity: each server pod on a distinct DSN."""
        if self.replicas > inventory.n_dsn:
            raise ValueError("anti-affinity violated: more replicas than DSNs")
        return list(range(self.replicas))

    def helm_command(self) -> str:
        return (
            f"helm install rabbitmq bitnami/rabbitmq "
            f"--namespace {self.namespace} -f rabbit.yaml"
        )
