"""DS2HPC / ACE testbed inventory (paper §3.1, §4.1): the Data Streaming
Nodes (DSNs) at the facility edge and the Andes client nodes, with the
effective link rates the architecture models turn into shared
contention resources.

A framework-free copy of the part of the reference package's
``ds2hpc`` module that the architectures read; names and defaults are
the reference's.
"""

from __future__ import annotations

import dataclasses


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
