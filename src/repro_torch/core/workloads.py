"""Streaming workload definitions (paper Table 1), as the wave path reads
them: message size and the consumer's per-message processing time.

A framework-free copy of the reference package's workload table, kept
in this package so that the port stands alone.  Names, defaults and
values are the reference's.
"""

from __future__ import annotations

import dataclasses
import enum

KIB = 1024
MIB = 1024 * 1024
GBIT = 1e9  # network giga (decimal), as in "1 Gbps Ethernet"


class PayloadFormat(enum.Enum):
    BINARY = "binary"
    HDF5 = "hdf5"
    JSON = "json"


class Parallelism(enum.Enum):
    MPI = "mpi"
    NON_MPI = "non-mpi"


@dataclasses.dataclass(frozen=True)
class Workload:
    """Streaming characteristics of one workload (one column of Table 1)."""

    name: str
    payload_bytes: int           # bytes per *message* as streamed
    payload_format: PayloadFormat
    payload_element: str         # "events" | "variables"
    events_per_message: int      # 1 => one item per message
    event_bytes: int             # bytes per element (payload_bytes / events)
    data_rate_gbps: float        # nominal source data rate (detector-side)
    consumption_parallelism: Parallelism
    production_parallelism: Parallelism
    #: consumer-side parse+handle cost (seconds/message) on the Andes
    #: clients; None derives it from payload size at Dstream's per-byte rate
    consumer_proc_s: "float | None" = None

    @property
    def message_bits(self) -> int:
        return self.payload_bytes * 8

    def proc_time_s(self) -> float:
        """Per-message consumer processing time."""
        if self.consumer_proc_s is not None:
            return self.consumer_proc_s
        return 80e-6 * self.payload_bytes / 16384


DSTREAM = Workload(
    name="dstream",
    payload_bytes=16 * KIB,          # 8 events x 2 KiB (paper fixes these)
    payload_format=PayloadFormat.BINARY,
    payload_element="events",
    events_per_message=8,
    event_bytes=2 * KIB,
    data_rate_gbps=32.0,
    consumption_parallelism=Parallelism.NON_MPI,
    production_parallelism=Parallelism.NON_MPI,
    consumer_proc_s=80e-6,
)

LSTREAM = Workload(
    name="lstream",
    payload_bytes=1 * MIB,
    payload_format=PayloadFormat.HDF5,
    payload_element="events",
    events_per_message=1,            # one HDF5 file per message
    event_bytes=1 * MIB,
    data_rate_gbps=30.0,
    consumption_parallelism=Parallelism.MPI,
    production_parallelism=Parallelism.MPI,
    consumer_proc_s=1.2e-3,
)

GENERIC = Workload(
    name="generic",
    payload_bytes=4 * MIB,
    payload_format=PayloadFormat.BINARY,
    payload_element="variables",
    events_per_message=1,            # one item per message
    event_bytes=4 * MIB,
    data_rate_gbps=25.0,
    consumption_parallelism=Parallelism.MPI,
    production_parallelism=Parallelism.MPI,
    consumer_proc_s=3.0e-3,
)

WORKLOADS: dict[str, Workload] = {
    w.name: w for w in (DSTREAM, LSTREAM, GENERIC)
}


def get_workload(name: str) -> Workload:
    try:
        return WORKLOADS[name]
    except KeyError:
        raise KeyError(
            f"unknown workload {name!r}; options: {sorted(WORKLOADS)}"
        ) from None
