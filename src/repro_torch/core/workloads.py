"""Streaming workload definitions (paper Table 1): message size, the
consumer's per-message processing time, and the deterministic payloads
and token rows the streamed data plane carries.

A framework-free copy of the reference package's workload table, kept
in this package so that the port stands alone.  Names, defaults and
values are the reference's, and so are the payloads and token rows, bit
for bit.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
from typing import Iterator

import numpy as np

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

    def messages_per_second_at_rate(self, gbps: float | None = None) -> float:
        """Message rate needed to sustain ``gbps`` (defaults to nominal)."""
        rate = self.data_rate_gbps if gbps is None else gbps
        return rate * GBIT / self.message_bits

    def payload(self, seed: int) -> bytes:
        """Deterministic pseudo-payload of exactly ``payload_bytes`` bytes.

        Uses a counter-mode SHA256 expansion so tests can assert integrity
        end-to-end without storing real detector data.
        """
        out = bytearray()
        counter = 0
        stem = f"{self.name}:{seed}".encode()
        while len(out) < self.payload_bytes:
            out += hashlib.sha256(stem + counter.to_bytes(8, "little")).digest()
            counter += 1
        return bytes(out[: self.payload_bytes])

    def payload_digest(self, seed: int) -> str:
        return hashlib.sha256(self.payload(seed)).hexdigest()

    def event_stream(self, seed: int, n_messages: int) -> Iterator[bytes]:
        for i in range(n_messages):
            yield self.payload(seed * 1_000_003 + i)


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


def tokens_from_payload(payload: bytes, vocab_size: int, n_tokens: int) -> np.ndarray:
    """Deterministically map a streamed payload to a token sequence.

    This is the bridge the edge-to-HPC training integration uses: a streamed
    detector message becomes training tokens.  (Synthetic, but deterministic
    so a redelivered message yields identical training data, which the
    fault-tolerance guarantees rest on.)  A payload shorter than
    ``4 * n_tokens`` bytes is tiled.
    """
    raw = np.frombuffer(payload, dtype=np.uint8)
    if raw.size < n_tokens * 4:
        reps = int(np.ceil(n_tokens * 4 / max(raw.size, 1)))
        raw = np.tile(raw, reps)
    words = raw[: n_tokens * 4].view("<u4").astype(np.int64)
    return (words % np.int64(vocab_size)).astype(np.int32)
