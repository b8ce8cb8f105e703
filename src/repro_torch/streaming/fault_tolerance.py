"""Fault-tolerance and elasticity helpers for the streaming data plane.

The primitives live where they act — redelivery in the broker state
machine (`core.broker.BrokerCluster.consumer_crash`), crash injection +
elastic consumer groups on the loader (`streaming.ingest`), atomic/async
checkpointing in `repro_torch.checkpoint`. This module composes them into
the operations a cluster controller would drive.

A copy of the reference package's ``streaming.fault_tolerance``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.streaming.ingest import StreamingDataLoader


@dataclasses.dataclass
class FailureEvent:
    t: float
    kind: str    # consumer-crash | consumer-respawn | straggler-replaced
    detail: str  # | resize
    redelivered: int = 0


class ElasticConsumerGroup:
    """Controller-view of the loader's consumer group: crash, respawn,
    resize — every transition logged with its redelivery count (the
    paper's 'rare events will not be lost' guarantee, §6).

    ``clock`` stamps the event log: pass the driving engine's sim-time
    callable to keep the log ordered with simulated time (the chaos
    campaign's epoch boundaries), or leave the default —
    ``time.monotonic``, not ``time.time``, so NTP steps can never
    reorder a controller log.
    """

    def __init__(self, loader: StreamingDataLoader,
                 clock: Optional[Callable[[], float]] = None):
        self.loader = loader
        self.clock = clock if clock is not None else time.monotonic
        self.log: list[FailureEvent] = []

    @property
    def size(self) -> int:
        return len(self.loader._consumer_ids)

    def crash(self, consumer_id: str) -> int:
        n = self.loader.crash_consumer(consumer_id)
        self.log.append(FailureEvent(self.clock(), "consumer-crash",
                                     consumer_id, redelivered=n))
        return n

    def respawn(self) -> str:
        cid = self.loader.add_consumer()
        self.log.append(FailureEvent(self.clock(), "consumer-respawn",
                                     cid))
        return cid

    def scale_to(self, n: int) -> None:
        """Resize the group to ``n`` consumers.  Growth spawns fresh
        consumers (work-queue semantics rebalance automatically);
        shrink retires the newest consumers by crashing them — their
        unacked messages redistribute to the survivors."""
        if n < 1:
            raise ValueError("consumer group size must be >= 1")
        while self.size < n:
            self.respawn()
        while self.size > n:
            self.crash(self.loader._consumer_ids[-1])
        self.log.append(FailureEvent(self.clock(), "resize", f"-> {n}"))

    def kill_straggler(self, consumer_id: str) -> str:
        """Straggler mitigation beyond the work-queue's natural balancing:
        forcibly reassign a slow consumer's in-flight work and respawn a
        replacement — logged as one composite transition (a controller
        replaces a straggler atomically; it never passes through a
        shrunken-group state)."""
        n = self.loader.crash_consumer(consumer_id)
        cid = self.loader.add_consumer()
        self.log.append(FailureEvent(
            self.clock(), "straggler-replaced",
            f"{consumer_id} -> {cid}", redelivered=n))
        return cid
