"""Real-time (wall-clock, threaded) engine over the same broker state
machine the heap engine uses (:class:`repro_torch.core.broker.BrokerCluster`).

This is the data plane the training integration runs on: edge producers
publish detector payloads, the StreamingDataLoader's consumers pull them
with prefetch/ack semantics, and the architecture (DTS/PRS/MSS) optionally
imposes its modeled per-message latency so experiments can compare ingest
paths end-to-end.

A copy of the reference package's ``streaming.rtbroker``, with its lock
and condition discipline, names and defaults.  It runs on the host.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from repro_torch.core.broker import BrokerCluster, Delivery, Message


class RealtimeBroker:
    def __init__(self, n_nodes: int = 3, default_prefetch: int = 64,
                 per_message_latency_s: float = 0.0):
        self._b = BrokerCluster(n_nodes=n_nodes,
                                default_prefetch=default_prefetch)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.per_message_latency_s = per_message_latency_s
        self._closed = False
        # deliveries popped round-robin for other consumers while one
        # consumer polls; drained before new broker pops
        self._pending: dict[str, list[Delivery]] = {}

    # -- topology -------------------------------------------------------------
    def declare_queue(self, name: str, **kw) -> None:
        with self._lock:
            self._b.declare_queue(name, **kw)

    def declare_fanout(self, exchange: str, queues: list[str]) -> None:
        with self._lock:
            self._b.declare_fanout(exchange, queues)

    def register_consumer(self, consumer_id: str, queue: str,
                          prefetch: Optional[int] = None) -> None:
        with self._cv:
            self._b.register_consumer(consumer_id, queue, prefetch)
            self._cv.notify_all()

    # -- data plane -------------------------------------------------------------
    def publish(self, msg: Message, block: bool = True,
                timeout: float = 10.0) -> bool:
        """Publish with reject-publish backpressure: blocks and retries
        until accepted (or timeout) when the queue is full."""
        if self.per_message_latency_s:
            time.sleep(self.per_message_latency_s)
        deadline = time.monotonic() + timeout
        while True:
            with self._cv:
                ok, _ = self._b.publish(msg)
                if ok:
                    self._cv.notify_all()
                    return True
            if not block or time.monotonic() >= deadline:
                return False
            time.sleep(0.005)

    def consume(self, consumer_id: str, timeout: float = 5.0
                ) -> Optional[Delivery]:
        """Blocking pull of the next delivery for this consumer; ``None``
        at once when the consumer is not registered (never was, or
        crashed), else after ``timeout``."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while not self._closed:
                ch = self._b.channels.get(consumer_id)
                if ch is None:
                    return None
                d = self._next_for(consumer_id)
                if d is not None:
                    return d
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cv.wait(timeout=min(remaining, 0.25))
        return None

    def _next_for(self, consumer_id: str) -> Optional[Delivery]:
        pend = self._pending.get(consumer_id)
        if pend:
            return pend.pop(0)
        ch = self._b.channels[consumer_id]
        if ch.window_available <= 0:
            return None
        # pump until this consumer gets one (round-robin may pick others
        # first; their deliveries stay pending on their channels)
        d = self._b.next_delivery(ch.queue)
        while d is not None and d.consumer_id != consumer_id:
            self._pending.setdefault(d.consumer_id, []).append(d)
            d = self._b.next_delivery(ch.queue)
        return d

    def ack(self, consumer_id: str, delivery_tag: int,
            multiple: bool = False) -> int:
        with self._cv:
            n = self._b.ack(consumer_id, delivery_tag, multiple)
            self._cv.notify_all()
            return n

    # -- fault injection -------------------------------------------------------
    def consumer_crash(self, consumer_id: str) -> int:
        """Kill a consumer: its unacked messages are redelivered (paper §6:
        'rare events will not be lost')."""
        with self._cv:
            self._pending.pop(consumer_id, None)
            n = self._b.consumer_crash(consumer_id)
            self._cv.notify_all()
            return n

    def queue_depth(self, name: str) -> int:
        with self._lock:
            return len(self._b.queues[name])

    def stats(self, name: str):
        with self._lock:
            return self._b.queues[name].stats

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
