"""Edge producers: synthetic detector-event sources shaped like the
paper's workloads (Dstream/Lstream/generic), publishing into the realtime
broker over a chosen architecture's ingest path.

Each producer runs in a thread, generating deterministic payloads (see
Workload.payload) at a target rate, honoring reject-publish backpressure,
and — under the work-sharing-with-feedback pattern — reading steering
replies from its direct reply queue and adapting its event rate.

A copy of the reference package's ``streaming.producers``.  A payload's
seed is the reference's, ``hash(producer_id) % 10**6 + i``: Python
salts ``str`` hashes per process, so a producer's stream equals the
reference's inside one process and differs from one process to the next.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

from repro_torch.core.broker import Message
from repro_torch.core.workloads import Workload
from repro_torch.streaming.rtbroker import RealtimeBroker

_pid = itertools.count()


class EdgeProducer:
    def __init__(self, broker: RealtimeBroker, workload: Workload,
                 queue_of, *, rate_msgs_s: float = 200.0,
                 n_messages: Optional[int] = None,
                 producer_id: Optional[str] = None,
                 reply_queue: Optional[str] = None):
        self.broker = broker
        self.workload = workload
        self.queue_of = queue_of          # fn(i) -> routing key
        self.rate = rate_msgs_s
        self.n_messages = n_messages
        self.id = producer_id or f"edge-{next(_pid)}"
        self.reply_queue = reply_queue
        self.sent = 0
        self.rejected = 0
        self.feedback_seen = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "EdgeProducer":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        if join and self._thread is not None:
            self._thread.join(timeout=10)

    def join(self, timeout: float = 60.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # -- main loop -------------------------------------------------------------
    def _run(self) -> None:
        i = 0
        while not self._stop.is_set():
            if self.n_messages is not None and i >= self.n_messages:
                break
            payload = self.workload.payload(seed=hash(self.id) % 10**6 + i)
            msg = Message(routing_key=self.queue_of(i),
                          size=len(payload), body=payload,
                          producer_id=self.id,
                          reply_to=self.reply_queue,
                          headers={"seq": i, "producer": self.id})
            if self.broker.publish(msg, block=True, timeout=5.0):
                self.sent += 1
                i += 1
            else:
                self.rejected += 1
            if self.rate > 0:
                time.sleep(1.0 / self.rate)

    # -- steering --------------------------------------------------------------
    def poll_feedback(self, timeout: float = 0.1) -> Optional[dict]:
        """Consume one steering reply (work sharing with feedback). The
        trainer publishes metrics; the producer adapts its rate (a stand-in
        for 'adjust beam settings' in the paper's workflows)."""
        if self.reply_queue is None:
            return None
        d = self.broker.consume(self.id, timeout=timeout)
        if d is None:
            return None
        self.broker.ack(self.id, d.delivery_tag)
        self.feedback_seen += 1
        fb = d.message.headers
        if fb.get("slow_down"):
            self.rate = max(1.0, self.rate * 0.5)
        elif fb.get("speed_up"):
            self.rate = self.rate * 1.25
        return fb
