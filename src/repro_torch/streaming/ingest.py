"""StreamingDataLoader: the edge→HPC work-sharing data plane feeding the
training loop (paper pattern #1 mapped onto data parallelism).

N consumer threads pull detector messages from the shared work queues
(round-robin, prefetch, batch acks), map payloads to token sequences
deterministically, and assemble global training batches into a bounded
staging buffer (backpressure: when training stalls, consumers stop acking,
prefetch windows close, the broker queues absorb the burst, and producers
eventually see reject-publish — the full paper §5.2 flow-control chain).

Fault tolerance: a consumer crash mid-batch requeues its unacked messages
(redelivered=True) and a respawned consumer picks them up — no event loss.
Straggler mitigation is inherent to the work-queue model: a slow consumer
simply takes fewer messages (its prefetch window stays full), exactly the
property the paper highlights for GRETA/Deleria.

A copy of the reference package's ``streaming.ingest``: the same threads,
bounded queues, ack batching and consumer names, and NumPy int32
batches.  One difference: a crashed consumer's thread returns, where the
reference's polls its deregistered channel again at once until the
loader closes (each poll returns ``None`` without waiting), and so takes
the interpreter lock from the thread that launches the train step; and
a consumer waiting on a full row queue gives up its row when it crashes
or the loader closes (the row's message is unacked, so a crash
redelivers it), where the reference's waits until a row is taken, for
ever once the loader has closed.  What is delivered, acked and
redelivered is the reference's.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.core.workloads import Workload, tokens_from_payload
from repro_torch.streaming.rtbroker import RealtimeBroker

WORK_QUEUES = ("work:0", "work:1")          # paper: two shared work queues


class StreamingDataLoader:
    def __init__(self, broker: RealtimeBroker, workload: Workload, *,
                 vocab_size: int, seq_len: int, batch_size: int,
                 n_consumers: int = 2, prefetch_batches: int = 2,
                 ack_batch: int = 8, queues: tuple = WORK_QUEUES):
        self.broker = broker
        self.workload = workload
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_size
        self.queues = queues
        self.ack_batch = ack_batch
        self._staging: "queue.Queue[dict]" = queue.Queue(
            maxsize=prefetch_batches)
        self._row_q: "queue.Queue[np.ndarray]" = queue.Queue(
            maxsize=batch_size * (prefetch_batches + 1))
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._consumer_ids: list[str] = []
        self._spawned = 0
        self.messages_consumed = 0
        self.redeliveries_seen = 0
        self._lock = threading.Lock()
        for q in queues:
            broker.declare_queue(q)
        for c in range(n_consumers):
            self.add_consumer()
        self._assembler = threading.Thread(target=self._assemble, daemon=True)
        self._assembler.start()

    # -- elastic consumer group -------------------------------------------------
    def add_consumer(self) -> str:
        # names come from a monotonic spawn counter, never from the live
        # count: a crash shrinks the live list, and reusing a crashed
        # consumer's name would collide at the broker
        cid = f"ingest-{self._spawned}"
        q = self.queues[self._spawned % len(self.queues)]
        self._spawned += 1
        self.broker.register_consumer(cid, q)
        t = threading.Thread(target=self._consume_loop, args=(cid,),
                             daemon=True)
        self._consumer_ids.append(cid)
        self._threads.append(t)
        t.start()
        return cid

    def crash_consumer(self, cid: str) -> int:
        """Fault injection: kill one consumer; returns #redelivered.  It
        leaves the live list first, so that its thread, which returns
        once its consumer is no longer live, polls the broker at most once
        after the crash."""
        if cid in self._consumer_ids:
            self._consumer_ids.remove(cid)
        return self.broker.consumer_crash(cid)

    # -- consumer threads -----------------------------------------------------
    def _consume_loop(self, cid: str) -> None:
        since_ack = 0
        last_tag = 0
        while not self._stop.is_set():
            d = self.broker.consume(cid, timeout=0.5)
            if d is None:
                if cid not in self._consumer_ids:
                    return                  # crashed
                continue
            msg = d.message
            if msg.redelivered:
                with self._lock:
                    self.redeliveries_seen += 1
            toks = tokens_from_payload(msg.body, self.vocab, self.seq + 1)
            if not self._put_row(cid, toks):    # backpressure point
                return                  # crashed or closed while waiting
            with self._lock:
                self.messages_consumed += 1
            since_ack += 1
            last_tag = max(last_tag, d.delivery_tag)
            if since_ack >= self.ack_batch:
                try:
                    self.broker.ack(cid, last_tag, multiple=True)
                except KeyError:            # crashed holding this delivery,
                    return                  # which is redelivered
                since_ack = 0

    def _put_row(self, cid: str, toks: np.ndarray) -> bool:
        """Put one row, waiting while the row queue is full; False, with the
        row dropped, once the loader closes or ``cid`` is no longer live
        (its unacked message is redelivered to a live consumer)."""
        while True:
            try:
                self._row_q.put(toks, timeout=0.1)
                return True
            except queue.Full:
                if self._stop.is_set() or cid not in self._consumer_ids:
                    return False

    def _assemble(self) -> None:
        while not self._stop.is_set():
            rows = []
            while len(rows) < self.batch and not self._stop.is_set():
                try:
                    rows.append(self._row_q.get(timeout=0.5))
                except queue.Empty:
                    continue
            if len(rows) < self.batch:
                return
            arr = np.stack(rows)            # (B, S+1)
            self._staging.put({
                "tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32),
            })

    # -- training-side API -------------------------------------------------------
    def next_batch(self, timeout: float = 60.0) -> dict:
        return self._staging.get(timeout=timeout)

    def __iter__(self):
        while True:
            yield self.next_batch()

    def close(self) -> None:
        self._stop.set()
        self.broker.close()
