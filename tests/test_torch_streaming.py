"""The port's streamed edge-to-HPC data plane (``repro_torch.streaming``,
``core.workloads``' payloads and token rows, and the streamed path of
``launch.train``) against the reference's, in one process, on the CPU.

* **payloads and token rows** — ``Workload.payload``, ``payload_digest``,
  ``event_stream``, ``messages_per_second_at_rate`` and
  ``tokens_from_payload`` bit for bit, the tile branch included;
* **the real-time broker** — scripted single-thread sequences and a
  property over random ones: equal deliveries (tags, consumers,
  redelivered flags, headers), depths, stats and errors;
* **the loader** — fed by producers of a fixed message count, both
  packages assemble the same multiset of rows, the token map of every
  published payload; after a consumer crash no payload is missing and
  every extra row is a redelivered message's; a crashed consumer's
  thread ends (the reference's polls on, see ``streaming.ingest``);
* **steering feedback and the elastic consumer group** — the same rates
  over the same replies, the same controller log under an injected clock;
* **the driver** — ``make_stream``'s topology, and ``run`` with
  ``--data stream`` and a consumer crash, against the reference's run.

Producers seed their payloads with ``hash(producer_id)``, which Python
salts per process, so every expected row is computed in this process.
Every wait has its own timeout.
"""

import argparse
import collections
import dataclasses
import math
import queue
import resource
import sys
import threading
import time

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import repro.streaming as ref_streaming
from repro.core import broker as ref_broker
from repro.core import workloads as ref_wl
from repro.launch import train as ref_train
from repro.streaming import fault_tolerance as ref_ft
from repro_torch import streaming as port_streaming
from repro_torch.core import broker as port_broker
from repro_torch.core import workloads as port_wl
from repro_torch.launch import train as port_train
from repro_torch.streaming import fault_tolerance as port_ft

PACKAGES = {"reference": (ref_streaming, ref_broker, ref_wl),
            "port": (port_streaming, port_broker, port_wl)}
VOCABS = (128, 32000, 49152)


# -- payloads and token rows --------------------------------------------------

@pytest.mark.parametrize("name", sorted(ref_wl.WORKLOADS))
def test_payloads_match_reference(name):
    ref, port = ref_wl.get_workload(name), port_wl.get_workload(name)
    seeds = (0, 1, 977) if name == "dstream" else (0, 5)
    for seed in seeds:
        pay = port.payload(seed)
        assert len(pay) == port.payload_bytes
        assert pay == ref.payload(seed)
        assert port.payload_digest(seed) == ref.payload_digest(seed)
    assert (list(port.event_stream(3, 2)) == list(ref.event_stream(3, 2)))
    for gbps in (None, 1.0, 10.0):
        assert (port.messages_per_second_at_rate(gbps)
                == ref.messages_per_second_at_rate(gbps))


@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("name", sorted(ref_wl.WORKLOADS))
def test_tokens_from_payload_match_reference(name, vocab):
    """Every workload's payloads at several seeds; on Dstream (16384
    bytes) 4097 tokens take the tile branch, 4096 just do not."""
    w = port_wl.get_workload(name)
    lengths = (1, 17, 4096, 4097) if name == "dstream" else (17, 4097)
    for seed in (0, 3, 123456):
        pay = w.payload(seed) if name == "dstream" else w.payload(seed)[:65536]
        for n in lengths:
            got = port_wl.tokens_from_payload(pay, vocab, n)
            want = ref_wl.tokens_from_payload(pay, vocab, n)
            assert got.dtype == want.dtype == np.int32
            assert got.shape == (n,)
            np.testing.assert_array_equal(got, want)
            assert 0 <= got.min() and got.max() < vocab
    # a payload shorter than one token tiles too
    for pay in (b"\x01\x02\x03", bytes(range(7))):
        np.testing.assert_array_equal(
            port_wl.tokens_from_payload(pay, vocab, 9),
            ref_wl.tokens_from_payload(pay, vocab, 9))


# -- the real-time broker -----------------------------------------------------

WORK = ("work:0", "work:1")
CONSUMERS = ("c0", "c1", "c2")
#: each consumer's queue: the three consumers on the work queues, and a
#: producer on its reply queue
HOME = {"c0": "work:0", "c1": "work:1", "c2": "work:0", "p0": "reply:p0"}


def _delivery(d):
    """A delivery in a package-free form (message ids are each package's
    own counter)."""
    if d is None:
        return None
    m = d.message
    return (d.delivery_tag, d.consumer_id, d.queue, m.redelivered,
            m.routing_key, m.size, m.producer_id, m.reply_to,
            m.body, tuple(sorted(m.headers.items())))


def _setup(streaming, broker_mod, prefetch: int):
    b = streaming.RealtimeBroker(default_prefetch=prefetch)
    for q in WORK:
        b.declare_queue(q)
    b.declare_queue("reply:p0", control=True)
    for i, cid in enumerate(CONSUMERS):
        b.register_consumer(cid, HOME[cid],
                            prefetch=None if i == 0 else prefetch + i)
    b.register_consumer("p0", "reply:p0")
    return b


def _op(broker_mod, b, x: int, last: dict):
    """Apply the operation ``x`` encodes; its result in a package-free
    form, ``KeyError`` where the broker raises one."""
    x = (x * 2654435761 + 97) % 2 ** 32
    op, x = x % 10, x // 10
    cid = tuple(HOME)[x % 4]
    q = (*WORK, "reply:p0")[x % 3]
    v = x // 12
    try:
        if op < 3:
            return b.publish(broker_mod.Message(
                q, 100 + 7 * (v % 13), body=bytes([v % 256]) * 3,
                headers={"i": v}, producer_id=f"p{v % 2}",
                reply_to="reply:p0"), block=False)
        if op < 6:
            d = b.consume(cid, timeout=0.0)
            if d is not None:
                last[cid] = d.delivery_tag
            return _delivery(d)
        if op == 6:
            return b.ack(cid, last.get(cid, v % 4 + 1), multiple=bool(v % 2))
        if op == 7:
            return b.consumer_crash(cid)
        if op == 8:
            # a consumer comes back on its own queue, as the loader's do
            b.register_consumer(cid, HOME[cid])
            return "registered"
        return (b.queue_depth(q), dataclasses.asdict(b.stats(q)))
    except KeyError:
        return "KeyError"


def test_realtime_broker_scripted_sequence():
    """Publishes to both work queues, round-robin pulls that park other
    consumers' deliveries, batch acks, a crash that redelivers, a
    re-registration that picks the redeliveries up, depths and stats."""
    seen = []
    for streaming, broker_mod, _ in PACKAGES.values():
        b = _setup(streaming, broker_mod, prefetch=3)
        out = []
        for i in range(12):
            out.append(b.publish(broker_mod.Message(
                WORK[i % 3 % 2], 16, body=bytes([i]), headers={"seq": i},
                producer_id="p0"), block=False))
        for cid in ("c0", "c0", "c1", "c2", "c2", "c0", "c1", "c0", "c2"):
            out.append(_delivery(b.consume(cid, timeout=0.0)))
        out.append([b.queue_depth(q) for q in WORK])
        out.append(b.ack("c0", 1))
        out.append(b.ack("c2", 1, multiple=True))
        out.append(b.consumer_crash("c0"))
        out.append(b.consume("c0", timeout=0.0))
        out.append([b.queue_depth(q) for q in WORK])
        b.register_consumer("c3", "work:0")
        for cid in ("c3", "c3", "c2", "c3", "c2"):
            out.append(_delivery(b.consume(cid, timeout=0.0)))
        out.append([dataclasses.asdict(b.stats(q)) for q in WORK])
        with pytest.raises(KeyError):
            b.ack("c0", 1)
        b.close()
        out.append(b.consume("c3", timeout=0.0))
        seen.append(out)
    assert seen[0] == seen[1]
    redelivered = [d for d in seen[1] if isinstance(d, tuple) and d[3]]
    assert redelivered, "the crash redelivered nothing"


@settings(max_examples=60, deadline=None)
@given(ops=st.lists(st.integers(0, 10 ** 6), min_size=20, max_size=120),
       prefetch=st.integers(1, 5))
def test_realtime_brokers_agree_on_random_sequences(ops, prefetch):
    ref = _setup(ref_streaming, ref_broker, prefetch)
    port = _setup(port_streaming, port_broker, prefetch)
    lr, lp = {}, {}
    for x in ops:
        assert _op(port_broker, port, x, lp) == _op(ref_broker, ref, x, lr), x


def test_publish_retries_until_its_deadline():
    """Reject-publish backpressure: a full queue refuses at once without
    blocking, and a blocking publish retries until its deadline, in both
    packages alike."""
    for streaming, broker_mod, _ in PACKAGES.values():
        b = streaming.RealtimeBroker()
        b.declare_queue("q", max_bytes=100)
        assert b.publish(broker_mod.Message("q", 80), block=False)
        assert not b.publish(broker_mod.Message("q", 80), block=False)
        t0 = time.monotonic()
        assert not b.publish(broker_mod.Message("q", 80), timeout=0.1)
        assert 0.1 <= time.monotonic() - t0 < 5.0
        assert b.stats("q").rejected >= 3


# -- the loader -------------------------------------------------------------

def _producers(streaming, broker, ids, msgs, rate=2000.0):
    return [streaming.EdgeProducer(broker, port_wl.DSTREAM,
                                   lambda j, i=i: f"work:{(i + j) % 2}",
                                   rate_msgs_s=rate, n_messages=msgs,
                                   producer_id=pid).start()
            for i, pid in enumerate(ids)]


def _rows(batch) -> list:
    """A batch's rows of ``seq + 1`` tokens, as bytes."""
    rows = np.concatenate([batch["tokens"], batch["labels"][:, -1:]], axis=1)
    assert (batch["labels"][:, :-1] == batch["tokens"][:, 1:]).all()
    return [r.astype(np.int32).tobytes() for r in rows]


def _published(ids, msgs, vocab, seq) -> collections.Counter:
    """The token row of every payload that producers ``ids`` publish."""
    return collections.Counter(
        port_wl.tokens_from_payload(
            port_wl.DSTREAM.payload(hash(pid) % 10 ** 6 + i), vocab,
            seq + 1).tobytes()
        for pid in ids for i in range(msgs))


def _drain(loader, n_rows: int, deadline_s: float = 15.0) -> list:
    rows, deadline = [], time.monotonic() + deadline_s
    while len(rows) < n_rows:
        assert time.monotonic() < deadline, (len(rows), n_rows)
        rows += _rows(loader.next_batch(timeout=10))
    return rows


@pytest.mark.parametrize("vocab,seq,batch,consumers", [
    (128, 16, 4, 2), (49152, 4096, 2, 3), (32000, 64, 3, 4)])
def test_loaders_assemble_every_published_payload(vocab, seq, batch,
                                                  consumers):
    ids, msgs = ("p0", "p1"), 24
    want = _published(ids, msgs, vocab, seq)
    for pkg, (streaming, _, _) in PACKAGES.items():
        broker = streaming.RealtimeBroker()
        loader = streaming.StreamingDataLoader(
            broker, port_wl.DSTREAM, vocab_size=vocab, seq_len=seq,
            batch_size=batch, n_consumers=consumers)
        ps = _producers(streaming, broker, ids, msgs)
        try:
            got = collections.Counter(_drain(loader, 2 * msgs))
            assert got == want, pkg
            assert loader.messages_consumed == 2 * msgs
            assert loader.redeliveries_seen == 0
            assert sum(p.sent for p in ps) == 2 * msgs
        finally:
            for p in ps:
                p.stop(join=False)
            loader.close()


def _recording(streaming):
    """The package's ``RealtimeBroker`` noting each redelivered message,
    each consumer's polls, and its polls after its crash."""

    class Recording(streaming.RealtimeBroker):
        def __init__(self):
            super().__init__()
            self.redelivered = collections.Counter()
            self.crashed_at = {}
            self.polls = collections.Counter()
            self.polls_after_crash = collections.Counter()

        def consume(self, consumer_id, timeout=5.0):
            d = super().consume(consumer_id, timeout)
            self.polls[consumer_id] += 1
            if consumer_id in self.crashed_at:
                self.polls_after_crash[consumer_id] += 1
            if d is not None and d.message.redelivered:
                self.redelivered[(d.message.producer_id,
                                  d.message.headers["seq"])] += 1
            return d

        def consumer_crash(self, consumer_id):
            self.crashed_at[consumer_id] = time.monotonic()
            return super().consumer_crash(consumer_id)

    return Recording()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_crash_loses_no_payload(pkg):
    """A consumer crashes mid-stream and a new one is spawned: every
    published payload still reaches a batch, and each extra row is a
    redelivered message's, at most once a redelivery."""
    streaming = PACKAGES[pkg][0]
    ids, msgs, vocab, seq = ("p0", "p1"), 40, 64, 8
    broker = _recording(streaming)
    loader = streaming.StreamingDataLoader(
        broker, port_wl.DSTREAM, vocab_size=vocab, seq_len=seq,
        batch_size=1, n_consumers=2, ack_batch=4)
    ps = _producers(streaming, broker, ids, msgs, rate=500.0)
    try:
        got = _drain(loader, 6)
        n_re = loader.crash_consumer("ingest-0")
        loader.add_consumer()
        want = _published(ids, msgs, vocab, seq)
        deadline = time.monotonic() + 15
        while not want.keys() <= set(got):
            assert time.monotonic() < deadline, "a payload was lost"
            got += _rows(loader.next_batch(timeout=10))
        for p in ps:
            p.join(timeout=10)
        while True:                 # the tail of the redeliveries
            try:
                got += _rows(loader.next_batch(timeout=1.0))
            except queue.Empty:     # the stream is drained
                break
    finally:
        for p in ps:
            p.stop(join=False)
        loader.close()
    _hold_no_loss(got, want, broker, vocab, seq)
    assert sum(broker.redelivered.values()) >= n_re
    if n_re:
        assert loader.redeliveries_seen >= 1


def _hold_no_loss(got: list, want: collections.Counter, broker, vocab: int,
                  seq: int) -> None:
    """Every published row arrived, and each extra row is a redelivered
    message's, at most once a redelivery."""
    assert not want - collections.Counter(got), "a payload was lost"
    extra = collections.Counter(got) - want
    allowed = collections.Counter()
    for (pid, i), n in broker.redelivered.items():
        allowed[port_wl.tokens_from_payload(
            port_wl.DSTREAM.payload(hash(pid) % 10 ** 6 + i), vocab,
            seq + 1).tobytes()] += n
    assert not extra - allowed, "an extra row that no redelivery explains"


def test_crashes_under_fast_thread_switching():
    """More consumer threads than cores, the interpreter switching threads
    every 10 µs, three consumers crashed mid-stream at once: no payload is
    lost, every extra row is a redelivery, and each crashed consumer's
    thread ends within 2 s."""
    ids, msgs, vocab, seq = ("p0", "p1", "p2"), 60, 64, 8
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    broker = _recording(port_streaming)
    loader = port_streaming.StreamingDataLoader(
        broker, port_wl.DSTREAM, vocab_size=vocab, seq_len=seq,
        batch_size=1, n_consumers=12, ack_batch=4)
    ps = _producers(port_streaming, broker, ids, msgs, rate=1000.0)
    try:
        got = _drain(loader, 10)
        victims = (0, 5, 7)
        for k in victims:
            loader.crash_consumer(f"ingest-{k}")
        t0 = time.monotonic()
        want = _published(ids, msgs, vocab, seq)
        while not want.keys() <= set(got):
            assert time.monotonic() - t0 < 15, "a payload was lost"
            got += _rows(loader.next_batch(timeout=10))
        for k in victims:
            loader._threads[k].join(timeout=max(0.0, t0 + 2 - time.monotonic()))
            assert not loader._threads[k].is_alive(), k
        assert loader._consumer_ids == [
            f"ingest-{k}" for k in range(12) if k not in victims]
    finally:
        sys.setswitchinterval(interval)
        for p in ps:
            p.stop(join=False)
        loader.close()
    _hold_no_loss(got, want, broker, vocab, seq)


def test_crashed_consumer_thread_ends():
    """The port's crashed consumer returns within 2 s of the crash, after
    at most one poll; the survivors keep the stream flowing."""
    broker = _recording(port_streaming)
    loader = port_streaming.StreamingDataLoader(
        broker, port_wl.DSTREAM, vocab_size=64, seq_len=8, batch_size=2,
        n_consumers=2, ack_batch=4)
    ps = _producers(port_streaming, broker, ("p0", "p1"), 200, rate=200.0)
    try:
        _drain(loader, 4)
        thread = loader._threads[0]
        loader.crash_consumer("ingest-0")
        t0 = time.monotonic()
        while thread.is_alive() and time.monotonic() - t0 < 2.0:
            loader.next_batch(timeout=2)
        thread.join(timeout=max(0.0, 2.0 - (time.monotonic() - t0)))
        assert not thread.is_alive(), "the crashed consumer's thread runs on"
        assert broker.polls_after_crash["ingest-0"] <= 1
        before = loader.messages_consumed
        _drain(loader, 4)
        assert loader.messages_consumed > before
        assert loader._threads[1].is_alive()
    finally:
        for p in ps:
            p.stop(join=False)
        loader.close()


def test_consumer_waiting_on_a_full_row_queue_ends_on_crash_and_close():
    """Nothing drains the loader, so the staging buffer and then the row
    queue fill and both consumers wait to put a row.  A crash ends the
    crashed consumer's wait and its thread, with nothing drained and no
    poll after the crash (its row's message, unacked, is redelivered);
    closing the loader ends the other's."""
    broker = _recording(port_streaming)
    loader = port_streaming.StreamingDataLoader(
        broker, port_wl.DSTREAM, vocab_size=64, seq_len=8, batch_size=1,
        n_consumers=2, ack_batch=4)
    ps = _producers(port_streaming, broker, ("p0", "p1"), 200, rate=2000.0)
    try:
        t0 = time.monotonic()
        while not (loader._row_q.full() and loader._staging.full()):
            assert time.monotonic() - t0 < 10, "the row queue never filled"
            time.sleep(0.01)
        time.sleep(0.3)                 # both consumers hold a row
        loader.crash_consumer("ingest-0")
        loader._threads[0].join(timeout=2)
        assert not loader._threads[0].is_alive()
        assert broker.polls_after_crash["ingest-0"] == 0
        assert loader._threads[1].is_alive()
    finally:
        for p in ps:
            p.stop(join=False)
        loader.close()
    loader._threads[1].join(timeout=2)
    assert not loader._threads[1].is_alive()


def test_crashed_consumer_idle_thread_ends():
    """With nothing to consume, the crash wakes the consumer's wait and
    its thread returns."""
    broker = port_streaming.RealtimeBroker()
    loader = port_streaming.StreamingDataLoader(
        broker, port_wl.DSTREAM, vocab_size=64, seq_len=8, batch_size=2)
    try:
        thread = loader._threads[1]
        loader.crash_consumer("ingest-1")
        thread.join(timeout=2.0)
        assert not thread.is_alive()
        assert loader._threads[0].is_alive()
    finally:
        loader.close()


def test_crashed_consumer_holding_a_delivery_ends(monkeypatch):
    """A consumer crashed while it holds a delivery, blocked on the full
    row queue: once a slot frees it hands its row over (the message is
    also redelivered), finds its channel gone at its ack and returns,
    raising nothing (the reference's thread dies of a ``KeyError``)."""
    raised = []
    monkeypatch.setattr(threading, "excepthook", raised.append)
    broker = port_streaming.RealtimeBroker()
    loader = port_streaming.StreamingDataLoader(
        broker, port_wl.DSTREAM, vocab_size=64, seq_len=8, batch_size=1,
        n_consumers=1, prefetch_batches=1, ack_batch=1)
    try:
        for i in range(5):
            broker.publish(port_broker.Message(
                "work:0", 16, body=bytes([i]) * 16, headers={"seq": i}))
        # one batch staged, one row held by the assembler, two queued:
        # the fifth delivery waits at the row queue, unacked
        _wait(lambda: loader.messages_consumed == 4
              and broker.queue_depth("work:0") == 0, "four rows queued")
        thread = loader._threads[0]
        assert loader.crash_consumer("ingest-0") == 1
        for _ in range(5):
            loader.next_batch(timeout=5)
        thread.join(timeout=2.0)
        assert not thread.is_alive()
        assert loader.messages_consumed == 5
        assert broker.queue_depth("work:0") == 1    # the redelivery
    finally:
        loader.close()
    assert not raised, raised


def test_backpressure_holds_the_burst():
    """Nobody drains batches: the staging buffer fills, the consumer stops,
    and the broker holds the rest; every published message is ready in a
    queue, unacked on a channel or acked."""
    broker = port_streaming.RealtimeBroker()
    loader = port_streaming.StreamingDataLoader(
        broker, port_wl.DSTREAM, vocab_size=64, seq_len=8, batch_size=2,
        n_consumers=1, prefetch_batches=1)
    ps = _producers(port_streaming, broker, ("p0",), 300, rate=5000.0)
    try:
        ps[0].join(timeout=15)
        assert ps[0].sent == 300
        time.sleep(0.5)
        with broker._lock:
            b = broker._b
            ready = sum(len(b.queues[q]) for q in WORK)
            unacked = sum(len(ch.unacked) for ch in b.channels.values())
            acked = sum(b.queues[q].stats.acked for q in WORK)
        assert ready > 0
        assert loader.messages_consumed < 300
        assert ready + unacked + acked == 300
    finally:
        for p in ps:
            p.stop(join=False)
        loader.close()


# -- steering feedback ----------------------------------------------------------

def test_feedback_rates_match_reference():
    """The same replies (slow down, speed up, nothing to read) give the
    same rates, floored at 1 msg/s, and the same replies read."""
    flags = (True, True, False, True, False, False) + (True,) * 9
    runs = []
    for streaming, _, wl in PACKAGES.values():
        broker = streaming.RealtimeBroker()
        broker.declare_queue("work:0")
        fb = streaming.SteeringFeedback(broker, ["p0", "p1"])
        ps = [streaming.EdgeProducer(broker, wl.DSTREAM, lambda i: "work:0",
                                     rate_msgs_s=rate, n_messages=0,
                                     producer_id=pid,
                                     reply_queue=fb.reply_queue(pid))
              for pid, rate in (("p0", 200.0), ("p1", 3.0))]
        out = []
        for step, flag in enumerate(flags):
            fb.publish_step(step, 2.5 - 0.1 * step, backpressure=flag)
            for p in ps:
                out.append((p.poll_feedback(timeout=3.0), p.rate))
        out.append([(p.poll_feedback(timeout=0.0), p.feedback_seen,
                     p.rate) for p in ps])
        out.append((fb.published, fb.producer_ids,
                     [fb.reply_queue(p) for p in fb.producer_ids]))
        runs.append(out)
    assert runs[0] == runs[1]
    assert runs[1][0][1] == 100.0 and runs[1][-2][1][2] == 1.0


# -- the elastic consumer group -----------------------------------------------

def _wait(cond, what: str, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _group_log(streaming, ft, broker_mod):
    """Crash, respawn, resize and straggler transitions at moments where
    each consumer's unacked messages are known, under an injected clock."""
    ticks = iter(range(100))
    broker = streaming.RealtimeBroker()
    loader = streaming.StreamingDataLoader(
        broker, port_wl.DSTREAM, vocab_size=64, seq_len=8, batch_size=1,
        n_consumers=2, prefetch_batches=32, ack_batch=1000)
    group = ft.ElasticConsumerGroup(loader, clock=lambda: float(next(ticks)))
    sizes = []
    try:
        for i in range(5):
            broker.publish(broker_mod.Message(
                "work:0", 16, body=bytes([i]) * 16, headers={"seq": i}))
        _wait(lambda: loader.messages_consumed == 5, "ingest-0's five")
        group.crash("ingest-0")
        sizes.append(group.size)
        group.respawn()                         # ingest-2, on work:0
        _wait(lambda: loader.messages_consumed == 10, "the redeliveries")
        group.kill_straggler("ingest-2")        # -> ingest-3, on work:1
        sizes.append(group.size)
        group.scale_to(4)                       # ingest-4 (work:0), -5
        _wait(lambda: loader.messages_consumed == 15, "ingest-4's five")
        group.scale_to(2)                       # crashes -5, then -4
        sizes.append(group.size)
        with pytest.raises(ValueError, match=">= 1"):
            group.scale_to(0)
        sizes.append((group.size, list(loader._consumer_ids),
                      loader.redeliveries_seen))
    finally:
        loader.close()
    return [dataclasses.astuple(e) for e in group.log], sizes


def test_elastic_group_log_matches_reference():
    ref = _group_log(ref_streaming, ref_ft, ref_broker)
    port = _group_log(port_streaming, port_ft, port_broker)
    assert port == ref
    log = port[0]
    assert log[0] == (0.0, "consumer-crash", "ingest-0", 5)
    assert log[2] == (2.0, "straggler-replaced", "ingest-2 -> ingest-3", 5)
    assert [e[1] for e in log].count("straggler-replaced") == 1
    assert port[1][-1] == (2, ["ingest-1", "ingest-3"], 10)


def test_elastic_group_default_clock_is_monotonic():
    broker = port_streaming.RealtimeBroker()
    loader = port_streaming.StreamingDataLoader(
        broker, port_wl.DSTREAM, vocab_size=64, seq_len=8, batch_size=2)
    try:
        assert port_ft.ElasticConsumerGroup(loader).clock is time.monotonic
    finally:
        loader.close()


# -- the driver -----------------------------------------------------------------

def test_make_stream_topology_matches_reference():
    from repro.configs import get_smoke_config as ref_smoke
    from repro_torch.configs import get_smoke_config
    views = []
    for make, cfg in ((ref_train.make_stream, ref_smoke("granite-8b")),
                      (port_train.make_stream,
                       get_smoke_config("granite-8b"))):
        broker, loader, fb, producers = make(cfg, 4, 16)
        try:
            b = broker._b
            views.append((
                {n: (q.name, q.home_node, q.max_bytes)
                 for n, q in b.queues.items()},
                sorted((c.consumer_id, c.queue, c.prefetch)
                       for c in b.channels.values()),
                (loader.vocab, loader.seq, loader.batch, loader.queues,
                 loader.ack_batch, list(loader._consumer_ids),
                 loader.workload.name, loader._staging.maxsize,
                 loader._row_q.maxsize),
                (fb.producer_ids, [fb.reply_queue(p) for p in fb.producer_ids]),
                [(p.id, p.rate, p.reply_queue, p.n_messages, p.workload.name,
                  [p.queue_of(j) for j in range(4)]) for p in producers]))
        finally:
            for p in producers:
                p.stop(join=False)
            loader.close()
    assert views[0] == views[1]


def _args(**kw):
    base = dict(arch="granite-8b-smoke", steps=14, batch=4, seq=16,
                lr=2e-3, seed=0, microbatches=1, data="stream",
                ckpt_dir="", ckpt_every=50, resume=True, log_every=100,
                feedback_every=5, crash_consumer_at=6)
    base.update(kw)
    return argparse.Namespace(**base)


def _held(losses, vocab):
    ln_v = math.log(vocab)
    assert len(losses) == 14
    assert all(math.isfinite(x) for x in losses)
    assert all(ln_v - 0.5 <= x <= ln_v + 2 for x in losses), losses


def test_streamed_run_with_crash_and_feedback(capsys):
    """``run`` with ``--data stream``, a consumer crash at step 6 and
    feedback every 5 steps, as the reference's streamed run: 14 finite
    losses within [ln V - 0.5, ln V + 2], the ``[fault]`` line printed,
    redeliveries seen when the crash redelivered anything, one reply a
    producer at each feedback, and the producers' and the crashed
    consumer's threads ended."""
    from repro_torch.configs import get_smoke_config
    vocab = get_smoke_config("granite-8b").vocab_size
    ref = ref_train.run(_args())
    _held(ref["losses"], vocab)
    out = port_train.run(_args(device="cpu"))
    _held(out["losses"], vocab)
    assert "[fault] crashed ingest-0 at step 6" in capsys.readouterr().out
    broker, loader, fb, producers = out["stream"]
    if out["redelivered"]:
        assert loader.redeliveries_seen >= 1
    assert fb.published == 2 * 3            # steps 0, 5 and 10
    assert all(p.feedback_seen == 3 for p in producers)
    assert loader.messages_consumed >= 14 * 4
    for p in producers:
        p.join(timeout=10)
        assert not p._thread.is_alive()
    loader._threads[0].join(timeout=2)
    assert not loader._threads[0].is_alive()


def test_local_run_has_no_stream():
    out = port_train.run(_args(device="cpu", data="local", steps=2,
                               crash_consumer_at=1))
    assert len(out["losses"]) == 2
    assert out["stream"] is None and out["redelivered"] is None


def report() -> None:
    """Print, for each package, the crashed consumer's polls and the
    process's CPU seconds in the second before a crash and the second
    after it, with nothing to consume.
    ``PYTHONPATH=src python tests/test_torch_streaming.py``"""
    def cpu() -> float:
        r = resource.getrusage(resource.RUSAGE_SELF)
        return r.ru_utime + r.ru_stime

    for pkg, (streaming, _, _) in PACKAGES.items():
        broker = _recording(streaming)
        loader = streaming.StreamingDataLoader(
            broker, port_wl.DSTREAM, vocab_size=64, seq_len=8, batch_size=2)
        c0 = cpu()
        time.sleep(1.0)
        c1, before = cpu(), broker.polls["ingest-0"]
        loader.crash_consumer("ingest-0")
        time.sleep(1.0)
        c2 = cpu()
        print(pkg, dict(polls_before=before,
                        polls_after=broker.polls_after_crash["ingest-0"],
                        cpu_s_before=c1 - c0, cpu_s_after=c2 - c1,
                        thread_alive=loader._threads[0].is_alive()))
        loader.close()


def report_crash_join(runs: int = 12) -> None:
    """Print, for ``runs`` runs of the streamed run that
    ``test_streamed_run_with_crash_and_feedback`` makes, the seconds from
    the consumer crash to the end of the crashed consumer's thread, the
    seconds from that end to the end of the run, and the line the thread
    was waiting on at the crash.  Run it beside a loaded test run (the
    join once timed out under ``-n 6``).
    ``PYTHONPATH=src python tests/test_torch_streaming.py join``"""
    import traceback
    from repro_torch.streaming.ingest import StreamingDataLoader as Loader
    for k in range(runs):
        ends, crash = {}, {}
        loop, crash_consumer = Loader._consume_loop, Loader.crash_consumer

        def timed_loop(self, cid):
            try:
                return loop(self, cid)
            finally:
                ends[cid] = time.perf_counter()

        def timed_crash(self, cid):
            frame = sys._current_frames().get(
                self._threads[int(cid.split("-")[1])].ident)
            crash["waiting_on"] = (traceback.format_stack(frame)[-1]
                                   .strip().splitlines()[-1].strip()
                                   if frame else None)
            crash["t"] = time.perf_counter()
            return crash_consumer(self, cid)

        with pytest.MonkeyPatch.context() as m:
            m.setattr(Loader, "_consume_loop", timed_loop)
            m.setattr(Loader, "crash_consumer", timed_crash)
            out = port_train.run(_args(device="cpu"))
        t_run = time.perf_counter()
        thread = out["stream"][1]._threads[0]
        thread.join(timeout=30)
        end = ends.get("ingest-0", float("nan"))
        print(dict(run=k, crash_to_end_s=end - crash["t"],
                   end_before_run_end_s=t_run - end,
                   alive=thread.is_alive(),
                   waiting_on=crash["waiting_on"]), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["join"]:
        report_crash_join()
    else:
        report()
