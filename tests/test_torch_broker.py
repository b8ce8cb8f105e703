"""The port's RabbitMQ broker model (``repro_torch.core.broker``) against
the reference's, on the same operation sequences.

* **state after every operation** — a property test drives both brokers
  with one random sequence of publishes (work queue, vhost queue,
  fanout, an undeclared queue), deliveries, acks (single and multiple),
  consumer crashes and re-registrations, queue interruptions, pauses,
  node failures and re-homes, and compares every return value and the
  whole broker state (queues, stats, credit-flow flags, consumer
  rotation, channels and their unacked deliveries) after each step;
* **the credit constant** — ``ClassicQueue.FLOW_CREDIT`` is the
  reference's, and the per-cohort engine reads it from the broker model;
* **declaration** — the 80/20 RAM budget, round-robin homes, vhost
  names, fanout binding errors.
"""

import dataclasses

import pytest
from _hypothesis_compat import given, settings, st

from repro.core import broker as ref_broker
from repro_torch.core import broker as port_broker
from repro_torch.core import cell

QUEUES = ("q0", "q1", "t1/work:0", "nowhere")
CONSUMERS = ("c0", "c1", "c2", "c3")


def _setup(mod, prefetch: int, cap: int):
    b = mod.BrokerCluster(n_nodes=3, default_prefetch=prefetch)
    b.declare_queue("q0", max_bytes=cap)
    b.declare_queue("q1", max_bytes=cap)
    b.declare_queue("work:0", vhost="t1", max_bytes=cap)
    b.declare_queue("ctl", control=True)
    b.declare_fanout("fx", ["q0", "q1"])
    for i, cid in enumerate(CONSUMERS[:3]):
        b.register_consumer(cid, QUEUES[i % 3],
                            prefetch=None if i == 0 else prefetch + i,
                            connected_node=None if i == 1 else i)
    return b


def _msg(d):
    return None if d is None else (d.message.headers.get("i"),
                                   d.message.routing_key, d.message.size,
                                   d.message.producer_id,
                                   d.message.redelivered, d.consumer_id,
                                   d.queue, d.delivery_tag)


def _state(b) -> tuple:
    """The whole broker state, with messages named by their ``i`` header
    (message ids are each package's own counter)."""
    qs = {n: (q.name, q.home_node, q.max_bytes, q.overflow, q.bytes_ready,
              q.paused, len(q), q.flow_threshold, q.flow_blocked,
              q.flow_resume, sorted(q.publishers), q.consumer_ids,
              dataclasses.asdict(q.stats),
              [(m.headers.get("i"), m.size, m.redelivered, m.producer_id)
               for m in q.ready])
          for n, q in b.queues.items()}
    chs = {c: (ch.consumer_id, ch.queue, ch.prefetch, ch.connected_node,
               ch.next_tag, ch.window_available,
               [(t, _msg(d)) for t, d in ch.unacked.items()])
           for c, ch in b.channels.items()}
    return (qs, chs, b.fanout_bindings, b._next_home, b.total_ready(),
            b.total_unacked(), {q: b.drainable(q) for q in b.queues})


def _step(mod, b, x: int):
    """Apply the operation that ``x`` encodes to ``b``; its return value
    in a package-free form.  The operation, its queue, its consumer and
    a variant are independent digits of ``x``, scrambled first so that
    small draws spread over every operation."""
    x = (x * 2654435761 + 97) % 2 ** 32
    op, x = x % 16, x // 16
    q, ci = QUEUES[x % 3], (x // 3) % len(CONSUMERS)
    cid, v = CONSUMERS[ci], x // 12
    if op < 4:                                  # publish
        rk = QUEUES[(x + v) % 4] if op < 3 else "fanout:fx"
        return b.publish(mod.Message(rk, 100 + 37 * (v % 11),
                                     headers={"i": v},
                                     producer_id=f"p{v % 3}"))
    if op < 9:                                  # deliver
        return _msg(b.next_delivery(q))
    if op < 11:                                 # ack
        ch = b.channels.get(cid)
        if ch is None:
            return None
        tags = list(ch.unacked) or [v % 5 + 1]
        return b.ack(cid, tags[v % len(tags)], multiple=bool(v % 2))
    if op == 11:
        return b.consumer_crash(cid)
    if op == 12:
        # a consumer comes back on its own queue, as the engines do
        ch = b.register_consumer(cid, QUEUES[ci % 3], prefetch=1 + v % 4,
                                 connected_node=v % 3)
        return ch.consumer_id, ch.queue, ch.prefetch, ch.connected_node
    if op == 13:
        return b.interrupt_queue(q)
    if op == 14:
        b.queues[q].paused = not b.queues[q].paused
        return b.queues[q].paused
    if v % 2:
        return b.node_failure(v % 3)
    b.rehome_queue(q, v % 3)
    return None


@settings(max_examples=60, deadline=None)
@given(ops=st.lists(st.integers(0, 10 ** 6), min_size=20, max_size=150),
       prefetch=st.integers(1, 6), cap=st.integers(300, 20000))
def test_brokers_agree_after_every_operation(ops, prefetch, cap):
    ref = _setup(ref_broker, prefetch, cap)
    port = _setup(port_broker, prefetch, cap)
    assert _state(port) == _state(ref)
    for x in ops:
        assert _step(port_broker, port, x) == _step(ref_broker, ref, x), x
        assert _state(port) == _state(ref), x


def test_flow_credit_is_the_reference_constant():
    assert (port_broker.ClassicQueue.FLOW_CREDIT
            == ref_broker.ClassicQueue.FLOW_CREDIT == 400)
    assert cell.FLOW_CREDIT is port_broker.ClassicQueue.FLOW_CREDIT


@pytest.mark.parametrize("mod", [ref_broker, port_broker],
                         ids=["reference", "port"])
def test_declaration_budget_homes_and_vhosts(mod):
    b = mod.BrokerCluster(n_nodes=3, ram_bytes_per_node=1000,
                          data_fraction=0.8)
    homes = [b.declare_queue(f"q{i}").home_node for i in range(4)]
    assert homes == [0, 1, 2, 0]
    assert b.queues["q0"].max_bytes == 800
    control = b.declare_queue("c", control=True)
    assert control.max_bytes == int((1.0 - 0.8) * 1000)
    assert b.declare_queue("q0") is b.queues["q0"]
    a = b.declare_queue("work:0", vhost="t0")
    c = b.declare_queue("work:0", vhost="t1")
    assert (a.name, c.name) == ("t0/work:0", "t1/work:0") and a is not c
    assert b.vhost_queues("t1") == ["t1/work:0"]
    with pytest.raises(KeyError, match="undeclared queue"):
        b.declare_fanout("x", ["q0", "missing"])
    assert b.publish(mod.Message("fanout:none", 10)) == (False, [])


def test_declaration_matches_reference():
    states = []
    for mod in (ref_broker, port_broker):
        b = mod.BrokerCluster(n_nodes=3, ram_bytes_per_node=1000)
        for i in range(5):
            b.declare_queue(f"q{i}", control=bool(i % 2),
                            home_node=None if i < 3 else 2)
        b.bind_fanout("f", "q1")
        b.bind_fanout("f", "q3")
        states.append(_state(b)[:4])
    assert states[0] == states[1]


def test_credit_flow_flags_match_reference():
    """Credit flow at the constant's own scale: two publishers block past
    800 ready messages and resume at 400, in both packages alike."""
    flags = []
    for mod in (ref_broker, port_broker):
        b = mod.BrokerCluster(n_nodes=3)
        b.declare_queue("q")
        b.register_consumer("c0", "q", prefetch=0)
        seen = []
        for i in range(900):
            b.publish(mod.Message("q", 10, producer_id=f"p{i % 2}"))
            seen.append((b.queues["q"].flow_blocked,
                         b.queues["q"].flow_resume))
        while b.next_delivery("q") is not None:
            seen.append((b.queues["q"].flow_blocked,
                         b.queues["q"].flow_resume))
        flags.append(seen)
    assert flags[0] == flags[1]
    blocked = [i for i, (blk, _) in enumerate(flags[1][:900]) if blk]
    assert blocked[0] == 800
    assert sum(res for _, res in flags[1][900:]) == 401
