"""RabbitMQ-semantics streaming-service model (paper §4.2, §5.2).

The paper deploys a three-node RabbitMQ 4.0.5 cluster on the DSNs and drives
it through the AMQP 0-9-1 model. This module implements the *semantics* that
the evaluation depends on, in a time-agnostic way: the heap engine
(:class:`repro_torch.core.simulator.StreamSim`) advances a virtual clock and
asks the broker what to do next.

Semantics implemented:

* classic queues with FIFO order and bounded memory;
* ``reject-publish`` overflow policy — producers observe backpressure and may
  re-publish (paper §5.2);
* routing models: **work queue** (shared queue, round-robin across
  consumers), **direct** (per-producer reply queues), **fanout** (pub-sub
  broadcast) — the three models behind the paper's three messaging patterns;
* consumer prefetch windows (basic.qos) and **batch acknowledgements**;
* publisher confirms (batched), used for producer flow control;
* redelivery of unacked messages when a consumer disconnects/crashes —
  the "rare events will not be lost" property the paper calls out for
  GRETA/Deleria (§6);
* a 3-node cluster model with queue home-node placement: clients connected
  to a different node than the queue's home pay an extra intra-cluster hop
  (the simulator charges for it).

A copy of the reference package's ``broker`` module, with its names,
defaults, semantics and error messages.  The per-cohort engine reads its
credit constant, :attr:`ClassicQueue.FLOW_CREDIT`.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import OrderedDict, deque
from typing import Iterable, Optional

from repro_torch.core.workloads import MIB


# --------------------------------------------------------------------------
# Messages
# --------------------------------------------------------------------------

_msg_ids = itertools.count()


@dataclasses.dataclass
class Message:
    """One AMQP message. ``body`` may be None in pure-simulation runs where
    only ``size`` matters; the real-time path carries actual payloads."""

    routing_key: str
    size: int
    body: Optional[bytes] = None
    headers: dict = dataclasses.field(default_factory=dict)
    msg_id: int = dataclasses.field(default_factory=lambda: next(_msg_ids))
    producer_id: Optional[str] = None
    publish_time: float = 0.0          # stamped by the engine
    redelivered: bool = False
    reply_to: Optional[str] = None     # direct-reply routing (feedback pattern)
    correlation_id: Optional[int] = None


@dataclasses.dataclass
class Delivery:
    """A message handed to a consumer, pending ack."""

    message: Message
    consumer_id: str
    queue: str
    delivery_tag: int


# --------------------------------------------------------------------------
# Queues
# --------------------------------------------------------------------------


class OverflowPolicy:
    REJECT_PUBLISH = "reject-publish"
    DROP_HEAD = "drop-head"


@dataclasses.dataclass
class QueueStats:
    published: int = 0
    rejected: int = 0
    delivered: int = 0
    acked: int = 0
    redelivered: int = 0


class ClassicQueue:
    """RabbitMQ classic queue: FIFO, memory-bounded, round-robin delivery."""

    #: RabbitMQ credit-flow: a publishing channel is blocked when its
    #: un-drained backlog exceeds ~400 messages (credit_flow_default_credit)
    FLOW_CREDIT = 400

    def __init__(
        self,
        name: str,
        home_node: int,
        max_bytes: int,
        overflow: str = OverflowPolicy.REJECT_PUBLISH,
    ) -> None:
        self.name = name
        self.home_node = home_node
        self.max_bytes = max_bytes
        self.overflow = overflow
        self.ready: deque[Message] = deque()
        self.bytes_ready = 0
        self.stats = QueueStats()
        self.publishers: set[str] = set()
        #: chaos outage flag: a paused queue rejects publishes (producers
        #: observe reject-publish backpressure and retry) and delivers
        #: nothing until unpaused — its host broker/vhost is down
        self.paused = False
        # round-robin cursor over consumer ids (insertion-ordered)
        self._consumers: "OrderedDict[str, None]" = OrderedDict()

    # -- credit-based flow control -------------------------------------------
    @property
    def flow_threshold(self) -> int:
        return self.FLOW_CREDIT * max(1, len(self.publishers))

    @property
    def flow_blocked(self) -> bool:
        """True when publishers to this queue should be throttled (their
        confirms withheld) until the queue drains."""
        return len(self.ready) > self.flow_threshold

    @property
    def flow_resume(self) -> bool:
        return len(self.ready) <= self.flow_threshold // 2

    # -- consumer registry ---------------------------------------------------
    def add_consumer(self, consumer_id: str) -> None:
        self._consumers.setdefault(consumer_id, None)

    def remove_consumer(self, consumer_id: str) -> None:
        self._consumers.pop(consumer_id, None)

    @property
    def consumer_ids(self) -> list[str]:
        return list(self._consumers)

    # -- publish / requeue ----------------------------------------------------
    def offer(self, msg: Message) -> bool:
        """Try to enqueue. Returns False (reject-publish) when full."""
        if self.paused:
            self.stats.rejected += 1
            return False
        if self.bytes_ready + msg.size > self.max_bytes:
            if self.overflow == OverflowPolicy.REJECT_PUBLISH:
                self.stats.rejected += 1
                return False
            while self.ready and self.bytes_ready + msg.size > self.max_bytes:
                dropped = self.ready.popleft()
                self.bytes_ready -= dropped.size
        self.ready.append(msg)
        self.bytes_ready += msg.size
        self.stats.published += 1
        return True

    def requeue_front(self, msgs: Iterable[Message]) -> None:
        """Redelivery path: crashed consumer's unacked messages go back to
        the *front* preserving original order, flagged redelivered."""
        for m in reversed(list(msgs)):
            m.redelivered = True
            self.ready.appendleft(m)
            self.bytes_ready += m.size
            self.stats.redelivered += 1

    def pop(self) -> Optional[Message]:
        if not self.ready:
            return None
        m = self.ready.popleft()
        self.bytes_ready -= m.size
        return m

    def __len__(self) -> int:
        return len(self.ready)


# --------------------------------------------------------------------------
# Consumers (broker-side channel state)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ConsumerChannel:
    consumer_id: str
    queue: str
    prefetch: int                      # basic.qos window (0 = unlimited)
    connected_node: int = 0
    next_tag: int = 1
    # unacked deliveries in tag order (for ack-multiple semantics)
    unacked: "OrderedDict[int, Delivery]" = dataclasses.field(
        default_factory=OrderedDict
    )

    @property
    def window_available(self) -> int:
        if self.prefetch <= 0:
            return 1 << 30
        return max(0, self.prefetch - len(self.unacked))


# --------------------------------------------------------------------------
# The broker cluster state machine
# --------------------------------------------------------------------------


class BrokerCluster:
    """Three-node RabbitMQ-model cluster (paper: RMQS1..3 on three DSNs).

    Memory accounting follows the paper's §5.2 configuration: of the RAM
    allocated per server, 80% is reserved for data-payload queues and 20%
    for control/management queues.
    """

    def __init__(
        self,
        n_nodes: int = 3,
        ram_bytes_per_node: int = 32 * 1024 * MIB,
        data_fraction: float = 0.8,
        default_prefetch: int = 64,
    ) -> None:
        self.n_nodes = n_nodes
        self.ram_bytes_per_node = ram_bytes_per_node
        self.data_fraction = data_fraction
        self.default_prefetch = default_prefetch
        self.queues: dict[str, ClassicQueue] = {}
        self.fanout_bindings: dict[str, list[str]] = {}  # exchange -> queues
        self.channels: dict[str, ConsumerChannel] = {}
        self._next_home = 0
        self.confirms_enabled = True

    # -- topology --------------------------------------------------------------
    @staticmethod
    def vhost_name(vhost: Optional[str], name: str) -> str:
        """Fully-qualified queue name: ``<vhost>/<name>`` (RabbitMQ-style
        virtual-host namespacing), or ``name`` for the default vhost."""
        return f"{vhost}/{name}" if vhost else name

    def declare_queue(
        self,
        name: str,
        *,
        control: bool = False,
        max_bytes: Optional[int] = None,
        home_node: Optional[int] = None,
        vhost: Optional[str] = None,
    ) -> ClassicQueue:
        """Declare (or return) a classic queue.  ``vhost`` namespaces the
        queue per tenant: the same base name declared in two vhosts
        yields two independent queues (multi-tenant MSS scenario); the
        returned queue's ``name`` is the fully-qualified one clients
        must publish/consume with."""
        name = self.vhost_name(vhost, name)
        if name in self.queues:
            return self.queues[name]
        if max_bytes is None:
            frac = (1.0 - self.data_fraction) if control else self.data_fraction
            # budget divided evenly among queues of the same class is an
            # approximation; the paper caps the whole class at frac*RAM.
            max_bytes = int(frac * self.ram_bytes_per_node)
        if home_node is None:
            home_node = self._next_home % self.n_nodes
            self._next_home += 1
        q = ClassicQueue(name, home_node, max_bytes)
        self.queues[name] = q
        return q

    def declare_fanout(self, exchange: str, queue_names: list[str]) -> None:
        for qn in queue_names:
            if qn not in self.queues:
                raise KeyError(f"fanout binding to undeclared queue {qn}")
        self.fanout_bindings[exchange] = list(queue_names)

    def bind_fanout(self, exchange: str, queue_name: str) -> None:
        self.fanout_bindings.setdefault(exchange, []).append(queue_name)

    # -- publish ----------------------------------------------------------------
    def publish(self, msg: Message) -> tuple[bool, list[str]]:
        """Route and enqueue. Returns (accepted, queues_enqueued).

        Work-queue / direct routing: routing_key == queue name.
        Fanout: routing_key == "fanout:<exchange>" replicates to all bound
        queues; accepted only if *all* bound queues accept (mirrors
        reject-publish on a full downstream queue).
        """
        if msg.routing_key.startswith("fanout:"):
            exchange = msg.routing_key.split(":", 1)[1]
            targets = self.fanout_bindings.get(exchange, [])
            if not targets:
                return False, []
            # check capacity first for atomicity
            for qn in targets:
                q = self.queues[qn]
                if q.bytes_ready + msg.size > q.max_bytes:
                    q.stats.rejected += 1
                    return False, []
            out = []
            for qn in targets:
                copy = dataclasses.replace(msg, msg_id=next(_msg_ids))
                q = self.queues[qn]
                if msg.producer_id:
                    q.publishers.add(msg.producer_id)
                q.offer(copy)
                out.append(qn)
            return True, out
        q = self.queues.get(msg.routing_key)
        if q is None:
            return False, []
        if msg.producer_id:
            q.publishers.add(msg.producer_id)
        ok = q.offer(msg)
        return ok, ([q.name] if ok else [])

    # -- consume ----------------------------------------------------------------
    def register_consumer(
        self,
        consumer_id: str,
        queue: str,
        prefetch: Optional[int] = None,
        connected_node: Optional[int] = None,
    ) -> ConsumerChannel:
        q = self.queues[queue]
        node = q.home_node if connected_node is None else connected_node
        ch = ConsumerChannel(
            consumer_id=consumer_id,
            queue=queue,
            prefetch=self.default_prefetch if prefetch is None else prefetch,
            connected_node=node,
        )
        self.channels[consumer_id] = ch
        q.add_consumer(consumer_id)
        return ch

    def next_delivery(self, queue_name: str) -> Optional[Delivery]:
        """Round-robin the queue's consumers respecting prefetch windows.

        Returns the next (consumer, message) pair, or None if the queue is
        empty or every consumer's window is closed. The engine decides *when*
        this delivery lands (service + network time).
        """
        q = self.queues[queue_name]
        if q.paused or not len(q):
            return None
        ids = q.consumer_ids
        if not ids:
            return None
        for cid in ids:
            ch = self.channels[cid]
            if ch.window_available > 0:
                # rotate round-robin cursor: move cid to the back
                q.remove_consumer(cid)
                q.add_consumer(cid)
                msg = q.pop()
                assert msg is not None
                tag = ch.next_tag
                ch.next_tag += 1
                d = Delivery(msg, cid, queue_name, tag)
                ch.unacked[tag] = d
                q.stats.delivered += 1
                return d
        return None

    def drainable(self, queue_name: str) -> bool:
        q = self.queues[queue_name]
        if q.paused or not len(q):
            return False
        return any(
            self.channels[c].window_available > 0 for c in q.consumer_ids
        )

    # -- acks --------------------------------------------------------------------
    def ack(self, consumer_id: str, delivery_tag: int, multiple: bool = False) -> int:
        """basic.ack; with multiple=True acks every tag <= delivery_tag
        (batch acknowledgements, paper §5.2). Returns #messages acked."""
        ch = self.channels[consumer_id]
        q = self.queues[ch.queue]
        acked = 0
        if multiple:
            for tag in [t for t in ch.unacked if t <= delivery_tag]:
                del ch.unacked[tag]
                acked += 1
        else:
            if delivery_tag in ch.unacked:
                del ch.unacked[delivery_tag]
                acked = 1
        q.stats.acked += acked
        return acked

    # -- failure handling ----------------------------------------------------------
    def consumer_crash(self, consumer_id: str) -> int:
        """Consumer disconnected without acking: requeue unacked in-order at
        the front (RabbitMQ behavior), deregister. Returns #redelivered."""
        ch = self.channels.pop(consumer_id, None)
        if ch is None:
            return 0
        q = self.queues[ch.queue]
        q.remove_consumer(consumer_id)
        pending = [d.message for d in ch.unacked.values()]
        q.requeue_front(pending)
        return len(pending)

    def interrupt_queue(self, name: str) -> int:
        """Broker/vhost outage: every delivery from ``name`` that is still
        unacked at the broker re-enters the queue front in order
        (at-least-once redelivery), *without* deregistering the consumers
        — their connections survive, only the queue's host died.  Late
        acks for the requeued tags become no-ops.  Returns #redelivered."""
        q = self.queues[name]
        n = 0
        for cid in q.consumer_ids:
            ch = self.channels.get(cid)
            if ch is None:
                continue
            tags = [t for t, d in ch.unacked.items() if d.queue == name]
            q.requeue_front(ch.unacked[t].message for t in tags)
            for t in tags:
                del ch.unacked[t]
            n += len(tags)
        return n

    def node_failure(self, node: int) -> list[str]:
        """Queues homed on a failed node become unavailable; returns their
        names. (Classic queues are not replicated — the paper uses classic
        queues — so failover means re-declaring on a surviving node, which
        the engine layer handles.)"""
        lost = [q.name for q in self.queues.values() if q.home_node == node]
        return lost

    def rehome_queue(self, name: str, new_node: int) -> None:
        self.queues[name].home_node = new_node

    # -- introspection ----------------------------------------------------------
    def vhost_queues(self, vhost: str) -> list[str]:
        """Names of the queues living in ``vhost``."""
        prefix = f"{vhost}/"
        return [n for n in self.queues if n.startswith(prefix)]

    def total_ready(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def total_unacked(self) -> int:
        return sum(len(ch.unacked) for ch in self.channels.values())
