"""Steering feedback channel: work sharing *with feedback* (paper pattern
#2) mapped onto the training loop — the HPC side publishes per-step
metrics/decisions to per-producer direct reply queues, closing the
edge↔HPC loop (LCLS 'recommend parameter changes while the sample is still
in the beam'; SNS 'adjust beam settings in minutes').

A copy of the reference package's ``streaming.feedback``."""

from __future__ import annotations

from typing import Iterable

from repro_torch.core.broker import Message
from repro_torch.streaming.rtbroker import RealtimeBroker


class SteeringFeedback:
    def __init__(self, broker: RealtimeBroker, producer_ids: Iterable[str]):
        self.broker = broker
        self.producer_ids = list(producer_ids)
        for pid in self.producer_ids:
            rq = f"reply:{pid}"
            broker.declare_queue(rq, control=True)
            broker.register_consumer(pid, rq)   # producer consumes its queue
        self.published = 0

    def reply_queue(self, pid: str) -> str:
        return f"reply:{pid}"

    def publish_step(self, step: int, loss: float, *,
                     backpressure: bool = False) -> None:
        """Direct-routed metric replies — one per producer, so each reply
        reaches exactly the producer it steers (paper §5.2: dedicated reply
        queues prevent misrouting)."""
        for pid in self.producer_ids:
            headers = {"step": step, "loss": float(loss),
                       "slow_down": bool(backpressure),
                       "speed_up": not backpressure}
            self.broker.publish(
                Message(routing_key=self.reply_queue(pid), size=256,
                        body=None, headers=headers, producer_id="trainer"),
                block=False)
            self.published += 1
