"""Serving with experimental steering (work sharing with feedback at
inference time): batched generation answers streamed analysis requests and
publishes per-request results back to the producers' reply queues — the
LCLS 'recommend parameter changes while the sample is in the beam' loop.
The ``repro_torch`` counterpart of ``examples/steering_serve.py``.

    PYTHONPATH=src python examples_torch/steering_serve.py
    PYTHONPATH=src python examples_torch/steering_serve.py --device cpu

Serves on the GPU by default; ``--device cpu`` serves on the CPU, and
without a GPU the default raises.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.workloads import DSTREAM, tokens_from_payload
from repro_torch.device import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models.zoo import build_model
from repro_torch.streaming import EdgeProducer, RealtimeBroker, SteeringFeedback


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Serve four streamed requests; returns the generated ``tokens``
    (one (1, 16) tensor a request), each producer's ``steering`` reply
    and the ``producers``, stopped."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_smoke_config("granite-8b")
    model = build_model(cfg, dev)
    model.init_params(torch.Generator(dev).manual_seed(0))

    broker = RealtimeBroker()
    broker.declare_queue("work:0")
    broker.declare_queue("work:1")
    fb = SteeringFeedback(broker, ["beamline-0", "beamline-1"])
    producers = [
        EdgeProducer(broker, DSTREAM, lambda i, j=j: f"work:{j}",
                     rate_msgs_s=50, n_messages=6,
                     producer_id=f"beamline-{j}",
                     reply_queue=fb.reply_queue(f"beamline-{j}"))
        for j in (0, 1)]
    for p in producers:
        p.start()
    broker.register_consumer("hpc", "work:0")

    tokens, steering = [], []
    served = 0
    while served < 4:
        d = broker.consume("hpc", timeout=5.0)
        if d is None:
            break
        prompt = tokens_from_payload(d.message.body, cfg.vocab_size, 8)
        toks = generate(model, torch.from_numpy(prompt)[None, :], max_new=8)
        broker.ack("hpc", d.delivery_tag)
        # steer the producing instrument with the "analysis" result
        fb.publish_step(served, float(toks.sum()) % 7, backpressure=False)
        served += 1
        tokens.append(toks)
        print(f"request {d.message.headers['seq']} from "
              f"{d.message.headers['producer']}: generated "
              f"{toks.shape[1]} tokens -> feedback published")
    for p in producers:
        r = p.poll_feedback(timeout=1.0)
        steering.append(r)
        print(f"{p.id} received steering: {r}")
        p.stop(join=False)
    print(f"served {served} streamed requests")
    return dict(tokens=tokens, steering=steering, producers=producers)


if __name__ == "__main__":
    main()
