"""Batched serving entry point of the port: prefill + decode with the cache,
the counterpart of the reference's ``repro.launch.serve``.

Runs on the GPU unless asked for the CPU::

    python -m repro_torch.launch.serve --arch granite-8b
    python -m repro_torch.launch.serve --arch granite-8b-smoke --device cpu
    python -m repro_torch.launch.serve --arch zamba2-7b
    python -m repro_torch.launch.serve --arch zamba2-7b-smoke --device cpu
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b-smoke --device cpu
    python -m repro_torch.launch.serve --arch musicgen-large
    python -m repro_torch.launch.serve --arch pixtral-12b-smoke --device cpu
    python -m repro_torch.launch.serve --arch xlstm-1.3b
    python -m repro_torch.launch.serve --arch xlstm-1.3b-smoke --device cpu

``--arch`` takes any name of ``repro_torch.configs.ARCH_NAMES`` (the
dense, MoE, audio, VLM, hybrid and xLSTM families) or its ``-smoke``
form.
Decode runs on token ids for every family, as the reference's: the
audio model's ids are its codebook tokens, and the VLM's prompt is text
only (the prefill step takes the frontends' embeddings).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.steps import build_serve_step
from repro_torch.models.sharding import ModelContext
from repro_torch.models.zoo import LM, build_model


def generate(model: LM, prompts: torch.Tensor, max_new: int,
             ctx: Optional[ModelContext] = None, greedy: bool = True,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """prompts: (B, P) token ids.  Returns (B, P+max_new) int32 tokens on
    the model's device.

    The prompt is prefilled token by token through the decode step, as
    the reference does.  The first new token is the argmax after the
    prompt; later ones are the argmax (``greedy``) or drawn from the
    softmax of the logits with ``generator`` (on the model's device;
    seeded 0 when omitted)."""
    B, P = prompts.shape
    total = P + max_new
    dev = model.device
    prompts = prompts.to(device=dev, dtype=torch.int32)
    if not greedy and generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    cache = model.init_cache(B, total)
    step = build_serve_step(model, ctx or ModelContext())
    out = [prompts]
    logits = None
    for t in range(P):
        pos = torch.full((B,), t, dtype=torch.int32, device=dev)
        logits, cache = step(cache, prompts[:, t], pos)
    cur = logits.argmax(-1).to(torch.int32)
    out.append(cur[:, None])
    for t in range(P, total - 1):
        pos = torch.full((B,), t, dtype=torch.int32, device=dev)
        logits, cache = step(cache, cur, pos)
        if greedy:
            cur = logits.argmax(-1).to(torch.int32)
        else:
            probs = torch.softmax(logits.float(), dim=-1)
            cur = torch.multinomial(probs, 1, generator=generator)[:, 0].to(
                torch.int32)
        out.append(cur[:, None])
    return torch.cat(out, dim=1)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b-smoke",
                    help="one of repro_torch.configs.ARCH_NAMES or "
                         "'<name>-smoke'")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = (get_smoke_config(args.arch.removesuffix("-smoke"))
           if args.arch.endswith("-smoke") else get_config(args.arch))
    model = build_model(cfg, args.device)
    dev = model.device
    model.init_params(torch.Generator(dev).manual_seed(args.seed))
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    toks = generate(model, prompts, args.max_new)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_new = args.batch * args.max_new
    print(f"generated {tuple(toks.shape)} on {dev} in {dt:.1f}s "
          f"({n_new / dt:.1f} tok/s batch-aggregate)")
    print("sample:", toks[0, :16].tolist(), "...")


if __name__ == "__main__":
    main()
