#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, one line each: the card; the kernel build from the sources in
the checkout (one ``nvcc`` per source, all started together); every
kernel against its plain PyTorch version on the card, with its time
beside its bound and, where one PyTorch call computes the same function,
that call's time: the pump bitwise; flash attention at the tolerances of
``tests/test_kernels.py`` and, row by row, against its plain version in
float32, on granite-8b's, zamba2-7b's and gemma2-9b's shapes and the edge
cases, each on the kernel its route rule picks (the tensor-core kernel
for bf16 at hd 64, 112 and 128), and both kernels timed at granite's and
zamba2's shapes with the registers and CTAs an SM they get; RMSNorm at both models' widths; flash decode on both models' full
caches, gemma2's window, ragged positions and one long request, with
the cache past each position overwritten, and at the four serving
shapes (granite 128 x 2048 and 32 x 8192, zamba2 32 x 4096 and 8 x 16384)
its time beside SDPA's, the bytes bound, the share of the memory rate,
the registers, CTAs an SM and waves of its grid (``decode shape:``
lines); the SSD state scan at zamba2's prefill and a 32768-token
request, timed with its registers and CTAs an SM beside the bound and
the bytes floor.
Then the paths, each with every kernel's launches counted from 0 just
before it and read just after (every flash-decode launch on the
tensor-core kernel):

* the wave path — ``run_many`` at deployment scale (1024x1024
  work-sharing on dts, prs-haproxy and mss, 256x256 feedback on dts,
  three seed-lanes each, built by ``patterns.pattern_spec`` with
  ``engine="jax", jax_device_loop=True``, the reference's opt-in to the
  wave program); the same Fig 4 cell run on the GPU and on the CPU,
  compared; and a ``torch.profiler`` breakdown of one cell;
* the cohort path — ``run_many`` on the cells the wave gate refuses and
  on the broadcast patterns, which go to the per-cohort engine: Fig 7a
  (broadcast, 64 consumers) and Fig 7b (broadcast+gather, 32 consumers)
  of the generic workload at 64 messages (``BROADCAST_MSGS``) on dts,
  prs-haproxy and mss,
  Fig 4's dstream at 4 consumers x 4096 messages on dts and Fig 6's
  dstream feedback at 64 x 3072 on mss, three seed-lanes each, warm,
  timed ``COHORT_REPEATS`` times, every lane consuming every message with
  no pump launch and the host's reads counted; a Fig 7b cell at 8
  consumers on the GPU and on the CPU, compared; and a device-only
  ``torch.profiler`` breakdown of the Fig 7b dts cell;
* the flow cells — ``run_many`` on two overflow-regime cells of
  ``benchmarks/bench_overflow_regime.py`` (feedback of dstream on dts
  under a byte cap: the parity cell, 4 x 4, and the scale smoke, 64 x
  64, 8192 messages each), which take the cohort engine's credit flow
  and reject-publish overflow, three seed-lanes each, warm, timed
  ``COHORT_REPEATS`` times: every lane consuming every message and
  rejecting publishes (the parity cell's also withholding confirms), no
  confirm left withheld, no pump launch; and a work-sharing 1 x 1 cell
  under a 424-message cap on the GPU and on the CPU, compared, counters
  exactly;
* the chaos cells — ``patterns.chaos_campaign`` at its defaults, the
  chaos campaign of ``benchmarks/bench_chaos.py`` at its full size (work
  sharing of the generic workload, 4 producers x 8 consumers, 4096
  messages, an outage over [5, 10) s): the ingress link, a broker queue
  and a consumer failing, and consumers autoscaled from 2 to 8, on dts,
  prs-haproxy and mss, each beside its arch's failure-free baseline, in
  one warm ``run_many`` on the per-cohort engine (each cell solo): nothing
  lost, every duplicate a redelivery, the broker outage redelivering and
  rejecting publishes, the link and autoscale cells redelivering
  nothing, the link outage stretching the run by less than its length,
  no pump launch and no confirm left withheld, and each point's
  scoreboard printed; and the broker and consumer cells on prs-haproxy
  at the bench's smoke size (512 messages, an outage over [1, 3) s) on
  the GPU and on the CPU, compared, counters exactly;
* the experiment layer — ``run_pattern`` on the main path's feedback
  cell, each seed solo on the wave program (pump launches), its
  summaries inside the ``device_loop.*`` bands of the main path's
  stacked lanes; ``run_campaign`` of Fig 6's feedback at 64 consumers x
  16384 messages on dts and mss, in-process, the dts group on the wave
  program (pump launches) and the mss group on the cohort engine (none),
  every summary reporting the jax engine; ``deployment_feasibility`` at
  1, 8 and 64 tenants, its curves and headline;
* the availability crossover — ``availability_crossover`` at the
  reference's defaults but for the outage durations, 5, 40 and 80 s of
  its five (single-fault ingress outages on dts and mss, 12 solo cohort
  cells), nothing lost in any cell, its curves, crossover duration and
  headline printed;
* the heap parity phase — the card's per-cohort engine held to the
  port's heap engine (``engine="heap"``, the one-event-per-hop model the
  reference's parity bands are defined against, which runs on the
  host), one line per part with the heap engine's wall, events and
  events a second on the host CPU beside the card engine's wall: (a)
  the reference's Fig 4/6/7 parity grid (work sharing and feedback of
  dstream at 4096 messages, broadcast+gather of generic at 400, on dts,
  prs-haproxy and mss at 8 consumers, seed 0, jitter 0) through
  ``run_pattern`` on each engine, within the reference's bands and
  with equal message counts; (b) the chaos phase's 15 card runs against
  heap runs of the same specs, by ``tests/test_chaos.py``'s checks; (c)
  the flow parity cell's three card lanes against a solo heap run of
  each seed, within the ``stacked_overflow`` bands with both counters
  non-zero; (d) ``examples/quickstart.py`` through the port, its
  deployment lines and its work-sharing table on both engines equal to
  the reference's.  No part launches a kernel;
* serving granite-8b at full width and depth (36 layers, random bf16
  weights from a seed), with ``attention_impl="pallas"``: the prefill
  step on 4 requests x 4096 prompt tokens (flash attention once per
  layer, every launch on the tensor-core kernel, RMSNorm for every norm),
  its logits held to the same prefill with each plain attention
  (reference, blocked) and its next token to theirs wherever their
  top-two gap exceeds their spread; the prefill walked
  layer by layer with each attention, the flash kernel checked on every
  layer's own q, k, v and the logits compared by depth; a profile of
  one prefill; ``generate`` (4 requests, 16-token prompts, 16 new tokens,
  greedy) and a profile of a few of its decode steps; decode steps
  against a full cache of 128 x 2048 and 32 x 8192 tokens with flash
  decode, each beside one step with the plain grouped einsum, logits
  compared; one decode step at 128 x 2048 walked layer by layer with
  flash decode, the einsum and a second plain decode attention, flash
  decode held on every layer's own q and cache and the logits compared
  by depth;
* serving zamba2-7b at full width and depth (81 Mamba2 layers, the
  shared attention block 13 times, random bf16 weights from a seed),
  after granite's memory is freed: the prefill step on 4 x 4096 tokens
  (flash attention 13 times on the tensor-core kernel, the SSD state scan
  once per Mamba2 layer, RMSNorm for every norm), its logits and next
  tokens held as granite's to the all-plain path and the blocked one; the SSD kernel held layer by layer to its plain version
  on the model's own inputs through the first macro-block; a profile of
  one prefill; ``generate``; decode steps against 32 x 4096 and 8 x 16384
  cached tokens with flash decode, each beside one plain step.

The line before the last holds the kernels' numbers as JSON, and the
last line the device.  Any failure exits nonzero; without CUDA it exits
1 before printing a result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peak memory rate (NVIDIA data sheet), bytes/s
HBM_BPS = 3.35e12
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), FLOP/s
BF16_FLOPS = 989e12
#: H100 SXM float32 peak outside the tensor cores (NVIDIA data sheet), FLOP/s
F32_FLOPS = 67e12
#: cross-device tolerance: CUDA's cumsum associates differently from the
#: CPU's sequential sum, so clocks may differ in the last bits
XDEV_RTOL = 1e-9

MAIN_CELLS = (
    ("work_sharing", "dts", 1024, 262144),
    ("work_sharing", "prs-haproxy", 1024, 262144),
    ("work_sharing", "mss", 1024, 262144),
    ("feedback", "dts", 256, 65536),
)
SEEDS = (0, 1000, 2000)
#: warm timed runs of each main-path cell (median and spread reported)
WALL_REPEATS = 3
#: warm timed runs of each cohort and flow cell: one, so that the smoke
#: with its chaos phase stays well inside its time limit (these phases are
#: host-bound, and their walls vary up to 1.8x between calls)
COHORT_REPEATS = 1

#: the cohort engine's cells, (pattern, arch, workload, consumers,
#: messages), from the paper's grids: Fig 7a and 7b at their widest
#: (``benchmarks/bench_fig7_broadcast_gather.py``), Fig 4's dstream at 4
#: consumers (1024 msgs/producer, past the wave gate's 256;
#: ``bench_fig4_work_sharing.py``) and Fig 6's dstream on mss, which the
#: gate refuses (``bench_fig6_feedback_rtt.py``).  Broadcast cells have
#: one producer, the others one per consumer (as the reference's
#: ``pattern_spec``).  The broadcast cells run ``BROADCAST_MSGS``
#: messages, cut in depth from the 384 they ran before the heap parity
#: phase, to keep the smoke's phases under 1000 s; their width (64 and
#: 32 consumers, 4 MiB messages) is uncut
BROADCAST_MSGS = 64
COHORT_CELLS = (
    ("broadcast", "dts", "generic", 64, BROADCAST_MSGS),
    ("broadcast", "prs-haproxy", "generic", 64, BROADCAST_MSGS),
    ("broadcast", "mss", "generic", 64, BROADCAST_MSGS),
    ("broadcast_gather", "dts", "generic", 32, BROADCAST_MSGS),
    ("broadcast_gather", "prs-haproxy", "generic", 32, BROADCAST_MSGS),
    ("broadcast_gather", "mss", "generic", 32, BROADCAST_MSGS),
    ("work_sharing", "dts", "dstream", 4, 4096),
    ("feedback", "mss", "dstream", 64, 3072),
)
#: the cohort cell run on the card and on the CPU, compared
COHORT_XCHECK = ("broadcast_gather", "prs-haproxy", "generic", 8, 384)
#: the gather leg's replies are 1/256 of the request (``pattern_spec``)
GATHER_REPLY_FACTOR = 1.0 / 256.0

#: the overflow-regime parameters (``patterns.OVERFLOW_STRESS_DEFAULTS``):
#: a small confirm window, slow consumers
OVERFLOW_STRESS = dict(confirm_window=64, prefetch=16, ack_batch=4,
                       consumer_proc_s=2e-3)
#: the flow cells, feedback of dstream on dts, one producer a consumer,
#: from ``benchmarks/bench_overflow_regime.py``: (name, consumers,
#: messages, byte cap in messages, parameters over OVERFLOW_STRESS).  The
#: parity cell's cap sits 6% above the credit threshold (400 a producer)
#: with jitter off, so both mechanisms fire; the scale smoke's consumers
#: take 250 µs each per consumer, so 64 producers outpace the drain and
#: the queues pin at their cap (reject-publish alone)
FLOW_CELLS = (
    ("parity", 4, 8192, int(400 * 4 * 1.06), dict(jitter=0.0)),
    ("scale smoke", 64, 8192, 2048, dict(consumer_proc_s=250e-6 * 64)),
)
#: the flow cell run on the card and on the CPU, compared: work sharing
#: of dstream on dts, 1 x 1, 1536 msgs, a 424-message cap (both
#: mechanisms)
FLOW_XCHECK = ("work_sharing", 1, 1536, 424, dict(consumer_proc_s=5e-3))

#: the chaos campaign runs ``patterns.chaos_campaign`` at its defaults,
#: ``benchmarks/bench_chaos.py``'s full size: work sharing of the generic
#: workload (4 MiB), 4 producers x 8 consumers, 4096 messages, consumer
#: processing 2 ms, jitter 0, an outage over [5, 10) s; each scenario on
#: each deployment arch, beside the arch's failure-free baseline.  The
#: chaos cells run on the card and on the CPU, compared, at the bench's
#: smoke size (``CHAOS_BENCH_SMOKE``)
CHAOS_XCHECK = (("prs-haproxy", "broker"), ("prs-haproxy", "consumer"))
CHAOS_XCHECK_MSGS, CHAOS_XCHECK_WINDOW = 512, (1.0, 3.0)

#: the experiment layer's cells: (a) ``run_pattern`` on the main path's
#: feedback cell, each seed solo; (b) a campaign of Fig 6's feedback at
#: 64 consumers x 16384 messages (256 a producer, inside the wave gate's
#: feedback corridor W < M <= 2W at the confirm window of 128) on dts,
#: which the gate takes, and mss, which it refuses; (c) the deployment
#: study at three of ``TENANT_SWEEP``'s seven tenant counts
EXP_PATTERN = ("feedback", "dts", 256, 65536)
EXP_CAMPAIGN = dict(name="fig6 c64", patterns=("feedback",),
                    architectures=("dts", "mss"), workloads=("dstream",),
                    consumers=(64,), n_runs=len(SEEDS), total_messages=16384,
                    params={"engine": "jax", "jax_device_loop": True})
EXP_TENANTS = (1, 8, 64)
#: the cells that opt in to the wave program, as the reference's do
WAVE = dict(engine="jax", jax_device_loop=True)

#: the heap parity phase (a): the reference's Fig 4/6/7 parity grid
#: (``tests/test_engine_parity.py``), (pattern, workload, messages) on
#: each of ``HEAP_ARCHS`` at ``HEAP_NC`` consumers, seed 0, jitter 0,
#: run once on the card's cohort engine and once on the heap engine
HEAP_GRID = (("work_sharing", "dstream", 4096),
             ("feedback", "dstream", 4096),
             ("broadcast_gather", "generic", 400))
HEAP_ARCHS = ("dts", "prs-haproxy", "mss")
HEAP_NC = 8
#: chaos scenario -> its parity band's scope (``tests/test_chaos.py``)
CHAOS_SCOPE = {"tunnel": "link", "broker": "broker",
               "consumer": "consumer", "autoscale": "autoscale"}
#: the heap parity phase (d): ``examples/quickstart.py`` through the port
#: (its work-sharing table: dstream, 8 x 8, 2048 messages, seed 0), and
#: the lines the reference package prints for it on each engine
#: (``PYTHONPATH=src python examples/quickstart.py [--engine heap]``)
QUICKSTART_ARCHS = ("dts", "prs-haproxy", "prs-stunnel", "mss")
QUICKSTART_DEPLOY = (
    "DTS : requires firewall/iptables rules, NodePort + DNS admin; viable "
    "only within unified administrative domains",
    "PRS : overlay producer -> 198.51.100.1:5100 -> 198.51.100.0:5100 -> "
    "consumer (uid=uid-000001)",
    "MSS : provisioned amqps://rabbitmq-abc123-1.apps.olivine.ccs.ornl.gov"
    ":443")
QUICKSTART_TABLE = {
    "vectorized": ("dts               35691 msgs/s (4.68 Gbps)",
                   "prs-haproxy       18775 msgs/s (2.46 Gbps)",
                   "prs-stunnel        6032 msgs/s (0.79 Gbps)",
                   "mss               14144 msgs/s (1.85 Gbps)",
                   "  prs-haproxy    1.90x",
                   "  prs-stunnel    5.92x",
                   "  mss            2.52x"),
    "heap": ("dts               35330 msgs/s (4.63 Gbps)",
             "prs-haproxy       18772 msgs/s (2.46 Gbps)",
             "prs-stunnel        6034 msgs/s (0.79 Gbps)",
             "mss               14137 msgs/s (1.85 Gbps)",
             "  prs-haproxy    1.88x",
             "  prs-stunnel    5.85x",
             "  mss            2.50x"),
}

#: flash-attention checks on the card: (case, dtype, B, S, T, H, KV, hd,
#: causal, window, logit cap).  The first is granite-8b's prefill shape
#: and is the one timed; zamba2-7b's (hd 112) is timed beside it.
ATTN_CASES = (
    ("granite-8b prefill", "bfloat16", 4, 4096, 4096, 32, 8, 128, True, 0, 0.0),
    ("zamba2-7b prefill", "bfloat16", 4, 4096, 4096, 32, 32, 112, True, 0, 0.0),
    ("granite-8b B=1", "bfloat16", 1, 4096, 4096, 32, 8, 128, True, 0, 0.0),
    ("gemma2-9b local", "bfloat16", 1, 8192, 8192, 16, 8, 256, True, 4096, 50.0),
    ("f32 hd=64", "float32", 2, 1024, 1024, 8, 2, 64, True, 0, 0.0),
    ("f32 hd=112 window softcap", "float32", 1, 1000, 1000, 4, 2, 112, True, 300, 30.0),
    ("non-causal", "bfloat16", 2, 1024, 1024, 8, 8, 128, False, 0, 0.0),
    ("MQA", "bfloat16", 2, 1024, 1024, 16, 1, 128, True, 0, 0.0),
    ("ragged S", "bfloat16", 1, 1000, 1000, 8, 2, 128, True, 0, 0.0),
    ("ragged f32 window softcap", "float32", 1, 777, 777, 4, 2, 64, True, 100, 30.0),
)
#: RMSNorm checks: (case, dtype, rows, D).  The first (granite-8b's
#: prefill rows) is timed; zamba2's out_norm over d_in 7168 beside it.
RMS_CASES = (
    ("granite-8b prefill", "bfloat16", 16384, 4096),
    ("zamba2-7b out_norm", "bfloat16", 16384, 7168),
    ("zamba2-7b decode", "bfloat16", 32, 3584),
    ("f32", "float32", 1000, 3584),
)
#: flash-decode checks: (case, dtype, B, T, H, KV, hd, window, cap, ragged
#: positions).  The first (granite-8b's 128 x 2048 cache, every request at
#: its last position) is timed.
DECODE_CASES = (
    ("granite-8b 128x2048", "bfloat16", 128, 2048, 32, 8, 128, 0, 0.0, False),
    ("granite-8b 32x8192 ragged", "bfloat16", 32, 8192, 32, 8, 128, 0, 0.0, True),
    ("zamba2-7b 32x4096", "bfloat16", 32, 4096, 32, 32, 112, 0, 0.0, False),
    ("gemma2-9b local 8x8192", "bfloat16", 8, 8192, 16, 8, 256, 4096, 50.0, True),
    ("zamba2-7b 1x65536", "bfloat16", 1, 65536, 32, 32, 112, 0, 0.0, False),
    ("f32 3x512 ragged", "float32", 3, 512, 8, 2, 64, 0, 0.0, True),
)
#: flash decode timed at the serving paths' shapes, every request at its
#: last position, bf16: (case, B, T, H, KV, hd).  The first is the one in
#: the kernels line.
DECODE_SHAPES = (
    ("granite-8b 128x2048", 128, 2048, 32, 8, 128),
    ("granite-8b 32x8192", 32, 8192, 32, 8, 128),
    ("zamba2-7b 32x4096", 32, 4096, 32, 32, 112),
    ("zamba2-7b 8x16384", 8, 16384, 32, 32, 112),
)
#: SSD state scan checks: (case, B, nc, nh, hd, N, Q).  The first
#: (zamba2-7b's prefill, 4 x 4096 tokens) is timed.
SSD_CASES = (
    ("zamba2-7b prefill", 4, 16, 112, 64, 64, 256),
    ("zamba2-7b 32768-token request", 1, 128, 112, 64, 64, 256),
    ("tests/test_kernels.py", 2, 4, 3, 8, 16, 32),
)
#: tolerance of the SSD scan (``tests/test_kernels.py``'s, rtol = atol)
SSD_TOL = 1e-5

#: serving paths: requests x prompt tokens (cut from prefill_32k's
#: 32 x 32768, whose SwiGLU intermediate does not fit)
PREFILL_BATCH, PREFILL_LEN = 4, 4096
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 4, 16, 16
#: decode steps against a full cache: (requests, cache length).  granite:
#: the same 262144 cached tokens (38.65 GB of bf16 K/V) cut from
#: decode_32k's 128 x 32768 (618 GB); zamba2: 131072 tokens (24.4 GB of
#: K/V over 13 applications, beside 4.76 GB of f32 SSM state at 32
#: requests) cut from decode_32k (781 GB of K/V)
DECODE_CTX = {"granite-8b": ((128, 2048), (32, 8192)),
              "zamba2-7b": ((32, 4096), (8, 16384))}
DECODE_CTX_STEPS = 5
#: decode steps profiled after ``generate``
PROFILE_STEPS = 4
#: prefill (and decode-step) logits against the same step with each
#: plain path: max |diff| over max |logit|, and the prefill's next token
#: equal where it is decided (``check_prefill``).  Deep stacks of random layers amplify every bf16 rounding: on the H100 the
#: two plain attentions of granite-8b differ by 4.9e-2 of max |logit|,
#: and any two of the three by 3.9e-2 to 5.3e-2.  After the first layer,
#: before any amplification, the limit is SHALLOW_RTOL (``walk_layers``
#: reads the spread at each of ``DEPTHS``); the kernel's own accuracy is
#: held at every layer (``_hold``).
PREFILL_RTOL = 1e-1
SHALLOW_RTOL = 2e-2
DEPTHS = (1, 2, 4, 9, 18, 36)
#: a kernel against its plain version in float32 on the same values,
#: element by element: twice the largest error of one rounding of the
#: output to bf16 (2^-8 relative), plus float32 accumulation of at most
#: ROW_ATOL of the row's RMS
ROW_ATOL = 1e-4


def _cuda_ms(fn, n_iter: int, repeats: int = 7) -> float:
    """Median over ``repeats`` of the mean time of ``n_iter`` calls,
    from CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n_iter):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / n_iter)
    return statistics.median(times)


def _graph_ms(fn, n_iter: int, repeats: int = 7) -> float:
    """Device time per call: ``n_iter`` calls captured in one CUDA graph,
    replayed and timed with CUDA events, so the host's per-call
    overhead drops out; median over ``repeats`` replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_iter):
            fn()
    return _cuda_ms(graph.replay, 1, repeats) / n_iter


def _bound(nbytes: float, flops: float, peak_flops: float) -> dict:
    """The least time for ``nbytes`` moved and ``flops`` done: the larger
    of the two times on the card's peaks, and which one it is."""
    bytes_ms = nbytes / HBM_BPS * 1e3
    ops_ms = flops / peak_flops * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="operations" if ops_ms > bytes_ms else "bytes",
                bytes=nbytes, flops=flops, bytes_ms=bytes_ms, ops_ms=ops_ms)


def _reset_launches() -> None:
    from repro_torch.kernels import KERNELS
    for fn in KERNELS.values():
        fn.launches = 0
    KERNELS["flash_attention"].tc_launches = 0
    KERNELS["flash_decode"].tc_launches = 0


def _launches() -> dict:
    from repro_torch.kernels import KERNELS
    return {name: fn.launches for name, fn in KERNELS.items()}


def _want_launches(cfg, phase: str, steps: int = 1) -> dict:
    """Every kernel's launches in one prefill or ``steps`` decode steps
    of ``cfg`` under ``attention_impl="pallas"``: flash attention once
    per attention layer in prefill, flash decode once per attention layer
    and step, the SSD scan once per Mamba2 layer in prefill, RMSNorm for
    every norm."""
    if cfg.family == "hybrid":
        attn, ssd = cfg.n_macro_blocks, cfg.n_layers
        norms = 2 * cfg.n_layers + 2 * attn + 1
    else:
        attn, ssd = cfg.n_layers, 0
        norms = (4 if cfg.post_norms else 2) * attn + 1
    prefill = phase == "prefill"
    return {"pump_assign": 0,
            "flash_attention": attn if prefill else 0,
            "rmsnorm": norms * (1 if prefill else steps),
            "flash_decode": 0 if prefill else attn * steps,
            "ssd_state_scan": ssd if prefill else 0}


def _check_launches(got: dict, want: dict, what: str) -> None:
    """The launches are exact, and every flash-decode launch (bf16 at the
    serving models' head dims) ran the tensor-core kernel."""
    from repro_torch.kernels import KERNELS
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, want {want}")
    tc = KERNELS["flash_decode"].tc_launches
    if tc != got["flash_decode"]:
        raise AssertionError(f"{what}: {tc} of {got['flash_decode']} "
                             f"flash-decode launches on the tensor-core "
                             f"kernel")


def _pump_inputs(rng, R: int, P: int, L: int, Np: int, case: str, dev):
    import torch
    ring = rng.uniform(0.0, 50.0, size=(R, P, L))
    t = rng.uniform(0.0, 50.0, size=(Np, L))
    gid = rng.integers(0, R, size=Np)
    idx = rng.integers(0, 4 * P, size=Np)
    valid = rng.random(Np) < 0.9
    if case == "all_below_P":
        idx = rng.integers(0, P, size=Np)
    elif case == "all_invalid":
        valid[:] = False
    elif case == "dummy_row":
        gid[:] = R - 1
    t[~valid] = float("inf")
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (ring, t, gid, idx, valid))


def check_pump(dev) -> dict:
    """The pump kernel against ``pump_assign_ref`` on the card, bitwise,
    at the main-path shapes and the edge cases; its time, the plain
    version's time and the bound at the main-path shape."""
    import numpy as np
    import torch
    from repro_torch.kernels.pump_assign import pump_assign, pump_assign_ref
    rng = np.random.default_rng(0)
    cases = [("main", 1025, 64, 3, 8192), ("L1", 1025, 64, 1, 8192),
             ("ragged", 257, 64, 3, 8192 - 37), ("all_below_P", 1025, 64, 3, 8192),
             ("all_invalid", 1025, 64, 3, 8192), ("dummy_row", 1025, 64, 3, 8192),
             ("reply_pump", 257, 64, 3, 2048)]
    for case, R, P, L, Np in cases:
        args = _pump_inputs(rng, R, P, L, Np, case, dev)
        got = pump_assign(*args)
        torch.cuda.synchronize()
        want = pump_assign_ref(*args)
        if not torch.equal(got, want):
            err = (got - want).abs().max().item()
            raise AssertionError(f"pump_assign differs from its plain "
                                 f"version on case {case}: {err}")
    ring, t, gid, idx, valid = _pump_inputs(rng, 1025, 64, 3, 8192, "main", dev)
    got, want = pump_assign(ring, t, gid, idx, valid), pump_assign_ref(
        ring, t, gid, idx, valid)
    fin = torch.isfinite(want)
    max_err = float((got[fin] - want[fin]).abs().max().item())
    ms = _graph_ms(lambda: pump_assign(ring, t, gid, idx, valid), 200)
    plain_ms = _graph_ms(lambda: pump_assign_ref(ring, t, gid, idx, valid), 200)
    # the launch floor: the same graph of calls at Np = 1, L = 1, where
    # the kernel moves a few bytes
    one = _pump_inputs(rng, 2, 64, 1, 1, "main", dev)
    floor_ms = _graph_ms(lambda: pump_assign(*one), 200)
    call_ms = _cuda_ms(lambda: pump_assign(ring, t, gid, idx, valid), 200)
    plain_call_ms = _cuda_ms(
        lambda: pump_assign_ref(ring, t, gid, idx, valid), 200)
    # bytes the function must move: t_ready, gid, idx_on, valid read
    # once, out written once, and the ring rows this data gates on
    gated = int(((idx >= 64) & valid).sum().item())
    nbytes = (t.numel() * 8 * 2 + gid.numel() * 8 + idx.numel() * 8
              + valid.numel() + gated * 3 * 8)
    return dict(name="pump_assign", route="cuda",
                source="src/repro_torch/kernels/csrc/pump_assign.cu",
                replaces="src/repro/core/jax_device_loop.py:837",
                launches=0, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BPS * 1e3, bound_by="bytes",
                library_ms=None, cases=len(cases), launch_floor_ms=floor_ms,
                call_ms=call_ms, plain_call_ms=plain_call_ms)


def _attn_tol(dtype: str, window: int, cap: float) -> float:
    """``tests/test_kernels.py``'s tolerances (rtol = atol)."""
    if dtype == "bfloat16":
        return 2e-2
    return 3e-5 if (window or cap) else 2e-5


def _hold_rows(got, want, want32, tol: float, what: str) -> dict:
    """A kernel's output ``got`` against its plain version: ``want`` on the
    same inputs within ``tol`` (rtol = atol), and ``want32`` (the plain
    version in float32 on the same values) element by element within
    twice one rounding of the output (2^-7 relative in bf16) plus
    ``ROW_ATOL`` of its row's RMS.  The second limit scales with each
    row: a flat one is as large as small outputs (|out| ~ 0.03 at row
    4096 of a long causal sequence).  Returns the readings: max abs
    error, max error over its row's RMS, and the largest share of the
    row limit used."""
    import torch
    g = got.float()
    diff = (g - want.float()).abs()
    flat_ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= tol + tol * want.float().abs()).all())
    err = diff.max().item()
    del diff
    rms = want32.pow(2).mean(-1, keepdim=True).sqrt()
    u = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    diff = (g - want32).abs()
    row_err = (diff / rms).max().item()
    use = (diff / (u * want32.abs() + ROW_ATOL * rms)).max().item()
    if not (flat_ok and use <= 1.0):
        raise AssertionError(f"{what}: max abs err {err} (tol {tol}), row "
                             f"limit used {use} (limit 1)")
    return dict(max_abs_err=err, tol=tol, row_rel_err=row_err,
                row_limit_used=use)


def _hold(got, q, k, v, pos, kw: dict, what: str) -> dict:
    """The flash kernel's output on ``q, k, v`` against its plain version
    (``_hold_rows``)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    want = flash_attention_ref(q, k, v, pos, pos, **kw)
    want32 = flash_attention_ref(q.float(), k.float(), v.float(), pos, pos,
                                 **kw)
    tol = _attn_tol(str(q.dtype).removeprefix("torch."), kw["window"],
                    kw["logit_cap"])
    return _hold_rows(got, want, want32, tol,
                      f"flash_attention vs its plain version on {what}")


def _visible_pairs(pos, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible: the work this data
    needs, counted row block by row block."""
    import torch
    n = 0
    for i in range(0, pos.numel(), 1024):
        d = pos[i:i + 1024, None].long() - pos[None, :].long()
        ok = torch.ones_like(d, dtype=torch.bool)
        if causal:
            ok &= d >= 0
        if window > 0:
            ok &= d < window
        n += int(ok.sum().item())
    return n


def _fma_copy(q):
    """q at a pointer 2 bytes off 16-byte alignment: TMA cannot address
    it, so the wrapper's rule sends a call with it to the FMA kernel."""
    import torch
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)
    out = buf[1:].view(q.shape)
    out.copy_(q)
    return out


def check_flash(dev) -> dict:
    """The flash-attention kernels against ``flash_attention_ref`` on the
    card at every ``ATTN_CASES`` shape, each on the route the wrapper's
    rule picks (every bf16 case at hd 64, 112 or 128 must run the
    tensor-core kernel); at granite-8b's and zamba2-7b's prefill shapes,
    for each route (the FMA kernel reached with a q that TMA cannot
    address), the time a launch, the registers and CTAs an SM that the
    compiler and the occupancy API report, the row-limit share and the
    rate, beside one ``scaled_dot_product_attention`` call's time; at
    granite's shape the plain version's time and the bounds."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    flash_attention, flash_attention_ref = fa.flash_attention, \
        fa.flash_attention_ref
    g = torch.Generator(dev).manual_seed(0)
    rows, timed = [], []
    for case, dtype, B, S, T, H, KV, hd, causal, window, cap in ATTN_CASES:
        td = getattr(torch, dtype)
        q = torch.randn(B, S, H, hd, generator=g, device=dev).to(td)
        k = torch.randn(B, T, KV, hd, generator=g, device=dev).to(td)
        v = torch.randn(B, T, KV, hd, generator=g, device=dev).to(td)
        pos = torch.arange(S, device=dev, dtype=torch.int32)
        kw = dict(causal=causal, window=window, logit_cap=cap)
        route = fa.route(q, k, v)
        if route != ("tc" if dtype == "bfloat16" and hd in fa.TC_HEAD_DIMS
                     else "fma"):
            raise AssertionError(f"flash_attention on {case}: route {route}")
        n_tc = flash_attention.tc_launches
        got = flash_attention(q, k, v, pos, pos, **kw)
        torch.cuda.synchronize()
        if flash_attention.tc_launches - n_tc != (route == "tc"):
            raise AssertionError(f"flash_attention on {case}: tc_launches "
                                 f"moved by {flash_attention.tc_launches - n_tc}")
        rows.append(dict(case=case, route=route,
                         **_hold(got, q, k, v, pos, kw, case)))
        del got
        if len(timed) < 2:
            timed.append((q, k, v, pos, kw))
        else:
            del q, k, v
        torch.cuda.empty_cache()
    shapes = {}
    for tag, (q, k, v, pos, kw) in zip(("granite", "zamba2"), timed):
        B, S, H, hd = q.shape
        # the library's fused attention on the same data, (B, H, S, hd)
        # layout made once outside the timing
        sdpa = functools.partial(
            F.scaled_dot_product_attention,
            *(x.transpose(1, 2).contiguous() for x in (q, k, v)),
            is_causal=True, enable_gqa=True)
        library_ms = _cuda_ms(sdpa, 5, 5)
        lib_err = (sdpa().transpose(1, 2).float() - flash_attention(
            q, k, v, pos, pos, **kw).float()).abs().max().item()
        pairs = _visible_pairs(pos, kw["causal"], kw["window"])
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
            + 2 * pos.numel() * 4
        bound = _bound(nbytes, 4 * B * H * hd * pairs, BF16_FLOPS)
        # the tensor-core kernel's own work: P.V twice (P_hi and P_lo)
        floor_ms = 6 * B * H * hd * pairs / BF16_FLOPS * 1e3
        routes = {}
        for route, qq in (("tc", q), ("fma", _fma_copy(q))):
            if fa.route(qq, k, v) != route:
                raise AssertionError(f"{tag}: route {fa.route(qq, k, v)}")
            n = 5 if route == "tc" else 1
            ms = _cuda_ms(lambda: flash_attention(qq, k, v, pos, pos, **kw),
                          n * 3, 5)
            held = _hold(flash_attention(qq, k, v, pos, pos, **kw), q, k, v,
                         pos, kw, f"{tag}'s prefill shape, {route} route")
            routes[route] = dict(
                ms=ms, **fa.kernel_info(route, q.dtype, hd), **held,
                tflops=bound["flops"] / ms / 1e9,
                bound_share=bound["bound_ms"] / ms, sdpa_factor=ms / library_ms)
            del qq
        shapes[tag] = dict(
            shape=dict(B=B, S=S, H=H, KV=k.shape[2], hd=hd,
                       dtype=str(q.dtype)),
            library_ms=library_ms, sdpa_max_abs_diff=lib_err,
            tc_floor_ms=floor_ms, routes=routes, **bound)
    q, k, v, pos, kw = timed[0]
    plain_ms = _cuda_ms(
        lambda: flash_attention_ref(q, k, v, pos, pos, **kw), 2, 3)
    gr = shapes["granite"]
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:79",
                launches=0, max_abs_err=rows[0]["max_abs_err"],
                ms=gr["routes"]["tc"]["ms"], plain_ms=plain_ms,
                bound_ms=gr["bound_ms"], bound_by=gr["bound_by"],
                library_ms=gr["library_ms"], shapes=shapes, cases=rows)


def check_rmsnorm(dev) -> dict:
    """The RMSNorm kernel against ``rmsnorm_ref`` on the card at every
    ``RMS_CASES`` shape (``tests/test_kernels.py``'s tolerances: bf16
    2e-2, f32 1e-5); at the first its time, the plain version's, one
    ``F.rms_norm`` call's (weight ``1 + w`` in x's dtype, made outside
    the timing, so that it takes its fused path) and the bound; at
    zamba2's out_norm width the kernel's and the library's times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    g = torch.Generator(dev).manual_seed(1)
    rows, timed = [], []
    for case, dtype, R, D in RMS_CASES:
        x = torch.randn(R, D, generator=g, device=dev).to(getattr(torch, dtype))
        w = 0.1 * torch.randn(D, generator=g, device=dev)
        got = rmsnorm(x, w)
        torch.cuda.synchronize()
        want = rmsnorm_ref(x, w).float()
        tol = 2e-2 if dtype == "bfloat16" else 1e-5
        diff = (got.float() - want).abs()
        if not (bool(torch.isfinite(got).all())
                and bool((diff <= tol + tol * want.abs()).all())):
            raise AssertionError(f"rmsnorm differs from its plain version on "
                                 f"{case}: {diff.max().item()} (tol {tol})")
        rows.append(dict(case=case, max_abs_err=diff.max().item(), tol=tol))
        if len(timed) < 2:
            timed.append((x, w))
    res = {}
    for tag, (x, w) in zip(("", "zamba2_"), timed):
        D = x.shape[-1]
        w1 = (1 + w).to(x.dtype)
        res[tag + "ms"] = _cuda_ms(lambda: rmsnorm(x, w), 20)
        res[tag + "library_ms"] = _cuda_ms(
            lambda: F.rms_norm(x, (D,), w1, 1e-6), 20)
        res[tag + "bound_ms"] = (2 * x.numel() * x.element_size()
                                 + 4 * D) / HBM_BPS * 1e3
    x, w = timed[0]
    plain_ms = _cuda_ms(lambda: rmsnorm_ref(x, w), 20)
    # bytes: x read once, y written once, w read once; five operations an
    # element (square-add, scale, 1 + w, product) in f32
    bound = _bound(2 * x.numel() * x.element_size() + 4 * x.shape[-1],
                   5 * x.numel(), F32_FLOPS)
    return dict(name="rmsnorm", route="cuda",
                source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm.py:23", launches=0,
                max_abs_err=rows[0]["max_abs_err"], ms=res["ms"],
                plain_ms=plain_ms, **bound, library_ms=res["library_ms"],
                zamba2_ms=res["zamba2_ms"],
                zamba2_library_ms=res["zamba2_library_ms"],
                zamba2_bound_ms=res["zamba2_bound_ms"], cases=rows,
                shape=dict(rows=x.shape[0], D=x.shape[1], dtype=str(x.dtype)))


def _decode_visible(pos, T: int, window: int) -> list:
    """Keys each request's query sees: the work this data needs."""
    out = []
    for p in pos.tolist():
        hi = min(p, T - 1)
        lo = max(0, p - window + 1) if window > 0 else 0
        out.append(max(0, hi - lo + 1))
    return out


def _decode_shape(g, dev, sms: int, case: str, B: int, T: int, H: int,
                  KV: int, hd: int) -> dict:
    """Flash decode at one serving shape (bf16, full cache): held to its
    plain version (``_hold_rows``), its time a launch beside one
    ``scaled_dot_product_attention`` call's on the (B, KV, T, hd) views
    with a key mask (``enable_gqa``), the bytes bound and the share of the
    memory rate; the instance's registers, CTAs an SM and spills (compiler
    and occupancy API) and the persistent grid it launches, with the waves
    it makes on ``sms`` SMs (1 when it is the full wave)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as fd
    q = torch.randn(B, H, hd, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, T, KV, hd, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, T, KV, hd, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.full((B,), T - 1, dtype=torch.int32, device=dev)
    held = _hold_rows(fd.flash_decode(q, k, v, pos),
                      fd.flash_decode_ref(q, k, v, pos),
                      fd.flash_decode_ref(q.float(), k.float(), v.float(),
                                          pos),
                      _attn_tol("bfloat16", 0, 0.0),
                      f"flash_decode vs its plain version at {case}")
    ms = _cuda_ms(lambda: fd.flash_decode(q, k, v, pos), 20)
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(T, device=dev)[None, :] <= pos[:, None])[:, None, None]
    library_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), 5)
    keys = B * T
    nbytes = (2 * keys * KV * hd + 2 * q.numel()) * 2 + 4 * B
    bound = _bound(nbytes, 4 * keys * H * hd, BF16_FLOPS)
    kernel_route = fd.route(q, k)
    gb = fd.heads_per_unit(H // KV, kernel_route)
    info = fd.kernel_info(kernel_route, q.dtype, hd, gb)
    _, kvu, ctas, cut = fd.plan(B, KV, H // KV, T, hd, kernel_route, sms,
                                info["ctas_per_sm"])
    return dict(case=case, shape=dict(B=B, T=T, H=H, KV=KV, hd=hd), ms=ms,
                library_ms=library_ms, sdpa_factor=ms / library_ms,
                memory_share=bound["bytes_ms"] / ms,
                gb_s=bound["bytes"] / ms / 1e6, **bound,
                kernel=kernel_route, gb=gb, kv_heads_per_unit=kvu, **info,
                grid=ctas, waves=ctas / (sms * info["ctas_per_sm"]),
                units_cut=cut, **held, tensors=(q, k, v, pos))


def check_decode(dev) -> dict:
    """The flash-decode kernel against ``flash_decode_ref`` on the card at
    every ``DECODE_CASES`` shape (``_hold_rows``; ``tests/test_kernels.py``'s
    tolerances), and unchanged, bit for bit, when the cache past each
    request's position is overwritten with NaN; at every
    ``DECODE_SHAPES`` shape its time, one SDPA call's, the bound, the
    share of the memory rate, registers, CTAs an SM and the grid's waves
    (``_decode_shape``); at the first the plain version's time."""
    import torch
    from repro_torch.kernels.decode_attention import (
        flash_decode, flash_decode_ref)
    g = torch.Generator(dev).manual_seed(2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for case, dtype, B, T, H, KV, hd, window, cap, ragged in DECODE_CASES:
        td = getattr(torch, dtype)
        q = torch.randn(B, H, hd, generator=g, device=dev).to(td)
        k = torch.randn(B, T, KV, hd, generator=g, device=dev).to(td)
        v = torch.randn(B, T, KV, hd, generator=g, device=dev).to(td)
        if ragged:
            pos = torch.randint(0, T, (B,), generator=g, device=dev,
                                dtype=torch.int32)
            pos[0] = T - 1
        else:
            pos = torch.full((B,), T - 1, dtype=torch.int32, device=dev)
        kw = dict(window=window, logit_cap=cap)
        got = flash_decode(q, k, v, pos, **kw)
        torch.cuda.synchronize()
        want = flash_decode_ref(q, k, v, pos, **kw)
        want32 = flash_decode_ref(q.float(), k.float(), v.float(), pos, **kw)
        r = _hold_rows(got, want, want32, _attn_tol(dtype, window, cap),
                       f"flash_decode vs its plain version on {case}")
        del want, want32
        if ragged:
            past = torch.arange(T, device=dev)[None, :] > pos[:, None]
            k2, v2 = k.clone(), v.clone()
            k2[past], v2[past] = float("nan"), float("nan")
            if not torch.equal(got, flash_decode(q, k2, v2, pos, **kw)):
                raise AssertionError(f"flash_decode on {case}: the output "
                                     f"changed when the cache past pos did")
            del k2, v2
        rows.append(dict(case=case, past_pos_overwritten=ragged, **r))
        del q, k, v, got
        torch.cuda.empty_cache()
    shapes = []
    for shape in DECODE_SHAPES:
        row = _decode_shape(g, dev, sms, *shape)
        q, k, v, pos = row.pop("tensors")
        if not shapes:
            plain_ms = _cuda_ms(lambda: flash_decode_ref(q, k, v, pos), 3)
        shapes.append(row)
        print("decode shape:", json.dumps(row))
        del q, k, v, pos
        torch.cuda.empty_cache()
    first = shapes[0]
    return dict(name="flash_decode", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_decode.cu",
                replaces="src/repro/kernels/decode_attention.py:68",
                launches=0, max_abs_err=first["max_abs_err"], ms=first["ms"],
                plain_ms=plain_ms, bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], library_ms=first["library_ms"],
                cases=rows, shapes=shapes)


def _ssd_inputs(g, B, nc, nh, hd, N, Q, dev):
    """``tests/test_kernels.py``'s inputs: states and C normal, totals and
    cum minus the magnitude of a normal."""
    import torch
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    return (rn(B, nc, nh, hd, N), -rn(B, nc, nh).abs(), rn(B, nc, Q, N),
            -rn(B, nc, Q, nh).abs())


def _hold_ssd(got, want, what: str) -> dict:
    import torch
    errs = {}
    for name, a, b in zip(("y", "final"), got, want):
        diff = (a - b).abs()
        if not (bool(torch.isfinite(a).all())
                and bool((diff <= SSD_TOL + SSD_TOL * b.abs()).all())):
            raise AssertionError(f"ssd_state_scan vs its plain version on "
                                 f"{what}: {name} max abs err "
                                 f"{diff.max().item()} (tol {SSD_TOL})")
        errs[f"max_abs_err_{name}"] = diff.max().item()
        errs[f"max_abs_{name}"] = b.abs().max().item()
    return errs


def check_ssd(dev) -> dict:
    """The SSD state-scan kernels against ``ssd_state_scan_ref`` on the card
    at every ``SSD_CASES`` shape at ``SSD_TOL``; at the first their time
    with the registers and CTAs an SM the product kernel gets, the plain
    version's time, the bound (f32 operations) and the design's floor (its
    bytes; no single PyTorch call computes it)."""
    import torch
    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.ssm_scan import ssd_state_scan, ssd_state_scan_ref
    g = torch.Generator(dev).manual_seed(3)
    rows, timed = [], None
    for case, B, nc, nh, hd, N, Q in SSD_CASES:
        args = _ssd_inputs(g, B, nc, nh, hd, N, Q, dev)
        got = ssd_state_scan(*args)
        torch.cuda.synchronize()
        r = _hold_ssd(got, ssd_state_scan_ref(*args), case)
        rows.append(dict(case=case, **r))
        del got
        if timed is None:
            timed = (args, max(r["max_abs_err_y"], r["max_abs_err_final"]))
    args, err = timed
    B, nc, nh, hd, N = args[0].shape
    Q = args[2].shape[2]
    ms = _cuda_ms(lambda: ssd_state_scan(*args), 20)
    plain_ms = _cuda_ms(lambda: ssd_state_scan_ref(*args), 3)
    # inputs read once, y and the final state written once; per chunk and
    # head the (Q x N) @ (N x hd) product, its exp(cum) scaling and the
    # state update
    nbytes = 4 * (sum(a.numel() for a in args) + B * nc * Q * nh * hd
                  + B * nh * hd * N)
    flops = B * nc * nh * (2 * Q * N * hd + Q * hd + 2 * hd * N)
    bound = _bound(nbytes, flops, F32_FLOPS)
    # the design's own floor: its bytes, with the 64 x 64 state before each
    # chunk written by the recurrence and read by the products (its 3xTF32
    # products take less at the TF32 peak)
    floor_ms = (nbytes + 2 * 4 * B * nc * nh * 64 * 64) / HBM_BPS * 1e3
    return dict(name="ssd_state_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_state_scan.cu",
                replaces="src/repro/kernels/ssm_scan.py:48", launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound,
                design_floor_ms=floor_ms,
                bound_share=bound["bound_ms"] / ms,
                floor_share=floor_ms / ms, library_ms=None,
                **ssm_scan.kernel_info(), cases=rows,
                shape=dict(B=B, nc=nc, nh=nh, hd=hd, N=N, Q=Q))


def build_lm(arch: str, dev):
    """``arch`` at full width and depth with random weights from seed 0;
    returns (model, seconds to build and fill it)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.zoo import build_model
    t0 = time.perf_counter()
    model = build_model(get_config(arch), dev).init_params(
        torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def drive_prefill(model, init_s: float) -> tuple:
    """Serving path, prefill: ``build_prefill_step(last_only=True)`` under
    ``attention_impl="pallas"`` on ``PREFILL_BATCH`` x ``PREFILL_LEN``
    tokens, warm, timed ``WALL_REPEATS`` times, every kernel's launches
    counted from 0 for each; then the same prefill with each plain
    attention (``reference``: every layer plain; ``blocked``), compared.
    Returns the row, the tokens and one run's launches."""
    import torch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.sharding import ModelContext
    cfg, dev = model.cfg, model.device
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev, dtype=torch.int32)
    step = build_prefill_step(model, ModelContext(attention_impl="pallas"),
                              last_only=True)
    step(tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = _want_launches(cfg, "prefill")
    walls, counts = [], []
    for _ in range(WALL_REPEATS):
        _reset_launches()
        t0 = time.perf_counter()
        logits = step(tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(_launches())
        _check_launches(counts[-1], want, f"{cfg.name} prefill")
        tc = KERNELS["flash_attention"].tc_launches
        if tc != want["flash_attention"]:
            raise AssertionError(f"{cfg.name} prefill: {tc} of "
                                 f"{want['flash_attention']} flash-attention "
                                 f"launches on the tensor-core kernel")
    peak = torch.cuda.max_memory_allocated()
    if logits.shape != (PREFILL_BATCH, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits: shape {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    other = {impl: build_prefill_step(model, ModelContext(attention_impl=impl),
                                      last_only=True)(tokens).float()
             for impl in ("reference", "blocked")}
    ref, blk = other["reference"], other["blocked"]
    scale = ref.abs().max().item()
    wall = statistics.median(walls)
    row = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               params=n_params, batch=PREFILL_BATCH, prompt=PREFILL_LEN,
               init_s=init_s, wall_s=wall, wall_s_runs=walls,
               tokens_s=PREFILL_BATCH * PREFILL_LEN / wall,
               launches=counts[0], tc_launches=tc, peak_mem_gb=peak / 1e9,
               logits_max_abs=scale,
               dev_vs_reference=(logits.float() - ref).abs().max().item(),
               dev_vs_blocked=(logits.float() - blk).abs().max().item(),
               dev_blocked_vs_reference=(blk - ref).abs().max().item(),
               rtol=PREFILL_RTOL,
               **{f"argmax_agree_{impl}": float(
                   (logits.argmax(-1) == o.argmax(-1)).float().mean().item())
                  for impl, o in other.items()},
               requests=_argmax_readings(logits.float(), ref, blk))
    return row, tokens, counts[0]


def _argmax_readings(got, ref, blk) -> list:
    """For each request: the reference's top-two logit gap, the plain
    paths' spread (max |reference - blocked| over its logits), whether
    the request is held (gap > spread: the next token is decided beyond
    what two equally correct paths disagree by) and each path's next
    token."""
    top2 = ref.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    spreads = (ref - blk).abs().max(-1).values.tolist()
    picks = {name: x.argmax(-1).tolist()
             for name, x in (("kernels", got), ("reference", ref),
                             ("blocked", blk))}
    return [dict(request=i, gap=gap, plain_spread=spread,
                 held=gap > spread, **{n: p[i] for n, p in picks.items()})
            for i, (gap, spread) in enumerate(zip(gaps, spreads))]


def check_prefill(row: dict) -> None:
    """The kernels' prefill logits against both plain paths': within
    ``PREFILL_RTOL`` of max |logit|; and the same next token as both on
    every request whose reference top-two gap exceeds the plain paths'
    spread there.  A closer request is a tie within rounding (two plain
    paths already pick different tokens on such requests), so it is
    printed, not held; at least one request must be held."""
    scale = row["logits_max_abs"]
    for impl in ("reference", "blocked"):
        dev = row[f"dev_vs_{impl}"]
        if not dev <= PREFILL_RTOL * scale:
            raise AssertionError(f"{row['arch']} prefill logits, kernels vs "
                                 f"{impl}: max |diff| {dev} > {PREFILL_RTOL} "
                                 f"x max |logit| {scale}")
    held = [r for r in row["requests"] if r["held"]]
    print(f"serve prefill argmax: {row['arch']} held {len(held)} of "
          f"{len(row['requests'])}:", json.dumps(row["requests"]))
    if not held:
        raise AssertionError(f"{row['arch']} prefill: no request's top-two "
                             f"gap exceeds the plain paths' spread, so no "
                             f"next token is held: {row['requests']}")
    for r in held:
        if not r["kernels"] == r["reference"] == r["blocked"]:
            raise AssertionError(f"{row['arch']} prefill request "
                                 f"{r['request']}: next tokens differ "
                                 f"(gap {r['gap']} > spread "
                                 f"{r['plain_spread']}): {r}")


def _last_logits(model, x):
    """The vocab head on the last position of the residual stream ``x``,
    as ``TransformerLM.forward(last_only=True)`` computes it."""
    from repro_torch.models import layers as L
    h = L.rmsnorm(x[:, -1:], model.final_norm)
    return L.unembed(h, model.head(), model.cfg.final_logit_softcap)[:, 0].float()


def walk_layers(model, tokens) -> dict:
    """One granite prefill walked layer by layer three times over, each
    stream carrying its own residual: under ``pallas`` (the kernels), with
    the reference attention and with the blocked attention.  At every
    layer the flash kernel is held (``_hold``) on the reference stream's
    own q, k, v.  At each of ``DEPTHS`` the three streams' last-position
    logits are compared, over max |logit| of the reference stream: how
    the spread between equally correct paths grows with depth.  After the
    first layer the kernels must lie within ``SHALLOW_RTOL`` of each plain
    path, at every depth within ``PREFILL_RTOL``.  These launches are
    checks, not the main path's."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import ModelContext
    ctxs = {impl: ModelContext(attention_impl=impl)
            for impl in ("pallas", "reference", "blocked")}
    pos = torch.arange(tokens.shape[1], device=tokens.device,
                       dtype=torch.int32)
    cap = model.cfg.attn_logit_softcap
    worst = dict(max_abs_err=0.0, row_rel_err=0.0, row_limit_used=0.0)
    curve = []
    with torch.no_grad():
        xs = dict.fromkeys(ctxs, L.embed(tokens, model.embed))
        for i, (blk, window) in enumerate(zip(model.blocks, model.windows)):
            q, k, v = blk._attn_proj(
                L.rmsnorm(xs["reference"], blk.attn_norm), pos)
            kw = dict(causal=True, window=window, logit_cap=cap)
            got = flash_attention(q, k, v, pos, pos, **kw)
            r = _hold(got, q, k, v, pos, kw, f"layer {i}'s q, k, v")
            worst = {key: max(val, r[key]) for key, val in worst.items()}
            del got, q, k, v
            xs = {impl: blk(x, window, pos, ctxs[impl])
                  for impl, x in xs.items()}
            if i + 1 not in DEPTHS:
                continue
            lg = {impl: _last_logits(model, x) for impl, x in xs.items()}
            scale = lg["reference"].abs().max().item()
            rel = lambda a, b: (lg[a] - lg[b]).abs().max().item() / scale  # noqa: E731
            pt = dict(depth=i + 1, logits_max_abs=scale,
                      flash_vs_reference=rel("pallas", "reference"),
                      flash_vs_blocked=rel("pallas", "blocked"),
                      blocked_vs_reference=rel("blocked", "reference"),
                      argmax={impl: lg[impl].argmax(-1).tolist()
                              for impl in lg})
            curve.append(pt)
            limit = SHALLOW_RTOL if i == 0 else PREFILL_RTOL
            for o in ("reference", "blocked"):
                if not pt[f"flash_vs_{o}"] <= limit:
                    raise AssertionError(
                        f"logits after {i + 1} layers, kernels vs {o}: "
                        f"{pt[f'flash_vs_{o}']} of max |logit| > {limit}")
    return dict(arch=model.cfg.name, layers=len(model.blocks),
                tol=_attn_tol("bfloat16", 0, 0.0), row_atol=ROW_ATOL,
                **worst, shallow_rtol=SHALLOW_RTOL, rtol=PREFILL_RTOL,
                by_depth=curve)


#: the decode walk's (requests, cache length): granite's first
#: ``DECODE_CTX`` shape
WALK_DECODE = (128, 2048)


def _decode_attention_plain2(blk, x, k_l, v_l, pos, window):
    """``Block.decode`` with its attention replaced by the second plain
    decode attention: ``flash_attention_ref`` at S = 1, the query at
    ``pos`` (the same for every request) over every cached key, masked
    causally and by the window (probabilities in v's dtype, as the
    reference's ``attention_reference``)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import ModelContext
    from repro_torch.models.transformer import _cache_write
    cfg, B, T = blk.cfg, x.shape[0], k_l.shape[1]
    h = L.rmsnorm(x, blk.attn_norm)
    q, k, v = blk._attn_proj(h, pos[:, None])
    _cache_write(k_l, k[:, 0], pos)
    _cache_write(v_l, v[:, 0], pos)
    a = flash_attention_ref(q, k_l, v_l, pos[:1],
                            torch.arange(T, device=x.device), causal=True,
                            window=window, logit_cap=cfg.attn_logit_softcap)
    a = a.reshape(B, cfg.n_heads * cfg.hd) @ blk.wo
    if cfg.post_norms:
        a = L.rmsnorm(a, blk.post_attn_norm)
    return blk._mlp(x + a[:, None], ModelContext())


def walk_decode(model) -> dict:
    """One decode step against a full ``WALK_DECODE`` cache (random keys,
    values and tokens from a seed, every request at the last position),
    walked layer by layer three times over, each stream with its own
    residual: under ``pallas`` (flash decode and the kernels' norms),
    with the grouped einsum (``flash_decode_ref``) and with the second
    plain decode attention (``_decode_attention_plain2``).  Each stream
    writes its own key and value at ``pos`` before it attends.  At every
    layer flash decode is held (``_hold_rows``) on the einsum stream's own
    q and cache.  At each of ``DEPTHS`` the streams' logits are compared
    over max |logit| of the einsum stream: after the first layer the
    kernels must lie within ``SHALLOW_RTOL`` of each plain path, at every
    depth within ``PREFILL_RTOL``.  These launches are checks, not the
    main path's."""
    import torch
    from repro_torch.kernels.decode_attention import (
        flash_decode, flash_decode_ref)
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import ModelContext
    from repro_torch.models.transformer import _cache_write
    cfg, dev = model.cfg, model.device
    B, T = WALK_DECODE
    g = torch.Generator(dev).manual_seed(4)
    cache = model.init_cache(B, T)
    _fill_cache(cache, g)
    tokens = torch.randint(0, cfg.vocab_size, (B,), generator=g, device=dev,
                           dtype=torch.int32)
    pos = torch.full((B,), T - 1, dtype=torch.int32, device=dev)
    pallas, plain = ModelContext(attention_impl="pallas"), ModelContext()
    cap = cfg.attn_logit_softcap
    worst = dict(max_abs_err=0.0, row_rel_err=0.0, row_limit_used=0.0)
    curve = []
    with torch.no_grad():
        xs = dict.fromkeys(("flash", "einsum", "plain2"),
                           L.embed(tokens[:, None], model.embed))
        for i, (blk, window) in enumerate(zip(model.blocks, model.windows)):
            k_l, v_l = cache["k"][i], cache["v"][i]
            q, k, v = blk._attn_proj(L.rmsnorm(xs["einsum"], blk.attn_norm),
                                     pos[:, None])
            _cache_write(k_l, k[:, 0], pos)
            _cache_write(v_l, v[:, 0], pos)
            kw = dict(window=window, logit_cap=cap)
            got = flash_decode(q[:, 0], k_l, v_l, pos, **kw)
            r = _hold_rows(
                got, flash_decode_ref(q[:, 0], k_l, v_l, pos, **kw),
                flash_decode_ref(q[:, 0].float(), k_l.float(), v_l.float(),
                                 pos, **kw),
                _attn_tol("bfloat16", window, cap),
                f"flash_decode vs its plain version on layer {i}'s q and "
                f"cache")
            worst = {key: max(val, r[key]) for key, val in worst.items()}
            del got, q, k, v
            xs = {"flash": blk.decode(xs["flash"], k_l, v_l, pos, window,
                                      pallas),
                  "einsum": blk.decode(xs["einsum"], k_l, v_l, pos, window,
                                       plain),
                  "plain2": _decode_attention_plain2(blk, xs["plain2"], k_l,
                                                     v_l, pos, window)}
            if i + 1 not in DEPTHS:
                continue
            lg = {name: _last_logits(model, x) for name, x in xs.items()}
            scale = lg["einsum"].abs().max().item()
            rel = lambda a, b: (lg[a] - lg[b]).abs().max().item() / scale  # noqa: E731
            pt = dict(depth=i + 1, logits_max_abs=scale,
                      flash_vs_einsum=rel("flash", "einsum"),
                      flash_vs_plain2=rel("flash", "plain2"),
                      plain2_vs_einsum=rel("plain2", "einsum"),
                      argmax_agree={name: float(
                          (lg[name].argmax(-1) == lg["einsum"].argmax(-1))
                          .float().mean().item()) for name in lg})
            curve.append(pt)
            limit = SHALLOW_RTOL if i == 0 else PREFILL_RTOL
            for o in ("einsum", "plain2"):
                if not pt[f"flash_vs_{o}"] <= limit:
                    raise AssertionError(
                        f"decode logits after {i + 1} layers, kernels vs "
                        f"{o}: {pt[f'flash_vs_{o}']} of max |logit| > "
                        f"{limit}")
    del cache
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, batch=B, cache_len=T, layers=len(model.blocks),
                tol=_attn_tol("bfloat16", 0, 0.0), row_atol=ROW_ATOL, **worst,
                shallow_rtol=SHALLOW_RTOL, rtol=PREFILL_RTOL, by_depth=curve)


def walk_ssd(model, tokens) -> dict:
    """zamba2's prefill walked through its first macro-block on the
    all-plain path: at each Mamba2 layer the SSD state-scan kernel is
    held to its plain version at ``SSD_TOL`` on that layer's own states,
    totals, C and cum.  These launches are checks, not the main path's."""
    import torch
    from repro_torch.kernels.ssm_scan import ssd_state_scan, ssd_state_scan_ref
    from repro_torch.models import layers as L
    from repro_torch.models.mamba2 import CHUNK, ssd_chunk_terms
    from repro_torch.models.sharding import ModelContext
    ctx = ModelContext(attention_impl="reference")
    rows = []
    with torch.no_grad():
        x = L.embed(tokens, model.embed)
        for i in range(model.cfg.mamba_per_block):
            blk = model.mamba[i]
            _, xh, dt, A, Bm, Cm, _ = blk.ssd_inputs(x, ctx)
            _, states, total, Cc, cum = ssd_chunk_terms(
                xh.float(), dt, A, Bm.float(), Cm.float(),
                min(CHUNK, tokens.shape[1]))
            got = ssd_state_scan(states, total, Cc, cum)
            torch.cuda.synchronize()
            rows.append(dict(layer=i, **_hold_ssd(
                got, ssd_state_scan_ref(states, total, Cc, cum),
                f"Mamba2 layer {i}'s inputs")))
            del got, states, total, Cc, cum, xh, dt, Bm, Cm
            x = x + blk(x, ctx)
    return dict(arch=model.cfg.name, tol=SSD_TOL, layers=rows)


def profile_prefill(model, tokens) -> dict:
    """Device busy time and the top kernels of one warm prefill under
    ``pallas``, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.sharding import ModelContext
    step = build_prefill_step(model, ModelContext(attention_impl="pallas"),
                              last_only=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _device_rows(prof, wall, "prefill " + model.cfg.name,
                        share_of="flash_tc_kernel")


def drive_decode(model) -> tuple:
    """Serving path, decode: ``generate`` under ``pallas`` on the
    prefill's model, greedy, warm then timed, every kernel's launches
    counted from 0; then ``PROFILE_STEPS`` of its decode steps under
    ``torch.profiler``.  Returns the row and the launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models.sharding import ModelContext
    ctx = ModelContext(attention_impl="pallas")
    cfg, dev = model.cfg, model.device
    V = cfg.vocab_size
    prompts = torch.randint(0, V, (DECODE_BATCH, DECODE_PROMPT),
                            generator=torch.Generator(dev).manual_seed(2),
                            device=dev, dtype=torch.int32)
    generate(model, prompts, DECODE_NEW, ctx)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    toks = generate(model, prompts, DECODE_NEW, ctx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    steps = DECODE_PROMPT + DECODE_NEW - 1
    _check_launches(launches, _want_launches(cfg, "decode", steps),
                    f"{cfg.name} generate")
    if toks.shape != (DECODE_BATCH, DECODE_PROMPT + DECODE_NEW):
        raise AssertionError(f"generate: shape {tuple(toks.shape)}")
    if not (bool(torch.equal(toks[:, :DECODE_PROMPT], prompts))
            and int(toks.min()) >= 0 and int(toks.max()) < V):
        raise AssertionError("generate: prompt not kept or ids outside the "
                             "vocabulary")
    step = build_serve_step(model, ctx)
    cache = model.init_cache(DECODE_BATCH, DECODE_PROMPT + DECODE_NEW)
    pos = torch.zeros((DECODE_BATCH,), dtype=torch.int32, device=dev)
    step(cache, toks[:, 0], pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(1, PROFILE_STEPS + 1):
            step(cache, toks[:, t], pos + t)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    row = dict(arch=cfg.name, batch=DECODE_BATCH, prompt=DECODE_PROMPT,
               new=DECODE_NEW, wall_s=wall, steps=steps,
               step_ms=wall / steps * 1e3,
               new_tokens_s=DECODE_BATCH * DECODE_NEW / wall,
               launches=launches, sample=toks[0, DECODE_PROMPT:].tolist(),
               profile=_device_rows(prof, pwall, f"decode {cfg.name}, "
                                    f"{PROFILE_STEPS} steps"))
    return row, launches


def _fill_cache(cache: dict, g) -> None:
    """Random keys, values and Mamba2 state in place."""
    for c in cache.values():
        if isinstance(c, dict):
            _fill_cache(c, g)
        else:
            c.normal_(generator=g)


def drive_decode_ctx(model) -> tuple:
    """Serving path, decode at a deployment-like context: for each of the
    model's ``DECODE_CTX`` (requests, cache length), ``build_serve_step``
    against a cache of that length filled with random keys, values and
    state, every request at its last position (a step reads the whole
    cache whatever the position).  One step under ``pallas`` (flash
    decode) and one with the plain grouped einsum, from the same cache
    (the Mamba2 state restored between them), logits compared; then one
    warm step and ``DECODE_CTX_STEPS`` timed under ``pallas``, launches
    counted, and two under ``torch.profiler``.  The bound is the weights
    and the cache read once and the Mamba2 state read and written once,
    at ``HBM_BPS``.  Returns the rows and one timed run's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models.sharding import ModelContext
    cfg, dev, V = model.cfg, model.device, model.cfg.vocab_size
    step = build_serve_step(model, ModelContext(attention_impl="pallas"))
    plain = build_serve_step(model, ModelContext())
    g = torch.Generator(dev).manual_seed(3)
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    rows, launches = [], {}
    for B, T in DECODE_CTX[cfg.name]:
        cache = model.init_cache(B, T)
        _fill_cache(cache, g)
        nbytes = lambda c: c.numel() * c.element_size()  # noqa: E731
        kv_bytes = nbytes(cache["k"]) + nbytes(cache["v"])
        st_bytes = sum(nbytes(c) for c in cache.get("mamba", {}).values())
        tokens = torch.randint(0, V, (B,), generator=g, device=dev,
                               dtype=torch.int32)
        pos = torch.full((B,), T - 1, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        snap = {k: c.clone() for k, c in cache.get("mamba", {}).items()}
        got, _ = step(cache, tokens, pos)
        got = got.float()
        for k, c in snap.items():
            cache["mamba"][k].copy_(c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, _ = plain(cache, tokens, pos)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        want = want.float()
        for k, c in snap.items():
            cache["mamba"][k].copy_(c)
        del snap
        scale = want.abs().max().item()
        diff = (got - want).abs().max().item()
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean().item())
        if not (bool(torch.isfinite(got).all()) and diff <= PREFILL_RTOL * scale):
            raise AssertionError(f"{cfg.name} decode {B}x{T}: flash decode vs "
                                 f"einsum logits max |diff| {diff} > "
                                 f"{PREFILL_RTOL} x max |logit| {scale}")
        step(cache, tokens, pos)
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        for _ in range(DECODE_CTX_STEPS):
            logits, _ = step(cache, tokens, pos)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / DECODE_CTX_STEPS
        counts = _launches()
        _check_launches(counts, _want_launches(cfg, "decode", DECODE_CTX_STEPS),
                        f"{cfg.name} decode {B}x{T}")
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        if logits.shape != (B, V) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"decode step {B}x{T}: logits shape "
                                 f"{tuple(logits.shape)} or not finite")
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                step(cache, tokens, pos)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        rows.append(dict(
            arch=cfg.name, batch=B, cache_len=T, cache_gb=kv_bytes / 1e9,
            state_gb=st_bytes / 1e9, steps=DECODE_CTX_STEPS,
            step_ms=wall * 1e3, einsum_step_ms=plain_ms,
            new_tokens_s=B / wall,
            bound_ms=(w_bytes + kv_bytes + 2 * st_bytes) / HBM_BPS * 1e3,
            peak_mem_gb=peak / 1e9, logits_max_abs=scale,
            flash_vs_einsum=diff, argmax_agree=agree, rtol=PREFILL_RTOL,
            launches=counts,
            profile=_device_rows(prof, pwall, f"decode {B}x{T}, 2 steps")))
        del cache, logits, got, want
        torch.cuda.empty_cache()
    return rows, launches


def _specs(pattern: str, arch: str, n: int, msgs: int):
    """A wave cell's seed-lanes, opted in to the wave program."""
    from repro_torch import pattern_spec
    return [pattern_spec(pattern, arch, "dstream", n, total_messages=msgs,
                         seed=s, **WAVE) for s in SEEDS]


def drive_main_path(dev) -> tuple[list, int]:
    """Every wave cell through ``run_many`` on the card, warm (after one
    untimed run), timed ``WALL_REPEATS`` times, each run with the
    launches counted from 0.  Returns the per-cell rows and the total
    pump launches."""
    import torch
    from repro_torch import run_many, summarize
    from repro_torch.core import torch_device_loop as dl
    from repro_torch.core.cell import WaveCell
    rows, total = [], 0
    for pattern, arch, n, msgs in MAIN_CELLS:
        specs = _specs(pattern, arch, n, msgs)
        t0 = time.perf_counter()
        cell = WaveCell(specs[0], stack_seeds=list(SEEDS))
        ws = dl.build_static(cell)
        dl.draw_jitter(cell, ws)
        host_s = time.perf_counter() - t0
        n_steps = ws.meta["nSteps"]
        run_many(specs, device=dev)
        torch.cuda.synchronize()
        need = (2 if pattern == "feedback" else 1) * n_steps
        walls, counts = [], []
        for _ in range(WALL_REPEATS):
            _reset_launches()
            t0 = time.perf_counter()
            res = run_many(specs, device=dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            got = _launches()
            counts.append(got.pop("pump_assign"))
            if counts[-1] < need or any(got.values()):
                raise AssertionError(
                    f"{pattern}/{arch}: {counts[-1]} pump launches (need "
                    f"{need}), others {got}: the main path missed the kernel")
        launches = counts[0]
        total += launches
        for r in res:
            if r.n_consumed != msgs:
                raise AssertionError(f"{pattern}/{arch} seed "
                                     f"{r.spec.params.seed}: consumed "
                                     f"{r.n_consumed} of {msgs}")
        sm = [summarize(r) for r in res]
        rows.append(dict(
            cell=f"{pattern}/{arch}/c{n}", msgs=msgs, lanes=len(res),
            steps=n_steps, wall_s=statistics.median(walls),
            wall_s_runs=walls, host_build_s=host_s, pump_launches=launches,
            throughput_msgs_s=[s.throughput_msgs_s for s in sm],
            median_rtt_s=([s.median_rtt_s for s in sm]
                          if pattern == "feedback" else None)))
    return rows, total


def cross_check(dev) -> dict:
    """The 64-consumer Fig 4 cell on the card and on the CPU, traces and
    summaries compared at ``XDEV_RTOL``."""
    import numpy as np
    from repro_torch import run_many, summarize
    from repro_torch.core import torch_device_loop as dl
    from repro_torch.core.cell import WaveCell
    specs = _specs("work_sharing", "dts", 64, 4096)
    cell = WaveCell(specs[0], stack_seeds=list(SEEDS))
    ws = dl.build_static(cell)
    jit = dl.draw_jitter(cell, ws)
    yg = dl.run_wave_trace(ws, jit, device=dev)
    yc = dl.run_wave_trace(ws, jit, device="cpu")
    worst = 0.0
    for k in yc:
        fin = np.isfinite(yc[k])
        if not np.array_equal(fin, np.isfinite(yg[k])):
            raise AssertionError(f"trace {k}: finite masks differ")
        if fin.any():
            rel = np.abs(yg[k][fin] - yc[k][fin]) / np.abs(yc[k][fin]).clip(1e-300)
            worst = max(worst, float(rel.max()))
    sg = [summarize(r) for r in run_many(specs, device=dev)]
    sc = [summarize(r) for r in run_many(specs, device="cpu")]
    for a, b in zip(sg, sc):
        rel = abs(a.throughput_msgs_s - b.throughput_msgs_s) / b.throughput_msgs_s
        worst = max(worst, rel)
        if a.n_messages != b.n_messages:
            raise AssertionError("cross-check: consumed counts differ")
    if worst > XDEV_RTOL:
        raise AssertionError(f"cuda vs cpu: max relative deviation {worst} "
                             f"> {XDEV_RTOL}")
    return dict(cell="work_sharing/dts/c64/4096msgs", lanes=len(SEEDS),
                max_rel_dev=worst, rtol=XDEV_RTOL,
                throughput_msgs_s=[s.throughput_msgs_s for s in sg])


def profile_cell(dev) -> dict:
    """Device busy time and the top kernels of one warm main-path run
    (work_sharing/dts/c1024), from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import run_many
    specs = _specs(*MAIN_CELLS[0])
    run_many(specs, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_many(specs, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _device_rows(prof, wall, "work_sharing/dts/c1024")


def _cohort_specs(pattern: str, arch: str, workload: str, n: int, msgs: int):
    from repro_torch import ExperimentSpec, SimParams, get_workload
    extra = ({"reply_factor": GATHER_REPLY_FACTOR}
             if pattern == "broadcast_gather" else {})
    return [ExperimentSpec(
        pattern=pattern, workload=get_workload(workload), arch=arch,
        n_producers=1 if pattern.startswith("broadcast") else n,
        n_consumers=n, total_messages=msgs,
        params=SimParams(seed=s, **extra)) for s in SEEDS]


def _counted(fn):
    """``fn()`` with the launches, the cohort runs and the host reads
    counted from 0: ``(result, wall, counts)``."""
    import torch
    from repro_torch.core.torch_engine import TorchStreamSim
    _reset_launches()
    TorchStreamSim.stats.update(runs=0, host_reads=0, withheld=0)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, dict(_launches(), **TorchStreamSim.stats)


def _cohort_run(specs, dev) -> tuple:
    """One ``run_many`` of ``specs`` with the launches, the cohort runs
    and the host reads counted from 0: ``(results, wall, counts)``."""
    from repro_torch import run_many
    return _counted(lambda: run_many(specs, device=dev))


def drive_cohort(dev) -> tuple[list, dict]:
    """Every cohort cell through ``run_many`` on the card, after a warm-up
    run of each pattern on the engine at 2 consumers, timed
    ``COHORT_REPEATS`` times:
    every lane consumes every message (each copy, for broadcast), no cell
    takes the wave program (no pump launch), and each ran the cohort
    engine.  Returns the per-cell rows and the launches of the runs."""
    from repro_torch import summarize
    for pattern in sorted({c[0] for c in COHORT_CELLS}):
        bc = pattern.startswith("broadcast")
        _cohort_run(_cohort_specs(pattern, "dts", "generic" if bc else
                                  "dstream", 2, 32 if bc else 600), dev)
    rows, total = [], {}
    for pattern, arch, wl, n, msgs in COHORT_CELLS:
        specs = _cohort_specs(pattern, arch, wl, n, msgs)
        walls, reads = [], []
        for _ in range(COHORT_REPEATS):
            res, wall, counts = _cohort_run(specs, dev)
            walls.append(wall)
            reads.append(counts.pop("host_reads"))
            if (counts.pop("runs") < 1 or counts.get("pump_assign")
                    or counts.pop("withheld")):
                raise AssertionError(f"{pattern}/{arch}: {counts}: the cell "
                                     f"did not run the cohort engine alone")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        want = msgs * (n if pattern.startswith("broadcast") else 1)
        for r in res:
            if r.n_consumed != want:
                raise AssertionError(f"{pattern}/{arch} seed "
                                     f"{r.spec.params.seed}: consumed "
                                     f"{r.n_consumed} of {want}")
        sm = [summarize(r) for r in res]
        rows.append(dict(
            cell=f"{pattern}/{wl}/{arch}/c{n}", msgs=msgs, lanes=len(res),
            wall_s=statistics.median(walls), wall_s_runs=walls,
            throughput_msgs_s=[s.throughput_msgs_s for s in sm],
            median_rtt_s=([s.median_rtt_s for s in sm] if res[0].rtts.size
                          else None),
            host_reads=reads[0], events=res[0].n_events,
            us_per_event=statistics.median(walls) / res[0].n_events * 1e6))
    return rows, total


def _flow_specs(pattern: str, n: int, msgs: int, cap: int, over: dict):
    from repro_torch import ExperimentSpec, SimParams, get_workload
    wl = get_workload("dstream")
    params = dict(OVERFLOW_STRESS, queue_max_bytes=cap * wl.payload_bytes,
                  **over)
    return [ExperimentSpec(pattern=pattern, workload=wl, arch="dts",
                           n_producers=n, n_consumers=n, total_messages=msgs,
                           params=SimParams(seed=s, **params))
            for s in SEEDS]


def drive_flow(dev) -> tuple[list, dict, dict]:
    """Every flow cell through ``run_many`` on the card, after a warm-up
    run of a small flow cell, timed ``COHORT_REPEATS`` times: every lane
    consumes every message, rejects publishes (and, in the parity cell,
    withholds confirms), no confirm is left withheld, no cell takes the
    wave program (no pump launch), and each ran the cohort engine.
    Returns the per-cell rows, the launches of the runs and each cell's
    results by name."""
    from repro_torch import summarize
    _cohort_run(_flow_specs("feedback", 2, 512, 48, {}), dev)
    rows, total, results = [], {}, {}
    for name, n, msgs, cap, over in FLOW_CELLS:
        specs = _flow_specs("feedback", n, msgs, cap, over)
        walls, reads = [], []
        for _ in range(COHORT_REPEATS):
            res, wall, counts = _cohort_run(specs, dev)
            walls.append(wall)
            reads.append(counts.pop("host_reads"))
            if (counts.pop("runs") < 1 or counts.get("pump_assign")
                    or counts.pop("withheld")):
                raise AssertionError(f"flow {name}: {counts}: the cell did "
                                     f"not run the cohort engine alone, or "
                                     f"left a confirm withheld")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        results[name] = res
        rej = [r.rejected_publishes for r in res]
        blk = [r.blocked_confirms for r in res]
        for r in res:
            if r.n_consumed != msgs:
                raise AssertionError(f"flow {name} seed {r.spec.params.seed}"
                                     f": consumed {r.n_consumed} of {msgs}")
        if min(rej) <= 0 or (name == "parity" and min(blk) <= 0):
            raise AssertionError(f"flow {name}: rejected {rej}, blocked "
                                 f"{blk}: flow control did not fire in "
                                 f"every lane")
        sm = [summarize(r) for r in res]
        rows.append(dict(
            cell=f"{name}: feedback/dstream/dts/c{n}", msgs=msgs,
            cap_msgs=cap, lanes=len(res), wall_s=statistics.median(walls),
            wall_s_runs=walls, events=res[0].n_events,
            us_per_event=statistics.median(walls) / res[0].n_events * 1e6,
            host_reads=reads[0], host_reads_runs=reads, rejected=rej,
            blocked=blk,
            throughput_msgs_s=[s.throughput_msgs_s for s in sm],
            median_rtt_s=[s.median_rtt_s for s in sm]))
    return rows, total, results


@contextlib.contextmanager
def _recorded_runs():
    """Record the results of every ``run_many`` call the experiment
    layer's drivers make, so that the smoke holds each cell without
    running it twice (the drivers return scores, not runs); yields the
    list of each call's results.  It wraps the name ``run_many`` in
    ``patterns``, and each phase unpacks exactly the calls it expects,
    so a driver that stops calling that name fails the phase instead of
    leaving its cells unheld."""
    from repro_torch.core import patterns
    calls, real = [], patterns.run_many

    def record(specs, **kw):
        calls.append(real(specs, **kw))
        return calls[-1]

    patterns.run_many = record
    try:
        yield calls
    finally:
        patterns.run_many = real


def _chaos_holds(r, what: str) -> dict:
    """Nothing lost and every duplicate completion a redelivery: the
    chaos run's scoreboard as a row."""
    from repro_torch import chaos_metrics
    m = chaos_metrics(r, r.spec.params.chaos).as_row()
    if m["lost"] or r.n_consumed != r.spec.total_messages + m["duplicates"]:
        raise AssertionError(f"{what}: lost messages or unaccounted "
                             f"completions: {m}")
    if m["duplicates"] > r.redelivered:
        raise AssertionError(f"{what}: duplicates beyond the redeliveries: "
                             f"{m}")
    return m


def drive_chaos(dev) -> tuple[list, dict, dict, list]:
    """The chaos scoreboard through ``patterns.chaos_campaign`` on the card
    at its full size, warm (after a small broker-outage cell): one
    ``run_many`` of the 15 cells, each solo on the cohort engine with no
    pump launch and no confirm left withheld; nothing is lost, every
    duplicate completion is a redelivery, the broker outage redelivers
    and rejects publishes, the link and autoscale cells redeliver
    nothing, and the link outage stretches the run by more than 0 and
    less than the outage's length against the arch's baseline.  Returns
    the per-point rows (the scoreboard beside each cell's hops), the
    launches, the phase's wall and counts, and the 15 runs."""
    from repro_torch.core.patterns import chaos_campaign, chaos_cell
    _cohort_run([chaos_cell("prs-haproxy", "broker", total_messages=256,
                            t0=0.2, t1=0.5)], dev)
    with _recorded_runs() as calls:
        points, wall, counts = _counted(lambda: chaos_campaign(device=dev))
    (results,) = calls
    if (counts.pop("runs") != len(points) or counts.get("pump_assign")
            or counts.pop("withheld")):
        raise AssertionError(f"chaos campaign: {counts}: the cells did not "
                             f"each run the cohort engine alone, or left a "
                             f"confirm withheld")
    reads = counts.pop("host_reads")
    rows, base = [], None
    for p, r in zip(points, results):
        what = f"chaos {p.arch}/{p.scenario}"
        sched = r.spec.params.chaos
        if r.spec.arch != p.arch or not p.feasible:
            raise AssertionError(f"{what}: infeasible or out of order")
        if sched is None:
            base = r
            if r.n_consumed != r.spec.total_messages or r.redelivered:
                raise AssertionError(f"{what}: consumed {r.n_consumed}, "
                                     f"redelivered {r.redelivered}")
        else:
            _chaos_holds(r, what)
        fails = []
        if p.scenario == "broker" and not (p.redelivered
                                           and p.storm_rejects):
            fails.append("the broker outage neither redelivered nor "
                         "rejected publishes")
        if p.scenario in ("tunnel", "autoscale") and p.redelivered:
            fails.append("redelivered without a broker boundary")
        stretch = r.sim_time - base.sim_time
        if p.scenario == "tunnel":
            t0, t1 = sched.outage_span()
            if not 0.0 < stretch < t1 - t0:
                fails.append(f"the link outage stretched the run by "
                             f"{stretch} s")
        if p.engine != "vectorized":
            fails.append(f"ran on engine {p.engine!r}")
        if fails:
            raise AssertionError(f"{what}: {'; '.join(fails)}: {p}")
        rows.append(dict(
            cell=f"{p.arch}/{p.scenario}", msgs=r.spec.total_messages,
            consumers=r.spec.n_consumers, tenants=r.spec.tenants,
            events=r.n_events, sim_time_s=r.sim_time, stretch_s=stretch,
            consumed=r.n_consumed, rejected=r.rejected_publishes,
            **dataclasses.asdict(p)))
    phase = dict(cells=len(points), wall_s=wall,
                 us_per_event=wall / sum(r.n_events for r in results) * 1e6,
                 host_reads=reads)
    return rows, counts, phase, results


def _held(got: float, want: float, tol: float, what: str) -> float:
    """The relative deviation of ``got`` from ``want``, held to ``tol``."""
    dev = abs(got - want) / abs(want)
    if not dev <= tol:
        raise AssertionError(f"{what}: {got} vs {want}: deviation {dev} > "
                             f"{tol}")
    return dev


def drive_experiment_layer(dev, main_rows: list) -> tuple[dict, dict]:
    """The experiment layer's drivers on the card, each with the launches
    counted from 0: (a) ``run_pattern`` on the main path's feedback cell,
    each seed solo through ``run_experiment`` on the wave program: it
    launches the pump, runs no cohort cell, and its summaries equal the
    main path's stacked lanes of the same program, seed 0 (the pilot
    lane, the solo run) at ``XDEV_RTOL`` and the other seeds inside the
    ``stacked.lanes.summary`` band; (b) ``run_campaign`` of
    ``EXP_CAMPAIGN`` on dts and on mss, one campaign each: dts takes the
    wave program (pump launches, no cohort run), mss the cohort engine
    (no pump launch, one stacked run), every summary reports the jax
    engine and consumes every message; (c) ``deployment_feasibility`` at
    ``EXP_TENANTS`` on the cohort engine (no pump launch), every point
    feasible with every metric finite.  Returns the rows and the launches."""
    import math
    from repro_torch import (
        CampaignSpec, deployment_feasibility, run_campaign, run_pattern,
        summarize)
    from repro_torch.core.parity import band
    total: dict = {}

    def add(counts: dict) -> None:
        for k in _launches():
            total[k] = total.get(k, 0) + counts[k]

    pattern, arch, n, msgs = EXP_PATTERN
    res, wall, counts = _counted(lambda: run_pattern(
        pattern, arch, "dstream", n, total_messages=msgs, n_runs=len(SEEDS),
        device=dev, **WAVE))
    main = next(r for r in main_rows if r["cell"] == f"{pattern}/{arch}/c{n}")
    if (not counts["pump_assign"] or counts["runs"]
            or len(res) != len(SEEDS)):
        raise AssertionError(f"run_pattern: {counts}: the seeds did not all "
                             f"take the wave program")
    add(counts)
    sm = [summarize(r) for r in res]
    devs = []
    for lane, (s, thr, rtt) in enumerate(zip(
            sm, main["throughput_msgs_s"], main["median_rtt_s"])):
        if s.engine != "jax" or s.n_messages != msgs:
            raise AssertionError(f"run_pattern: {s}")
        tol = XDEV_RTOL if lane == 0 else band("stacked.lanes.summary")
        devs.append(tuple(
            _held(got, want, tol, f"run_pattern seed {SEEDS[lane]} {what} "
                                  f"vs the stacked lane")
            for got, want, what in ((s.throughput_msgs_s, thr, "throughput"),
                                    (s.median_rtt_s, rtt, "median RTT"))))
    pat_row = dict(cell=f"run_pattern {pattern}/{arch}/c{n}", msgs=msgs,
                   seeds=len(res), wall_s=wall,
                   pump_launches=counts["pump_assign"],
                   throughput_msgs_s=[s.throughput_msgs_s for s in sm],
                   median_rtt_s=[s.median_rtt_s for s in sm],
                   dev_vs_stacked=devs)

    groups, camps = [], []
    for one in EXP_CAMPAIGN["architectures"]:
        grid = CampaignSpec(**dict(EXP_CAMPAIGN, architectures=(one,)))
        camp, _, counts = _counted(lambda: run_campaign(grid, device=dev))
        groups.append(dict(arch=one, wall_s=camp.wall_s, **counts))
        camps.append(camp)
        add(counts)
        for s in camp.summaries:
            if (s.engine != "jax"
                    or s.n_messages != EXP_CAMPAIGN["total_messages"]):
                raise AssertionError(f"run_campaign: {s}")
    dts, mss = groups
    if (not dts["pump_assign"] or dts["runs"] or mss["pump_assign"]
            or mss["runs"] != 1 or any(c.n_fallback for c in camps)):
        raise AssertionError(f"run_campaign: {groups}: dts must take the "
                             f"wave program and mss the cohort engine")
    camp_row = dict(cell=f"run_campaign {EXP_CAMPAIGN['name']}",
                    cells=sum(len(c.cells) for c in camps),
                    wall_s=sum(c.wall_s for c in camps), groups=groups,
                    averaged=[dict(arch=s.arch, engine=s.engine,
                                   n_runs=s.n_runs,
                                   throughput_msgs_s=s.throughput_msgs_s,
                                   median_rtt_s=s.median_rtt_s)
                              for c in camps for s in c.averaged])

    study, wall, counts = _counted(lambda: deployment_feasibility(
        tenant_counts=EXP_TENANTS, device=dev))
    if counts["pump_assign"] or not counts["runs"] or counts["withheld"]:
        raise AssertionError(f"deployment_feasibility: {counts}")
    add(counts)
    curves = {}
    for a, pts in study.curves.items():
        for p in pts:
            vals = (p.tenant_throughput_msgs_s, p.tenant_median_rtt_s,
                    p.fairness, p.degradation, p.ingress_utilization)
            if (not p.feasible or p.n_runs != len(SEEDS)
                    or not all(map(math.isfinite, vals))):
                raise AssertionError(f"deployment_feasibility: {p}")
        curves[a] = [dataclasses.asdict(p) for p in pts]
    feas_row = dict(cell=f"deployment_feasibility tenants {EXP_TENANTS}",
                    wall_s=wall, cohort_runs=counts["runs"],
                    host_reads=counts["host_reads"],
                    crossover_tenants=study.crossover_tenants,
                    crossover_utilization=study.crossover_utilization,
                    headline=study.headline(), curves=curves)
    return dict(run_pattern=pat_row, run_campaign=camp_row,
                deployment_feasibility=feas_row), total


def drive_availability(dev) -> tuple[dict, dict]:
    """``availability_crossover`` on the card at the reference's defaults
    (dts and mss, single-fault ingress outages of 5, 20, 40, 80 and
    120 s, one solo cohort cell per failed host, 20 cells): every cell
    ran the cohort engine alone with no pump launch and no confirm left
    withheld, lost nothing and redelivered every duplicate; every point
    feasible with a finite throughput.
    Returns the curves, the crossover and the headline, and the
    launches."""
    import math
    from repro_torch import availability_crossover
    with _recorded_runs() as calls:
        study, wall, counts = _counted(
            lambda: availability_crossover(device=dev))
    (results,) = calls
    if (counts.pop("runs") != len(results) or counts.get("pump_assign")
            or counts.pop("withheld")):
        raise AssertionError(f"availability: {counts}: the cells did not "
                             f"each run the cohort engine alone")
    scores = [_chaos_holds(r, f"availability {r.spec.arch} "
                              f"{r.spec.params.chaos}") for r in results]
    for pts in study.curves.values():
        for p in pts:
            if not p.feasible or not math.isfinite(p.throughput_msgs_s):
                raise AssertionError(f"availability: {p}")
    events = sum(r.n_events for r in results)
    row = dict(cells=len(results), wall_s=wall, events=events,
               us_per_event=wall / events * 1e6,
               host_reads=counts.pop("host_reads"),
               redelivered=[m["redelivered"] for m in scores],
               crossover_duration_s=study.crossover_duration_s,
               headline=study.headline(),
               curves={a: [dataclasses.asdict(p) for p in pts]
                       for a, pts in study.curves.items()})
    return row, counts


def _heap_of(spec):
    """``spec`` on the heap engine."""
    return dataclasses.replace(spec, params=dataclasses.replace(
        spec.params, engine="heap"))


def _heap_timed(fn) -> tuple:
    """``fn()`` on the heap engine: ``(out, wall)``, with the launches and
    the cohort runs counted from 0 and held at 0 (the heap engine runs
    on the host and never reaches the card's engines)."""
    out, wall, counts = _counted(fn)
    if counts["runs"] or any(counts[k] for k in _launches()):
        raise AssertionError(f"heap engine: {counts}: a heap cell ran on "
                             f"another engine")
    return out, wall


def _part_row(heap_results, heap_wall: float, card_wall: float,
              cells: list) -> dict:
    """One part's line: the heap engine's wall, events and events a second
    on the host CPU beside the card engine's wall."""
    events = sum(r.n_events for r in heap_results)
    return dict(heap_host_cpu_wall_s=heap_wall, heap_events=events,
                heap_events_per_s_host_cpu=events / heap_wall,
                card_wall_s=card_wall, cells=cells)


def heap_grid(dev) -> dict:
    """(a) The reference's Fig 4/6/7 parity grid: each cell of
    ``HEAP_GRID`` on ``HEAP_ARCHS`` through ``run_pattern`` on the card's
    cohort engine and on the heap engine, held to the reference's bands
    and to equal message counts."""
    from repro_torch import run_pattern, summarize
    from repro_torch.core.parity import band
    cells, heap_rs, heap_wall, card_wall = [], [], 0.0, 0.0
    for pattern, wl, msgs in HEAP_GRID:
        for arch in HEAP_ARCHS:
            kw = dict(total_messages=msgs, n_runs=1, seed=0, jitter=0.0,
                      device=dev)
            (v,), wall, counts = _counted(lambda: run_pattern(
                pattern, arch, wl, HEAP_NC, engine="vectorized", **kw))
            if counts["runs"] != 1 or counts["pump_assign"]:
                raise AssertionError(f"heap grid {pattern}/{arch}: {counts}")
            card_wall += wall
            (h,), hwall = _heap_timed(lambda: run_pattern(
                pattern, arch, wl, HEAP_NC, engine="heap", **kw))
            heap_wall += hwall
            heap_rs.append(h)
            hs, vs = summarize(h), summarize(v)
            want = msgs * (HEAP_NC if pattern == "broadcast_gather" else 1)
            if not hs.n_messages == vs.n_messages == want:
                raise AssertionError(f"heap grid {pattern}/{arch}: "
                                     f"{hs.n_messages} and {vs.n_messages} "
                                     f"of {want}")
            if hs.engine != "heap" or vs.engine != "vectorized":
                raise AssertionError(f"heap grid {pattern}/{arch}: engines "
                                     f"{hs.engine}, {vs.engine}")
            held = {"work_sharing": (
                ("throughput_msgs_s", f"work_sharing.{arch}.throughput"),),
                "feedback": (
                ("median_rtt_s", f"feedback.{arch}.median_rtt"),
                ("throughput_msgs_s", "feedback.all.throughput")),
                "broadcast_gather": (
                ("throughput_msgs_s", "broadcast_gather.all.throughput"),
                ("median_rtt_s", f"broadcast_gather.{arch}.gather_rtt"))}
            devs = {}
            for field, key in held[pattern]:
                devs[key] = dict(
                    dev=_held(getattr(vs, field), getattr(hs, field),
                              band(key), f"heap grid {pattern}/{arch} "
                                         f"{field}"),
                    band=band(key), heap=getattr(hs, field),
                    card=getattr(vs, field))
            cells.append(dict(cell=f"{pattern}/{wl}/{arch}/c{HEAP_NC}",
                              msgs=want, heap_events=h.n_events,
                              card_events=v.n_events, card_wall_s=wall,
                              heap_host_cpu_wall_s=hwall, held=devs))
    return _part_row(heap_rs, heap_wall, card_wall, cells)


def heap_chaos(dev, rows: list, results: list, card_wall: float) -> dict:
    """(b) The chaos phase's 15 card runs (``results``, with the phase's
    ``rows`` naming each one's scenario) against heap runs of the same
    specs, held by ``tests/test_chaos.py``'s checks: ``sim_time`` within
    the scenario's ``chaos.<scope>.summary`` band (a baseline within the
    tightest of them: the reference sets no band of its own for the
    failure-free cell), nothing lost, agreement on a finite recovery and
    ``chaos.all.recovery`` where finite, redeliveries within
    ``chaos.all.redelivered`` (an absolute gap of at most 8 below 8), none
    in the tunnel, autoscale and baseline cells, and the broker outage's
    rejects in both engines and within ``chaos.broker.rejects``."""
    import math
    from repro_torch import chaos_metrics, run_many
    from repro_torch.core.parity import band, factor_band
    heap, wall = _heap_timed(lambda: run_many(
        [_heap_of(r.spec) for r in results], device=dev))
    base_tol = min(band(f"chaos.{s}.summary") for s in CHAOS_SCOPE.values())
    cells = []
    for row, v, h in zip(rows, results, heap):
        sched, scenario = v.spec.params.chaos, row["scenario"]
        what = f"heap chaos {v.spec.arch}/{scenario}"
        if h.spec.params.engine != "heap" or not h.feasible:
            raise AssertionError(f"{what}: not a feasible heap run")
        tol = (band(f"chaos.{CHAOS_SCOPE[scenario]}.summary")
               if sched is not None else base_tol)
        out = dict(cell=f"{v.spec.arch}/{scenario}", heap_events=h.n_events,
                   card_events=v.n_events, heap_sim_time_s=h.sim_time,
                   card_sim_time_s=v.sim_time, band=tol,
                   sim_time_dev=_held(v.sim_time, h.sim_time, tol,
                                      f"{what} sim_time"),
                   redelivered=[h.redelivered, v.redelivered],
                   rejected=[h.rejected_publishes, v.rejected_publishes])
        if sched is None:
            if h.redelivered or v.redelivered or not (
                    h.n_consumed == v.n_consumed == v.spec.total_messages):
                raise AssertionError(f"{what}: {out}")
            cells.append(out)
            continue
        mh, mv = chaos_metrics(h, sched), chaos_metrics(v, sched)
        if mh.lost or mv.lost:
            raise AssertionError(f"{what}: lost {mh.lost}, {mv.lost}")
        if math.isfinite(mh.recovery_s) != math.isfinite(mv.recovery_s):
            raise AssertionError(f"{what}: recoveries {mh.recovery_s} and "
                                 f"{mv.recovery_s} disagree on finite")
        if math.isfinite(mh.recovery_s):
            rec = abs(mv.recovery_s - mh.recovery_s) / max(mh.recovery_s, 1.0)
            if not rec < band("chaos.all.recovery"):
                raise AssertionError(f"{what}: recovery deviation {rec}")
            out["recovery_dev"] = rec
        out["recovery_s"] = [mh.recovery_s, mv.recovery_s]
        if scenario in ("tunnel", "autoscale"):
            if h.redelivered or v.redelivered:
                raise AssertionError(f"{what}: redelivered {out}")
        elif h.redelivered >= 8:
            lo, hi = factor_band("chaos.all.redelivered")
            if not lo < v.redelivered / h.redelivered < hi:
                raise AssertionError(f"{what}: redelivered {out}")
        elif abs(v.redelivered - h.redelivered) > 8:
            raise AssertionError(f"{what}: redelivered {out}")
        if scenario == "broker":
            lo, hi = factor_band("chaos.broker.rejects")
            if not (h.rejected_publishes > 0 and v.rejected_publishes > 0
                    and lo < v.rejected_publishes / h.rejected_publishes
                    < hi):
                raise AssertionError(f"{what}: rejects {out}")
        cells.append(out)
    return _part_row(heap, wall, card_wall, cells)


def heap_flow(dev, results: list, card_wall: float) -> dict:
    """(c) The flow parity cell's three card lanes against a solo heap run
    of each seed: throughput and median RTT within
    ``stacked_overflow.lanes.summary``, rejects and withheld confirms
    within their factor bands and non-zero in every lane of both
    engines, every message consumed."""
    from repro_torch import run_experiment, summarize
    from repro_torch.core.parity import band, factor_band
    heap, wall = _heap_timed(lambda: [
        run_experiment(_heap_of(r.spec), device=dev) for r in results])
    tol = band("stacked_overflow.lanes.summary")
    rej_lo, rej_hi = factor_band("stacked_overflow.lanes.rejected")
    blk_lo, blk_hi = factor_band("stacked_overflow.lanes.blocked")
    cells = []
    for v, h in zip(results, heap):
        what = f"heap flow seed {v.spec.params.seed}"
        msgs = v.spec.total_messages
        if not (h.n_consumed == v.n_consumed == msgs
                and h.rejected_publishes > 0 and h.blocked_confirms > 0
                and v.rejected_publishes > 0 and v.blocked_confirms > 0):
            raise AssertionError(f"{what}: consumed {h.n_consumed}, "
                                 f"{v.n_consumed}; counters {h.rejected_publishes}"
                                 f"/{h.blocked_confirms}, "
                                 f"{v.rejected_publishes}/{v.blocked_confirms}")
        rej = v.rejected_publishes / h.rejected_publishes
        blk = v.blocked_confirms / h.blocked_confirms
        if not (rej_lo < rej < rej_hi and blk_lo < blk < blk_hi):
            raise AssertionError(f"{what}: rejected x{rej}, blocked x{blk}")
        hs, vs = summarize(h), summarize(v)
        cells.append(dict(
            seed=v.spec.params.seed, heap_events=h.n_events, band=tol,
            throughput_dev=_held(vs.throughput_msgs_s, hs.throughput_msgs_s,
                                 tol, f"{what} throughput"),
            median_rtt_dev=_held(vs.median_rtt_s, hs.median_rtt_s, tol,
                                 f"{what} median RTT"),
            rejected=[h.rejected_publishes, v.rejected_publishes],
            blocked=[h.blocked_confirms, v.blocked_confirms],
            rejected_factor=rej, blocked_factor=blk))
    return _part_row(heap, wall, card_wall, cells)


def quickstart_deploy() -> list:
    """The deployment lines of ``examples/quickstart.py``, through the
    port."""
    from repro_torch import (
        ResourceSettings, S3MService, establish_prs_session,
        make_architecture)
    dts = make_architecture("dts")
    sess = establish_prs_session(num_conn=1, tunnel="haproxy")
    s3m = S3MService()
    s3m.register_project("abc123")
    token = s3m.issue_token("abc123")
    cluster = s3m.provision_cluster(token, settings=ResourceSettings(
        cpus=12, ram_gbs=32, nodes=3))
    return [f"DTS : {dts.deployment_feasibility}",
            f"PRS : overlay {' -> '.join(sess.hops)} (uid={sess.uid})",
            f"MSS : provisioned {cluster.amqps_url}"]


def quickstart_table(engine: str, dev) -> tuple:
    """The work-sharing table of ``examples/quickstart.py`` on ``engine``,
    through the port: ``(lines, results)``."""
    from repro_torch import overhead_table, run_pattern, summarize
    lines, summaries, results = [], [], []
    for arch in QUICKSTART_ARCHS:
        r = run_pattern("work_sharing", arch, "dstream", 8,
                        total_messages=2048, n_runs=1, engine=engine,
                        device=dev)[0]
        s = summarize(r)
        results.append(r)
        summaries.append(s)
        lines.append(f"{arch:14s} {s.throughput_msgs_s:8.0f} msgs/s "
                     f"({s.goodput_gbps:.2f} Gbps)" if s.feasible else
                     f"{arch:14s} INFEASIBLE")
    for (arch, wl, nc), ov in overhead_table(summaries).items():
        lines.append(f"  {arch:14s} {ov:.2f}x")
    return lines, results


def heap_quickstart(dev) -> dict:
    """(d) ``examples/quickstart.py`` through the port: its deployment
    lines, and its work-sharing table on the card's cohort engine and on
    the heap engine, each equal to what the reference prints."""
    deploy = quickstart_deploy()
    if tuple(deploy) != QUICKSTART_DEPLOY:
        raise AssertionError(f"quickstart deployment: {deploy}")
    (card, _), card_wall, counts = _counted(
        lambda: quickstart_table("vectorized", dev))
    if counts["runs"] != len(QUICKSTART_ARCHS) or counts["pump_assign"]:
        raise AssertionError(f"quickstart on the card: {counts}")
    (heap, results), wall = _heap_timed(
        lambda: quickstart_table("heap", dev))
    for engine, got in (("vectorized", card), ("heap", heap)):
        if tuple(got) != QUICKSTART_TABLE[engine]:
            raise AssertionError(f"quickstart on {engine}: {got}")
    return dict(_part_row(results, wall, card_wall, []), deployment=deploy,
                card_table=card, heap_table=heap)


def drive_heap_parity(dev, chaos_rows: list, chaos_results: list,
                      chaos_wall: float, flow_results: list,
                      flow_wall: float) -> dict:
    """The heap parity phase: the card's cohort engine held to the port's
    heap engine at the reference's parity bands, in four parts, one row
    each: (a) ``heap_grid``, (b) ``heap_chaos`` on the chaos phase's runs,
    (c) ``heap_flow`` on the flow parity cell's lanes, (d)
    ``heap_quickstart``.  No part launches a kernel."""
    return {"(a) Fig 4/6/7 grid": heap_grid(dev),
            "(b) chaos cells": heap_chaos(dev, chaos_rows, chaos_results,
                                          chaos_wall),
            "(c) flow parity lanes": heap_flow(dev, flow_results, flow_wall),
            "(d) quickstart": heap_quickstart(dev)}


def _chaos_xcheck_spec(arch: str, scenario: str):
    """A chaos cross-check cell, at the bench's smoke size."""
    from repro_torch.core.patterns import chaos_cell
    t0, t1 = CHAOS_XCHECK_WINDOW
    return chaos_cell(arch, scenario, total_messages=CHAOS_XCHECK_MSGS,
                      t0=t0, t1=t1)


def chaos_cross_check(dev) -> dict:
    """The chaos cross-check cells on the card and on the CPU: clocks
    compared at ``XDEV_RTOL``, counters exactly."""
    import numpy as np
    out = []
    for arch, scenario in CHAOS_XCHECK:
        spec = _chaos_xcheck_spec(arch, scenario)
        (a,), wall_gpu, _ = _cohort_run([spec], dev)
        (b,), wall_cpu, _ = _cohort_run([spec], "cpu")
        for f in ("n_consumed", "n_events", "rejected_publishes",
                  "blocked_confirms", "redelivered"):
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(f"chaos cross-check {arch}/{scenario}: "
                                     f"{f} differs: {getattr(a, f)} vs "
                                     f"{getattr(b, f)}")
        if not np.array_equal(a.consume_producers, b.consume_producers):
            raise AssertionError(f"chaos cross-check {arch}/{scenario}: "
                                 f"consume producers differ")
        worst = 0.0
        for f in ("consume_times", "publish_starts"):
            x, y = getattr(a, f), getattr(b, f)
            rel = np.abs(x - y) / np.abs(y).clip(1e-300)
            worst = max(worst, float(rel.max()))
        if worst > XDEV_RTOL:
            raise AssertionError(f"chaos cuda vs cpu {arch}/{scenario}: max "
                                 f"relative deviation {worst} > {XDEV_RTOL}")
        if not a.redelivered:
            raise AssertionError(f"chaos cross-check {arch}/{scenario}: "
                                 f"nothing redelivered")
        out.append(dict(cell=f"{arch}/{scenario}/{CHAOS_XCHECK_MSGS}msgs",
                        max_rel_dev=worst, rtol=XDEV_RTOL,
                        redelivered=a.redelivered,
                        rejected=a.rejected_publishes, events=a.n_events,
                        wall_s_gpu=wall_gpu, wall_s_cpu=wall_cpu))
    return dict(cells=out)


def flow_cross_check(dev) -> dict:
    """The flow cross-check cell on the card and on the CPU: every lane's
    clocks compared at ``XDEV_RTOL``, its counters exactly."""
    import numpy as np
    pattern, n, msgs, cap, over = FLOW_XCHECK
    specs = _flow_specs(pattern, n, msgs, cap, over)
    rg, wall_gpu, _ = _cohort_run(specs, dev)
    rc, wall_cpu, _ = _cohort_run(specs, "cpu")
    worst = 0.0
    for a, b in zip(rg, rc):
        for f in ("n_consumed", "n_events", "rejected_publishes",
                  "blocked_confirms"):
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(f"flow cross-check: {f} differs: "
                                     f"{getattr(a, f)} vs {getattr(b, f)}")
        for f in ("consume_times", "rtts", "publish_starts"):
            x, y = getattr(a, f), getattr(b, f)
            if y.size:
                rel = np.abs(x - y) / np.abs(y).clip(1e-300)
                worst = max(worst, float(rel.max()))
    if worst > XDEV_RTOL:
        raise AssertionError(f"flow cuda vs cpu: max relative deviation "
                             f"{worst} > {XDEV_RTOL}")
    if not all(r.rejected_publishes and r.blocked_confirms for r in rg):
        raise AssertionError("flow cross-check: a lane neither rejected "
                             "nor withheld")
    return dict(cell=f"{pattern}/dstream/dts/c{n}/{msgs}msgs/cap{cap}",
                lanes=len(SEEDS), max_rel_dev=worst, rtol=XDEV_RTOL,
                rejected=[r.rejected_publishes for r in rg],
                blocked=[r.blocked_confirms for r in rg],
                wall_s_gpu=wall_gpu, wall_s_cpu=wall_cpu)


def cohort_cross_check(dev) -> dict:
    """The cross-check cell on the card and on the CPU, every lane's
    clocks compared at ``XDEV_RTOL``."""
    import numpy as np
    specs = _cohort_specs(*COHORT_XCHECK)
    rg, wall_gpu, _ = _cohort_run(specs, dev)
    rc, wall_cpu, _ = _cohort_run(specs, "cpu")
    worst = 0.0
    for a, b in zip(rg, rc):
        if a.n_consumed != b.n_consumed or a.n_events != b.n_events:
            raise AssertionError("cohort cross-check: counts differ")
        for f in ("consume_times", "rtts", "publish_starts"):
            x, y = getattr(a, f), getattr(b, f)
            if y.size:
                rel = np.abs(x - y) / np.abs(y).clip(1e-300)
                worst = max(worst, float(rel.max()))
    if worst > XDEV_RTOL:
        raise AssertionError(f"cohort cuda vs cpu: max relative deviation "
                             f"{worst} > {XDEV_RTOL}")
    pattern, arch, wl, n, msgs = COHORT_XCHECK
    return dict(cell=f"{pattern}/{wl}/{arch}/c{n}/{msgs}msgs",
                lanes=len(SEEDS), max_rel_dev=worst, rtol=XDEV_RTOL,
                wall_s_gpu=wall_gpu, wall_s_cpu=wall_cpu)


def profile_cohort(dev) -> dict:
    """Device busy time, idle share and the top kernels of one warm run of
    the Fig 7b dts cell, from ``torch.profiler`` (device activity only)."""
    from torch.profiler import ProfilerActivity, profile
    specs = _cohort_specs(*COHORT_CELLS[3])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall, counts = _cohort_run(specs, dev)
    out = _device_rows(prof, wall, "broadcast_gather/generic/dts/c32")
    out["host_reads"] = counts["host_reads"]
    return out


def _device_rows(prof, wall: float, cell: str, share_of: str = "") -> dict:
    """Device busy time, idle share of ``wall`` and the top kernels of a
    ``torch.profiler`` run; with ``share_of``, the device time, launches
    and share of busy time of the kernels whose name holds it.  Summed
    from the profiler's raw device events (kernels, copies), which skips
    building an event tree: a cohort run has a million kernels."""
    import torch
    agg: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        a = agg.setdefault(ev.name(), [0.0, 0])
        a[0] += ev.duration_ns() / 1e3
        a[1] += 1
    rows = sorted(((us, n, name) for name, (us, n) in agg.items() if us),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    out = dict(cell=cell, wall_s=wall,
               device_busy_s=busy if rows else "not measured",
               idle_share=1.0 - busy / wall if rows else "not measured",
               device_events=sum(r[1] for r in rows),
               top=[dict(us=r[0], count=r[1], name=r[2][:80])
                    for r in rows[:10]])
    if share_of:
        mine = [r for r in rows if share_of in r[2]]
        us = sum(r[0] for r in mine)
        out[share_of] = dict(
            us=us, count=sum(r[1] for r in mine),
            share_of_busy=us / 1e6 / busy if rows else "not measured")
    return out


def serve(arch: str, dev, done, walk, walk_dec=None) -> tuple:
    """Every serving phase of ``arch``: build, prefill (checked),
    ``walk`` (the per-layer checks), prefill profile, ``generate``,
    decode at context, and ``walk_dec`` (the decode step's per-layer
    checks) where given.  Returns the launches of each main-path run by
    path."""
    import torch
    model, init_s = build_lm(arch, dev)
    prefill, tokens, counts = drive_prefill(model, init_s)
    print("serve prefill:", json.dumps(prefill))
    by_path = {f"{arch} prefill": counts}
    check_prefill(prefill)
    done(f"{arch} prefill")
    print("serve layers:", json.dumps(walk(model, tokens)))
    done(f"{arch} prefill by layer")
    print("profile:", json.dumps(profile_prefill(model, tokens)))
    row, by_path[f"{arch} generate"] = drive_decode(model)
    print("serve decode:", json.dumps(row))
    done(f"{arch} prefill profile and generate")
    rows, by_path[f"{arch} decode at context"] = drive_decode_ctx(model)
    for r in rows:
        print("serve decode context:", json.dumps(r))
    done(f"{arch} decode at context")
    if walk_dec is not None:
        print("serve decode layers:", json.dumps(walk_dec(model)))
        done(f"{arch} decode by layer")
    print(f"{arch} peak memory: {torch.cuda.max_memory_allocated() / 1e9} GB")
    del model, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import KERNELS, _build
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {kind}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    phase_s, t_prev = {}, time.perf_counter()

    def done(phase: str) -> None:
        """Record the seconds since the previous phase ended."""
        nonlocal t_prev
        now = time.perf_counter()
        phase_s[phase], t_prev = now - t_prev, now

    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.build, KERNELS))
    done("build")
    print(f"build: {sorted(KERNELS)} in {phase_s['build']:.2f} s")
    # float32 products in full float32 (the default, stated): the plain
    # versions are the yardsticks of the f32 checks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {}
    for check in (check_pump, check_flash, check_rmsnorm, check_decode,
                  check_ssd):
        row = check(dev)
        kernels[row["name"]] = row
        print("kernel check:", json.dumps(row))
        torch.cuda.empty_cache()
    done("kernel checks")
    main_rows, pump_launches = drive_main_path(dev)
    for r in main_rows:
        print("main path:", json.dumps(r))
    by_path = {"wave": {"pump_assign": pump_launches}}
    done("wave cells")
    rows, by_path["cohort"] = drive_cohort(dev)
    for r in rows:
        print("cohort cells:", json.dumps(r))
    done("cohort cells")
    flow_rows, by_path["flow"], flow_results = drive_flow(dev)
    for r in flow_rows:
        print("flow cells:", json.dumps(r))
    done("flow cells")
    chaos_rows, by_path["chaos"], phase, chaos_results = drive_chaos(dev)
    for r in chaos_rows:
        print("chaos cells:", json.dumps(r))
    print("chaos campaign:", json.dumps(phase))
    done("chaos cells")
    exp, by_path["experiment layer"] = drive_experiment_layer(dev, main_rows)
    for name, row in exp.items():
        print(f"experiment layer: {name}:", json.dumps(row))
    done("experiment layer")
    avail, by_path["availability"] = drive_availability(dev)
    print("availability:", json.dumps(avail))
    done("availability")
    for part, row in drive_heap_parity(
            dev, chaos_rows, chaos_results, phase["wall_s"],
            flow_results["parity"], flow_rows[0]["wall_s"]).items():
        print(f"heap parity {part}:", json.dumps(row))
    done("heap parity")
    print("cross-check:", json.dumps(cross_check(dev)))
    print("cohort cross-check:", json.dumps(cohort_cross_check(dev)))
    print("flow cross-check:", json.dumps(flow_cross_check(dev)))
    print("chaos cross-check:", json.dumps(chaos_cross_check(dev)))
    done("cross-checks")
    print("profile:", json.dumps(profile_cell(dev)))
    print("cohort profile:", json.dumps(profile_cohort(dev)))
    done("profiles")
    by_path.update(serve("granite-8b", dev, done, walk_layers, walk_decode))
    by_path.update(serve("zamba2-7b", dev, done, walk_ssd))
    print("phase seconds:", json.dumps(phase_s))
    for name, row in kernels.items():
        row["launches"] = sum(c.get(name, 0) for c in by_path.values())
        row["launches_by_path"] = {p: c[name] for p, c in by_path.items()
                                   if c.get(name)}
        if not row["launches"]:
            raise AssertionError(f"{name}: no launch on the main paths")
    print("launches by path:", json.dumps(by_path))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
