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
float32, on granite-8b's, zamba2-7b's, qwen3-moe-30b-a3b's (GQA 8:1),
moonshot-v1-16b-a3b's (MHA at hd 128), musicgen-large's (bf16 MHA at
hd 64) and gemma2-9b's shapes and the edge cases, each timed on the
kernel its route rule picks (the tensor-core kernel for bf16 at hd 64,
112 and 128), and both kernels timed at granite's and zamba2's shapes
with the registers and CTAs an SM they get; RMSNorm at every served
model's width (2048 to 7168), at the prefill's rows and at the decode
steps' 32 and 128, each call and its device time beside ``F.rms_norm``'s
and the bytes bound, with the route, grid and registers the kernel's C
entry point picks; flash decode on the models'
full caches, gemma2's window, ragged positions and one long request,
with the cache past each position overwritten, and at the eight serving
shapes (granite 128 x 2048 and 32 x 8192, zamba2 32 x 4096 and 8 x
16384, qwen3 128 x 1024, moonshot 32 x 1024, musicgen 32 x 4096,
pixtral 128 x 2048) its time beside SDPA's, the bytes bound, the share
of the memory rate, the registers, CTAs an SM and waves of its grid
(``decode shape:`` lines); the SSD state scan at zamba2's prefill and a
32768-token request, timed with its registers and CTAs an SM beside the
bound and the bytes floor.
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
  under a byte cap: the parity cell, 4 x 4 x 4096 messages, and the
  scale smoke, 64 x 64 x 6144, both cut in depth from the bench's
  8192), which take the cohort engine's credit flow
  and reject-publish overflow, three seed-lanes each, warm, timed
  ``COHORT_REPEATS`` times: every lane consuming every message and
  rejecting publishes (the parity cell's also withholding confirms), no
  confirm left withheld, no pump launch; and a work-sharing 1 x 1 cell
  under a 424-message cap on the GPU and on the CPU, compared, counters
  exactly;
* the chaos cells — ``patterns.chaos_campaign`` at its defaults but
  3072 messages a cell (``CHAOS_MSGS``), the chaos campaign of
  ``benchmarks/bench_chaos.py`` cut in depth (work sharing of the
  generic workload, 4 producers x 8 consumers, 4096 messages there, an
  outage over [5, 10) s): the ingress link, a broker queue
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
  10240 messages on dts and mss, in-process, the dts group on the wave
  program (pump launches) and the mss group on the cohort engine (none),
  every summary reporting the jax engine; ``deployment_feasibility`` at
  1, 8 and 64 tenants of 16 messages each, its curves and headline;
* the availability crossover — ``availability_crossover`` at the
  reference's defaults (single-fault ingress outages of 5, 20, 40, 80
  and 120 s on dts and mss, 20 solo cohort cells) but 512 messages a
  cell (``AVAIL_MSGS``), nothing lost in any cell, its curves, crossover
  duration and headline printed;
* the heap parity phase — the card's per-cohort engine held to the
  port's heap engine (``engine="heap"``, the one-event-per-hop model the
  reference's parity bands are defined against, which runs on the
  host), one line per part with the heap engine's wall, events and
  events a second on the host CPU beside the card engine's wall: (a)
  the reference's Fig 4/6/7 parity grid cut in depth (work sharing and
  feedback of dstream at 1024 messages, broadcast+gather of generic at
  100, where the reference's test runs 4096 and 400, on dts,
  prs-haproxy and mss at 8 consumers, seed 0, jitter 0) through
  ``run_pattern`` on each engine, within the reference's bands and
  with equal message counts; (b) the chaos phase's 15 card runs against
  heap runs of the same specs, by ``tests/test_chaos.py``'s checks; (c)
  the flow parity cell's three card lanes against a solo heap run of
  each seed, within the ``stacked_overflow`` bands with both counters
  non-zero; (d) ``examples_torch/quickstart.py``'s functions, its
  deployment lines and its work-sharing table on both engines equal to
  the lines the reference's ``examples/quickstart.py`` prints.  No part
  launches a kernel;
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
  cached tokens with flash decode, each beside one plain step;
* serving qwen3-moe-30b-a3b at full width and depth (48 layers of 128
  experts, top-8, 61.1 GB of random bf16 weights), after zamba2's
  memory is freed: the prefill step on 2 x 2048 tokens (``moe_dense``:
  every expert for every token, as the reference's ``moe_block`` runs
  without a mesh; flash attention at GQA 8:1 once a layer, RMSNorm for
  every norm), its logits and next tokens held as granite's; the
  prefill walked layer by layer (``MOE_DEPTHS``), each layer also held
  on one input with its expert flips explained by rounding
  (``_hold_moe_layer``); a profile of one prefill with ``moe_block``'s
  and ``moe_dense``'s share of its device time read from the trace;
  ``generate``; decode steps against 128 x 1024 cached tokens with flash
  decode, beside one einsum step and one step with the second plain
  decode attention, and that step walked layer by layer.  Routing is
  discontinuous, so the held streams and steps take the einsum's (or
  the reference's) experts at every layer, and the natural ones, with
  the requests whose experts flipped, are printed beside them;
* serving moonshot-v1-16b-a3b likewise (64 experts, top-6, and 2 shared
  experts, the one path that runs them; 57.8 GB): prefill 2 x 2048,
  decode 32 x 1024, both walked;
* serving musicgen-large (48 layers, 6.5 GB; the audio stub frontend):
  the prefill step on 4 x 4096 frame embeddings (``{"embeds"}``), flash
  attention on the tensor-core kernel at bf16 hd 64, logits held as
  granite's; a profile; ``generate`` on codebook tokens; decode steps
  against 32 x 4096 cached tokens (51.5 GB of K/V);
* serving pixtral-12b (40 layers, d 5120, 24.5 GB; the vision stub
  frontend): the prefill step on 4 requests of 1024 patch embeddings
  before 3072 text tokens, held as granite's; a profile; ``generate``;
  decode steps against 128 x 2048 cached tokens (42.9 GB of K/V);
* serving xlstm-1.3b at full width and depth (48 blocks, every 8th an
  sLSTM block, 9.28 GB of random bf16 weights), after pixtral's memory
  is freed: the prefill step on 4 x 4096 tokens (RMSNorm for each of the
  97 norms; the mLSTM and the sLSTM plain), its logits printed beside
  both plain paths' (the mLSTM at 256- and at 128-position chunks),
  since at random weights the full-depth model is chaotic
  (``FORCED_WALK_FAMILIES``); the prefill walked block by block on the
  plain stream, each block under the kernels and with the other chunking
  held on that stream's input, the first 8 blocks' chunked prefill held
  to their decode recurrence on 2 x 512 tokens, the natural kernel
  stream printed by depth, and the sLSTM blocks' share of the block
  time; a profile; ``generate``; decode steps at 32 requests from a
  random f32 state (22.6 GB), and that step walked block by block;
* the train phase — training as ``launch/train.run`` drives it, each
  trainer from its ``build_trainer`` (``SyntheticTokens(seed=0)``, f32
  masters, AdamW on ``cosine_warmup`` with the model's decayed set, the
  microbatched train step under ``ModelContext()``, remat): granite-8b at full width cut to 8 of 36
  layers, 12 steps, and zamba2-7b at full width cut to 13 of 81 Mamba2
  layers (two macro-blocks and a tail layer), 8 steps, each of 4 x 4096
  tokens in 4 microbatches, and xlstm-1.3b at full width cut to 8 of 48
  blocks (block 7 its sLSTM block), 12 steps of 4 x 4096 tokens in its
  config's one microbatch; then, each of 4 x 4096 positions in 4
  microbatches, qwen3-moe-30b-a3b and moonshot-v1-16b-a3b cut to 4 of 48
  layers, 3 steps each, musicgen-large at full depth on frame embeddings
  (``zoo.make_batch``) with ``SyntheticTokens`` labels, 4 steps, and
  pixtral-12b cut to 8 of 40 layers on 1024 patch embeddings before 3072
  ``SyntheticTokens`` positions, 4 steps; with their losses, grad norms,
  step walls, tokens/s, peak memory and, for granite, zamba2, xLSTM and
  qwen3, one profiled step (by kernel kind; qwen3's also with
  ``moe_dense``'s share of the device time under autograd: forward,
  recompute and backward); every loss finite, the first near ln V and
  the last at least 0.3 below it; musicgen's first 2 steps again under
  ``remat_policy="dots"`` from the same weights and batches (the first
  loss equal, the grad norms within 1e-5, both peaks and step walls);
  the same three steps of the seven smoke configs (the families' batch
  forms) on the card and on the CPU,
  compared by their losses, grad norms and each weight's trained change
  (an expert flip between the devices counted and named);
  ``launch.train.run`` on the card resuming from its
  checkpoint; and no model kernel launched in the phase, as training
  runs the plain paths.  Then the kernels' forward-only guard: a train
  step of granite-8b's and of qwen3-moe-30b-a3b's smoke config under
  ``attention_impl="pallas"`` and each model kernel called with an input
  that requires grad raise;
* the stream phase — training on the streamed edge-to-HPC data plane
  (edge producers publishing Dstream payloads into the real-time broker,
  a consumer group assembling token rows, steering feedback, a consumer
  crash and its redelivery): ``launch.train.run`` with ``--data
  stream`` at the reference's own test size (granite-8b-smoke, 14 steps
  of 4 x 16, a crash at step 6, feedback every 5), its losses within
  [ln V - 0.5, ln V + 2], its ``[fault]`` line printed and the
  redelivered messages seen again; then granite-8b as the train phase
  cuts it, built by ``build_trainer``, fed by ``make_stream``'s defaults
  and driven by ``run``'s own loop, 10 steps with a crash at step 5 and
  feedback every 2, and one profiled step: step walls before and after
  the crash beside the train phase's on local data, the wait for each
  batch, host CPU seconds a step, the device's idle share, peak memory,
  the producers' rates and the work queues' depths at each feedback;
  every loss finite and in the band, every row of every batch, read back
  from the card, a published payload's tokens, and no model kernel
  launched;
* the mesh path — in a one-rank NCCL world (``init_process_group`` on
  ``localhost``, rank 0 of 1) on a (1, 1) ("data", "model") mesh, the
  port's DTensor placements from ``launch.shardings.assemble``:
  qwen3-moe-30b-a3b as its serving phase built it (placed in place: on
  one rank every placement is a view), its first MoE layer under expert
  parallelism (``moe_ep``, ``moe_impl="auto"``) at a capacity factor of
  E/k = 16 (nothing dropped) against ``moe_dense``; the full-depth 2 x
  2048 prefill under ``pallas`` (flash attention and RMSNorm through
  ``local_map``) at E/k with the dense run's experts forced, held as the
  MoE rows hold their logits; at the config's capacity factor the
  prefill timed beside the dense one, the dropped share of (token,
  expert) pairs, the requests whose experts flipped, a profile with
  ``moe_ep``'s share of busy time; the decode step at 128 x 1024 (flash
  decode on the whole cache) held likewise and timed beside the step off
  the mesh; and, after granite-8b's train run, one train step of that
  run's model, state and batch in the ZeRO layout, its loss against the
  same step's off the mesh (``mesh_moe``, ``mesh_train``);
* the examples path — the port's examples (``examples_torch``), each
  through its ``main`` as a user runs it, one line each with its wall,
  the comparison and edge-to-HPC each in a child process started before
  the heap parity phase and collected after the cross-checks (all
  host-bound, the card idle most of the time), steering then in this
  process:
  ``cross_facility_comparison.py`` at its defaults (Fig 4, 6 and 7a in
  miniature, 18 solo cohort runs), its 28 lines equal to the reference
  script's (``COMPARISON_LINES``); ``edge_to_hpc_training.py`` at its
  defaults (the ~100M-parameter ``edge-100m`` trained 200 steps on the
  streamed data plane with a consumer crash at step 66, feedback every
  10 steps, checkpoints every 50) in a fresh checkpoint directory: every
  loss finite, the first near ln V and the final below it, the
  ``[fault]`` line, the crash's messages redelivered and seen, the
  checkpoints at 50, 100, 150 and 200 with the last three kept, its
  steps/s and peak memory; ``steering_serve.py``: 4 streamed requests
  served by granite-8b's smoke model, 8 new tokens each, both producers
  steered, their threads ended; no kernel launched;
* the dryrun path — the dry run (``repro_torch.launch.dryrun``), which
  runs a cell's step on the meta device over a fake world of 256 or 512
  ranks and counts rank 0's local ops: (a) its CLI in child processes
  (the fake world cannot share a process with an NCCL one), one a group
  of ``DRYRUN_CELLS``, all started together before musicgen-large's train
  run and collected after it (``DRYRUN_BESIDE``; they use no card), each
  child's wall held to ``DRYRUN_TIMEOUT``, each record's roofline,
  memory and timings printed on a ``dryrun cell:`` line, any failed cell
  failing the smoke; (b) on the card, granite-8b's serving prefill (4 x
  4096 under ``attention_impl="auto"``, the plain attention, so that the
  count sees every product) counted by the dry run's ``CostCounter`` on
  CUDA tensors, its FLOPs equal to the same count on the meta device,
  the H100 roofline's bound printed beside the measured wall of the same
  step, which may not lie below it; no model kernel or pump launched
  (``dryrun_children``, ``dryrun_count``).

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
import os
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
#: timed runs of each wave cell (after its warm run): one, cut from three
#: (``WALL_REPEATS``) to make room for the mesh path (a repeat of the four
#: cells took about 13 s on an H100 at 700 W); a timed run's wall varies
#: up to 15% between repeats (the spread a median of three hid)
WAVE_REPEATS = 1
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
#: the queues pin at their cap (reject-publish alone).  Both cut in depth
#: from the bench's 8192 messages to make room for the MoE, audio and
#: VLM train runs: the parity cell to 4096 (68 rejected and 256 withheld
#: a lane; at 3072 and 2048 no publish is rejected), the scale smoke to
#: 6144 (1077 to 3115 rejected a lane; at 4096 none)
FLOW_CELLS = (
    ("parity", 4, 4096, int(400 * 4 * 1.06), dict(jitter=0.0)),
    ("scale smoke", 64, 6144, 2048, dict(consumer_proc_s=250e-6 * 64)),
)
#: the flow cell run on the card and on the CPU, compared: work sharing
#: of dstream on dts, 1 x 1, 1536 msgs, a 424-message cap (both
#: mechanisms)
FLOW_XCHECK = ("work_sharing", 1, 1536, 424, dict(consumer_proc_s=5e-3))

#: the chaos campaign runs ``patterns.chaos_campaign`` at its defaults but
#: ``CHAOS_MSGS``, ``benchmarks/bench_chaos.py``'s size otherwise: work
#: sharing of the generic workload (4 MiB), 4 producers x 8 consumers,
#: consumer processing 2 ms, jitter 0, an outage over [5, 10) s; each
#: scenario on each deployment arch, beside the arch's failure-free
#: baseline.  The chaos cells run on the card and on the CPU, compared,
#: at the bench's smoke size (``CHAOS_BENCH_SMOKE``)
CHAOS_XCHECK = (("prs-haproxy", "broker"), ("prs-haproxy", "consumer"))
#: messages a chaos cell: the bench's 4096 cut to 3072 to make room for
#: the xLSTM phases (the phase took 162.1 s at 4096 in phases of 1131.7
#: s on an H100 at 700 W); the outage [5, 10) s falls inside every run,
#: and the heap parity phase's (b) holds the cells to the heap engine at
#: the reference's bands at this size too (a cut to 2048 missed the band
#: of prs-haproxy/autoscale)
CHAOS_MSGS = 3072
CHAOS_XCHECK_MSGS, CHAOS_XCHECK_WINDOW = 512, (1.0, 3.0)

#: the experiment layer's cells: (a) ``run_pattern`` on the main path's
#: feedback cell, each seed solo; (b) a campaign of Fig 6's feedback at
#: 64 consumers x 10240 messages (160 a producer, inside the wave gate's
#: feedback corridor W < M <= 2W at the confirm window of 128; cut from
#: 16384 to make room for the mesh path: the mss group took 26.9 s of
#: the campaign's 28.2 at 16384 on an H100 at 700 W; at 10240 dts still
#: takes the wave program and mss the cohort engine,
#: ``chip_probes/depth_cuts.py exp`` on the CPU) on dts, which the gate
#: takes, and mss, which it refuses; (c) the deployment study at three
#: of ``TENANT_SWEEP``'s seven tenant counts, 16 messages a tenant (the
#: reference's 256 cut to 64 to keep the smoke's phases inside 1050 s on
#: a slow host, then to 16 and 8 for the mesh path: 29.6 s at 64 and
#: 8.1 s at 16 on an H100 at 700 W; at 16 and at 8 every point is
#: feasible and finite and the crossover stays inside the sweep, 51.4 and
#: 53.3 tenants against 55.05 at 64, ``chip_probes/depth_cuts.py exp`` on
#: the CPU)
EXP_PATTERN = ("feedback", "dts", 256, 65536)
EXP_CAMPAIGN = dict(name="fig6 c64", patterns=("feedback",),
                    architectures=("dts", "mss"), workloads=("dstream",),
                    consumers=(64,), n_runs=len(SEEDS), total_messages=10240,
                    params={"engine": "jax", "jax_device_loop": True})
EXP_TENANTS = (1, 8, 64)
EXP_TENANT_MSGS = 8
#: messages a cell of the availability crossover: the reference's 4096
#: cut to 1024 to keep the smoke's phases near 906 s (the availability
#: phase took 251.3 s at 4096 in phases of 1021 s, 128.0 s at 2048 in
#: phases of 945.6 s), then to 512 to make room for the xLSTM phases
#: (89.0 s at 1024 in phases of 1131.7 s on an H100 at 700 W); the
#: outages still start inside every run and the crossover stays inside
#: the sweep
AVAIL_MSGS = 512
#: the cells that opt in to the wave program, as the reference's do
WAVE = dict(engine="jax", jax_device_loop=True)

#: the heap parity phase (a): the reference's Fig 4/6/7 parity grid
#: (``tests/test_engine_parity.py``), (pattern, workload, messages) on
#: each of ``HEAP_ARCHS`` at ``HEAP_NC`` consumers, seed 0, jitter 0,
#: run once on the card's cohort engine and once on the heap engine; cut
#: in depth from the reference's 4096 and 400 messages to 1024 and 100 to
#: make room for the MoE, audio and VLM train runs (every band is met at
#: 1024 and at 2048, the widest deviation 0.0108 of a 0.02 band; 2048
#: saved too little)
HEAP_GRID = (("work_sharing", "dstream", 1024),
             ("feedback", "dstream", 1024),
             ("broadcast_gather", "generic", 100))
HEAP_ARCHS = ("dts", "prs-haproxy", "mss")
HEAP_NC = 8
#: chaos scenario -> its parity band's scope (``tests/test_chaos.py``)
CHAOS_SCOPE = {"tunnel": "link", "broker": "broker",
               "consumer": "consumer", "autoscale": "autoscale"}
#: the heap parity phase (d): ``examples_torch/quickstart.py`` (its
#: work-sharing table: dstream, 8 x 8, 2048 messages, seed 0), and the
#: lines the reference package prints for ``examples/quickstart.py`` on
#: each engine (``PYTHONPATH=src python examples/quickstart.py [--engine
#: heap]``)
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

#: the examples path: the lines the reference package prints for
#: ``examples/cross_facility_comparison.py`` at its defaults (the
#: vectorized engine; ``PYTHONPATH=src python
#: examples/cross_facility_comparison.py``), which
#: ``examples_torch/cross_facility_comparison.py`` prints on the card
COMPARISON_LINES = (
    "== Fig4 (mini): work-sharing throughput, dstream [vectorized] ==",
    "  dts           c=  1      6071 msgs/s",
    "  dts           c=  8     35691 msgs/s",
    "  dts           c= 32     37489 msgs/s",
    "  prs-haproxy   c=  1      6186 msgs/s",
    "  prs-haproxy   c=  8     18775 msgs/s",
    "  prs-haproxy   c= 32     16788 msgs/s",
    "  mss           c=  1      4660 msgs/s",
    "  mss           c=  8     14144 msgs/s",
    "  mss           c= 32     14172 msgs/s",
    "== Fig6 (mini): feedback median RTT, dstream [vectorized] ==",
    "  dts           c=  1        39 ms",
    "  dts           c=  8        67 ms",
    "  prs-haproxy   c=  1        37 ms",
    "  prs-haproxy   c=  8       131 ms",
    "  mss           c=  1       123 ms",
    "  mss           c=  8       177 ms",
    "== Fig7a (mini): broadcast throughput, generic [vectorized] ==",
    "  dts           c=  8       145 msgs/s",
    "  prs-haproxy   c=  8       148 msgs/s",
    "  mss           c=  8       114 msgs/s",
    "== overhead vs DTS (work sharing) ==",
    "  mss           c=  1  1.30x",
    "  mss           c=  8  2.52x",
    "  mss           c= 32  2.65x",
    "  prs-haproxy   c=  1  0.98x",
    "  prs-haproxy   c=  8  1.90x",
    "  prs-haproxy   c= 32  2.23x",
)
#: the examples path's edge-to-HPC run: ``examples_torch/
#: edge_to_hpc_training.py`` at its defaults (``--steps 200``), whose
#: checkpoints land at these steps, the last ``EDGE_KEEP`` kept
EDGE_STEPS = 200
EDGE_CKPT_STEPS = (50, 100, 150, 200)
EDGE_KEEP = 3
#: seconds the examples path waits for each example's child process
EXAMPLES_TIMEOUT = 600
#: the steering example's requests, prompt tokens and new tokens a request
STEER_REQUESTS = 4
STEER_PROMPT = 8
STEER_NEW = 8

#: flash-attention checks on the card: (case, dtype, B, S, T, H, KV, hd,
#: causal, window, logit cap), each timed.  The first is granite-8b's
#: prefill shape and is the one in the kernels line; zamba2-7b's (hd 112)
#: is timed beside it on both routes.  The MoE and audio models' prefill
#: shapes follow: GQA 8:1 (qwen3), MHA at hd 128 (moonshot), bf16 MHA at
#: hd 64 (musicgen); pixtral's is granite's.
ATTN_CASES = (
    ("granite-8b prefill", "bfloat16", 4, 4096, 4096, 32, 8, 128, True, 0, 0.0),
    ("zamba2-7b prefill", "bfloat16", 4, 4096, 4096, 32, 32, 112, True, 0, 0.0),
    ("qwen3-moe-30b-a3b prefill", "bfloat16", 2, 2048, 2048, 32, 4, 128, True, 0, 0.0),
    ("moonshot-v1-16b-a3b prefill", "bfloat16", 2, 2048, 2048, 16, 16, 128, True, 0, 0.0),
    ("musicgen-large prefill", "bfloat16", 4, 4096, 4096, 32, 32, 64, True, 0, 0.0),
    ("granite-8b B=1", "bfloat16", 1, 4096, 4096, 32, 8, 128, True, 0, 0.0),
    ("gemma2-9b local", "bfloat16", 1, 8192, 8192, 16, 8, 256, True, 4096, 50.0),
    ("f32 hd=64", "float32", 2, 1024, 1024, 8, 2, 64, True, 0, 0.0),
    ("f32 hd=112 window softcap", "float32", 1, 1000, 1000, 4, 2, 112, True, 300, 30.0),
    ("non-causal", "bfloat16", 2, 1024, 1024, 8, 8, 128, False, 0, 0.0),
    ("MQA", "bfloat16", 2, 1024, 1024, 16, 1, 128, True, 0, 0.0),
    ("ragged S", "bfloat16", 1, 1000, 1000, 8, 2, 128, True, 0, 0.0),
    ("ragged f32 window softcap", "float32", 1, 777, 777, 4, 2, 64, True, 100, 30.0),
)
#: RMSNorm checks: (case, dtype, rows, D), each timed two ways beside
#: ``F.rms_norm``.  The first (granite-8b's prefill rows) is in the kernels
#: line.  Prefill rows are 4 x 4096 tokens (qwen3's 2 x 2048); decode rows
#: are the requests of a serving decode step: 128 for granite, qwen3 and
#: pixtral, 32 for zamba2, moonshot, musicgen (d 2048, as xLSTM's norm)
#: and xLSTM.
RMS_CASES = (
    ("granite-8b prefill", "bfloat16", 16384, 4096),
    ("zamba2-7b out_norm", "bfloat16", 16384, 7168),
    ("qwen3-moe-30b-a3b prefill", "bfloat16", 4096, 2048),
    ("musicgen-large prefill", "bfloat16", 16384, 2048),
    ("pixtral-12b prefill", "bfloat16", 16384, 5120),
    ("granite-8b decode", "bfloat16", 128, 4096),
    ("pixtral-12b decode", "bfloat16", 128, 5120),
    ("qwen3-moe-30b-a3b decode", "bfloat16", 128, 2048),
    ("zamba2-7b decode", "bfloat16", 32, 3584),
    ("zamba2-7b decode out_norm", "bfloat16", 32, 7168),
    ("xlstm-1.3b prefill norm", "bfloat16", 16384, 2048),
    ("xlstm-1.3b prefill out_norm", "bfloat16", 16384, 4096),
    ("xlstm-1.3b decode norm", "bfloat16", 32, 2048),
    ("xlstm-1.3b decode out_norm", "bfloat16", 32, 4096),
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
    ("qwen3-moe-30b-a3b 128x1024", "bfloat16", 128, 1024, 32, 4, 128, 0, 0.0, False),
    ("musicgen-large 32x4096 ragged", "bfloat16", 32, 4096, 32, 32, 64, 0, 0.0, True),
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
    ("qwen3-moe-30b-a3b 128x1024", 128, 1024, 32, 4, 128),
    ("moonshot-v1-16b-a3b 32x1024", 32, 1024, 16, 16, 128),
    ("musicgen-large 32x4096", 32, 4096, 32, 32, 64),
    ("pixtral-12b 128x2048", 128, 2048, 32, 8, 128),
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
#: the MoE, audio and VLM serving phases, each model at full width and
#: depth: ``prefill`` (requests, positions) under ``pallas``, then
#: ``decode_ctx`` (requests, cache length); ``walk``: the prefill and the
#: decode step at context walked layer by layer (the MoE models).
#: qwen3-moe-30b-a3b, 61.1 GB of bf16 weights (48 layers, 128 experts,
#: top-8): prefill 2 x 2048, since ``moe_dense`` materialises (E, T, 2F)
#: and (E, T, D) a layer, 128·4096·1536·2 B = 1.6 GB and 128·4096·2048·2 B
#: = 2.15 GB at 4096 tokens, 6.4 and 8.6 GB at 4 x 4096, which does not
#: fit beside the weights; decode 128 x 1024 = 131072 cached tokens, K/V
#: 48·4·128·2·2 B = 98304 B a token, 12.9 GB (decode_32k's 128 x 32768
#: would be 412 GB)
QWEN3_SERVE = dict(prefill=(2, 2048), decode_ctx=((128, 1024),), walk=True)
#: moonshot-v1-16b-a3b, 57.8 GB (64 experts, top-6, 2 shared: the only
#: path with shared experts): prefill 2 x 2048 for the same reasons;
#: decode 32 x 1024 = 32768 tokens at 48·16·128·2·2 B = 393216 B, 12.9 GB
MOONSHOT_SERVE = dict(prefill=(2, 2048), decode_ctx=((32, 1024),),
                      walk=True)
#: musicgen-large, 6.5 GB (audio stub: frame embeddings in, ``{"embeds"}``):
#: prefill 4 x 4096, flash attention's tensor-core route at bf16 hd 64;
#: decode 32 x 4096 = 131072 tokens at 393216 B, 51.5 GB
MUSICGEN_SERVE = dict(prefill=(4, 4096), decode_ctx=((32, 4096),),
                      walk=False)
#: pixtral-12b, 24.5 GB (vision stub): prefill 4 requests of 1024 patch
#: embeddings + 3072 text tokens; decode 128 x 2048 = 262144 tokens (as
#: granite's) at 40·8·128·2·2 B = 163840 B, 42.9 GB
PIXTRAL_SERVE = dict(prefill=(4, 4096), decode_ctx=((128, 2048),),
                     walk=False)
#: xlstm-1.3b, 9.28 GB of bf16 weights (48 blocks, every 8th sLSTM; the
#: reference's tree gives every block both kinds' leaves, 4637886848
#: parameters): prefill 4 x 4096, as granite's; decode at 32 requests,
#: each at position 4095 of a random f32 state (the state does not grow
#: with the context: 705 MB a request over the 42 mLSTM blocks, 22.5 GB
#: at 32); ``recurrence``: the chunked prefill's logits at every position
#: against the decode steps' from an empty state, on (requests,
#: positions), two mLSTM chunks
XLSTM_SERVE = dict(prefill=(4, 4096), decode_ctx=((32, 4096),),
                   recurrence=(2, 512))
#: the blocks whose chunked prefill ``walk_xlstm`` holds to their decode
#: recurrence: the first 8, seven mLSTM and the first sLSTM block (all 48
#: took 22.758799921999923 s, one position at a time, on an H100 at
#: 700 W)
XLSTM_RECURRENCE_BLOCKS = 8
#: the families whose full-depth model on random weights is chaotic: a
#: difference of one bf16 rounding grows block by block (xLSTM's kernel
#: stream against the plain one, each carrying its own residual: 0.0030
#: of max |output| after 1 block, 0.185 after 8, 0.69 after 16, 1.2 after
#: 48, on an H100 at 700 W), so two equally correct
#: plain paths end uncorrelated.  Their end-to-end logits are printed,
#: not held; the kernels are held block by block on the lead plain
#: stream's input (``walk_xlstm``, ``walk_decode_xlstm``), the decode
#: recurrence too
FORCED_WALK_FAMILIES = ("ssm",)
#: the depths at which ``walk_xlstm`` prints the natural kernel stream's
#: distance from the lead plain stream (each carrying its own residual)
XLSTM_DEPTHS = (1, 2, 4, 8, 16, 32, 48)
#: the mLSTM chunk of xLSTM's second plain prefill: it has no attention,
#: so the two plain paths (``_plain_prefills``) are the chunked form at
#: the model's 256 positions and at this many, the same function summed
#: in another order
XLSTM_PLAIN_CHUNK = 128
FAMILY_SERVE = {"qwen3-moe-30b-a3b": QWEN3_SERVE,
                "moonshot-v1-16b-a3b": MOONSHOT_SERVE,
                "musicgen-large": MUSICGEN_SERVE,
                "pixtral-12b": PIXTRAL_SERVE}
#: prefill (requests, positions) of each served model
#: the mesh path: one NCCL rank on a (1, 1) ("data", "model") mesh, the
#: port's DTensor placements from ``launch.shardings.assemble``.  The
#: serving model on it (the one ``serve_families`` built, placed in place:
#: on one rank every placement is a view) and its decode shape; the
#: trained model (the train phase's run, after its steps)
MESH_SERVE, MESH_TRAIN = "qwen3-moe-30b-a3b", "granite-8b"
MESH_DECODE = (128, 1024)
#: timed runs of the mesh prefill and decode step, each after a held or
#: recorded run of the same step
MESH_REPEATS = 2
#: the mesh train step against the same step off the mesh: its loss and
#: grad norm (relative) and each weight's change (of the change off the
#: mesh), near rounding (the loss read equal bit for bit on an H100 at
#: 700 W); the first MoE layer under EP at a capacity that drops nothing
#: against ``moe_dense`` (of max |y|)
MESH_TRAIN_RTOL, MESH_LAYER_TOL = 1e-5, 2e-2
#: the dryrun path's CLI runs: (archs, shapes, mesh, ``--set``), one
#: child process each, all started together.  The four cells that raised
#: before the uneven-shard repairs (granite-8b train_4k and decode_32k,
#: qwen3-moe-30b-a3b decode_32k, xlstm-1.3b prefill_32k), a multi-pod
#: cell, and every kind; granite's train step cut to 4 of 36 layers and
#: xLSTM's prefill to 7 of 48 blocks (its first sLSTM block is the 8th,
#: whose position loop alone takes minutes on meta DTensors), to keep the
#: path's CPU time inside its budget
DRYRUN_CELLS = (
    ("granite-8b", "decode_32k", "single", ""),
    ("granite-8b", "prefill_32k", "single", ""),
    ("qwen3-moe-30b-a3b", "decode_32k", "single", ""),
    ("granite-8b", "decode_32k", "multi", ""),
    ("granite-8b", "train_4k", "single", "n_layers=4"),
    ("xlstm-1.3b", "prefill_32k", "single", "n_layers=7"),
)
#: seconds a dry-run child may take, from its start to its records, and
#: the smoke waits for it once collecting
DRYRUN_TIMEOUT = 90
#: the train run beside which the dry run's children run (they use no
#: card): musicgen-large's, whose step keeps the card busy (idle 0.033 of
#: a profiled step on an H100 at 700 W) and whose steps are not profiled;
#: granite-8b's step (the stream phase's yardstick) and the host-bound
#: xLSTM's run alone
DRYRUN_BESIDE = "musicgen-large"
#: the served model whose prefill the dry run's count is checked on, and
#: its timed runs (three runs read 2.5789–2.5799 s on an H100)
DRYRUN_SERVE = "granite-8b"
DRYRUN_REPEATS = 2
PREFILL = {"granite-8b": (PREFILL_BATCH, PREFILL_LEN),
           "zamba2-7b": (PREFILL_BATCH, PREFILL_LEN),
           "xlstm-1.3b": XLSTM_SERVE["prefill"],
           **{a: c["prefill"] for a, c in FAMILY_SERVE.items()}}
DECODE_CTX = {"granite-8b": ((128, 2048), (32, 8192)),
              "zamba2-7b": ((32, 4096), (8, 16384)),
              "xlstm-1.3b": XLSTM_SERVE["decode_ctx"],
              **{a: c["decode_ctx"] for a, c in FAMILY_SERVE.items()}}
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
#: the MoE models' walks (48 layers).  Their routing is discontinuous: an
#: expert flips wherever a token's k-th and (k+1)-th router logits lie
#: closer than two streams' difference, and a flipped expert moves that
#: token's residual by far more than rounding does, so deep logits of two
#: equally correct streams may differ by more than the limits.  The held
#: streams therefore take the lead plain stream's experts at every layer
#: (``_routing``), and each layer's own choice is held on one input
#: (``_hold_moe_layer``); the natural streams are printed beside them,
#: with the requests whose experts flipped
MOE_DEPTHS = (1, 2, 4, 12, 24, 48)
#: a kernel against its plain version in float32 on the same values,
#: element by element: twice the largest error of one rounding of the
#: output to bf16 (2^-8 relative), plus float32 accumulation of at most
#: ROW_ATOL of the row's RMS
ROW_ATOL = 1e-4
#: the train phase's full-width runs, as ``launch/train.run`` drives
#: them: (arch, config fields cut, steps, microbatches).  Width uncut;
#: depth cut so that 16 B a parameter (the f32 master, its f32 grad,
#: which also accumulates the microbatches, and Adam's m and v) and the
#: activations fit in 80 GB: granite-8b to 8 of 36 layers (2147553280
#: parameters, 34.4 GB; all 36 would need 132 GB), zamba2-7b to 13 of 81
#: Mamba2 layers, two macro-blocks of 6 and one tail layer, so that the
#: shared block is applied twice (1448527632 parameters, 23.2 GB; all 81
#: would need 108 GB); zamba2's 8 microbatches cannot divide a batch of 4;
#: xlstm-1.3b to 8 of 48 blocks, so that block 7 is its one sLSTM block
#: (944687168 parameters, 15.1 GB; all 48, 4637886848 parameters, would
#: need 74.2 GB before any activation), in its config's one microbatch,
#: since each microbatch runs the sLSTM's 4096 positions one at a time
#: again; 12 steps, since 8 in 4 microbatches lowered the loss by 0.24
#: (on an H100 at 700 W).  granite-8b runs 12 steps, 16 before xLSTM
#: joined the phase, to make room for it.  The MoE, audio and VLM families
#: (counted from the reference's ``abstract_params``): qwen3-moe-30b-a3b
#: to 4 of 48 layers (3114813440 parameters, 49.8 GB; all 48 would need
#: 488.5 GB), moonshot-v1-16b-a3b to 4 of 48 (3022538752, 48.4 GB; 462.2
#: GB), musicgen-large at full depth (3229812736, 51.7 GB), pixtral-12b to
#: 8 of 40 (3523302400, 56.4 GB; 196.0 GB); pixtral's 8 microbatches
#: cannot divide a batch of 4.  Each takes the fewest steps whose last
#: loss lies ``TRAIN_DROP`` below its first with room (the 5-step warmup
#: makes the first 7 losses those of any longer run; 10-step runs on an
#: H100 at 700 W): musicgen 4 (drops 0.094, 0.246, 0.359, 0.301 after
#: 1-4 steps, then a spike), pixtral 4 (0.106, 0.320, 0.836: 3 steps
#: clear the limit by 0.020 only); the MoE models 3, though 2 clear it
#: (qwen3 0.438, moonshot 0.530), so that the median step wall is not
#: the first step's, which pays the run's first use of its shapes
TRAIN_RUNS = (
    ("granite-8b", dict(n_layers=8), 12, 4),
    ("zamba2-7b", dict(n_layers=13, n_macro_blocks=2, tail_mamba_layers=1),
     8, 4),
    ("xlstm-1.3b", dict(n_layers=8), 12, 1),
    ("qwen3-moe-30b-a3b", dict(n_layers=4), 3, 4),
    ("moonshot-v1-16b-a3b", dict(n_layers=4), 3, 4),
    ("musicgen-large", {}, 4, 4),
    ("pixtral-12b", dict(n_layers=8), 4, 4),
)
#: the runs with a profiled step: by kernel kind, and for an MoE model
#: ``moe_dense``'s share of the device time under autograd
TRAIN_PROFILED = ("granite-8b", "zamba2-7b", "xlstm-1.3b",
                  "qwen3-moe-30b-a3b")
#: the remat policies against each other: this run's first TRAIN_DOTS_STEPS
#: steps (remat_policy "full", its config's) again under "dots" from the
#: same weights and batches: the first loss equal, the grad norms within
#: TRAIN_DOTS_RTOL relative
TRAIN_DOTS, TRAIN_DOTS_STEPS, TRAIN_DOTS_RTOL = "musicgen-large", 2, 1e-5
#: train_4k's sequence (``configs/shapes.py``); its batch of 256 cut to 4
TRAIN_BATCH, TRAIN_SEQ = 4, 4096
#: ``launch/train.py``'s peak learning rate for the full-width runs
TRAIN_LR = 3e-4
#: the first loss of a full-width run lies within [ln V - 0.5, ln V + 2],
#: and the last at least this far below it (``tests/test_train_loop.py``'s
#: own margin)
TRAIN_DROP = 0.3
#: the GPU-against-CPU train check: smoke configs with remat, 2
#: microbatches, 3 steps of (batch, seq) at this learning rate; losses and
#: grad norms within TRAIN_XDEV_RTOL relative, and each weight's trained
#: change ``dW = w_3 - w_0`` within TRAIN_XDEV_DW of the CPU's,
#: ``||dW_gpu - dW_cpu|| / ||dW_cpu||`` (bf16 activations round
#: differently on the two devices; a step that updates nothing reads 1.0)
TRAIN_XDEV = dict(archs=("granite-8b", "zamba2-7b", "xlstm-1.3b",
                         "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b",
                         "musicgen-large", "pixtral-12b"),
                  steps=3, M=2, batch=4, seq=64, lr=1e-3)
TRAIN_XDEV_RTOL = 2e-2
TRAIN_XDEV_DW = 0.3
#: the stream phase's entry-point run, ``launch.train.run`` at the
#: reference's own streamed test (``tests/test_train_loop.py``'s
#: ``test_streamed_training_with_crash_and_feedback``): granite-8b-smoke,
#: 14 steps of 4 x 16 tokens, a consumer crash at step 6, feedback every 5
STREAM_RUN = dict(arch="granite-8b-smoke", steps=14, batch=4, seq=16,
                  lr=2e-3, seed=0, microbatches=1, data="stream",
                  ckpt_dir="", ckpt_every=50, resume=True, log_every=100,
                  feedback_every=5, crash_consumer_at=6)
#: the stream phase's full-width run: the train phase's granite-8b cut
#: (``TRAIN_RUNS[0]``, ``TRAIN_BATCH`` x ``TRAIN_SEQ``, ``TRAIN_LR``)
#: on the stream of ``launch.train.make_stream``'s defaults (2 Dstream
#: producers at 500 msgs/s, 2 consumers): STREAM_STEPS steps, a consumer
#: crash at step STREAM_CRASH_AT, feedback every STREAM_FEEDBACK_EVERY
#: steps, then one profiled step.  Its losses lie within the first-loss
#: band [ln V - 0.5, ln V + 2]: tokens drawn from SHA-256 payloads are
#: uniform, so there is nothing to learn below ln V
STREAM_STEPS, STREAM_CRASH_AT, STREAM_FEEDBACK_EVERY = 10, 5, 2


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
    every norm (xLSTM: ``norm`` and ``out_norm`` of each block and
    ``final_norm``)."""
    if cfg.family == "hybrid":
        attn, ssd = cfg.n_macro_blocks, cfg.n_layers
        norms = 2 * cfg.n_layers + 2 * attn + 1
    elif cfg.family == "ssm":
        attn, ssd = 0, 0
        norms = 2 * cfg.n_layers + 1
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
    tensor-core kernel), each timed beside its bound (its bytes, and the
    visible pairs' operations at the dtype's peak); at granite-8b's and
    zamba2-7b's prefill shapes,
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
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
            + 2 * pos.numel() * 4
        flops = 4 * B * H * hd * _visible_pairs(pos, causal, window)
        rows.append(dict(case=case, route=route,
                         **_hold(got, q, k, v, pos, kw, case),
                         ms=_cuda_ms(lambda: flash_attention(
                             q, k, v, pos, pos, **kw), 3, 3),
                         bound_ms=_bound(nbytes, flops, BF16_FLOPS if
                                         dtype == "bfloat16" else F32_FLOPS
                                         )["bound_ms"]))
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
    2e-2, f32 1e-5).  Each case is timed two ways, the kernel and one
    ``F.rms_norm`` call (weight ``1 + w`` in x's dtype, made outside the
    timing, so that it takes its fused path) alike: the call, ``ms``
    (``_cuda_ms``: CUDA events around a host loop, so at decode's few
    rows the host's cost a call) and the device time, ``device_ms``
    (``_graph_ms``: the calls captured in one CUDA graph); beside them the
    bytes bound and the C entry point's plan (route, threads, grid,
    registers).  The plain version is timed at the first case."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import plan, rmsnorm, rmsnorm_ref
    g = torch.Generator(dev).manual_seed(1)
    rows, first = [], None
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
        w1 = (1 + w).to(x.dtype)
        kernel = functools.partial(rmsnorm, x, w)
        library = functools.partial(F.rms_norm, x, (D,), w1, 1e-6)
        # bytes: x read once, y written once, w read once; five operations
        # an element (square-add, scale, 1 + w, product) in f32
        bound = _bound(2 * x.numel() * x.element_size() + 4 * D,
                       5 * x.numel(), F32_FLOPS)
        rows.append(dict(
            case=case, dtype=dtype, rows=R, D=D,
            max_abs_err=diff.max().item(), tol=tol,
            ms=_cuda_ms(kernel, 20), device_ms=_graph_ms(kernel, 20),
            library_ms=_cuda_ms(library, 20),
            library_device_ms=_graph_ms(library, 20),
            bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
            plan=plan(x, w, got)))
        if first is None:
            first = (x, w)
        del x, w, got, want, diff, w1, kernel, library
    x, w = first
    plain_ms = _cuda_ms(lambda: rmsnorm_ref(x, w), 20)
    top = rows[0]
    return dict(name="rmsnorm", route="cuda",
                source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm.py:23", launches=0,
                max_abs_err=top["max_abs_err"], ms=top["ms"],
                device_ms=top["device_ms"], plain_ms=plain_ms,
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=top["library_ms"],
                library_device_ms=top["library_device_ms"], cases=rows,
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


def _prefill_batch(cfg, B: int, S: int, dev):
    """One prefill's input from seed 1: token ids (B, S), or, for the
    audio and VLM frontends, ``zoo.make_batch``'s frame embeddings or
    patch embeddings before ids (S positions in all), without labels."""
    import torch
    from repro_torch.models import zoo
    g = torch.Generator(dev).manual_seed(1)
    if cfg.family in ("audio", "vlm"):
        batch = zoo.make_batch(cfg, g, B, S)
        del batch["labels"]
        return batch
    return torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev,
                         dtype=torch.int32)


def drive_prefill(model, init_s: float) -> tuple:
    """Serving path, prefill: ``build_prefill_step(last_only=True)`` under
    ``attention_impl="pallas"`` on the model's ``PREFILL`` requests x
    positions (``_prefill_batch``), warm, timed ``WALL_REPEATS`` times,
    every kernel's launches counted from 0 for each; then the same
    prefill with each plain attention (``reference``: every layer plain;
    ``blocked``), compared.  Returns the row, the batch and one run's
    launches."""
    import torch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.sharding import ModelContext
    cfg, dev = model.cfg, model.device
    n_params = sum(p.numel() for p in model.parameters())
    B, S = PREFILL[cfg.name]
    tokens = _prefill_batch(cfg, B, S, dev)
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
    if logits.shape != (B, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits: shape {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    other = _plain_prefills(model, tokens)
    ref, blk = other["reference"], other["blocked"]
    scale = ref.abs().max().item()
    wall = statistics.median(walls)
    row = dict(arch=cfg.name, family=cfg.family, layers=cfg.n_layers,
               d_model=cfg.d_model, params=n_params, batch=B, prompt=S,
               init_s=init_s, wall_s=wall, wall_s_runs=walls,
               tokens_s=B * S / wall,
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


@contextlib.contextmanager
def _mlstm_chunk(chunk: int):
    """While inside, the xLSTM prefill's mLSTM runs its chunked form over
    ``chunk`` positions (``models.xlstm.MLSTM_CHUNK``)."""
    from repro_torch.models import xlstm
    orig, xlstm.MLSTM_CHUNK = xlstm.MLSTM_CHUNK, chunk
    try:
        yield
    finally:
        xlstm.MLSTM_CHUNK = orig


def _plain_prefills(model, tokens) -> dict:
    """The prefill's last-position logits (f32) on the two plain paths:
    ``reference`` (every layer plain) and ``blocked`` (attention over KV
    blocks).  xLSTM has no attention: its ``blocked`` is the reference's
    path with the mLSTM over ``XLSTM_PLAIN_CHUNK``-position chunks."""
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.sharding import ModelContext
    ssm = model.cfg.family == "ssm"
    out = {}
    for impl in ("reference", "blocked"):
        ctx = ModelContext(attention_impl="reference" if ssm else impl)
        with (_mlstm_chunk(XLSTM_PLAIN_CHUNK) if ssm and impl == "blocked"
              else contextlib.nullcontext()):
            out[impl] = build_prefill_step(model, ctx, last_only=True)(
                tokens).float()
    return out


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
    ``PREFILL_RTOL`` of max |logit|; and on every request whose reference
    top-two gap exceeds the plain paths' spread there, the same next token
    as both.  Where the two plain paths themselves pick different tokens
    on such a request (a gap above the spread may lie below twice it, and
    each path's logits move by up to the spread), the kernels' token must
    be one of theirs.  A closer request is a tie within rounding, so it is
    printed, not held; at least one request must be held.  For a family of
    ``FORCED_WALK_FAMILIES`` the readings are printed, not held: its
    walks hold the kernels block by block."""
    scale = row["logits_max_abs"]
    if row["family"] in FORCED_WALK_FAMILIES:
        print(f"serve prefill argmax: {row['arch']} printed, not held (the "
              f"plain paths {row['dev_blocked_vs_reference']} of "
              f"{scale} apart):", json.dumps(row["requests"]))
        return
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
        _hold_next_token(r["kernels"], r["reference"], r["blocked"],
                         f"{row['arch']} prefill request {r['request']} "
                         f"(gap {r['gap']} > spread {r['plain_spread']}): "
                         f"{r}")


def _hold_next_token(got: int, want: int, want2: int, what: str) -> None:
    """A held request's next token: equal to both plain paths' where they
    agree, one of theirs where they do not."""
    if got != want if want == want2 else got not in (want, want2):
        raise AssertionError(f"{what}: next tokens differ, kernels {got}, "
                             f"plain {want} and {want2}")


def _last_logits(model, x):
    """The vocab head on the last position of the residual stream ``x``,
    as ``TransformerLM.forward(last_only=True)`` computes it."""
    from repro_torch.models import layers as L
    h = L.rmsnorm(x[:, -1:], model.final_norm)
    return L.unembed(h, model.head(), model.cfg.final_logit_softcap)[:, 0].float()


def _hold_moe_layer(blk, x1: dict, ctxs: dict) -> dict:
    """An MoE layer held on one input: ``x1`` holds, under ``"pallas"``
    and one plain name, the input plus that path's attention output, both
    from the same input.  Where a token's top-k experts agree, the two
    block outputs lie within ``SHALLOW_RTOL`` of max |output| (one layer,
    no amplification); where they differ, the flip is one rounding
    explains: the plain path's gap between its k-th and (k+1)-th router
    logits at that token at most twice the largest difference between the
    two paths' router logits there.  Returns the flips and the
    readings."""
    from repro_torch.models import layers as L
    cfg, k = blk.cfg, blk.cfg.experts_per_token
    plain = next(n for n in x1 if n != "pallas")
    logits, out = {}, {}
    for name, x in x1.items():
        h = L.rmsnorm(x, blk.mlp_norm, ctx=ctxs[name])
        logits[name] = h.reshape(-1, cfg.d_model).float() @ blk.router
        out[name] = blk._mlp(x, ctxs[name]).reshape(-1, cfg.d_model).float()
    ref = logits[plain]
    top = {n: lg.topk(k, dim=-1).indices.sort(-1).values
           for n, lg in logits.items()}
    same = (top["pallas"] == top[plain]).all(-1)
    srt = ref.topk(k + 1, dim=-1).values
    gap = srt[:, k - 1] - srt[:, k]
    ldiff = (logits["pallas"] - ref).abs().amax(-1)
    flips = ~same
    diff = (out["pallas"] - out[plain]).abs().amax(-1)
    scale = out[plain].abs().max().item()
    agreed = diff[same].max().item() if bool(same.any()) else 0.0
    row = dict(tokens=int(same.numel()), flips=int(flips.sum().item()),
               unexplained_flips=int((flips & (gap > 2 * ldiff)).sum().item()),
               agreed_rel=agreed / scale,
               flipped_rel=(diff[flips].max().item() / scale
                            if bool(flips.any()) else 0.0),
               router_logit_diff=ldiff.max().item())
    if row["unexplained_flips"] or not agreed <= SHALLOW_RTOL * scale:
        raise AssertionError(f"MoE layer on one input, kernels vs {plain}: "
                             f"{row}")
    return row


def _moe_summary(rows: list) -> dict:
    """``_hold_moe_layer``'s readings over a walk's layers."""
    return dict(flips=sum(r["flips"] for r in rows),
                tokens=sum(r["tokens"] for r in rows),
                agreed_rel_max=max(r["agreed_rel"] for r in rows),
                flipped_rel_max=max(r["flipped_rel"] for r in rows),
                router_logit_diff_max=max(r["router_logit_diff"]
                                          for r in rows),
                by_layer=[(r["layer"], r["flips"]) for r in rows])


@contextlib.contextmanager
def _routing(lead: "list | None" = None):
    """While inside, every MoE layer's own expert choice (``router_probs``'
    top-k indices, (tokens, k), in call order) is appended to the list
    this yields.  With ``lead``, the choices recorded by another run of
    the same layers, each layer's experts are forced to ``lead``'s at that
    call, with its own probabilities there as gates, renormalised as
    ``router_probs`` does: the streams then differ only by the rounding of
    continuous functions, not by discrete expert flips."""
    import torch
    from repro_torch.models import moe
    orig, own = moe.router_probs, []

    def routed(x, w_router, k):
        gates, idx, probs = orig(x, w_router, k)
        own.append(idx)
        if lead is None:
            return gates, idx, probs
        idx = lead[len(own) - 1]
        gates = probs.gather(1, idx)
        return (gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9),
                idx, probs)

    moe.router_probs = routed
    try:
        yield own
    finally:
        moe.router_probs = orig


def _flipped(own: list, lead: list, batch: int):
    """(batch,) bool: the requests with a token whose top-k experts in
    ``own`` differ from ``lead``'s at any recorded layer."""
    out = None
    for a, b in zip(own, lead, strict=True):
        f = (a.sort(-1).values != b.sort(-1).values).any(-1)
        f = f.reshape(batch, -1).any(-1)
        out = f if out is None else out | f
    return out


#: a walk's forced streams: each named after the stream it copies, its
#: experts forced to the lead stream's at every layer (``_routing``)
FORCED = "="


def _advance(cfg, xs: dict, step: dict, lead: str, flipped: dict) -> dict:
    """One layer of a walk's streams: ``step[name]`` runs the layer on
    stream ``name``'s residual, the lead first.  For an MoE model a name
    ending in ``FORCED`` runs its base stream's step with the experts
    forced to the lead's at this layer; ``flipped[name]`` (requests) gains
    those where the stream's own experts, on its own input, left the
    lead's.  Returns the new residuals."""
    if not cfg.is_moe:
        return {n: step[n](x) for n, x in xs.items()}
    with _routing() as lead_idx:
        out = {lead: step[lead](xs[lead])}
    B = xs[lead].shape[0]
    for name, x in xs.items():
        if name == lead:
            continue
        forced = name.endswith(FORCED)
        with _routing(lead_idx if forced else None) as own:
            out[name] = step[name.rstrip(FORCED)](x)
        f = _flipped(own, lead_idx, B)
        flipped[name] = f if name not in flipped else flipped[name] | f
    return out


def _depth_point(depth: int, lg: dict, pairs: dict, lead: str,
                 flipped: dict) -> dict:
    """The readings at one depth: for each of ``pairs`` (key: the two
    streams), max |logit difference| over max |logit| of the lead stream,
    over every request.  With ``flipped`` (an MoE model's natural
    streams), also the requests where either stream's experts left the
    lead's at some layer so far, and the reading over the others."""
    scale = lg[lead].abs().max().item()
    pt = dict(depth=depth, logits_max_abs=scale)
    for key, (a, b) in pairs.items():
        per = (lg[a] - lg[b]).abs().amax(-1)
        pt[key] = per.max().item() / scale
        if flipped:
            f = flipped.get(a, False) | flipped.get(b, False)
            pt[f"{key}_flipped"] = int(f.sum().item())
            pt[f"{key}_unflipped"] = (per[~f].max().item() / scale
                                      if bool((~f).any()) else None)
            pt[f"{key}_at_max_flipped"] = bool(f[per.argmax()].item())
    return pt


def _hold_curve(curve: list, plains: tuple, what: str) -> None:
    """A walk's logits by depth: the kernels' stream within
    ``SHALLOW_RTOL`` of each plain stream after the first layer and
    within ``PREFILL_RTOL`` at every depth."""
    for pt in curve:
        limit = SHALLOW_RTOL if pt["depth"] == 1 else PREFILL_RTOL
        for o in plains:
            if not pt[f"flash_vs_{o}"] <= limit:
                raise AssertionError(
                    f"{what} after {pt['depth']} layers, kernels vs {o}: "
                    f"{pt[f'flash_vs_{o}']} of max |logit| > {limit}")


def _walk_streams(cfg, names: tuple) -> tuple:
    """A walk's stream names, the held pairs and the natural pairs.  For
    a dense model the three natural streams are the held ones.  For an
    MoE model the kernels' stream and the second plain stream run twice,
    with their own experts and forced to the lead's (``FORCED``): the
    forced streams are held, the natural ones printed with their flips."""
    flash, lead, other = names
    pair = lambda f, o: {f"flash_vs_{lead}": (f, lead),  # noqa: E731
                         f"flash_vs_{other}": (f, o),
                         f"{other}_vs_{lead}": (o, lead)}
    natural = pair(flash, other)
    if not cfg.is_moe:
        return names, natural, {}
    streams = names + (flash + FORCED, other + FORCED)
    return streams, pair(flash + FORCED, other + FORCED), natural


def walk_layers(model, tokens, depths: tuple = DEPTHS) -> dict:
    """One prefill walked layer by layer three times over, each stream
    carrying its own residual: under ``pallas`` (the kernels), with the
    reference attention and with the blocked attention.  At every layer
    the flash kernel is held (``_hold``) on the reference stream's own q,
    k, v, and an MoE layer also on the reference stream's input
    (``_hold_moe_layer``).  At each of ``depths`` the three streams'
    last-position logits are compared, over max |logit| of the reference
    stream: how the spread between equally correct paths grows with
    depth.  After the first layer the kernels must lie within
    ``SHALLOW_RTOL`` of each plain path, at every depth within
    ``PREFILL_RTOL`` (``_hold_curve``).  For an MoE model the held
    streams take the reference stream's experts at every layer
    (``_walk_streams``); the natural streams' readings and flips are
    printed beside them.  These launches are checks, not the main
    path's."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import ModelContext
    ctxs = {impl: ModelContext(attention_impl=impl)
            for impl in ("pallas", "reference", "blocked")}
    streams, held, natural = _walk_streams(
        model.cfg, ("pallas", "reference", "blocked"))
    pos = torch.arange(tokens.shape[1], device=tokens.device,
                       dtype=torch.int32)
    cfg = model.cfg
    cap = cfg.attn_logit_softcap
    worst = dict(max_abs_err=0.0, row_rel_err=0.0, row_limit_used=0.0)
    curve, moe_rows, flipped = [], [], {}
    with torch.no_grad():
        xs = dict.fromkeys(streams, L.embed(tokens, model.embed))
        for i, (blk, window) in enumerate(zip(model.blocks, model.windows)):
            q, k, v = blk._attn_proj(
                L.rmsnorm(xs["reference"], blk.attn_norm), pos)
            kw = dict(causal=True, window=window, logit_cap=cap)
            got = flash_attention(q, k, v, pos, pos, **kw)
            r = _hold(got, q, k, v, pos, kw, f"layer {i}'s q, k, v")
            worst = {key: max(val, r[key]) for key, val in worst.items()}
            del got, q, k, v
            if cfg.is_moe:
                x1 = {n: blk.attend(xs["reference"], window, pos, ctxs[n])
                      for n in ("pallas", "reference")}
                moe_rows.append(dict(layer=i,
                                     **_hold_moe_layer(blk, x1, ctxs)))
                del x1
            step = {n: functools.partial(blk, window=window, positions=pos,
                                         ctx=ctxs[n]) for n in ctxs}
            xs = _advance(cfg, xs, step, "reference", flipped)
            if i + 1 not in depths:
                continue
            lg = {n: _last_logits(model, x) for n, x in xs.items()}
            pt = _depth_point(i + 1, lg, held, "reference", {})
            if natural:
                pt["natural"] = _depth_point(i + 1, lg, natural, "reference",
                                             flipped)
            curve.append(pt)
    _hold_curve(curve, ("reference", "blocked"), "logits")
    out = dict(arch=cfg.name, layers=len(model.blocks),
               tol=_attn_tol("bfloat16", 0, 0.0), row_atol=ROW_ATOL,
               **worst, shallow_rtol=SHALLOW_RTOL, rtol=PREFILL_RTOL,
               by_depth=curve)
    if moe_rows:
        out["moe_layers"] = _moe_summary(moe_rows)
    return out


#: the decode walk's (requests, cache length): granite's first
#: ``DECODE_CTX`` shape
WALK_DECODE = (128, 2048)


def _decode_attention_plain2(blk, x, k_l, v_l, pos, window):
    """``Block.decode`` with its attention replaced by the second plain
    decode attention: ``flash_attention_ref`` at S = 1, the query at
    ``pos`` (the same for every request) over every cached key, masked
    causally and by the window (probabilities in v's dtype, as the
    reference's ``attention_reference``), 32 requests at a time, which
    bounds its expanded f32 keys."""
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
    a = torch.cat([flash_attention_ref(
        q[b:b + 32], k_l[b:b + 32], v_l[b:b + 32], pos[:1],
        torch.arange(T, device=x.device), causal=True, window=window,
        logit_cap=cfg.attn_logit_softcap) for b in range(0, B, 32)])
    a = a.reshape(B, cfg.n_heads * cfg.hd) @ blk.wo
    if cfg.post_norms:
        a = L.rmsnorm(a, blk.post_attn_norm)
    return blk._mlp(x + a[:, None], ModelContext())


def walk_decode(model, shape: tuple = WALK_DECODE,
                depths: tuple = DEPTHS) -> dict:
    """One decode step against a full cache of ``shape`` (requests, cache
    length; random keys, values and tokens from a seed, every request at
    the last position), walked layer by layer three times over, each
    stream with its own residual: under ``pallas`` (flash decode and the
    kernels' norms), with the grouped einsum (``flash_decode_ref``) and
    with the second plain decode attention (``_decode_attention_plain2``).
    Each stream writes its own key and value at ``pos`` before it
    attends.  At every layer flash decode is held (``_hold_rows``) on the
    einsum stream's own q and cache, and an MoE layer on the einsum
    stream's input (``_hold_moe_layer``, the attention halves under
    ``pallas`` and with the einsum).  At each of ``depths`` the streams'
    logits are compared over max |logit| of the einsum stream: after the
    first layer the kernels must lie within ``SHALLOW_RTOL`` of each plain
    path, at every depth within ``PREFILL_RTOL`` (``_hold_curve``).  For
    an MoE model the held streams take the einsum stream's experts at
    every layer (``_walk_streams``); the natural streams' readings, with
    the requests whose experts flipped, are printed beside them.  These
    launches are checks, not the main path's."""
    import torch
    from repro_torch.kernels.decode_attention import (
        flash_decode, flash_decode_ref)
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import ModelContext
    from repro_torch.models.transformer import _cache_write
    cfg, dev = model.cfg, model.device
    B, T = shape
    g = torch.Generator(dev).manual_seed(4)
    cache = model.init_cache(B, T)
    _fill_cache(cache, g)
    tokens = torch.randint(0, cfg.vocab_size, (B,), generator=g, device=dev,
                           dtype=torch.int32)
    pos = torch.full((B,), T - 1, dtype=torch.int32, device=dev)
    pallas, plain = ModelContext(attention_impl="pallas"), ModelContext()
    ctxs = {"pallas": pallas, "einsum": plain}
    streams, held, natural = _walk_streams(cfg, ("flash", "einsum", "plain2"))
    cap = cfg.attn_logit_softcap
    worst = dict(max_abs_err=0.0, row_rel_err=0.0, row_limit_used=0.0)
    curve, moe_rows, flipped = [], [], {}
    with torch.no_grad():
        xs = dict.fromkeys(streams, L.embed(tokens[:, None], model.embed))
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
            if cfg.is_moe:
                x1 = {n: blk.decode_attend(xs["einsum"], k_l, v_l, pos,
                                           window, c) for n, c in ctxs.items()}
                moe_rows.append(dict(layer=i,
                                     **_hold_moe_layer(blk, x1, ctxs)))
                del x1
            step = {"flash": functools.partial(blk.decode, k_l=k_l, v_l=v_l,
                                               pos=pos, window=window,
                                               ctx=pallas),
                    "einsum": functools.partial(blk.decode, k_l=k_l, v_l=v_l,
                                                pos=pos, window=window,
                                                ctx=plain),
                    "plain2": functools.partial(_decode_attention_plain2,
                                                blk, k_l=k_l, v_l=v_l,
                                                pos=pos, window=window)}
            xs = _advance(cfg, xs, step, "einsum", flipped)
            if i + 1 not in depths:
                continue
            lg = {name: _last_logits(model, x) for name, x in xs.items()}
            pt = _depth_point(i + 1, lg, held, "einsum", {})
            pt["argmax_agree"] = {
                a: float((lg[a].argmax(-1) == lg["einsum"].argmax(-1))
                         .float().mean().item()) for a in lg}
            if natural:
                pt["natural"] = _depth_point(i + 1, lg, natural, "einsum",
                                             flipped)
            curve.append(pt)
    _hold_curve(curve, ("einsum", "plain2"), "decode logits")
    del cache
    torch.cuda.empty_cache()
    out = dict(arch=cfg.name, batch=B, cache_len=T, layers=len(model.blocks),
               tol=_attn_tol("bfloat16", 0, 0.0), row_atol=ROW_ATOL, **worst,
               shallow_rtol=SHALLOW_RTOL, rtol=PREFILL_RTOL, by_depth=curve)
    if moe_rows:
        out["moe_layers"] = _moe_summary(moe_rows)
    return out


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


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def _hold_block(reading: float, what: str) -> None:
    if not reading <= SHALLOW_RTOL:
        raise AssertionError(f"{what}: {reading} of max |output| > "
                             f"{SHALLOW_RTOL}")


def walk_xlstm(model, tokens) -> dict:
    """xLSTM's prefill walked block by block on the lead plain stream
    (``reference``: plain norms, the mLSTM at 256-position chunks).  At
    every block, on the lead's input: (a) the block under ``pallas`` (the
    RMSNorm kernel) and with the mLSTM over ``XLSTM_PLAIN_CHUNK``-position
    chunks, each held within ``SHALLOW_RTOL`` of max |output| of the
    lead's output; (b) on ``XLSTM_SERVE["recurrence"]`` (requests x
    positions, the first of the prefill's), the block's chunked prefill
    against its decode recurrence, one position at a time from an empty
    state, held alike, on the first ``XLSTM_RECURRENCE_BLOCKS`` blocks.
    Then the vocab head on the lead's last position with the kernel's
    final norm against the plain one, held alike.  The
    natural kernel stream, carrying its own residual, is printed at
    ``XLSTM_DEPTHS`` (``FORCED_WALK_FAMILIES``: not held).  The lead's
    block walls (synchronised) give the sLSTM blocks' share of the
    prefill's block time.  These launches are checks, not the main
    path's."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import ModelContext
    from repro_torch.models.xlstm import init_xlstm_state
    ref, ker = (ModelContext(attention_impl=i) for i in ("reference", "pallas"))
    B, S = XLSTM_SERVE["recurrence"]
    rows, curve, walls = [], [], {"mlstm": 0.0, "slstm": 0.0}
    rec_s = 0.0
    with torch.no_grad():
        x = nat = L.embed(tokens, model.embed)
        for i, blk in enumerate(model.blocks):
            kind = "slstm" if blk.is_slstm else "mlstm"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = blk(x, ref)
            torch.cuda.synchronize()
            walls[kind] += time.perf_counter() - t0
            row = dict(block=i, kind=kind,
                       kernels=_rel(blk(x, ker), y))
            with _mlstm_chunk(XLSTM_PLAIN_CHUNK):
                row["plain_chunk"] = _rel(blk(x, ref), y)
            if i < XLSTM_RECURRENCE_BLOCKS:
                t0 = time.perf_counter()
                xr = x[:B, :S]
                state = init_xlstm_state(B, model.cfg.d_model,
                                         model.cfg.n_heads, blk.is_slstm,
                                         model.device)
                stepped = torch.cat([blk(xr[:, t:t + 1], ref, state)
                                     for t in range(S)], 1)
                row["recurrence"] = _rel(stepped, blk(xr, ref))
                rec_s += time.perf_counter() - t0
            for key in ("kernels", "plain_chunk", "recurrence"):
                if key in row:
                    _hold_block(row[key], f"{model.cfg.name} block {i} "
                                          f"({kind}), {key} vs the lead")
            rows.append(row)
            nat = blk(nat, ker)
            x = y
            if i + 1 in XLSTM_DEPTHS:
                curve.append(dict(depth=i + 1, natural_kernels=_rel(
                    nat[:, -1], x[:, -1])))
        lg = [L.unembed(L.rmsnorm(x[:, -1], model.final_norm, ctx=c),
                        model.lm_head) for c in (ker, ref)]
        head = _rel(*lg)
    _hold_block(head, f"{model.cfg.name} vocab head on the lead's stream")
    worst = {key: max(r.get(key, 0.0) for r in rows)
             for key in ("kernels", "plain_chunk", "recurrence")}
    total = walls["mlstm"] + walls["slstm"]
    return dict(arch=model.cfg.name, blocks=len(rows),
                shallow_rtol=SHALLOW_RTOL, worst=worst, head=head,
                recurrence=dict(batch=B, positions=S,
                                blocks=XLSTM_RECURRENCE_BLOCKS, wall_s=rec_s),
                natural_by_depth=curve,
                block_wall_s=walls,
                slstm_share_of_blocks=walls["slstm"] / total, by_block=rows)


def walk_decode_xlstm(model) -> dict:
    """xLSTM's decode step at its ``DECODE_CTX`` (requests) walked block
    by block from a random state (``_fill_cache``) on the lead plain
    stream: at every block, on the lead's input and each from a copy of
    the block's state, the block under ``pallas`` against the plain one,
    its output held within ``SHALLOW_RTOL`` of max |output| and its new
    state's distance printed; then the vocab head with the kernel's final
    norm against the plain one, held alike.  These launches are checks,
    not the main path's."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import ModelContext
    ref, ker = (ModelContext(attention_impl=i) for i in ("reference", "pallas"))
    (B, T), = DECODE_CTX[model.cfg.name]
    g = torch.Generator(model.device).manual_seed(4)
    cache = model.init_cache(B)
    _fill_cache(cache, g)
    tokens = torch.randint(0, model.cfg.vocab_size, (B,), generator=g,
                           device=model.device, dtype=torch.int32)
    rows = []
    with torch.no_grad():
        x = L.embed(tokens[:, None], model.embed)
        for i, (blk, st) in enumerate(zip(model.blocks, cache)):
            kst = tuple(c.clone() for c in st)
            y = blk(x, ref, st)
            row = dict(block=i, kernels=_rel(blk(x, ker, kst), y),
                       state=max(_rel(a, b) for a, b in zip(kst, st)))
            _hold_block(row["kernels"], f"{model.cfg.name} decode {B}x{T} "
                                        f"block {i}, kernels vs the lead")
            rows.append(row)
            x = y
            del kst
        lg = [L.unembed(L.rmsnorm(x[:, 0], model.final_norm, ctx=c),
                        model.lm_head) for c in (ker, ref)]
        head = _rel(*lg)
    del cache
    torch.cuda.empty_cache()
    _hold_block(head, f"{model.cfg.name} decode vocab head")
    return dict(arch=model.cfg.name, batch=B, position=T - 1,
                shallow_rtol=SHALLOW_RTOL,
                worst=max(r["kernels"] for r in rows),
                worst_state=max(r["state"] for r in rows), head=head,
                by_block=rows)


def _activities(cfg) -> list:
    """The profiler's activities for a prefill or a train step of
    ``cfg``: the device's and the host's, but the device's alone for
    xLSTM, whose sLSTM blocks launch about 11 kernels a position (303076
    device events a prefill on an H100), so that the host's
    events do not multiply the trace the profiler processes."""
    from torch.profiler import ProfilerActivity
    if cfg.family == "ssm":
        return [ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def profile_prefill(model, tokens) -> dict:
    """Device busy time and the top kernels of one warm prefill under
    ``pallas``, from ``torch.profiler`` (``_activities``)."""
    import torch
    from torch.profiler import profile
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.sharding import ModelContext
    step = build_prefill_step(model, ModelContext(attention_impl="pallas"),
                              last_only=True)
    with _moe_ranges(), profile(activities=_activities(model.cfg)) as prof:
        t0 = time.perf_counter()
        step(tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = _device_rows(prof, wall, "prefill " + model.cfg.name,
                       share_of="flash_tc_kernel")
    if model.cfg.is_moe:
        busy = out["device_busy_s"]
        for name, (us, calls) in _range_kernels(prof, MOE_RANGES).items():
            out[name] = dict(us=us, calls=calls,
                             share_of_busy=(us / 1e6 / busy
                                            if isinstance(busy, float)
                                            else busy))
    return out


def _range_kernels(prof, names: tuple) -> dict:
    """For each profiler range of ``names``: the device time (µs) of the
    kernels and copies launched while the host was inside one of its
    calls, and the number of calls.  A device event is tied to its
    launch by the correlation id of the runtime call on the host."""
    import bisect
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans = {n: [] for n in names}
    launched, device = {}, []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                device.append(ev)
        elif ev.device_type() == cpu:
            if ev.name() in spans:
                spans[ev.name()].append((ev.start_ns(), ev.end_ns()))
            elif ev.name().startswith("cu") and ev.correlation_id():
                launched[ev.correlation_id()] = ev.start_ns()
    out = {}
    for name, sp in spans.items():
        sp.sort()
        starts = [a for a, _ in sp]
        us = 0.0
        for ev in device:
            t = launched.get(ev.correlation_id())
            i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            if i >= 0 and t < sp[i][1]:
                us += ev.duration_ns() / 1e3
        out[name] = (us, len(sp))
    return out


#: the MoE functions a prefill profile reads in its trace: each call runs
#: in a profiler range of its name (``_moe_ranges``), whose kernels' device
#: time the profile sums
MOE_RANGES = ("moe_block", "moe_dense")


@contextlib.contextmanager
def _moe_ranges():
    """While inside, ``moe_block`` (as ``Block`` calls it), ``moe_dense``
    and ``moe_ep`` (as ``moe_block`` calls them) each run in a
    ``torch.profiler`` range of their name."""
    import torch
    from repro_torch.models import moe, transformer
    where = ((transformer, "moe_block"), (moe, "moe_dense"), (moe, "moe_ep"))
    orig = [getattr(m, n) for m, n in where]

    def ranged(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call

    for (m, n), fn in zip(where, orig):
        setattr(m, n, ranged(n, fn))
    try:
        yield
    finally:
        for (m, n), fn in zip(where, orig):
            setattr(m, n, fn)


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


def _fill_cache(cache: "dict | list", g) -> None:
    """Random keys, values and recurrent state in place: N(0, 1), but an
    sLSTM block's normalizer n (the middle of its (c, n, h)) 1 + |N(0,
    1)|, since its scan keeps n >= 1."""
    if isinstance(cache, list):
        for st in cache:
            for i, c in enumerate(st):
                c.normal_(generator=g)
                if len(st) == 3 and i == 1:
                    c.abs_().add_(1.0)
        return
    for c in cache.values():
        if isinstance(c, dict):
            _fill_cache(c, g)
        else:
            c.normal_(generator=g)


def _state_tensors(cache: "dict | list") -> list:
    """The recurrent state that a decode step updates in place: the
    hybrid's Mamba2 conv and SSM state, or every xLSTM block's state."""
    if isinstance(cache, list):
        return [c for st in cache for c in st]
    return list(cache.get("mamba", {}).values())


def drive_decode_ctx(model) -> tuple:
    """Serving path, decode at a deployment-like context: for each of the
    model's ``DECODE_CTX`` (requests, cache length), ``build_serve_step``
    against a cache of that length filled with random keys, values and
    state, every request at its last position (a step reads the whole
    cache whatever the position; xLSTM's state does not grow, so its
    length only names the position).  One step under ``pallas`` (flash
    decode, the RMSNorm kernel) and one with the plain grouped einsum and
    plain norms, from the same cache (the recurrent state restored
    between them), logits compared; then one warm step and
    ``DECODE_CTX_STEPS`` timed under ``pallas``, launches counted, and two
    under ``torch.profiler``.  The bound is the weights and the cache read
    once and the recurrent state read and written once, at ``HBM_BPS``.
    Returns the rows and one timed run's launches."""
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
        kv_bytes = (nbytes(cache["k"]) + nbytes(cache["v"])
                    if isinstance(cache, dict) else 0)
        state = _state_tensors(cache)
        st_bytes = sum(nbytes(c) for c in state)
        tokens = torch.randint(0, V, (B,), generator=g, device=dev,
                               dtype=torch.int32)
        pos = torch.full((B,), T - 1, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        snap = [c.clone() for c in state]
        with _routing() as own:
            got, _ = step(cache, tokens, pos)
        got = got.float()
        for c, c0 in zip(state, snap):
            c.copy_(c0)
        torch.cuda.synchronize()
        with _routing() as lead:
            t0 = time.perf_counter()
            want, _ = plain(cache, tokens, pos)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        want = want.float()
        for c, c0 in zip(state, snap):
            c.copy_(c0)
        del snap
        scale = want.abs().max().item()
        diff = (got - want).abs().max().item()
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean().item())
        moe_row = (_decode_moe_hold(model, step, cache, tokens, pos, got,
                                    want, own, lead) if cfg.is_moe else {})
        del own, lead
        if not bool(torch.isfinite(got).all()) or (
                not cfg.is_moe and cfg.family not in FORCED_WALK_FAMILIES
                and not diff <= PREFILL_RTOL * scale):
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
            **moe_row, launches=counts,
            profile=_device_rows(prof, pwall, f"decode {B}x{T}, 2 steps")))
        del cache, state, logits, got, want
        torch.cuda.empty_cache()
    return rows, launches


def _decode_plain2_step(model, cache: dict, tokens, pos):
    """A whole decode step with the second plain decode attention in
    every layer (``_decode_attention_plain2``); returns the logits in
    float32."""
    import torch
    from repro_torch.models import layers as L
    with torch.no_grad():
        x = L.embed(tokens[:, None], model.embed)
        for i, (blk, window) in enumerate(zip(model.blocks, model.windows)):
            x = _decode_attention_plain2(blk, x, cache["k"][i],
                                         cache["v"][i], pos, window)
        return _last_logits(model, x)


def _decode_moe_hold(model, step, cache: dict, tokens, pos, got, want,
                     own: list, lead: list) -> dict:
    """An MoE model's decode step at context held against two plain
    paths: ``want`` (the grouped einsum, whose experts ``lead`` recorded)
    and the step with the second plain decode attention.  The kernels'
    step (``step``) and the second plain step are run again with every
    layer's experts forced to the einsum step's (``_routing``), so that
    the three differ only by rounding; those logits are held within
    ``PREFILL_RTOL`` of max |logit| of each other, and the next token as
    the prefill's (``_hold_next_token``) on every request whose einsum
    top-two gap exceeds the forced plain paths' spread there.  The
    natural steps' readings (``got``, whose experts ``own`` recorded, and
    the second plain step with its own experts) are printed beside them,
    with the requests whose experts flipped."""
    import torch
    B = tokens.shape[0]
    with _routing() as own2:
        want2 = _decode_plain2_step(model, cache, tokens, pos)
    with _routing(lead), torch.no_grad():
        got_f = step(cache, tokens, pos)[0].float()
    with _routing(lead):
        want2_f = _decode_plain2_step(model, cache, tokens, pos)
    scale = want.abs().max().item()
    flips = {"kernels": _flipped(own, lead, B), "plain2": _flipped(own2, lead, B)}
    spread = (want - want2_f).abs().max(-1).values
    top2 = want.topk(2, dim=-1).values
    held = (top2[:, 0] - top2[:, 1]) > spread
    picks = [x.argmax(-1).tolist() for x in (got_f, want, want2_f)]
    nat = (got - want).abs().amax(-1)
    row = dict(forced=dict(
                   kernels_vs_einsum=(got_f - want).abs().max().item(),
                   kernels_vs_plain2=(got_f - want2_f).abs().max().item(),
                   plain_spread=spread.max().item(),
                   requests_held=int(held.sum().item())),
               natural=dict(
                   plain_spread=(want - want2).abs().max().item(),
                   kernels_vs_plain2=(got - want2).abs().max().item(),
                   plain_argmax_agree=float(
                       (want.argmax(-1) == want2.argmax(-1)).float()
                       .mean().item()),
                   requests_flipped={n: int(f.sum().item())
                                     for n, f in flips.items()},
                   kernels_vs_einsum_unflipped=(
                       nat[~flips["kernels"]].max().item()
                       if bool((~flips["kernels"]).any()) else None)))
    for key in ("kernels_vs_einsum", "kernels_vs_plain2"):
        if not row["forced"][key] <= PREFILL_RTOL * scale:
            raise AssertionError(f"{model.cfg.name} decode at context, "
                                 f"experts forced to the einsum step's: "
                                 f"{key} {row['forced'][key]} > "
                                 f"{PREFILL_RTOL} x max |logit| {scale}: "
                                 f"{row}")
    if not bool(held.any()):
        raise AssertionError(f"{model.cfg.name} decode at context: no "
                             f"request's top-two gap exceeds the plain "
                             f"paths' spread: {row}")
    for b in held.nonzero()[:, 0].tolist():
        _hold_next_token(picks[0][b], picks[1][b], picks[2][b],
                         f"{model.cfg.name} decode at context, request {b} "
                         f"(experts forced): {row}")
    return row


def _specs(pattern: str, arch: str, n: int, msgs: int):
    """A wave cell's seed-lanes, opted in to the wave program."""
    from repro_torch import pattern_spec
    return [pattern_spec(pattern, arch, "dstream", n, total_messages=msgs,
                         seed=s, **WAVE) for s in SEEDS]


def drive_main_path(dev) -> tuple[list, int]:
    """Every wave cell through ``run_many`` on the card, warm (after one
    untimed run), timed ``WAVE_REPEATS`` times, each run with the
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
        for _ in range(WAVE_REPEATS):
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
        points, wall, counts = _counted(lambda: chaos_campaign(
            device=dev, total_messages=CHAOS_MSGS))
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
    ``EXP_TENANTS`` x ``EXP_TENANT_MSGS`` on the cohort engine (no pump launch), every point
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
        tenant_counts=EXP_TENANTS, messages_per_tenant=EXP_TENANT_MSGS,
        device=dev))
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
    feas_row = dict(cell=f"deployment_feasibility tenants {EXP_TENANTS} x "
                         f"{EXP_TENANT_MSGS} msgs",
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
    120 s, one solo cohort cell per failed host, 20 cells) at
    ``AVAIL_MSGS`` messages a cell: every cell
    ran the cohort engine alone with no pump launch and no confirm left
    withheld, lost nothing and redelivered every duplicate; every point
    feasible with a finite throughput.
    Returns the curves, the crossover and the headline, and the
    launches."""
    import math
    from repro_torch import availability_crossover
    with _recorded_runs() as calls:
        study, wall, counts = _counted(
            lambda: availability_crossover(device=dev,
                                           total_messages=AVAIL_MSGS))
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


def heap_quickstart(dev) -> dict:
    """(d) ``examples_torch/quickstart.py``: its deployment lines, and its
    work-sharing table on the card's cohort engine and on the heap
    engine, each equal to what the reference's ``examples/quickstart.py``
    prints."""
    from examples_torch import quickstart

    def table(engine: str) -> tuple:
        lines, overhead, results = quickstart.work_sharing(engine, dev)
        return lines + overhead, results

    deploy = quickstart.deploy_lines()
    if tuple(deploy) != QUICKSTART_DEPLOY:
        raise AssertionError(f"quickstart deployment: {deploy}")
    (card, _), card_wall, counts = _counted(lambda: table("vectorized"))
    if counts["runs"] != len(quickstart.ARCHS) or counts["pump_assign"]:
        raise AssertionError(f"quickstart on the card: {counts}")
    (heap, results), wall = _heap_timed(lambda: table("heap"))
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


def _kernel_kind(name: str) -> str:
    """A device kernel's kind, from its name: an f32 GEMM (cuBLAS's
    ``f32f32`` and CUTLASS's ``sgemm`` kernels), another GEMM (bf16), an
    elementwise kernel, a reduction, or other."""
    if any(t in name for t in ("gemm", "nvjet", "cutlass")):
        return "gemm f32" if ("f32f32" in name or "sgemm" in name) \
            else "gemm bf16"
    for kind in ("elementwise", "reduce"):
        if kind in name:
            return kind
    return "other"


def _device_rows(prof, wall: float, cell: str, share_of: str = "",
                 kinds: bool = False) -> dict:
    """Device busy time, idle share of ``wall`` and the top kernels of a
    ``torch.profiler`` run; with ``share_of``, the device time, launches
    and share of busy time of the kernels whose name holds it; with
    ``kinds``, device time and launches by :func:`_kernel_kind`.  Summed
    from the profiler's raw device events (kernels, copies; not the
    device spans of profiler ranges), which skips building an event tree:
    a cohort run has a million kernels."""
    import torch
    agg: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA or (
                ev.is_user_annotation()):
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
    if kinds:
        out["by_kind"] = by_kind = {}
        for us, n, name in rows:
            k = _kernel_kind(name)
            a = by_kind.setdefault(k, dict(us=0.0, count=0))
            a["us"] += us
            a["count"] += n
    if share_of:
        mine = [r for r in rows if share_of in r[2]]
        us = sum(r[0] for r in mine)
        out[share_of] = dict(
            us=us, count=sum(r[1] for r in mine),
            share_of_busy=us / 1e6 / busy if rows else "not measured")
    return out


def _token_batches(cfg, n: int, batch: int, seq: int, dev) -> list:
    """``n`` batches of ``SyntheticTokens(seed=0)`` on ``dev``."""
    import torch
    from repro_torch.data import SyntheticTokens
    it = iter(SyntheticTokens(cfg.vocab_size, seq, seed=0, batch_size=batch))
    return [{k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
            for _ in range(n)]


def _train_batches(cfg, n: int, batch: int, seq: int, dev) -> list:
    """``n`` training batches of ``cfg``'s family, ``seq`` positions each,
    on ``dev``: ``SyntheticTokens(seed=0)`` ids and labels; for audio,
    ``zoo.make_batch``'s frame embeddings (generator seed 0) with
    ``SyntheticTokens`` labels; for vlm, ``make_batch``'s ``num_patches``
    patch embeddings before ``SyntheticTokens`` rows of the other ``seq -
    num_patches`` positions (the loss reads the text positions only)."""
    import torch
    from repro_torch.models import zoo
    if cfg.family not in ("audio", "vlm"):
        return _token_batches(cfg, n, batch, seq, dev)
    P = cfg.num_patches if cfg.family == "vlm" else 0
    g = torch.Generator(dev).manual_seed(0)
    out = []
    for toks in _token_batches(cfg, n, batch, seq - P, dev):
        emb = zoo.make_batch(cfg, g, batch, seq)
        if cfg.family == "audio":
            out.append(dict(embeds=emb["embeds"], labels=toks["labels"]))
        else:
            out.append(dict(toks, patch_embeds=emb["patch_embeds"]))
    return out


def _autograd_range_kernels(prof, names: tuple) -> dict:
    """For each profiler range of ``names`` in a train step: the device
    time (µs) of the kernels launched inside its calls (forward, and the
    recompute of a remat unit) and by the backward of the ops its forward
    calls ran (autograd's ``evaluate_function`` events carry the sequence
    number and forward thread of the op whose node they run), each launch
    counted once; and the number of calls."""
    import bisect
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans = {n: [] for n in names}
    ops, backward, launches, device = [], [], [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                device.setdefault(ev.correlation_id(), []).append(
                    ev.duration_ns() / 1e3)
            continue
        if ev.device_type() != cpu:
            continue
        name, tid = ev.name(), ev.start_thread_id()
        if name in spans:
            spans[name].append((ev.start_ns(), ev.end_ns(), tid))
        elif name.startswith("autograd::engine::evaluate_function"):
            backward.append((ev.sequence_nr(), ev.fwd_thread_id(),
                             ev.start_ns(), ev.end_ns(), tid))
        elif name.startswith("cu") and ev.correlation_id():
            launches.append((ev.start_ns(), tid, ev.correlation_id()))
        elif ev.sequence_nr() >= 0:
            ops.append((ev.start_ns(), tid, ev.sequence_nr()))

    def within(sp: list):
        """A test of (time, thread) against the spans ``sp``, which do
        not overlap on a thread."""
        by = {}
        for a, b, th in sorted(sp):
            by.setdefault(th, ([], []))
            by[th][0].append(a)
            by[th][1].append(b)

        def test(t: int, tid: int) -> bool:
            starts, ends = by.get(tid, ((), ()))
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t < ends[i]
        return test

    out = {}
    for name, sp in spans.items():
        fwd_in = within(sp)
        mine = {(seq, tid) for t, tid, seq in ops if fwd_in(t, tid)}
        back_in = within([(a, b, th) for seq, fwd, a, b, th in backward
                          if (seq, fwd) in mine])
        corr = {c for t, tid, c in launches
                if fwd_in(t, tid) or back_in(t, tid)}
        out[name] = (sum(sum(device.get(c, ())) for c in corr), len(sp))
    return out


def drive_train(arch: str, cut: dict, steps: int, M: int, dev,
                profiled: bool = True, mesh: bool = False) -> dict:
    """One full-width training run: ``steps`` steps of ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` positions of the family's batches (``_train_batches``,
    drawn before the timed loop), each timed to its loss read; then, if
    ``profiled``, one profiled step, by kernel kind and, for an MoE model,
    with ``moe_block``'s and ``moe_dense``'s share of its device time
    under autograd.  Holds every loss and grad norm finite, the first loss
    near ln V and the last ``TRAIN_DROP`` below it.  With ``mesh``, the
    weights and AdamW state are copied before the step after the run's
    (the profiled one, or an unprofiled one), and the mesh path's train
    step repeats that step from the copy (``mesh_train``; its row is the
    result's ``mesh``)."""
    import math
    import torch
    from torch.profiler import profile
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_trainer
    cfg = dataclasses.replace(get_config(arch), **cut)
    t0 = time.perf_counter()
    model, step, state = build_trainer(cfg, dev, TRAIN_LR, steps, M, seed=0)
    torch.cuda.synchronize()
    init_s, t0 = time.perf_counter() - t0, time.perf_counter()
    batches = _train_batches(cfg, steps + int(profiled or mesh),
                             TRAIN_BATCH, TRAIN_SEQ, dev)
    data_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, norms, lrs, walls = [], [], [], []
    for batch in batches[:steps]:
        t0 = time.perf_counter()
        met = step(state, batch)
        losses.append(float(met["loss"]))
        walls.append(time.perf_counter() - t0)
        norms.append(float(met["grad_norm"]))
        lrs.append(float(met["lr"]))
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    wall_med = statistics.median(walls)
    ln_v = math.log(cfg.vocab_size)
    row = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               microbatches=M, remat=cfg.remat,
               remat_policy=cfg.remat_policy, steps=steps, init_s=init_s,
               data_s=data_s, losses=losses, grad_norms=norms, lrs=lrs,
               step_wall_s=wall_med, step_walls_s=walls,
               tokens_s=TRAIN_BATCH * TRAIN_SEQ / wall_med,
               peak_mem_gb=peak / 1e9, ln_vocab=ln_v)
    snap = _snapshot(model, state) if mesh else None
    if profiled:
        with _moe_ranges(), profile(activities=_activities(cfg)) as prof:
            t0 = time.perf_counter()
            met = step(state, batches[steps])
            float(met["loss"])
            wall = time.perf_counter() - t0
        row["profile"] = _device_rows(prof, wall, f"train step {cfg.name}",
                                      kinds=True)
        busy = row["profile"]["device_busy_s"]
        if cfg.is_moe and isinstance(busy, float):
            for name, (us, calls) in _autograd_range_kernels(
                    prof, MOE_RANGES).items():
                row["profile"][name] = dict(us=us, calls=calls,
                                            share_of_busy=us / 1e6 / busy)
    if mesh:
        if not profiled:
            met = step(state, batches[steps])
        state = None
        row["mesh"] = mesh_train(model, snap, met, batches[steps], steps, M)
        del snap
    del model, step, state, batches
    gc.collect()
    torch.cuda.empty_cache()
    print("train:", json.dumps(row), flush=True)
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train {cfg.name}: a loss or grad norm is not "
                             f"finite: {losses}, {norms}")
    if not ln_v - 0.5 <= losses[0] <= ln_v + 2:
        raise AssertionError(f"train {cfg.name}: first loss {losses[0]} "
                             f"outside [ln V - 0.5, ln V + 2] = "
                             f"[{ln_v - 0.5}, {ln_v + 2}]")
    if losses[-1] > losses[0] - TRAIN_DROP:
        raise AssertionError(f"train {cfg.name}: last loss {losses[-1]} not "
                             f"{TRAIN_DROP} below the first {losses[0]}")
    return row


def train_dots(full: dict, cut: dict, M: int, dev) -> dict:
    """``TRAIN_DOTS``'s run again for its first ``TRAIN_DOTS_STEPS`` steps
    under ``remat_policy="dots"``, from the same weights (the same seed)
    and batches, on the same schedule, beside the ``full`` run's row: the
    first loss equal, every grad norm within ``TRAIN_DOTS_RTOL``
    relative; both runs' peaks and step walls."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_trainer
    cfg = dataclasses.replace(get_config(TRAIN_DOTS), remat_policy="dots",
                              **cut)
    n = TRAIN_DOTS_STEPS
    model, step, state = build_trainer(cfg, dev, TRAIN_LR, full["steps"], M,
                                       seed=0)
    batches = _train_batches(cfg, n, TRAIN_BATCH, TRAIN_SEQ, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, walls = [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        met = step(state, batch)
        losses.append(float(met["loss"]))
        walls.append(time.perf_counter() - t0)
        norms.append(float(met["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    del model, step, state, batches
    gc.collect()
    torch.cuda.empty_cache()
    norm_dev = max(abs(a - b) / abs(b) for a, b in zip(
        norms, full["grad_norms"][:n]))
    row = dict(arch=cfg.name, steps=n, full_losses=full["losses"][:n],
               dots_losses=losses, full_grad_norms=full["grad_norms"][:n],
               dots_grad_norms=norms, grad_norm_rel_dev=norm_dev,
               rtol=TRAIN_DOTS_RTOL, full_step_walls_s=full["step_walls_s"][:n],
               dots_step_walls_s=walls, full_peak_mem_gb=full["peak_mem_gb"],
               dots_peak_mem_gb=peak / 1e9)
    print("train dots:", json.dumps(row), flush=True)
    if losses[0] != full["losses"][0] or not norm_dev <= TRAIN_DOTS_RTOL:
        raise AssertionError(f"train dots {cfg.name}: first loss "
                             f"{losses[0]} vs {full['losses'][0]} under full "
                             f"remat, grad norms {norms} vs "
                             f"{full['grad_norms'][:n]}")
    return row


def train_cross_check(dev) -> dict:
    """``TRAIN_XDEV``: the same f32 masters and batches (the family's,
    ``_train_batches``, drawn on the CPU) trained on the card and on the
    CPU, each trainer built as ``launch.train.run`` builds it; the largest
    deviations of the losses, grad norms and trained changes, each
    against its limit.  For an MoE model the tokens whose experts differ
    between the devices are counted over every router call
    (``_routing``) and named in a failure."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import build_trainer
    x = TRAIN_XDEV
    out = {}
    for arch in x["archs"]:
        cfg = dataclasses.replace(get_smoke_config(arch), remat=True)
        host = _train_batches(cfg, x["steps"], x["batch"], x["seq"], "cpu")
        runs = {}
        for where in ("cpu", dev):
            model, step, state = build_trainer(cfg, where, x["lr"],
                                               x["steps"], x["M"], seed=0)
            if where != "cpu":
                model.load_state_dict(runs["cpu"][0])
            init = {k: v.clone() for k, v in model.state_dict().items()}
            with _routing() as routed:
                mets = [step(state, {k: v.to(where) for k, v in b.items()})
                        for b in host]
            runs[str(where)] = (init, model, mets, routed)
        (w0, cpu, cm, cr), (init, gpu, gm, gr) = runs["cpu"], runs[str(dev)]
        for k, v in init.items():
            if not torch.equal(v.cpu(), w0[k]):
                raise AssertionError(f"train xdev {arch}: {k} differs at init")
        flips = sum(int((a.sort(-1).values != b.cpu().sort(-1).values
                         ).any(-1).sum()) for a, b in zip(cr, gr, strict=True))
        row = dict(expert_flips=flips) if cfg.is_moe else {}
        why = f" ({flips} tokens' experts flipped)" if flips else ""
        for key in ("loss", "grad_norm"):
            dev_rel = max(abs(float(a[key]) - float(b[key])) / abs(float(a[key]))
                          for a, b in zip(cm, gm))
            row[f"{key}_rel_dev"] = dev_rel
            if dev_rel > TRAIN_XDEV_RTOL:
                raise AssertionError(f"train xdev {arch}: {key} relative "
                                     f"deviation {dev_rel} > "
                                     f"{TRAIN_XDEV_RTOL}{why}")
        worst = (0.0, "")
        for (name, a), b in zip(cpu.named_parameters(), gpu.parameters()):
            d_cpu = a.detach() - w0[name]
            d_gpu = b.detach().cpu() - w0[name]
            worst = max(worst, (float((d_gpu - d_cpu).norm() / d_cpu.norm()),
                                name))
        row["trained_change_dev"], row["trained_change_worst"] = worst
        if worst[0] > TRAIN_XDEV_DW:
            raise AssertionError(f"train xdev {arch}: {worst[1]}'s trained "
                                 f"change deviates by {worst[0]} > "
                                 f"{TRAIN_XDEV_DW}{why}")
        row["losses_gpu"] = [float(m["loss"]) for m in gm]
        out[arch] = row
    return out


def train_resume(dev) -> dict:
    """``launch.train.run`` at granite-8b-smoke on the card: 10 steps with a
    checkpoint every 5, then a run to 14 steps resumes from step 10 and
    returns 4 losses (``tests/test_train_loop.py``'s
    ``test_checkpoint_restart_continues``)."""
    import argparse
    import math
    import tempfile
    from repro_torch.launch.train import run
    with tempfile.TemporaryDirectory() as d:
        base = dict(arch="granite-8b-smoke", batch=8, seq=32, lr=2e-3,
                    seed=0, microbatches=1, data="local", ckpt_dir=d,
                    ckpt_every=5, resume=True, log_every=100,
                    feedback_every=5, crash_consumer_at=-1, device=str(dev))
        first = run(argparse.Namespace(**base, steps=10))
        second = run(argparse.Namespace(**base, steps=14))
    row = dict(first=len(first["losses"]), resumed=len(second["losses"]),
               losses=first["losses"] + second["losses"])
    if row["first"] != 10 or row["resumed"] != 4 or not all(
            math.isfinite(v) for v in row["losses"]):
        raise AssertionError(f"train resume: {row}")
    return row


def train_guard(dev) -> dict:
    """Under grad the kernels refuse: a train step of granite-8b's and of
    qwen3-moe-30b-a3b's smoke config under ``attention_impl="pallas"``,
    and each model kernel's wrapper called
    with an input that requires grad, raise ``RuntimeError`` on the card;
    under ``no_grad`` the same calls launch."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import build_trainer
    from repro_torch.models.sharding import ModelContext
    from repro_torch.optim import AdamW
    refused = []
    for arch in ("granite-8b", "qwen3-moe-30b-a3b"):
        cfg = get_smoke_config(arch)
        model, _, state = build_trainer(cfg, dev, 1e-3, 1, 1, seed=0)
        step = build_train_step(model, AdamW(decayed=model.decayed()),
                                ModelContext(attention_impl="pallas"))
        try:
            step(state, _token_batches(cfg, 1, 2, 64, dev)[0])
        except RuntimeError as e:
            if "forward-only" not in str(e):
                raise
            refused.append(f"{arch} train step")
    g = torch.Generator(dev).manual_seed(0)
    r = lambda *sh: torch.randn(*sh, generator=g, device=dev)
    pos = torch.arange(64, dtype=torch.int32, device=dev)
    calls = {
        "rmsnorm": (lambda a, b: ops.rmsnorm(a, b), (r(4, 128), r(128))),
        "flash_attention": (lambda q, k, v: ops.flash_attention(
            q, k, v, pos, pos), (r(1, 64, 2, 64), r(1, 64, 1, 64),
                                 r(1, 64, 1, 64))),
        "flash_decode": (lambda q, k, v: ops.flash_decode(
            q, k, v, torch.tensor([40], device=dev)),
            (r(1, 2, 64), r(1, 64, 1, 64), r(1, 64, 1, 64))),
        "ssd_state_scan": (ops.ssd_state_scan, (
            r(1, 2, 2, 16, 16), -r(1, 2, 2).abs(), r(1, 2, 64, 16),
            -r(1, 2, 64, 2).abs())),
    }
    for name, (fn, args) in calls.items():
        try:
            fn(args[0].requires_grad_(), *args[1:])
        except RuntimeError as e:
            if "forward-only" not in str(e):
                raise
            refused.append(name)
        with torch.no_grad():
            fn(*args)
    torch.cuda.synchronize()
    if refused != ["granite-8b train step", "qwen3-moe-30b-a3b train step",
                   *calls]:
        raise AssertionError(f"train guard: only {refused} refused grad")
    return dict(refused=refused)


def drive_train_phase(dev, done, runs=TRAIN_RUNS, checks: bool = True,
                      beside=None) -> tuple[dict, dict]:
    """The train phase: every kernel's launches counted from 0 before it
    and read after (all 0: training runs the plain paths, as the
    reference's does), the full-width ``runs`` (``TRAIN_RUNS``), the
    ``TRAIN_DOTS`` pair when its run is among them, and with ``checks``
    the GPU-against-CPU check, the entry point's resume and the kernels'
    guard.  With ``beside`` = ``(arch, context)``, ``arch``'s run (not
    its ``"dots"`` pair) runs inside ``context()``.  Returns the launches
    and the full-width runs' rows by arch."""
    _reset_launches()
    rows = {}
    for arch, cut, steps, M in runs:
        with (beside[1]() if beside and beside[0] == arch
              else contextlib.nullcontext()):
            rows[arch] = drive_train(arch, cut, steps, M, dev,
                                     profiled=arch in TRAIN_PROFILED,
                                     mesh=arch == MESH_TRAIN)
            done(f"train {arch}")
        if arch == TRAIN_DOTS:
            train_dots(rows[arch], cut, M, dev)
            done(f"train {arch} dots")
    if checks:
        print("train cross-check:", json.dumps(train_cross_check(dev)))
        print("train resume:", json.dumps(train_resume(dev)))
        done("train cross-check and resume")
    counts = _launches()
    if any(counts.values()):
        raise AssertionError(f"train: kernel launches {counts}, want none")
    if checks:
        print("train guard:", json.dumps(train_guard(dev)))
        done("train guard")
    return counts, rows


def _cpu_s() -> float:
    """The host CPU seconds of this process so far, all threads."""
    import resource
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def _in_band(losses: list, vocab: int, what: str) -> float:
    """Every loss finite and within [ln V - 0.5, ln V + 2]; returns ln V."""
    import math
    ln_v = math.log(vocab)
    if not all(math.isfinite(x) and ln_v - 0.5 <= x <= ln_v + 2
               for x in losses):
        raise AssertionError(f"{what}: a loss is not finite or lies outside "
                             f"[ln V - 0.5, ln V + 2] = [{ln_v - 0.5}, "
                             f"{ln_v + 2}]: {losses}")
    return ln_v


def _hold_redelivery(redelivered, loader, what: str) -> None:
    """A crash that redelivered messages was seen redelivered."""
    if redelivered and loader.redeliveries_seen < 1:
        raise AssertionError(f"{what}: the crash redelivered {redelivered} "
                             f"messages and the loader saw none")


def stream_entry(dev) -> dict:
    """``launch.train.run`` on the card with ``STREAM_RUN``: 14 losses in
    the band, the ``[fault]`` line printed, the redeliveries seen."""
    import argparse
    import io
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import run
    out_text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out_text):
        out = run(argparse.Namespace(**STREAM_RUN, device=str(dev)))
    wall = time.perf_counter() - t0
    print(out_text.getvalue(), end="")
    loader, producers = out["stream"][1], out["stream"][3]
    row = dict(arch=STREAM_RUN["arch"], wall_s=wall, losses=out["losses"],
               redelivered=out["redelivered"],
               redeliveries_seen=loader.redeliveries_seen,
               messages_consumed=loader.messages_consumed,
               producers=[dict(id=p.id, sent=p.sent, rejected=p.rejected,
                               rate=p.rate) for p in producers])
    what = "stream entry"
    if len(out["losses"]) != STREAM_RUN["steps"]:
        raise AssertionError(f"{what}: {len(out['losses'])} losses")
    row["ln_vocab"] = _in_band(out["losses"], get_smoke_config(
        "granite-8b").vocab_size, what)
    if f"[fault] crashed ingest-0 at step {STREAM_RUN['crash_consumer_at']}" \
            not in out_text.getvalue():
        raise AssertionError(f"{what}: no [fault] line")
    _hold_redelivery(out["redelivered"], loader, what)
    return row


def _rows_published(recs: list, producers, vocab: int, seq: int) -> dict:
    """Every row of every batch the trainer received, read back from the
    card, against ``tokens_from_payload`` of the producers' payloads,
    recomputed here (a payload's seed is salted per process): seeds
    searched in order up to each producer's ``sent`` until every row is
    found.  Returns the rows, the distinct rows and the payloads
    searched."""
    import numpy as np
    from repro_torch.core.workloads import DSTREAM, tokens_from_payload
    rows = []
    for rec in recs:
        tok = rec["batch"]["tokens"].cpu().numpy()
        lab = rec["batch"]["labels"].cpu().numpy()
        if tok.shape != (TRAIN_BATCH, seq) or not (
                lab[:, :-1] == tok[:, 1:]).all():
            raise AssertionError(f"stream: step {rec['step']}'s batch is "
                                 f"not a shifted row of {seq + 1} tokens")
        rows += [r.tobytes() for r in np.concatenate(
            [tok, lab[:, -1:]], axis=1).astype(np.int32)]
    missing, searched = set(rows), 0
    for i in range(max(p.sent for p in producers)):
        for p in producers:
            if i < p.sent and missing:
                searched += 1
                missing.discard(tokens_from_payload(DSTREAM.payload(
                    hash(p.id) % 10 ** 6 + i), vocab, seq + 1).tobytes())
        if not missing:
            break
    if missing:
        raise AssertionError(f"stream: {len(missing)} of {len(set(rows))} "
                             f"rows equal no published payload's tokens")
    return dict(rows=len(rows), distinct=len(set(rows)),
                payloads_searched=searched)


def drive_stream(dev, local_wall=None) -> dict:
    """The full-width streamed run: granite-8b as the train phase cuts it,
    built by ``build_trainer``, fed by ``make_stream`` and driven by
    ``train_loop`` (``run``'s loop: its crash, its feedback), each step
    timed to its loss read with the host CPU it took; then one profiled
    step.  Holds every loss and grad norm finite, the losses in the band,
    every row a published payload's tokens, the redeliveries seen, and
    the crashed consumer's thread ended (the port's one difference from
    the reference's loader).  ``local_wall`` is the train phase's median
    step on local data."""
    import math
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch.train import (
        build_trainer, close_stream, make_stream, train_loop)
    arch, cut, _, M = TRAIN_RUNS[0]
    cfg = dataclasses.replace(get_config(arch), **cut)
    t0 = time.perf_counter()
    model, step, state = build_trainer(cfg, dev, TRAIN_LR, STREAM_STEPS + 1,
                                       M, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    stream = make_stream(cfg, TRAIN_BATCH, TRAIN_SEQ)
    broker, loader, _, producers = stream
    loop = train_loop(model, step, state, iter(loader), 0, STREAM_STEPS + 1,
                      stream, STREAM_CRASH_AT, STREAM_FEEDBACK_EVERY)
    recs, walls, cpus = [], [], []
    try:
        for _ in range(STREAM_STEPS + 1):
            t0, c0 = time.perf_counter(), _cpu_s()
            if len(recs) < STREAM_STEPS:
                recs.append(next(loop))
            else:
                peak = torch.cuda.max_memory_allocated()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    recs.append(next(loop))
            walls.append(time.perf_counter() - t0)
            cpus.append(_cpu_s() - c0)
        crashed = loader._threads[0]
        crashed.join(timeout=2.0)
        if crashed.is_alive():
            raise AssertionError(f"stream {cfg.name}: the crashed consumer's "
                                 f"thread runs on")
    finally:
        close_stream(stream)
    wall = walls.pop()
    cpus.pop()
    losses = [r["loss"] for r in recs]
    norms = [float(r["metrics"]["grad_norm"]) for r in recs]
    redelivered = recs[STREAM_CRASH_AT]["redelivered"]
    k = STREAM_CRASH_AT
    row = dict(
        arch=cfg.name, layers=cfg.n_layers, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        microbatches=M, steps=STREAM_STEPS, crash_at=k,
        feedback_every=STREAM_FEEDBACK_EVERY, init_s=init_s, losses=losses,
        grad_norms=norms, step_walls_s=walls,
        step_wall_s=statistics.median(walls),
        step_wall_before_crash_s=statistics.median(walls[:k]),
        step_wall_after_crash_s=statistics.median(walls[k:]),
        local_step_wall_s=(local_wall if local_wall is not None
                           else "not measured"),
        tokens_s=TRAIN_BATCH * TRAIN_SEQ / statistics.median(walls),
        next_batch_wait_s=[r["wait_s"] for r in recs],
        cpu_s_per_step=cpus,
        cpu_s_per_step_before_crash=statistics.median(cpus[:k]),
        cpu_s_per_step_after_crash=statistics.median(cpus[k:]),
        peak_mem_gb=peak / 1e9,
        feedback=[r["feedback"] for r in recs if "feedback" in r],
        producers=[dict(id=p.id, sent=p.sent, rejected=p.rejected,
                        rate=p.rate) for p in producers],
        messages_consumed=loader.messages_consumed, redelivered=redelivered,
        redeliveries_seen=loader.redeliveries_seen,
        depths_at_end={q: broker.queue_depth(q) for q in loader.queues},
        profile=_device_rows(prof, wall, f"stream step {cfg.name}",
                             kinds=True))
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"stream {cfg.name}: a loss or grad norm is not "
                             f"finite: {losses}, {norms}")
    row["ln_vocab"] = _in_band(losses, cfg.vocab_size, f"stream {cfg.name}")
    row["integrity"] = _rows_published(recs, producers, cfg.vocab_size,
                                       TRAIN_SEQ)
    _hold_redelivery(redelivered, loader, f"stream {cfg.name}")
    del model, step, state, recs, loop
    gc.collect()
    torch.cuda.empty_cache()
    return row


def drive_stream_phase(dev, done, local_wall=None) -> dict:
    """The stream phase: every kernel's launches counted from 0 before it
    and read after (all 0: the streamed trainer runs the plain paths),
    the entry point at the reference's test size, then the full-width
    streamed run."""
    _reset_launches()
    print("stream entry:", json.dumps(stream_entry(dev)), flush=True)
    done("stream entry")
    print("stream:", json.dumps(drive_stream(dev, local_wall)), flush=True)
    done("stream granite-8b")
    counts = _launches()
    if any(counts.values()):
        raise AssertionError(f"stream: kernel launches {counts}, want none")
    return counts


def _example(main, dev, *argv: str) -> tuple:
    """An example's ``main`` on ``dev`` with its standard output captured,
    then printed: ``(its result, the lines it printed, wall seconds)``."""
    import io
    import torch
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        out = main([*argv, "--device", str(dev)])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(text.getvalue(), end="", flush=True)
    return out, text.getvalue().splitlines(), wall


def example_comparison(dev) -> dict:
    """``examples_torch/cross_facility_comparison.py`` at its defaults:
    its lines equal to the reference's (``COMPARISON_LINES``), every cell
    a solo run of the card's cohort engine."""
    from examples_torch import cross_facility_comparison as comparison
    from repro_torch.core.torch_engine import TorchStreamSim
    TorchStreamSim.stats.update(runs=0, host_reads=0, withheld=0)
    lines, printed, wall = _example(comparison.main, dev)
    runs = dict(TorchStreamSim.stats)
    # Fig 4 at three consumer counts, Fig 6 at two, Fig 7a at one
    want_runs = len(comparison.ARCHS) * (3 + 2 + 1)
    if tuple(lines) != COMPARISON_LINES or printed != lines:
        raise AssertionError(f"comparison: {printed}, want "
                             f"{list(COMPARISON_LINES)}")
    if runs["runs"] != want_runs:
        raise AssertionError(f"comparison: {runs['runs']} cohort runs, want "
                             f"{want_runs}")
    return dict(wall_s=wall, lines=len(lines), equal_to_reference=True,
                cohort_runs=runs["runs"], host_reads=runs["host_reads"])


def example_edge(dev) -> dict:
    """``examples_torch/edge_to_hpc_training.py`` at its defaults in a
    fresh checkpoint directory (under ``build/``, removed after, timed):
    every loss finite, the first in [ln V - 0.5, ln V + 2] and the final
    below it (the example's own check), the ``[fault]`` line printed and
    the crash's messages redelivered and seen, a checkpoint written at
    each of ``EDGE_CKPT_STEPS`` (each save recorded) and the last
    ``EDGE_KEEP`` kept; the run's own steps/s and the peak memory
    printed, with the seconds before the example starts (``setup_s``:
    imports, the directory) and after it returns (``after_s``)."""
    t_in = time.perf_counter()
    import math
    import re
    import shutil
    import tempfile
    import torch
    from examples_torch import edge_to_hpc_training as edge
    from repro_torch.checkpoint import checkpointer
    saved, save = [], checkpointer.save_checkpoint

    def recorded(directory, step, tree, keep=3):
        saved.append((step, keep))
        return save(directory, step, tree, keep)

    (ROOT / "build").mkdir(exist_ok=True)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ckpt = tempfile.mkdtemp(prefix="edge2hpc_", dir=ROOT / "build")
    checkpointer.save_checkpoint = recorded
    try:
        setup = time.perf_counter() - t_in
        out, printed, wall = _example(
            edge.main, dev, "--steps", str(EDGE_STEPS), "--ckpt-dir", ckpt)
        t_out = time.perf_counter()
        kept = sorted(os.listdir(ckpt))
    finally:
        checkpointer.save_checkpoint = save
        t0 = time.perf_counter()
        shutil.rmtree(ckpt, ignore_errors=True)
        cleanup = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    losses, loader = out["losses"], out["stream"][1]
    n_params = sum(p.numel() for p in out["model"].parameters())
    rates = re.findall(r"\(([0-9.]+) steps/s\)", "\n".join(printed))
    crash = EDGE_STEPS // 3
    row = dict(wall_s=wall, steps=len(losses), steps_per_s=float(rates[-1]),
               first_loss=losses[0], final_loss=out["final_loss"],
               params=n_params, crash_at=crash,
               redelivered=out["redelivered"],
               redeliveries_seen=loader.redeliveries_seen,
               messages_consumed=loader.messages_consumed,
               checkpoints_saved=[s for s, _ in saved], checkpoints_kept=kept,
               checkpoints_removed_s=cleanup,
               peak_mem_gb=peak if cuda else "not measured", setup_s=setup)
    what = "edge-to-HPC"
    if len(losses) != EDGE_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{what}: {len(losses)} losses, or one not "
                             f"finite: {losses}")
    _in_band(losses[:1], edge.CONFIG.vocab_size, what)
    # the config's count leaves out the final norm, as the reference's
    if n_params != edge.CONFIG.param_count() + edge.CONFIG.d_model:
        raise AssertionError(f"{what}: {n_params} parameters, the config "
                             f"counts {edge.CONFIG.param_count()} and a "
                             f"final norm of {edge.CONFIG.d_model}")
    if f"[fault] crashed ingest-0 at step {crash};" not in "\n".join(printed):
        raise AssertionError(f"{what}: no [fault] line")
    if not out["redelivered"]:
        raise AssertionError(f"{what}: the crash redelivered nothing")
    _hold_redelivery(out["redelivered"], loader, what)
    if saved != [(s, EDGE_KEEP) for s in EDGE_CKPT_STEPS] or kept != [
            f"step_{s:010d}" for s in EDGE_CKPT_STEPS[-EDGE_KEEP:]]:
        raise AssertionError(f"{what}: checkpoints saved {saved}, kept "
                             f"{kept}")
    if out["summary"] not in printed:
        raise AssertionError(f"{what}: no summary line")
    del out, loader
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    row["after_s"] = time.perf_counter() - t_out
    return row


def example_steering(dev) -> dict:
    """``examples_torch/steering_serve.py``: ``STEER_REQUESTS`` requests
    served on the card, each ``STEER_NEW`` new tokens after its
    ``STEER_PROMPT``-token prompt; both producers steered; each producer's
    thread ended (joined with a 2 s timeout after the example returns)."""
    from examples_torch import steering_serve as steering
    out, printed, wall = _example(steering.main, dev)
    what = "steering"
    producers = out["producers"]
    for p in producers:
        p.join(timeout=2.0)
    alive = [p.id for p in producers if p._thread.is_alive()]
    shapes = [tuple(t.shape) for t in out["tokens"]]
    if alive:
        raise AssertionError(f"{what}: producer threads run on: {alive}")
    if shapes != [(1, STEER_PROMPT + STEER_NEW)] * STEER_REQUESTS or any(
            t.device.type != dev.type for t in out["tokens"]):
        raise AssertionError(f"{what}: generated {shapes}")
    if len(out["steering"]) != len(producers) or None in out["steering"]:
        raise AssertionError(f"{what}: steering received {out['steering']}")
    if printed[-1] != f"served {STEER_REQUESTS} streamed requests":
        raise AssertionError(f"{what}: {printed}")
    return dict(wall_s=wall, requests=len(shapes), tokens=shapes,
                steering=out["steering"],
                producers=[dict(id=p.id, sent=p.sent,
                                feedback_seen=p.feedback_seen)
                           for p in producers])


#: the examples that run in child processes of the smoke, by name
EXAMPLE_CHILDREN = {"comparison": "example_comparison",
                    "edge-to-HPC": "example_edge"}


def example_child(name: str, device: str) -> None:
    """One of ``EXAMPLE_CHILDREN`` in a child process of the smoke
    (``start_examples``) on ``device``, every kernel's launches counted
    from 0 before it: what it prints, then its row and the launches as
    JSON on the last line."""
    import torch
    _reset_launches()
    row = globals()[EXAMPLE_CHILDREN[name]](torch.device(device))
    print(json.dumps(dict(row=row, launches=_launches())), flush=True)


def start_examples(dev) -> list:
    """Start each of ``EXAMPLE_CHILDREN`` on ``dev`` in a child process
    of its own, all together, each printing to a log under ``build/``:
    ``[(name, process, log path)]``.  Every example is host-bound and
    leaves the card idle most of the time, and the host has cores to
    spare, so the smoke goes on with phases of the same kind meanwhile
    and collects them with ``drive_examples``."""
    (ROOT / "build").mkdir(exist_ok=True)
    children = []
    for name in EXAMPLE_CHILDREN:
        log = ROOT / "build" / f"example_{name}.log"
        with open(log, "w") as out:
            children.append((name, subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke as cs; "
                 f"cs.example_child({name!r}, {str(dev)!r})"],
                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT), log))
    return children


def _finish_example(name: str, proc, log: Path) -> dict:
    """Wait for an example's child (``EXAMPLES_TIMEOUT`` s at most), print
    what it printed and its ``examples <name>:`` row; raises when it
    failed.  Returns its launches."""
    rc = _wait(proc, EXAMPLES_TIMEOUT)
    text = log.read_text()
    last = [ln for ln in text.splitlines() if ln.startswith('{"row": ')]
    if rc != 0 or not last:
        raise AssertionError(f"examples {name}: exit {rc}\n{text[-3000:]}")
    out = json.loads(last[-1])
    print(text.replace(last[-1] + "\n", ""), end="")
    print(f"examples {name}:", json.dumps(out["row"]), flush=True)
    return out["launches"]


def drive_examples(dev, done, children=None) -> dict:
    """The examples path: the three examples of ``examples_torch`` that
    heap parity (d) does not run, one line each with its wall.  The
    comparison and edge-to-HPC run in child processes (``children``, from
    ``start_examples``; started here when not given), collected here;
    then the steering example runs in this process.  Every kernel's
    launches are counted from 0 in each process and summed (all 0: the
    comparison runs the cohort engine, training the plain paths, and the
    steering server its default ``ModelContext()``)."""
    if children is None:
        children = start_examples(dev)
    counts = dict.fromkeys(_launches(), 0)
    with _stopped(proc for _, proc, _ in children):
        for name, proc, log in children:
            for k, n in _finish_example(name, proc, log).items():
                counts[k] += n
            done(f"examples {name} (its wait)")
    _reset_launches()
    print("examples steering:", json.dumps(example_steering(dev)),
          flush=True)
    done("examples steering")
    here = _launches()
    counts = {k: n + here[k] for k, n in counts.items()}
    if any(counts.values()):
        raise AssertionError(f"examples: kernel launches {counts}, want "
                             f"none")
    return counts


def moe_share(model) -> dict:
    """``moe_block`` of the first layer alone, on a random activation of
    the prefill's shape (bf16, seed 5), timed with CUDA events beside its
    bound (all experts for every token, the shared experts too: 6 T D F
    (E + n_s) operations, at the bf16 peak).  The share of the prefill's
    device time is read from its trace (``profile_prefill``)."""
    import torch
    from repro_torch.models.moe import moe_block
    cfg, blk = model.cfg, model.blocks[0]
    B, S = PREFILL[cfg.name]
    h = torch.randn(B, S, cfg.d_model, device=model.device,
                    generator=torch.Generator(model.device).manual_seed(5)
                    ).to(torch.bfloat16)
    kw = dict(k=cfg.experts_per_token, n_experts=cfg.n_experts,
              n_shared=cfg.n_shared_experts,
              capacity_factor=cfg.capacity_factor)
    with torch.no_grad():
        ms = _cuda_ms(lambda: moe_block(h, blk.moe_params(), **kw), 3, 3)
    flops = 6 * B * S * cfg.d_model * cfg.d_ff * (
        cfg.n_experts + cfg.n_shared_experts)
    return dict(layer_ms=ms, flops=flops, bound_ms=flops / BF16_FLOPS * 1e3,
                bound_share=flops / BF16_FLOPS * 1e3 / ms)


@contextlib.contextmanager
def _mesh_world():
    """A one-rank NCCL world (``init_process_group`` given its address on
    ``localhost``, world size 1 and rank 0: nothing on the machine
    announces a cluster), destroyed on leaving."""
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _capacity(model, cf: float):
    """While inside, every block of ``model`` runs its MoE at capacity
    factor ``cf``."""
    cfgs = [blk.cfg for blk in model.blocks]
    for blk in model.blocks:
        blk.cfg = dataclasses.replace(blk.cfg, capacity_factor=cf)
    try:
        yield
    finally:
        for blk, cfg in zip(model.blocks, cfgs):
            blk.cfg = cfg


def _ep_dropped(idxs: list, n_experts: int, cf: float) -> tuple:
    """(pairs, dropped) of the (token, expert) pairs that ``moe_ep``'s
    dispatch (``dispatch_slots`` at ``capacity``) gives each of ``idxs``,
    the expert choices ``_routing`` recorded, one a layer call: on one
    rank every layer's choices are all of its tokens'."""
    from repro_torch.models import moe
    pairs = dropped = 0
    for idx in idxs:
        T, k = idx.shape
        keep = moe.dispatch_slots(idx, n_experts,
                                  moe.capacity(T, k, cf, n_experts))[3]
        pairs += T * k
        dropped += int((~keep).sum())
    return pairs, dropped


def mesh_moe(model, tokens, dense_wall: float) -> tuple:
    """The mesh path of ``MESH_SERVE`` (full width and depth), on the
    model ``serve`` built: first, off the mesh, the first MoE layer's
    input and the prefill (``PREFILL``) under ``pallas`` with its experts
    recorded (``dense_wall``: its warm median wall, ``drive_prefill``'s,
    in this process); then the model placed on a (1, 1) mesh by
    ``assemble(..., "prefill", ...)``'s placements, where
    ``moe_impl="auto"`` is expert parallelism (``moe_ep``) and flash
    attention, RMSNorm and flash decode run through ``local_map``:
    the first MoE layer at a capacity factor of E/k (nothing dropped)
    against ``moe_dense`` within ``MESH_LAYER_TOL`` of max |y|; the
    full-depth prefill at E/k with the dense run's experts forced at every
    layer against its logits within ``PREFILL_RTOL`` of max |logit|, then
    timed ``MESH_REPEATS`` times at E/k with its own experts (nothing
    dropped: every pair computed, as ``moe_dense`` computes them); at
    the config's capacity factor the prefill run with its routing
    recorded, then timed ``MESH_REPEATS`` times, the dropped share of
    (token, expert) pairs (``_ep_dropped`` on the recorded routing),
    the requests whose experts flipped and the logits' distance, and one
    profiled run with ``moe_ep``'s share of busy time; then the decode
    step at ``MESH_DECODE`` off the mesh (experts recorded, timed) and
    under ``assemble(..., "decode", ...)`` (the whole cache on the rank:
    flash decode), held likewise at E/k with the dense step's experts
    forced, and timed at the config's factor.  Every kernel launch on the
    mesh is counted and exact.
    The model is gathered back afterwards.  Returns (row, launches)."""
    import torch
    from torch.profiler import profile
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.shardings import assemble, gather, place
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models.sharding import ModelContext
    cfg, dev = model.cfg, model.device
    B, S = PREFILL[cfg.name]
    Bd, Td = MESH_DECODE
    nodrop = cfg.n_experts / cfg.experts_per_token
    plain = ModelContext(attention_impl="pallas")
    kw = dict(k=cfg.experts_per_token, n_experts=cfg.n_experts,
              n_shared=cfg.n_shared_experts)
    blk = model.blocks[0]

    def timed(fn, n):
        """The mean wall of ``n`` calls of ``fn``, each shape already run
        once just before (no warm call here)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / n

    # ---- off the mesh ----
    with torch.no_grad():
        x = model.input_embeds({"tokens": tokens})
        pos_s = torch.arange(S, dtype=torch.int32, device=dev)
        h = L.rmsnorm(blk.attend(x, model.windows[0], pos_s, plain),
                      blk.mlp_norm, ctx=plain)
        y_dense = moe.moe_dense(h, blk.moe_params(), cfg.experts_per_token
                                ).float()
        del x
    dense = build_prefill_step(model, plain, last_only=True)
    with _routing() as lead:
        want = dense(tokens).float()

    # ---- the prefill on the mesh ----
    mesh = make_local_mesh(1, 1, device=dev)
    ctx, sh = assemble(model, mesh, "prefill", B, S, attention_impl="pallas")
    place(model, sh["params"], mesh)
    tok_m = place(tokens, sh["batch"]["tokens"], mesh)
    step = build_prefill_step(model, ctx, last_only=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    n_prefill = n_decode = 0
    # the first MoE layer at E/k: nothing dropped
    with torch.no_grad(), _routing() as l0:
        y_ep = moe.moe_block(ctx.shard(h, "batch", "seq", "d_model"),
                             blk.moe_params(), capacity_factor=nodrop,
                             ctx=ctx, **kw).full_tensor().float()
    pairs16, dropped16 = _ep_dropped(l0, cfg.n_experts, nodrop)
    scale = y_dense.abs().max().item()
    layer_diff = (y_ep - y_dense).abs().max().item()
    if dropped16 or not layer_diff <= MESH_LAYER_TOL * scale:
        raise AssertionError(
            f"mesh {cfg.name} layer 0 at capacity factor {nodrop}: "
            f"{dropped16} of {pairs16} pairs dropped, max |ep - dense| "
            f"{layer_diff} > {MESH_LAYER_TOL} x max |y| {scale}")
    del y_ep, y_dense, h
    # the full depth at E/k, the dense run's experts forced
    with _capacity(model, nodrop), _routing(lead):
        got16 = step(tok_m).full_tensor().float()
    n_prefill += 1
    lscale = want.abs().max().item()
    forced_diff = (got16 - want).abs().max().item()
    if got16.shape != want.shape or not forced_diff <= PREFILL_RTOL * lscale:
        raise AssertionError(
            f"mesh {cfg.name} prefill at capacity factor {nodrop}, experts "
            f"forced: max |mesh - dense| {forced_diff} > {PREFILL_RTOL} x "
            f"max |logit| {lscale}")
    # and timed at E/k, its own experts: every pair computed, as the
    # dense path computes them (the forced run above warmed its shapes)
    with _capacity(model, nodrop), _routing() as own16:
        _, nodrop_wall = timed(lambda: step(tok_m), MESH_REPEATS)
    pairs16_all, dropped16_all = _ep_dropped(own16, cfg.n_experts, nodrop)
    del own16
    if dropped16_all:
        raise AssertionError(f"mesh {cfg.name} prefill at capacity factor "
                             f"{nodrop}: {dropped16_all} pairs dropped")
    # the config's capacity factor: drops, natural routing
    with _routing() as own:
        got = step(tok_m).full_tensor().float()
    pairs, dropped = _ep_dropped(own, cfg.n_experts, cfg.capacity_factor)
    flipped = _flipped(own, lead, B).tolist()
    del own
    _, mesh_wall = timed(lambda: step(tok_m), MESH_REPEATS)
    n_prefill += 1 + 2 * MESH_REPEATS
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"mesh {cfg.name} prefill: logits not finite")
    with _moe_ranges(), profile(activities=_activities(cfg)) as prof:
        t0 = time.perf_counter()
        step(tok_m)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    n_prefill += 1
    prof_row = _device_rows(prof, pwall, f"mesh prefill {cfg.name}")
    busy = prof_row["device_busy_s"]
    for name, (us, calls) in _range_kernels(
            prof, ("moe_block", "moe_ep")).items():
        prof_row[name] = dict(us=us, calls=calls, share_of_busy=(
            us / 1e6 / busy if isinstance(busy, float) else busy))
    peak_prefill = torch.cuda.max_memory_allocated()
    counts = _launches()
    want_counts = {k: n * n_prefill
                   for k, n in _want_launches(cfg, "prefill").items()}
    _check_launches(counts, want_counts, f"mesh {cfg.name} prefill")
    if KERNELS["flash_attention"].tc_launches != counts["flash_attention"]:
        raise AssertionError(f"mesh {cfg.name}: flash-attention launches off "
                             f"the tensor-core kernel")
    # the decode step off the mesh (the cache allocated only now: beside
    # the weights it leaves no room for the prefill's expert buffers)
    gather(model)
    g = torch.Generator(dev).manual_seed(3)
    cache = model.init_cache(Bd, Td)
    _fill_cache(cache, g)
    dtok = torch.randint(0, cfg.vocab_size, (Bd,), generator=g, device=dev,
                         dtype=torch.int32)
    dpos = torch.full((Bd,), Td - 1, dtype=torch.int32, device=dev)
    dstep = build_serve_step(model, plain)
    with _routing() as dlead:
        want_dec = dstep(cache, dtok, dpos)[0].float()
    _, dec_wall = timed(lambda: dstep(cache, dtok, dpos), MESH_REPEATS)
    # and on the mesh, the whole cache on the rank
    _reset_launches()
    ctx_d, shd = assemble(model, mesh, "decode", Bd, Td,
                          attention_impl="pallas")
    place(model, shd["params"], mesh)
    cache_m = place(cache, shd["cache"], mesh)
    dtok_m = place(dtok, shd["tokens"], mesh)
    dpos_m = place(dpos, shd["tokens"], mesh)
    mstep = build_serve_step(model, ctx_d)
    with _capacity(model, nodrop), _routing(dlead):
        got_dec = mstep(cache_m, dtok_m, dpos_m)[0].full_tensor().float()
    dscale = want_dec.abs().max().item()
    dec_diff = (got_dec - want_dec).abs().max().item()
    if not dec_diff <= PREFILL_RTOL * dscale:
        raise AssertionError(
            f"mesh {cfg.name} decode {Bd}x{Td} at capacity factor {nodrop},"
            f" experts forced: max |mesh - dense| {dec_diff} > "
            f"{PREFILL_RTOL} x max |logit| {dscale}")
    with _routing() as down:
        dec_m, mdec_wall = timed(lambda: mstep(cache_m, dtok_m, dpos_m),
                                 MESH_REPEATS)
    dpairs, ddropped = _ep_dropped(down, cfg.n_experts, cfg.capacity_factor)
    del down
    n_decode += 1 + MESH_REPEATS
    dec_counts = _launches()
    _check_launches(dec_counts, _want_launches(cfg, "decode", n_decode),
                    f"mesh {cfg.name} decode")
    counts = {k: n + dec_counts[k] for k, n in counts.items()}
    if not bool(torch.isfinite(dec_m[0].full_tensor()).all()):
        raise AssertionError(f"mesh {cfg.name} decode: logits not finite")
    peak = torch.cuda.max_memory_allocated()
    gather(model)
    del cache, cache_m
    torch.cuda.empty_cache()
    row = dict(
        arch=cfg.name, mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
        rules_batch=ctx.rules["batch"], moe_impl="ep (auto)",
        batch=B, prompt=S, capacity_factor=cfg.capacity_factor,
        nodrop_capacity_factor=nodrop,
        layer0_nodrop=dict(max_abs_diff=layer_diff, max_abs_y=scale,
                           pairs=pairs16, dropped=dropped16,
                           tol=MESH_LAYER_TOL),
        prefill_nodrop_forced=dict(max_abs_diff=forced_diff,
                                   max_abs_logit=lscale, rtol=PREFILL_RTOL),
        prefill=dict(wall_s=mesh_wall, tokens_s=B * S / mesh_wall,
                     dense_wall_s=dense_wall, dense_tokens_s=B * S / dense_wall,
                     nodrop_wall_s=nodrop_wall,
                     nodrop_tokens_s=B * S / nodrop_wall,
                     nodrop_pairs=pairs16_all, nodrop_dropped=dropped16_all,
                     pairs=pairs, dropped=dropped, dropped_share=dropped / pairs,
                     vs_dense_max_abs=(got - want).abs().max().item(),
                     argmax_agree=float((got.argmax(-1) == want.argmax(-1))
                                        .float().mean().item()),
                     flipped_requests=[i for i, f in enumerate(flipped) if f],
                     peak_mem_gb=peak_prefill / 1e9, profile=prof_row),
        decode=dict(batch=Bd, cache_len=Td, step_ms=mdec_wall * 1e3,
                    dense_step_ms=dec_wall * 1e3,
                    nodrop_forced_max_abs_diff=dec_diff,
                    max_abs_logit=dscale, pairs=dpairs, dropped=ddropped,
                    dropped_share=ddropped / max(dpairs, 1)),
        peak_mem_gb=peak / 1e9, launches=counts)
    return row, counts


def _snapshot(model, state: dict) -> dict:
    """A copy of ``model``'s weights and of its AdamW ``state``, on the
    card."""
    import torch
    with torch.no_grad():
        return dict(params={n: p.detach().clone()
                            for n, p in model.named_parameters()},
                    state={"m": {n: t.clone() for n, t in state["m"].items()},
                           "v": {n: t.clone() for n, t in state["v"].items()},
                           "step": state["step"].clone()})


def mesh_train(model, snap: dict, ref: dict, batch, steps: int, M: int
               ) -> dict:
    """The mesh path's train step.  ``model`` has just taken the step
    ``ref`` (its metrics) on ``batch`` off the mesh from the weights and
    AdamW state ``snap`` (``_snapshot``); its weights are swapped back to
    ``snap``'s, then, in a one-rank NCCL world, the model and the state
    are placed on a (1, 1) mesh in the ZeRO layout of
    ``assemble(..., "train", ...)`` (``opt_params``,
    ``opt_state_shardings``) and take one step of ``batch`` with the
    forward in the ``params`` layout, the run's optimizer (its schedule)
    rebuilt.  Held within ``MESH_TRAIN_RTOL``: the loss and the grad norm
    (relative to the step off the mesh), and each weight's change (max
    |mesh - off| over max |off - before|: the grads redistributed to the
    ZeRO placements, the moments updated on local shards, the step count
    and the global norm all enter it).  Its wall, the world's set-up
    included, beside the run's."""
    import math
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.shardings import (
        assemble, gather, opt_state_shardings, place)
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import AdamW, cosine_warmup
    cfg = model.cfg
    t_all = time.perf_counter()
    want_loss, want_norm = float(ref["loss"]), float(ref["grad_norm"])
    off, update = {}, {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            off[name], p.data = p.data, snap["params"][name]
            update[name] = (off[name] - p.data).abs().max()
    snap["params"] = None
    with _mesh_world():
        mesh = make_local_mesh(1, 1, device=model.device)
        ctx, sh = assemble(model, mesh, "train", TRAIN_BATCH, TRAIN_SEQ)
        # the run's optimizer (launch.train.build_trainer's)
        opt = AdamW(learning_rate=cosine_warmup(
            TRAIN_LR, warmup_steps=max(steps // 20, 5), total_steps=steps),
            decayed=model.decayed())
        place(model, sh["opt_params"], mesh)
        state = place(snap["state"],
                      opt_state_shardings(sh["opt_params"], mesh), mesh)
        snap["state"] = None
        batch_m = place(batch, sh["batch"], mesh)
        step = build_train_step(model, opt, ctx, M, compute=sh["params"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        met = step(state, batch_m)
        loss = float(met["loss"])
        wall = time.perf_counter() - t0
        gnorm = float(met["grad_norm"])
        peak = torch.cuda.max_memory_allocated()
        gather(model)
        del state, step
    worst, worst_name = -1.0, None
    with torch.no_grad():
        for name, p in model.named_parameters():
            d = ((p - off[name]).abs().max() / update[name]).item()
            if not d <= worst:
                worst, worst_name = d, name
    del off
    loss_dev = abs(loss - want_loss) / abs(want_loss)
    norm_dev = abs(gnorm - want_norm) / abs(want_norm)
    row = dict(arch=cfg.name, layers=cfg.n_layers,
               mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
               rules_batch=ctx.rules["batch"], batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, microbatches=M, loss=loss,
               loss_off_mesh=want_loss, loss_rel_dev=loss_dev,
               grad_norm=gnorm, grad_norm_off_mesh=want_norm,
               grad_norm_rel_dev=norm_dev, worst_update_rel_dev=worst,
               worst_update_leaf=worst_name, rtol=MESH_TRAIN_RTOL,
               step_wall_s=wall, wall_s=time.perf_counter() - t_all,
               peak_mem_gb=peak / 1e9)
    print("mesh train:", json.dumps(row), flush=True)
    if not (math.isfinite(loss) and math.isfinite(gnorm)
            and loss_dev <= MESH_TRAIN_RTOL and norm_dev <= MESH_TRAIN_RTOL
            and worst <= MESH_TRAIN_RTOL):
        raise AssertionError(
            f"mesh train {cfg.name}: loss {loss} vs {want_loss} off the "
            f"mesh (rel {loss_dev}), grad norm {gnorm} vs {want_norm} (rel "
            f"{norm_dev}), worst update {worst_name} rel {worst}: past "
            f"{MESH_TRAIN_RTOL} or not finite")
    return row


def start_dryrun(out_dir: Path) -> list:
    """The dryrun path (a): ``python -m repro_torch.launch.dryrun`` in one
    child process a group of ``DRYRUN_CELLS``, all started together, each
    writing its records to ``out_dir``; collected by ``finish_dryrun``.
    Returns ``[(records path, log, process, its start on time.time())]``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONPYCACHEPREFIX=str(_warm_bytecode(out_dir / "pycache")))
    procs = []
    for i, (arch, shapes, mesh, sets) in enumerate(DRYRUN_CELLS):
        out = out_dir / f"dryrun_{i}.json"
        out.unlink(missing_ok=True)
        log = open(out_dir / f"dryrun_{i}.log", "w")
        procs.append((out, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shapes, "--mesh", mesh, "--set", sets,
             "--out", str(out)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), time.time()))
    return procs


def finish_dryrun(procs: list) -> list:
    """Collect ``start_dryrun``'s children, each waited for
    ``DRYRUN_TIMEOUT`` s at most from here: each child's own wall (its
    start to its records' last write) printed on a ``dryrun child:`` line
    and held to ``DRYRUN_TIMEOUT``, each cell's roofline, memory and
    timings on a ``dryrun cell:`` line.  Raises on a child that fails or
    is slower than that and on any failed cell.  Returns the records."""
    records = []
    for out, log, proc, started in procs:
        rc = _wait(proc, DRYRUN_TIMEOUT)
        log.close()
        text = Path(log.name).read_text()
        if rc != 0 or "[FAIL]" in text or not out.exists():
            raise AssertionError(f"dry run {proc.args[3:]}: exit {rc}\n"
                                 f"{text[-3000:]}")
        wall = out.stat().st_mtime - started
        print("dryrun child:", json.dumps(dict(args=proc.args[3:],
                                               wall_s=wall)))
        if wall > DRYRUN_TIMEOUT:
            raise AssertionError(f"dry run {proc.args[3:]}: {wall} s, more "
                                 f"than {DRYRUN_TIMEOUT}")
        for key, rec in json.load(open(out)).items():
            if not rec.get("ok"):
                raise AssertionError(f"dry run {key}: {rec.get('error')}")
            records.append(rec)
            print("dryrun cell:", json.dumps({
                "cell": key, "devices": rec["devices"],
                "overrides": rec["overrides"], "roofline": rec["roofline"],
                "memory": rec["memory"], "timings": rec["timings"],
                "local_ops": rec["local_ops"],
                "collective_bytes": {k: v["bytes"] for k, v in
                                     rec["collectives"].items()},
                "probe_fit": rec.get("probe", {}).get("fit")}))
    return records


@contextlib.contextmanager
def dryrun_children(done):
    """The dryrun path (a) around a block: its children started before it
    (``start_dryrun``, under ``build/dryrun``) and collected after it
    (``finish_dryrun``), every child stopped if either fails."""
    procs = start_dryrun(ROOT / "build" / "dryrun")
    done("dryrun start")
    with _stopped(proc for _, _, proc, _ in procs):
        yield
        finish_dryrun(procs)
    done("dryrun cells (their wait)")


def _warm_bytecode(prefix: Path) -> Path:
    """Compile the sources of every module this process has loaded into
    ``prefix``, all cores at once, and return it: the dry run's children
    read their bytecode there (``PYTHONPYCACHEPREFIX``) where the
    installed packages hold none, instead of each compiling the same
    modules again (about 13 s a child on an H100 host)."""
    prefix.mkdir(parents=True, exist_ok=True)
    files = sorted({f for m in list(sys.modules.values())
                    if (f := getattr(m, "__file__", None))
                    and f.endswith(".py")})
    n = os.cpu_count() or 1
    procs = []
    for i in range(n):        # compileall compiles listed files serially
        part = prefix / f"sources_{i}.txt"
        part.write_text("\n".join(files[i::n]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "compileall", "-q", "-i", str(part)],
            env=dict(os.environ, PYTHONPYCACHEPREFIX=str(prefix)),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
    for p in procs:
        p.wait(timeout=DRYRUN_TIMEOUT)
    return prefix


def dryrun_count(model, tokens) -> tuple:
    """The dryrun path (b), on ``DRYRUN_SERVE``'s serving model and
    prefill batch: the prefill step (``last_only``) under
    ``attention_impl="auto"`` once under the dry run's ``CostCounter`` on
    the card (also the warm-up), then timed ``DRYRUN_REPEATS`` times; and
    once on a model of the same config on the meta device.  Holds the two
    FLOP counts equal and the measured wall at or above the H100
    roofline's bound of the count; no kernel launched.  Returns the row
    and the launches."""
    import torch
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.sharding import ModelContext
    from repro_torch.models.zoo import build_model
    ctx = ModelContext(attention_impl="auto")
    cfg = model.cfg
    B, S = tokens.shape
    _reset_launches()
    step = build_prefill_step(model, ctx, last_only=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    card = dr.CostCounter()
    card.hold([dict(model.named_parameters()), tokens])
    with card:
        logits = step(tokens)
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated()
    walls = []
    for _ in range(DRYRUN_REPEATS):
        t0 = time.perf_counter()
        step(tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    meta_model = build_model(cfg, "meta")
    meta = dr.CostCounter()
    meta_tokens = torch.empty(tokens.shape, dtype=tokens.dtype,
                              device="meta")
    meta.hold([dict(meta_model.named_parameters()), meta_tokens])
    with meta:
        build_prefill_step(meta_model, ctx, last_only=True)(meta_tokens)
    meta_s = time.perf_counter() - t0
    counts = _launches()
    if any(counts.values()):
        raise AssertionError(f"dryrun: kernel launches {counts}")
    if card.flops != meta.flops:
        raise AssertionError(f"dryrun: {card.flops} FLOPs counted on the "
                             f"card, {meta.flops} on meta")
    if logits.shape != (B, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("dryrun: prefill logits not finite")
    terms = {"compute_s": card.flops / dr.PEAK_FLOPS,
             "memory_s": card.bytes_accessed / dr.HBM_BW,
             "collective_s": card.costs()["collective_s"]}
    bound = max(terms.values())
    wall = statistics.median(walls)
    if wall < bound:
        raise AssertionError(f"dryrun: prefill wall {wall} s below the "
                             f"roofline's bound {bound} s")
    mf = dr.model_flops(cfg, "prefill", B, S)
    row = dict(arch=cfg.name, batch=B, prompt=S, impl="auto",
               wall_s=wall, wall_s_runs=walls, bound_step_s=bound,
               dominant=max(terms, key=terms.get), **terms,
               wall_over_bound=wall / bound, flops=card.flops,
               flops_meta=meta.flops, bytes_accessed=card.bytes_accessed,
               bytes_accessed_meta=meta.bytes_accessed,
               local_ops=card.local_ops, local_ops_meta=meta.local_ops,
               model_flops=mf, useful_compute_ratio=mf / card.flops,
               peak_bytes_counted=card.peak_bytes,
               peak_bytes_meta=meta.peak_bytes,
               peak_bytes_allocator=card_peak,
               allocated_before=base, meta_count_s=meta_s)
    return row, counts


def serve(arch: str, dev, done, walk=None, walk_dec=None) -> tuple:
    """Every serving phase of ``arch``: build, prefill (checked),
    ``walk`` (the per-layer checks) where given, prefill profile (with an
    MoE model's ``moe_block`` and ``moe_dense`` shares read from its
    trace, and ``moe_share``), ``generate``, decode at context,
    ``walk_dec`` (the decode step's per-layer checks) where given, and for
    ``MESH_SERVE`` the mesh path on the same model (``mesh_moe``).
    Returns the launches of each main-path run by path."""
    import torch
    model, init_s = build_lm(arch, dev)
    prefill, tokens, counts = drive_prefill(model, init_s)
    print("serve prefill:", json.dumps(prefill))
    by_path = {f"{arch} prefill": counts}
    check_prefill(prefill)
    done(f"{arch} prefill")
    if walk is not None:
        print("serve layers:", json.dumps(walk(model, tokens)))
        done(f"{arch} prefill by layer")
    prof = profile_prefill(model, tokens)
    if model.cfg.is_moe:
        prof["moe_block_alone"] = moe_share(model)
    print("profile:", json.dumps(prof))
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
    if arch == DRYRUN_SERVE:
        row, by_path["dryrun"] = dryrun_count(model, tokens)
        print("dryrun card:", json.dumps(row))
        done(f"{arch} dryrun count")
    if arch == MESH_SERVE:
        with _mesh_world():
            row, by_path["mesh"] = mesh_moe(model, tokens,
                                            prefill["wall_s"])
        print("mesh serve:", json.dumps(row))
        done(f"{arch} mesh")
    del model, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


def serve_families(dev, done) -> dict:
    """The MoE, audio and VLM serving phases (``FAMILY_SERVE``), each
    model built after the previous one's memory is freed; the MoE
    models' prefill and decode step at context walked layer by layer
    (``MOE_DEPTHS``).  Returns the launches by path."""
    walk = functools.partial(walk_layers, depths=MOE_DEPTHS)
    by_path = {}
    for arch, sizes in FAMILY_SERVE.items():
        walk_dec = functools.partial(walk_decode, shape=sizes["decode_ctx"][0],
                                     depths=MOE_DEPTHS)
        by_path.update(serve(arch, dev, done, *(
            (walk, walk_dec) if sizes["walk"] else ())))
    return by_path


def _wait(proc, timeout: float):
    """Wait ``timeout`` s for a child process: its exit code, or
    ``"timeout"`` after killing it."""
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return "timeout"


@contextlib.contextmanager
def _stopped(procs):
    """Kill and reap every process of ``procs`` still running when the
    block ends, however it ends."""
    procs = list(procs)
    try:
        yield procs
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


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
    # the comparison and edge-to-HPC examples in child processes beside
    # the heap parity and cross-check phases: all host-bound, the card
    # idle most of the time
    examples = start_examples(dev)
    with _stopped(proc for _, proc, _ in examples):
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
        by_path["examples"] = drive_examples(dev, done, examples)
    print("profile:", json.dumps(profile_cell(dev)))
    print("cohort profile:", json.dumps(profile_cohort(dev)))
    done("profiles")
    by_path.update(serve("granite-8b", dev, done, walk_layers, walk_decode))
    by_path.update(serve("zamba2-7b", dev, done, walk_ssd))
    by_path.update(serve_families(dev, done))
    by_path.update(serve("xlstm-1.3b", dev, done, walk_xlstm,
                         walk_decode_xlstm))
    by_path["train"], train_rows = drive_train_phase(
        dev, done, beside=(DRYRUN_BESIDE, lambda: dryrun_children(done)))
    by_path["stream"] = drive_stream_phase(
        dev, done, train_rows["granite-8b"]["step_wall_s"])
    mesh = by_path["mesh"]
    if not all(mesh[k] for k in ("flash_attention", "rmsnorm",
                                 "flash_decode")):
        raise AssertionError(f"mesh: kernel launches {mesh}")
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
