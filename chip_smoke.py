#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, one line each: the card; the kernel build from the sources in
the checkout (one ``nvcc`` per source, all started together); every
kernel against its plain PyTorch version on the card, with its time
beside its bound (the pump bitwise; flash attention at the tolerances
of ``tests/test_kernels.py`` and, row by row, against its plain version
in float32, on granite-8b's and gemma2-9b's shapes and the edge cases,
beside ``scaled_dot_product_attention``).  Then the two paths, each
with its kernel launches counted from 0:

* the wave path — ``run_many`` at deployment scale (1024x1024
  work-sharing on dts, prs-haproxy and mss, 256x256 feedback on dts,
  three seed-lanes each); the same Fig 4 cell run on the GPU and on the
  CPU, compared; and a ``torch.profiler`` breakdown of one cell;
* the serving path — granite-8b at full width and depth (36 layers,
  random bf16 weights from a seed): ``build_prefill_step`` with the
  flash-attention kernel on 4 requests x 4096 prompt tokens (one kernel
  launch per layer), its logits held to the same prefill with each
  plain attention (reference, blocked); the prefill walked layer by
  layer with each attention, the kernel checked on every layer's own
  q, k, v and the logits compared by depth; a ``torch.profiler``
  breakdown of one prefill; ``generate`` (4 requests, 16-token prompts,
  16 new tokens, greedy), with its own profile; and decode steps
  against a full cache of 128 x 2048 and 32 x 8192 tokens, profiled.

The line before the last holds the kernels' numbers as JSON, and the
last line the device.  Any failure exits nonzero; without CUDA it exits
1 before printing a result.
"""

from __future__ import annotations

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

#: flash-attention checks on the card: (case, dtype, B, S, T, H, KV, hd,
#: causal, window, logit cap).  The first is the serving path's shape
#: (granite-8b prefill, 4 x 4096 tokens) and is the one timed.
ATTN_CASES = (
    ("granite-8b prefill", "bfloat16", 4, 4096, 4096, 32, 8, 128, True, 0, 0.0),
    ("granite-8b B=1", "bfloat16", 1, 4096, 4096, 32, 8, 128, True, 0, 0.0),
    ("gemma2-9b local", "bfloat16", 1, 8192, 8192, 16, 8, 256, True, 4096, 50.0),
    ("f32 hd=64", "float32", 2, 1024, 1024, 8, 2, 64, True, 0, 0.0),
    ("non-causal", "bfloat16", 2, 1024, 1024, 8, 8, 128, False, 0, 0.0),
    ("MQA", "bfloat16", 2, 1024, 1024, 16, 1, 128, True, 0, 0.0),
    ("ragged S", "bfloat16", 1, 1000, 1000, 8, 2, 128, True, 0, 0.0),
    ("ragged f32 window softcap", "float32", 1, 777, 777, 4, 2, 64, True, 100, 30.0),
)
#: serving path: granite-8b, requests x prompt tokens (cut from
#: prefill_32k's 32 x 32768, whose SwiGLU intermediate does not fit)
SERVE_ARCH = "granite-8b"
PREFILL_BATCH, PREFILL_LEN = 4, 4096
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 4, 16, 16
#: decode steps against a full cache: (requests, cache length), the same
#: 262144 cached tokens (38.65 GB of bf16 K/V) cut from decode_32k's
#: 128 x 32768 (618 GB); timed steps of each
DECODE_CTX = ((128, 2048), (32, 8192))
DECODE_CTX_STEPS = 5
#: prefill logits against the same prefill with each plain attention
#: (reference, blocked): max |diff| over max |logit|, and the argmax
#: equal.  36 layers of random weights amplify every bf16 rounding: on
#: the H100 the two plain attentions themselves differ by 4.9e-2 of max
#: |logit|, and any two of the three by 3.9e-2 to 5.3e-2.  After the
#: first layer, before any amplification, the limit is SHALLOW_RTOL
#: (``walk_layers`` reads the spread at each of ``DEPTHS``); the
#: kernel's own accuracy is held at every layer (``_hold``).
PREFILL_RTOL = 1e-1
SHALLOW_RTOL = 2e-2
DEPTHS = (1, 2, 4, 9, 18, 36)
#: the kernel against its plain version in float32 on the same values,
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
    """Phase 3: the pump kernel against ``pump_assign_ref`` on the card,
    bitwise, at the main-path shapes and the edge cases; its time, the
    plain version's time and the bound at the main-path shape."""
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
                library_ms=None, cases=len(cases), call_ms=call_ms,
                plain_call_ms=plain_call_ms)


def _attn_tol(dtype: str, window: int, cap: float) -> float:
    """``tests/test_kernels.py``'s tolerances (rtol = atol)."""
    if dtype == "bfloat16":
        return 2e-2
    return 3e-5 if (window or cap) else 2e-5


def _hold(got, q, k, v, pos, kw: dict, what: str) -> dict:
    """The kernel's output ``got`` on ``q, k, v`` against its plain
    version: at ``tests/test_kernels.py``'s tolerance on the same
    inputs, and against the plain version in float32 on the same values
    within twice one rounding of each output (2^-7 relative in bf16)
    plus ``ROW_ATOL`` of its row's RMS.  The second limit scales with each
    row: the flat one is as large as the outputs of the late rows of a
    long causal sequence (|out| ~ 0.03 at row 4096).  Returns the
    readings: max abs error, max error over its row's RMS, and the
    largest share of the row limit used."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_ref
    g = got.float()
    want = flash_attention_ref(q, k, v, pos, pos, **kw).float()
    tol = _attn_tol(str(q.dtype).removeprefix("torch."), kw["window"],
                    kw["logit_cap"])
    diff = (g - want).abs()
    flat_ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= tol + tol * want.abs()).all())
    err = diff.max().item()
    del want, diff
    want = flash_attention_ref(q.float(), k.float(), v.float(), pos, pos, **kw)
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    u = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    diff = (g - want).abs()
    row_err = (diff / rms).max().item()
    use = (diff / (u * want.abs() + ROW_ATOL * rms)).max().item()
    if not (flat_ok and use <= 1.0):
        raise AssertionError(f"flash_attention differs from its plain "
                             f"version on {what}: max abs err {err} (tol "
                             f"{tol}), row limit used {use} (limit 1)")
    return dict(max_abs_err=err, tol=tol, row_rel_err=row_err,
                row_limit_used=use)


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


def check_flash(dev) -> dict:
    """Phase 3b: the flash-attention kernel against
    ``flash_attention_ref`` on the card at every ``ATTN_CASES`` shape;
    at the serving path's shape its time, the plain version's, one
    ``scaled_dot_product_attention`` call's, and the bounds."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_ref)
    g = torch.Generator(dev).manual_seed(0)
    rows, timed = [], None
    for case, dtype, B, S, T, H, KV, hd, causal, window, cap in ATTN_CASES:
        td = getattr(torch, dtype)
        q = torch.randn(B, S, H, hd, generator=g, device=dev).to(td)
        k = torch.randn(B, T, KV, hd, generator=g, device=dev).to(td)
        v = torch.randn(B, T, KV, hd, generator=g, device=dev).to(td)
        pos = torch.arange(S, device=dev, dtype=torch.int32)
        kw = dict(causal=causal, window=window, logit_cap=cap)
        got = flash_attention(q, k, v, pos, pos, **kw)
        torch.cuda.synchronize()
        rows.append(dict(case=case, **_hold(got, q, k, v, pos, kw, case)))
        del got
        if timed is None:
            timed = (q, k, v, pos, kw, rows[-1]["max_abs_err"])
        else:
            del q, k, v
        torch.cuda.empty_cache()
    q, k, v, pos, kw, err = timed
    B, S, H, hd = q.shape
    KV = k.shape[2]
    ms = _cuda_ms(lambda: flash_attention(q, k, v, pos, pos, **kw), 3, 5)
    plain_ms = _cuda_ms(lambda: flash_attention_ref(q, k, v, pos, pos, **kw),
                        2, 3)
    # the library's fused attention on the same data, (B, H, S, hd) layout
    # made once outside the timing
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    lib_err = (sdpa().transpose(1, 2).float()
               - flash_attention(q, k, v, pos, pos, **kw).float()).abs().max()
    library_ms = _cuda_ms(sdpa, 5, 5)
    pairs = _visible_pairs(pos, kw["causal"], kw["window"])
    flops = 4 * B * H * hd * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + 2 * pos.numel() * 4
    ops_ms, bytes_ms = flops / BF16_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:79",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=library_ms, cases=rows,
                shape=dict(B=B, S=S, H=H, KV=KV, hd=hd, dtype=str(q.dtype)),
                flops=flops, bytes=nbytes, tflops=flops / ms / 1e9,
                sdpa_max_abs_diff=lib_err.item())


def drive_prefill(dev):
    """Serving path, prefill: granite-8b at full width and depth with
    random weights from a seed, ``build_prefill_step(last_only=True)``
    on ``PREFILL_BATCH`` x ``PREFILL_LEN`` tokens with the flash kernel,
    warm, timed ``WALL_REPEATS`` times with the kernel's launches
    counted from 0 for each; then the same prefill with the reference
    attention, compared.  Returns the row, the model and the tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.sharding import ModelContext
    from repro_torch.models.zoo import build_model
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, dev).init_params(
        torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev, dtype=torch.int32)
    step = build_prefill_step(model, ModelContext(attention_impl="pallas"),
                              last_only=True)
    step(tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, counts = [], []
    for _ in range(WALL_REPEATS):
        flash_attention.launches = 0
        t0 = time.perf_counter()
        logits = step(tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(flash_attention.launches)
        if counts[-1] != cfg.n_layers:
            raise AssertionError(f"prefill: {counts[-1]} flash-attention "
                                 f"launches, want one per layer "
                                 f"({cfg.n_layers})")
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
    row = dict(arch=SERVE_ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
               params=n_params, batch=PREFILL_BATCH, prompt=PREFILL_LEN,
               init_s=init_s, wall_s=wall, wall_s_runs=walls,
               tokens_s=PREFILL_BATCH * PREFILL_LEN / wall,
               flash_launches=counts, peak_mem_gb=peak / 1e9,
               logits_max_abs=scale,
               dev_vs_reference=(logits.float() - ref).abs().max().item(),
               dev_vs_blocked=(logits.float() - blk).abs().max().item(),
               dev_blocked_vs_reference=(blk - ref).abs().max().item(),
               rtol=PREFILL_RTOL,
               **{f"argmax_agree_{impl}": float(
                   (logits.argmax(-1) == o.argmax(-1)).float().mean().item())
                  for impl, o in other.items()})
    return row, model, tokens


def check_prefill(row: dict) -> None:
    """The kernel's prefill logits against both plain attentions': within
    ``PREFILL_RTOL`` of max |logit|, and the same argmax on every
    request."""
    scale = row["logits_max_abs"]
    for impl in ("reference", "blocked"):
        dev = row[f"dev_vs_{impl}"]
        if not dev <= PREFILL_RTOL * scale:
            raise AssertionError(f"prefill logits, flash vs {impl} "
                                 f"attention: max |diff| {dev} > "
                                 f"{PREFILL_RTOL} x max |logit| {scale}")
        if row[f"argmax_agree_{impl}"] != 1.0:
            raise AssertionError(f"prefill: flash and {impl} attention "
                                 f"pick different next tokens")


def _last_logits(model, x):
    """The vocab head on the last position of the residual stream ``x``,
    as ``TransformerLM.forward(last_only=True)`` computes it."""
    from repro_torch.models import layers as L
    h = L.rmsnorm(x[:, -1:], model.final_norm)
    return L.unembed(h, model.head(), model.cfg.final_logit_softcap)[:, 0].float()


def walk_layers(model, tokens) -> dict:
    """One prefill walked layer by layer three times over, each stream
    carrying its own residual: with the kernel, the reference attention
    and the blocked attention.  At every layer the kernel is held
    (``_hold``) on the reference stream's own q, k, v.  At each of
    ``DEPTHS`` the three streams' last-position logits are compared,
    over max |logit| of the reference stream: how the spread between
    equally correct attentions grows with depth.  After the first layer
    the kernel must lie within ``SHALLOW_RTOL`` of each plain attention,
    at every depth within ``PREFILL_RTOL``.  These launches are checks,
    not the main path's."""
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
            rel = lambda a, b: (lg[a] - lg[b]).abs().max().item() / scale
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
                        f"logits after {i + 1} layers, flash vs {o}: "
                        f"{pt[f'flash_vs_{o}']} of max |logit| > {limit}")
    return dict(arch=model.cfg.name, layers=len(model.blocks),
                tol=_attn_tol("bfloat16", 0, 0.0), row_atol=ROW_ATOL,
                **worst, shallow_rtol=SHALLOW_RTOL, rtol=PREFILL_RTOL,
                by_depth=curve)


def profile_prefill(model, tokens) -> dict:
    """Device busy time and the top kernels of one warm prefill, from
    ``torch.profiler``."""
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
    return _device_rows(prof, wall, "prefill " + SERVE_ARCH)


def profile_decode(model) -> dict:
    """Device busy time and the top kernels of ``generate`` (warm), from
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import generate
    prompts = torch.zeros((DECODE_BATCH, DECODE_PROMPT), dtype=torch.int32,
                          device=model.device)
    generate(model, prompts, DECODE_NEW)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(model, prompts, DECODE_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _device_rows(prof, wall, "decode " + SERVE_ARCH)


def drive_decode(model) -> dict:
    """Serving path, decode: ``generate`` on the prefill's model, greedy,
    warm then timed; no flash-attention launch (the reference's decode
    runs no kernel either)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import generate
    V = model.cfg.vocab_size
    prompts = torch.randint(0, V, (DECODE_BATCH, DECODE_PROMPT),
                            generator=torch.Generator(model.device).manual_seed(2),
                            device=model.device, dtype=torch.int32)
    generate(model, prompts, DECODE_NEW)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    toks = generate(model, prompts, DECODE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if toks.shape != (DECODE_BATCH, DECODE_PROMPT + DECODE_NEW):
        raise AssertionError(f"generate: shape {tuple(toks.shape)}")
    if not (bool(torch.equal(toks[:, :DECODE_PROMPT], prompts))
            and int(toks.min()) >= 0 and int(toks.max()) < V):
        raise AssertionError("generate: prompt not kept or ids outside the "
                             "vocabulary")
    if flash_attention.launches:
        raise AssertionError("generate launched the prefill kernel")
    steps = DECODE_PROMPT + DECODE_NEW - 1
    return dict(arch=SERVE_ARCH, batch=DECODE_BATCH, prompt=DECODE_PROMPT,
                new=DECODE_NEW, wall_s=wall, steps=steps,
                step_ms=wall / steps * 1e3,
                new_tokens_s=DECODE_BATCH * DECODE_NEW / wall,
                sample=toks[0, DECODE_PROMPT:].tolist())


def drive_decode_ctx(model) -> list:
    """Serving path, decode at a deployment-like context: for each
    ``DECODE_CTX`` (requests, cache length), ``build_serve_step`` against
    a cache of that length filled with random keys and values, every
    request at its last position (a step reads the whole cache whatever
    the position).  One warm step, ``DECODE_CTX_STEPS`` timed, two under
    ``torch.profiler``; the bound is the weights and the cache read once
    at ``HBM_BPS``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models.sharding import ModelContext
    dev, V = model.device, model.cfg.vocab_size
    step = build_serve_step(model, ModelContext())
    g = torch.Generator(dev).manual_seed(3)
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    rows = []
    for B, T in DECODE_CTX:
        cache = model.init_cache(B, T)
        for c in cache.values():
            c.normal_(generator=g)
        c_bytes = sum(c.numel() * c.element_size() for c in cache.values())
        tokens = torch.randint(0, V, (B,), generator=g, device=dev,
                               dtype=torch.int32)
        pos = torch.full((B,), T - 1, dtype=torch.int32, device=dev)
        step(cache, tokens, pos)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        for _ in range(DECODE_CTX_STEPS):
            logits, _ = step(cache, tokens, pos)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / DECODE_CTX_STEPS
        if logits.shape != (B, V) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"decode step {B}x{T}: logits shape "
                                 f"{tuple(logits.shape)} or not finite")
        if flash_attention.launches:
            raise AssertionError("the decode step launched the prefill kernel")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                step(cache, tokens, pos)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        rows.append(dict(
            arch=SERVE_ARCH, batch=B, cache_len=T, cache_gb=c_bytes / 1e9,
            steps=DECODE_CTX_STEPS, step_ms=wall * 1e3,
            new_tokens_s=B / wall,
            bound_ms=(w_bytes + c_bytes) / HBM_BPS * 1e3,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            profile=_device_rows(prof, pwall, f"decode {B}x{T}, 2 steps")))
        del cache, logits
        torch.cuda.empty_cache()
    return rows


def _specs(pattern: str, arch: str, n: int, msgs: int):
    from repro_torch import ExperimentSpec, SimParams, get_workload
    return [ExperimentSpec(pattern=pattern, workload=get_workload("dstream"),
                           arch=arch, n_producers=n, n_consumers=n,
                           total_messages=msgs, params=SimParams(seed=s))
            for s in SEEDS]


def drive_main_path(dev) -> tuple[list, int]:
    """Phase 4: every main-path cell through ``run_many`` on the card,
    warm (after one untimed run), timed ``WALL_REPEATS`` times, each
    run with the pump launches counted from 0.  Returns the per-cell rows and the total launches."""
    import torch
    from repro_torch import run_many, summarize
    from repro_torch.core import torch_device_loop as dl
    from repro_torch.core.cell import WaveCell
    from repro_torch.kernels.pump_assign import pump_assign
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
            pump_assign.launches = 0
            t0 = time.perf_counter()
            res = run_many(specs, device=dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts.append(pump_assign.launches)
            if counts[-1] < need:
                raise AssertionError(
                    f"{pattern}/{arch}: {counts[-1]} pump launches < {need}: "
                    f"the main path missed the kernel")
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
    """Phase 5: the 64-consumer Fig 4 cell on the card and on the CPU,
    traces and summaries compared at ``XDEV_RTOL``."""
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


def _device_rows(prof, wall: float, cell: str) -> dict:
    """Device busy time, idle share of ``wall`` and the top kernels of a
    ``torch.profiler`` run."""
    import torch
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): the CPU-side op
        # events carry the same device time again
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = ev.self_device_time_total
        if dt:
            rows.append((dt, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    return dict(cell=cell, wall_s=wall,
                device_busy_s=busy if rows else "not measured",
                idle_share=1.0 - busy / wall if rows else "not measured",
                device_events=sum(r[1] for r in rows),
                top=[dict(us=r[0], count=r[1], name=r[2][:80])
                     for r in rows[:8]])


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
    pump = check_pump(dev)
    print("kernel check:", json.dumps(pump))
    flash = check_flash(dev)
    print("kernel check:", json.dumps(flash))
    done("kernel checks")
    rows, launches = drive_main_path(dev)
    for r in rows:
        print("main path:", json.dumps(r))
    pump["launches"] = launches
    done("wave cells")
    print("cross-check:", json.dumps(cross_check(dev)))
    print("profile:", json.dumps(profile_cell(dev)))
    done("wave cross-check and profile")
    prefill, model, tokens = drive_prefill(dev)
    print("serve prefill:", json.dumps(prefill))
    flash["launches"] = prefill["flash_launches"][0]
    done("prefill")
    print("serve layers:", json.dumps(walk_layers(model, tokens)))
    done("prefill by layer")
    print("profile:", json.dumps(profile_prefill(model, tokens)))
    print("serve decode:", json.dumps(drive_decode(model)))
    print("profile:", json.dumps(profile_decode(model)))
    done("prefill profile and generate")
    for r in drive_decode_ctx(model):
        print("serve decode context:", json.dumps(r))
    done("decode at context")
    print("phase seconds:", json.dumps(phase_s))
    check_prefill(prefill)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in (pump, flash)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
