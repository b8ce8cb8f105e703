"""RMSNorm alone on the card: where a decode-sized call's host time goes,
and the device time of the kernel's three designs.

``breakdown``: at 32 x 4096 bf16 (a decode step's rows), each piece of
the launch path timed with a host clock over ``CALLS`` calls (median of
``REPEATS`` loops, each ended by a synchronize): the whole call through
``layers.rmsnorm`` (under ``pallas``), ``ops.rmsnorm`` and the wrapper
(the differences are the two outer frames), then the wrapper's pieces,
and one ``F.rms_norm`` call beside them.  The pieces are the wrapper's
own expressions, repeated here; the parent tree's wrapper (which has
``_check`` and builds a ``(rows, D)`` view) gets its own list.

``designs``: the device time (calls captured in a CUDA graph) of three
designs at every ``chip_smoke.RMS_CASES`` shape, in turns 0, 1, 2, 2, 1,
0, each with its plan, and beside them ``Tensor.copy_`` of the same
bytes: 0 is the package's kernel (one CTA a row), 1 and 2 the persistent
designs of ``chip_probes/rmsnorm_designs.cu`` (a register double buffer;
a TMA ring), all built there into one library.

Run from the root of a checkout on a machine with one NVIDIA GPU; the
checkout's own ``src/`` is used, so a parent commit unpacked elsewhere is
timed by running this file from that tree's root (``breakdown`` only)::

    python3 chip_probes/rmsnorm_probe.py [breakdown] [designs]
"""
import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.getcwd(), "src"))
sys.path.insert(1, os.getcwd())
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import layers as TL
from repro_torch.models.sharding import ModelContext

CALLS, REPEATS = 10_000, 5
dev = torch.device("cuda")


def host_us(fn) -> float:
    """Host microseconds a call: ``CALLS`` calls, then a synchronize;
    median of ``REPEATS`` loops after a warm-up loop."""
    times = []
    for k in range(REPEATS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        if k:
            times.append((time.perf_counter() - t) / CALLS * 1e6)
    return statistics.median(times)


def event_ms(fn, n_iter: int, repeats: int = 7) -> float:
    """As ``chip_smoke._cuda_ms``: CUDA events around ``n_iter`` calls."""
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


def graph_ms(fn, n_iter: int = 20, repeats: int = 7) -> float:
    """As ``chip_smoke._graph_ms``: ``n_iter`` calls in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_iter):
            fn()
    return event_ms(graph.replay, 1, repeats) / n_iter


def pieces_now(x, w, out, D):
    """The wrapper's pieces, as ``kernels/rmsnorm.py`` has them."""
    launch, current_device, current_stream = rn._cuda()
    released = ctypes.CDLL(str(_build.build("rmsnorm"))).rmsnorm_launch
    released.argtypes, released.restype = launch.argtypes, launch.restype
    shape, dev_i = x.shape, x.get_device()
    xp, wp, op, st = (x.data_ptr(), w.data_ptr(), out.data_ptr(),
                      current_stream(dev_i))

    def checks():
        s = x.shape
        return ((not s or s[-1] < 1 or w.shape != s[-1:]),
                x.dtype not in rn._DTYPE_CODE or w.dtype != torch.float32,
                torch.is_grad_enabled() and (x.requires_grad
                                             or w.requires_grad),
                not x.is_cuda)

    def device():
        launch_, cd, cs = rn._cuda()
        d = x.get_device()
        return w.get_device() != d or d != cd()

    def strides():
        s = x.stride()
        bad = (s[-1] != 1 and D > 1) or not w.is_contiguous()
        return bad, rn._rows(shape, s)

    def counter():
        rn.rmsnorm.launches += 1

    return {
        "checks (shape, dtype, grad, is_cuda)": checks,
        "device (_cuda(), get_device x2, current device)": device,
        "strides and rows (_rows)": strides,
        "allocation (torch.empty_like)": lambda: torch.empty_like(
            x, memory_format=torch.contiguous_format),
        "allocation as torch.empty (not used)": lambda: torch.empty(
            x.shape, dtype=x.dtype, device=x.device),
        "data_ptr x3": lambda: (x.data_ptr(), w.data_ptr(), out.data_ptr()),
        "stream (raw, current)": lambda: current_stream(dev_i),
        "stream as torch.cuda.current_stream() (not used)":
            lambda: torch.cuda.current_stream().cuda_stream,
        "ctypes call and launch (GIL held)": lambda: launch(
            xp, wp, op, 1, x.shape[0], D, D, 1e-6, st),
        "ctypes call, no launch (R = 0)": lambda: launch(
            xp, wp, op, 1, 0, D, D, 1e-6, st),
        "ctypes call and launch, GIL released (CDLL; not used)":
            lambda: released(xp, wp, op, 1, x.shape[0], D, D, 1e-6, st),
        "launch counter": counter,
    }


def pieces_parent(x, w, out, D):
    """The parent tree's wrapper pieces (``_check``, a view, ...)."""
    from repro_torch.kernels._grad import refuse_grad
    fn = rn._launcher()
    rows = x.view(-1, D)
    xp, wp, op = rows.data_ptr(), w.data_ptr(), out.data_ptr()
    st = torch.cuda.current_stream().cuda_stream

    def strides():
        r = x.view(-1, D)
        return ((r.stride(1) != 1 and D > 1) or not w.is_contiguous(),
                r.shape[0] >= 2 ** 31)

    def align():
        vec = 16 // x.element_size()
        return (D % vec == 0 and rows.stride(0) % vec == 0
                and rows.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)

    def counter():
        rn.rmsnorm.launches += 1

    return {
        "_check": lambda: rn._check(x, w),
        "refuse_grad": lambda: refuse_grad("rmsnorm", x, w),
        "device (x.device.type, current_device)": lambda: (
            x.device.type != "cpu",
            x.device.index != torch.cuda.current_device()),
        "view and strides": strides,
        "allocation (torch.empty)": lambda: torch.empty(
            x.shape, dtype=x.dtype, device=x.device),
        "data_ptr x3": lambda: (rows.data_ptr(), w.data_ptr(),
                                out.data_ptr()),
        "alignment arithmetic": align,
        "stream (torch.cuda.current_stream)":
            lambda: torch.cuda.current_stream().cuda_stream,
        "ctypes call and launch": lambda: fn(
            xp, wp, op, 1, x.shape[0], D, D, 1e-6, 1, st),
        "launch counter": counter,
    }


def breakdown() -> dict:
    R, D = 32, 4096
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(R, D, generator=g, device=dev).to(torch.bfloat16)
    w = 0.1 * torch.randn(D, generator=g, device=dev)
    w1 = (1 + w).to(x.dtype)
    out = torch.empty_like(x)
    ctx = ModelContext(attention_impl="pallas")
    torch.testing.assert_close(rn.rmsnorm(x, w), rn.rmsnorm_ref(x, w),
                               rtol=2e-2, atol=2e-2)
    whole = {
        "layers.rmsnorm (pallas)": lambda: TL.rmsnorm(x, w, 1e-6, ctx),
        "ops.rmsnorm": lambda: ops.rmsnorm(x, w),
        "wrapper": lambda: rn.rmsnorm(x, w),
        "F.rms_norm": lambda: F.rms_norm(x, (D,), w1, 1e-6),
    }
    tree = "parent" if hasattr(rn, "_check") else "this"
    parts = (pieces_parent if tree == "parent" else pieces_now)(x, w, out, D)
    res = {"tree": tree, "shape": [R, D], "calls": CALLS,
           "host_us": {k: host_us(f) for k, f in whole.items()}}
    res["host_us"]["frame layers.rmsnorm"] = (
        res["host_us"]["layers.rmsnorm (pallas)"] - res["host_us"]["ops.rmsnorm"])
    res["host_us"]["frame ops.rmsnorm"] = (
        res["host_us"]["ops.rmsnorm"] - res["host_us"]["wrapper"])
    res["pieces_us"] = {k: host_us(f) for k, f in parts.items()}
    res["pieces_sum_us"] = sum(v for k, v in res["pieces_us"].items()
                               if "not used" not in k and "R = 0" not in k)
    res["empty_loop_us"] = host_us(lambda: None)
    res["event_ms"] = {"wrapper": event_ms(whole["wrapper"], 20),
                       "layers.rmsnorm (pallas)": event_ms(
                           whole["layers.rmsnorm (pallas)"], 20),
                       "F.rms_norm": event_ms(whole["F.rms_norm"], 20)}
    res["graph_ms"] = {"wrapper": graph_ms(whole["wrapper"]),
                       "F.rms_norm": graph_ms(whole["F.rms_norm"])}
    return res


def designs_library() -> ctypes.CDLL:
    """``chip_probes/rmsnorm_designs.cu`` (design 0, the package's source,
    with designs 1 and 2 beside it), built as the package's kernels are."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "rmsnorm_designs.cu")
    out = os.path.join("build", "rmsnorm_probe", "librmsnorm_designs.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                   check=True)
    lib = ctypes.CDLL(os.path.abspath(out))
    lib.rmsnorm_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                   + [ctypes.c_int64, ctypes.c_float,
                                      ctypes.c_void_p])
    lib.rmsnorm_persistent_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
           ctypes.c_void_p])
    return lib


def designs() -> list:
    import chip_smoke as cs
    lib = designs_library()
    g = torch.Generator(dev).manual_seed(1)
    rows = []
    for case, dtype, R, D in cs.RMS_CASES:
        x = torch.randn(R, D, generator=g, device=dev).to(getattr(torch, dtype))
        w = 0.1 * torch.randn(D, generator=g, device=dev)
        want = rn.rmsnorm_ref(x, w)
        info = {1: (ctypes.c_int * 7)(), 2: (ctypes.c_int * 7)()}

        def run(design, out):
            args = (x.data_ptr(), w.data_ptr(), out.data_ptr(),
                    rn._DTYPE_CODE[x.dtype], R, D, D, 1e-6)
            stream = torch.cuda.current_stream().cuda_stream
            err = (lib.rmsnorm_launch(*args, stream) if design == 0 else
                   lib.rmsnorm_persistent_launch(*args, design - 1, stream,
                                                 info[design]))
            if err:
                raise RuntimeError(f"design {design}: CUDA error {err}")

        row = dict(case=case, dtype=dtype, rows=R, D=D)
        tol = 2e-2 if dtype == "bfloat16" else 1e-5
        for design in (0, 1, 2):
            out = torch.empty_like(x)
            run(design, out)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                       atol=tol)
        row["plan0"] = rn.plan(x, w, out)
        for design in (1, 2):
            row[f"plan{design}"] = dict(zip(
                ("threads", "grid", "ctas_per_sm", "prefetch", "smem",
                 "registers", "local_bytes"), info[design]))
        times = {0: [], 1: [], 2: []}
        for design in (0, 1, 2, 2, 1, 0):
            out = torch.empty_like(x)
            times[design].append(graph_ms(functools.partial(run, design, out)))
        row["device_ms"] = {d: min(t) for d, t in times.items()}
        # the same bytes moved by PyTorch's copy: what the card's memory
        # gives a read-once, write-once pass
        out = torch.empty_like(x)
        row["copy_ms"] = graph_ms(functools.partial(out.copy_, x))
        row["bound_ms"] = (2 * x.numel() * x.element_size() + 4 * D) / 3.35e12 * 1e3
        rows.append(row)
        print("rmsnorm design:", json.dumps(row), flush=True)
        del x, w, want
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("rmsnorm_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "tree", os.getcwd())
    t = time.perf_counter()
    _build.build("rmsnorm")
    print(f"build: {time.perf_counter() - t:.2f} s")
    parts = sys.argv[1:] or ["breakdown", "designs"]
    if "breakdown" in parts:
        print("rmsnorm breakdown:", json.dumps(breakdown()), flush=True)
    if "designs" in parts:
        designs()
    return 0


if __name__ == "__main__":
    sys.exit(main())
