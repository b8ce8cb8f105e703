"""The port's RMSNorm (``repro_torch.kernels.rmsnorm``) against the
reference's, on the CPU.

* the port's RMSNorm on CPU tensors (its plain version) against the
  reference's Pallas kernel in interpret mode and its oracle, at the
  shapes and tolerances of ``tests/test_kernels.py`` (f32 2e-5 and 1e-5,
  bf16 2e-2) and at zamba2's widths;
* ``layers.rmsnorm`` runs the kernel's entry point under ``pallas`` and
  the plain version otherwise;
* the wrapper's contract: CPU calls do not count launches, inputs the
  kernel does not take raise, and the rows and row stride it hands the
  kernel are those of ``x.view(-1, D)``; the CUDA kernel against its
  plain version on every route, its plan (route, grid, registers) and a
  capture in a CUDA graph on a side stream (``gpu`` marker, skipped
  without a card).

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the reference runs on the CPU also where a GPU is present: the
# tolerances here are set against its CPU results
jax.config.update("jax_platforms", "cpu")

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import KERNELS, ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import layers as TL
from repro_torch.models.sharding import ModelContext


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _xw(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32),
            0.1 * rng.standard_normal(shape[-1:], dtype=np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 64), (3, 17, 128), (2, 5, 7, 32),
                                   (3, 7168), (2, 1, 3584)])
def test_plain_rmsnorm_matches_pallas_interpret_and_oracle(shape, dtype):
    x, w = _xw(shape)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ops.rmsnorm(tx, torch.from_numpy(w))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    pallas = jops.rmsnorm(jx, jnp.asarray(w), block_rows=4)
    oracle = jref.rmsnorm_ref(jx, jnp.asarray(w))
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("rows,d,seed", [(1, 8, 0), (33, 32, 1), (17, 128, 2),
                                         (5, 8, 3)])
def test_plain_rmsnorm_property_cases(rows, d, seed):
    """``tests/test_kernels.py``'s property test at 1e-5, on fixed draws."""
    x, w = _xw((rows, d), seed)
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    want = jops.rmsnorm(jnp.asarray(x), jnp.asarray(w), block_rows=8)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_eps_and_strided_rows():
    """``eps`` reaches the computation; a view whose rows are one stride
    apart (the last position of a prefill) gives the same rows."""
    x, w = _xw((2, 6, 32), seed=4)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(
        _np(ops.rmsnorm(tx, tw, eps=0.5)),
        _np(jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(w), eps=0.5)),
        rtol=1e-5, atol=1e-5)
    last = ops.rmsnorm(tx[:, -1:], tw)
    assert last.is_contiguous() and last.shape == (2, 1, 32)
    assert torch.equal(last, ops.rmsnorm(tx[:, -1:].contiguous(), tw))


@pytest.mark.parametrize("impl", ["pallas", "reference", None])
def test_layer_dispatch(impl, monkeypatch):
    calls = []
    monkeypatch.setattr(TL.kops, "rmsnorm",
                        lambda x, w, eps: calls.append(1) or rn.rmsnorm_ref(
                            x, w, eps))
    x, w = _xw((3, 16), seed=5)
    ctx = None if impl is None else ModelContext(attention_impl=impl)
    out = TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), ctx=ctx)
    assert len(calls) == (impl == "pallas")
    assert torch.equal(out, rn.rmsnorm_ref(torch.from_numpy(x),
                                           torch.from_numpy(w)))


def test_cpu_calls_run_the_plain_version_and_do_not_count():
    x, w = _xw((4, 64), seed=6)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    before = rn.rmsnorm.launches
    out = rn.rmsnorm(tx, torch.from_numpy(w))
    assert rn.rmsnorm.launches == before
    assert torch.equal(out, rn.rmsnorm_ref(tx, torch.from_numpy(w)))
    assert KERNELS["rmsnorm"] is rn.rmsnorm


@pytest.mark.parametrize("bad", ["x_dtype", "w_dtype", "w_shape", "scalar"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, w = (torch.from_numpy(a) for a in _xw((4, 64), seed=7))
    if bad == "x_dtype":
        x = x.half()
    elif bad == "w_dtype":
        w = w.to(torch.bfloat16)
    elif bad == "w_shape":
        w = w[:32]
    else:
        x = x[0, 0]
    with pytest.raises((TypeError, ValueError)):
        rn.rmsnorm(x, w)


def _views():
    """Views of a (2, 3, 4, 8) tensor: (name, view) pairs."""
    x = torch.arange(2 * 3 * 4 * 8, dtype=torch.float32).reshape(2, 3, 4, 8)
    wide = torch.zeros(5, 6, 40)
    return [
        ("contiguous 4-D", x), ("2-D", x.reshape(24, 8)), ("1-D", x[0, 0, 0]),
        ("last position", x[:, :, -1:]), ("first rows", x[:, 1]),
        ("row slice of 2-D", x.reshape(24, 8)[3:17]),
        ("padded rows", wide[:, :, :32]), ("padded 2-D", wide[0, :, 3:35]),
        ("size-1 dims", x[:1, :, :1]), ("one row", x[1:2, 2:3, 3:4]),
        ("every other row", x[:, ::2]), ("transposed rows", x.transpose(0, 1)),
        ("broadcast rows", x[0, 0, 0].expand(3, 5, 8)),
        ("no rows", x[:, :0]), ("strided last dim", x[..., ::2]),
    ]


@pytest.mark.parametrize("name", [n for n, _ in _views()])
def test_rows_and_row_stride_are_those_of_view(name):
    """The only launch logic left in Python: the rows and the row stride
    the wrapper hands the kernel are ``x.view(-1, D)``'s, and it raises
    where that view fails (the route and the grid are the C entry
    point's, held by ``test_plan_on_gpu``)."""
    x = dict(_views())[name]
    D = x.shape[-1]
    try:
        rows = x.view(-1, D)
    except RuntimeError:
        with pytest.raises(ValueError, match="one stride apart"):
            rn._rows(x.shape, x.stride())
        return
    R, stride = rn._rows(x.shape, x.stride())
    assert R == rows.shape[0]
    if R > 1:
        assert stride == rows.stride(0)
        # each row of the (R, D) view lies at its stride from the first
        flat = torch.as_strided(x, (R, D), (stride, x.stride(-1)))
        assert torch.equal(flat, rows)


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _on_gpu(shape, dtype, seed, view=None):
    x, w = _xw(shape, seed)
    tx = torch.from_numpy(x).to("cuda", getattr(torch, dtype))
    if view is not None:
        tx = view(tx)
    return tx, torch.from_numpy(w[: tx.shape[-1]].copy()).cuda()


def _assert_plain(got, tx, tw, dtype):
    want = rn.rmsnorm_ref(tx, tw)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    assert got.is_contiguous()
    tol = _tol(dtype) if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **tol)


#: (dtype, shape, view) on every route: the vector route at many rows
#: (5000, 20011) and at R = 1, the zoo's widths up to zamba2's out_norm
#: (7168), strided ``x[:, -1:]`` views, f32; the loop route for an odd D,
#: for rows whose stride breaks 16-byte alignment, and beyond what
#: registers hold
GPU_CASES = [
    ("bfloat16", (64, 4096), None), ("bfloat16", (8, 7168), None),
    ("float32", (100, 3584), None), ("bfloat16", (3, 5, 100), None),
    ("bfloat16", (4, 16, 3584), lambda t: t[:, -1:]),
    ("float32", (7, 36), None),
    ("bfloat16", (20011, 4096), None), ("bfloat16", (5000, 2048), None),
    ("bfloat16", (1, 4096), None), ("bfloat16", (1, 1, 7168), None),
    ("bfloat16", (3001, 7168), None), ("bfloat16", (128, 5120), None),
    ("float32", (1, 2048), None), ("float32", (20011, 4096), None),
    ("float32", (64, 7168), None),
    ("bfloat16", (2, 1024, 4096), lambda t: t[:, -1:]),
    ("float32", (3, 40, 7168), lambda t: t[:, -1:]),
    ("bfloat16", (257, 7167), None), ("float32", (33, 4095), None),
    ("bfloat16", (1, 1), None), ("bfloat16", (9, 4104), lambda t: t[:, 3:4099]),
    ("bfloat16", (3, 20000), None), ("float32", (5, 9000), None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,view", GPU_CASES)
def test_kernel_matches_plain_version_on_gpu(dtype, shape, view):
    """The CUDA kernel against its plain version on the card, one launch
    per call, on every route (needs a card; skipped elsewhere)."""
    _gpu()
    tx, tw = _on_gpu(shape, dtype, 8, view)
    before = rn.rmsnorm.launches
    got = rn.rmsnorm(tx, tw)
    torch.cuda.synchronize()
    assert rn.rmsnorm.launches == before + 1
    _assert_plain(got, tx, tw, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,view,vector", [
    ("bfloat16", (16384, 4096), None, True),
    ("bfloat16", (32, 7168), None, True),
    ("bfloat16", (16384, 7168), None, True),
    ("float32", (1000, 3584), None, True),
    ("float32", (3, 7168), None, True),
    ("bfloat16", (4, 16, 3584), lambda t: t[:, -1:], True),
    ("bfloat16", (9, 4104), lambda t: t[:, 3:4099], False),
    ("bfloat16", (9, 4104), lambda t: t[:, 8:4104], True),
    ("bfloat16", (257, 7167), None, False),
    ("bfloat16", (8, 4096), lambda t: t.view(-1)[1:-7].view(8, 4095)[:, :4088],
     False),
])
def test_plan_on_gpu(dtype, shape, view, vector):
    """The C entry point's plan: the vector route only where x, its row
    stride, y and w allow 16-byte loads and D is a multiple of the vector,
    else the loop route; a grid of one CTA a row, so every row is covered
    once; the row's vectors fit its threads; the many-rows kernel only
    where the grid outgrows the card at once, and evict-first stores only
    where y outgrows L2; no spills at the zoo's widths."""
    _gpu()
    tx, tw = _on_gpu(shape, dtype, 10, view)
    out = torch.empty_like(tx, memory_format=torch.contiguous_format)
    p = rn.plan(tx, tw, out)
    R, stride = rn._rows(tx.shape, tx.stride())
    D = tx.shape[-1]
    vec = p["vec"]
    aligned = (tx.data_ptr() % 16 == 0 and tw.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0 and (R == 1 or stride % vec == 0)
               and D % vec == 0)
    assert bool(p["vector"]) == aligned == vector
    assert p["grid"] == R and p["threads"] % 32 == 0
    assert p["loop"] == (not vector)
    if vector:
        assert p["threads"] * p["units_per_thread"] >= D // vec
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        # ctas_per_sm is the chosen kernel's: the few-rows one's when the
        # grid fits the card at once
        if p["many"]:
            assert R > sms
        else:
            assert R <= p["ctas_per_sm"] * sms
        # y stored evict-first only where it outgrows L2
        l2 = torch.cuda.get_device_properties(0).L2_cache_size
        assert p["stream"] == int(bool(p["many"]) and out.nbytes > l2)
    assert p["local_bytes"] == 0 and p["registers"] <= 128
    got = rn.rmsnorm(tx, tw)
    _assert_plain(got, tx, tw, dtype)


@pytest.mark.gpu
def test_capture_in_cuda_graph_on_side_stream():
    """The wrapper reads the current stream on every call: captured in a
    CUDA graph on a side stream, the graph replays the kernel on new data
    in the captured buffers."""
    _gpu()
    tx, tw = _on_gpu((128, 4096), "bfloat16", 11)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rn.rmsnorm(tx, tw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = rn.rmsnorm.launches
    with torch.cuda.graph(graph):
        got = rn.rmsnorm(tx, tw)
    assert rn.rmsnorm.launches == before + 1
    for seed in (12, 13):
        x, w = _xw((128, 4096), seed)
        tx.copy_(torch.from_numpy(x).to("cuda", torch.bfloat16))
        tw.copy_(torch.from_numpy(w).cuda())
        graph.replay()
        torch.cuda.synchronize()
        _assert_plain(got, tx, tw, "bfloat16")
