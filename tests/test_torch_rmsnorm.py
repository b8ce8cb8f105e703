"""The port's RMSNorm (``repro_torch.kernels.rmsnorm``) against the
reference's, on the CPU.

* the port's RMSNorm on CPU tensors (its plain version) against the
  reference's Pallas kernel in interpret mode and its oracle, at the
  shapes and tolerances of ``tests/test_kernels.py`` (f32 2e-5 and 1e-5,
  bf16 2e-2) and at zamba2's widths;
* ``layers.rmsnorm`` runs the kernel's entry point under ``pallas`` and
  the plain version otherwise;
* the wrapper's contract: CPU calls do not count launches, inputs the
  kernel does not take raise; the CUDA kernel against its plain version
  (``gpu`` marker, skipped without a card).

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,strided", [
    ("bfloat16", (64, 4096), False), ("bfloat16", (8, 7168), False),
    ("float32", (100, 3584), False), ("bfloat16", (3, 5, 100), False),
    ("bfloat16", (4, 16, 3584), True), ("float32", (7, 36), False),
])
def test_kernel_matches_plain_version_on_gpu(dtype, shape, strided):
    """The CUDA kernel against its plain version on the card, one launch
    per call, on the vector and the scalar path (needs a card; skipped
    elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x, w = _xw(shape, seed=8)
    tx = torch.from_numpy(x).to("cuda", getattr(torch, dtype))
    tw = torch.from_numpy(w).cuda()
    if strided:
        tx = tx[:, -1:]
    before = rn.rmsnorm.launches
    got = rn.rmsnorm(tx, tw)
    torch.cuda.synchronize()
    assert rn.rmsnorm.launches == before + 1
    want = rn.rmsnorm_ref(tx, tw)
    tol = _tol(dtype) if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **tol)
