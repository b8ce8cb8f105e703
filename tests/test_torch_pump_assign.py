"""The port's pump window assignment (``repro_torch.kernels.pump_assign``)
against the reference's Pallas kernel and its XLA closed form.

The function is a gather and a max, so every comparison is bitwise.  On
the CPU the wrapper runs its plain PyTorch version; the CUDA kernel is
held to that version on the card (``gpu`` marker; ``chip_smoke.py``
runs the same cases at the main-path shapes).  Inputs are made with
numpy from a seed and handed to both packages.
"""

import jax
import numpy as np
import pytest
import torch

# the reference runs on the CPU also where a GPU is present: the
# tolerances here are set against its CPU results
jax.config.update("jax_platforms", "cpu")

from repro.core import jax_device_loop as jdl
from repro_torch.kernels.pump_assign import pump_assign, pump_assign_ref

#: (case, R ring rows, P prefetch, L lanes, Np members) — the edge cases
#: of the chip smoke's kernel check, at CPU-test size
CASES = [("main", 9, 8, 3, 64), ("L1", 9, 8, 1, 64), ("ragged", 5, 8, 3, 61),
         ("all_below_P", 9, 8, 3, 64), ("all_invalid", 9, 8, 3, 64),
         ("dummy_row", 9, 8, 3, 64)]


def _inputs(case, R, P, L, Np, seed=0):
    rng = np.random.default_rng(seed)
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
    t[~valid] = np.inf
    return ring, t, gid, idx, valid


def _torch(*arrays, device="cpu"):
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


@pytest.mark.parametrize("case,R,P,L,Np", CASES, ids=[c[0] for c in CASES])
def test_pump_matches_pallas_interpret_and_xla_bitwise(case, R, P, L, Np):
    """Port pump == Pallas kernel (interpret mode, float64) == the
    reference's XLA closed form under NumPy, to the last bit."""
    ring, t, gid, idx, valid = _inputs(case, R, P, L, Np)
    got = pump_assign(*_torch(ring, t, gid, idx, valid)).numpy()
    with jax.enable_x64(True):
        pallas = np.asarray(jdl._pump_assign_pallas(
            ring, t, gid, idx, valid, P, interpret=True))
    xla = jdl._pump_assign_xla(jdl._NumpyOps, ring, t, gid, None, idx,
                               valid, dict(P=P))
    assert got.dtype == pallas.dtype == xla.dtype == np.float64
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)


def test_cpu_calls_run_the_plain_version_and_do_not_count():
    ring, t, gid, idx, valid = _torch(*_inputs("main", 9, 8, 3, 64))
    before = pump_assign.launches
    out = pump_assign(ring, t, gid, idx, valid)
    assert pump_assign.launches == before
    assert torch.equal(out, pump_assign_ref(ring, t, gid, idx, valid))


@pytest.mark.parametrize("bad", ["dtype", "shape", "members", "contig"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    ring, t, gid, idx, valid = _torch(*_inputs("main", 9, 8, 3, 64))
    if bad == "dtype":
        t = t.float()
    elif bad == "shape":
        ring = ring[:, :, :2].contiguous()
    elif bad == "members":
        gid = gid[:-1]
    else:
        t = t.t().contiguous().t()
    with pytest.raises((TypeError, ValueError)):
        pump_assign(ring, t, gid, idx, valid)


def test_build_names_the_library_by_source_hash():
    """The shared library's name carries a hash of the source and flags,
    under the checkout's ``build/repro_torch_kernels`` directory."""
    from repro_torch.kernels import _build
    lib = _build.library_path("pump_assign")
    assert lib == _build.library_path("pump_assign")
    assert lib.parent.name == "repro_torch_kernels"
    assert lib.parent.parent.name == "build"
    assert lib.name.startswith("libpump_assign-") and lib.suffix == ".so"


@pytest.mark.gpu
@pytest.mark.parametrize("case,R,P,L,Np", CASES, ids=[c[0] for c in CASES])
def test_pump_kernel_matches_plain_version_on_gpu(case, R, P, L, Np):
    """The CUDA kernel equals its plain version bitwise and counts one
    launch per call (needs a card; skipped elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _torch(*_inputs(case, R, P, L, Np), device="cuda")
    before = pump_assign.launches
    got = pump_assign(*args)
    torch.cuda.synchronize()
    assert pump_assign.launches == before + 1
    assert torch.equal(got, pump_assign_ref(*args))
