"""The port's SSD state scan (``repro_torch.kernels.ssm_scan``) and Mamba2
mixer (``repro_torch.models.mamba2``) against the reference's, on the
CPU.

* the port's scan on CPU tensors (its plain version) against the
  reference's Pallas kernel in interpret mode and its oracle, at the
  shapes and the 1e-5 tolerance of ``tests/test_kernels.py``;
* ``ssd_chunked`` (with the scan's plain version and through the
  kernel's entry point), ``ssd_decode_step``, the causal conv and the
  whole mixer (prefill over several chunks, then decode steps) against
  the reference's in f32 at 1e-5, on parameters carried over, with step
  sizes in Mamba2's own range (dt in [1e-3, 1e-1]);
* at the reference init's larger step sizes (dt about 0.7, so within-chunk
  cumulative decays reach -1e3 and their f32 rounding is 1e-4 of the
  decay), ``ssd_chunked`` against the token-by-token recurrence in
  float64, where the reference lies too;
* the kernel's 3xTF32 products (C and the state each split into TF32 hi
  and lo parts, hi.hi + hi.lo + lo.hi in f32), emulated chunk by chunk,
  against the reference's Pallas kernel and the plain version at 1e-5,
  and single-pass TF32 shown to miss that tolerance;
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

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as JM
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import KERNELS, ops
from repro_torch.kernels import ssm_scan as sc
from repro_torch.models import mamba2 as TM
from repro_torch.models.sharding import ModelContext

F32_TOL = dict(rtol=1e-5, atol=1e-5)
PALLAS = ModelContext(attention_impl="pallas")
REF = ModelContext(attention_impl="reference")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _scan_inputs(B, nc, nh, hd, N, Q, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, nc, nh, hd, N), dtype=np.float32),
            -np.abs(rng.standard_normal((B, nc, nh), dtype=np.float32)),
            rng.standard_normal((B, nc, Q, N), dtype=np.float32),
            -np.abs(rng.standard_normal((B, nc, Q, nh), dtype=np.float32)))


@pytest.mark.parametrize("B,nc,nh,hd,N,Q", [
    (1, 2, 1, 4, 8, 16), (2, 4, 3, 8, 16, 32), (1, 8, 2, 16, 32, 64),
    (1, 3, 2, 64, 64, 256),       # zamba2's head dim, state and chunk
])
def test_plain_scan_matches_pallas_interpret_and_oracle(B, nc, nh, hd, N, Q):
    arrays = _scan_inputs(B, nc, nh, hd, N, Q)
    y, fin = ops.ssd_state_scan(*(torch.from_numpy(a) for a in arrays))
    assert y.shape == (B, nc, Q, nh, hd) and fin.shape == (B, nh, hd, N)
    jarr = [jnp.asarray(a) for a in arrays]
    for yr, fr in (jops.ssd_state_scan(*jarr), jref.ssd_state_scan_ref(*jarr)):
        np.testing.assert_allclose(_np(y), _np(yr), **F32_TOL)
        np.testing.assert_allclose(_np(fin), _np(fr), **F32_TOL)


def test_plain_scan_takes_strided_inputs_and_an_initial_state():
    """Views in the layouts ``ssd_chunked`` hands over give the same
    result as contiguous copies; an initial state enters as the state
    before the first chunk (the reference's ``ssd_chunked``)."""
    states, _, C, cum = (torch.from_numpy(a)
                         for a in _scan_inputs(2, 3, 4, 8, 16, 32, seed=1))
    totals = cum[:, :, -1]
    y, fin = sc.ssd_state_scan(states, totals, C, cum)
    y2, fin2 = sc.ssd_state_scan(states, totals.contiguous(), C, cum)
    assert torch.equal(y, y2) and torch.equal(fin, fin2)
    s0 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 4, 8, 16), dtype=np.float32))
    yi, fi = sc.ssd_state_scan_ref(states, totals, C, cum, init_state=s0)
    decay = torch.exp(totals).prod(dim=1)[:, :, None, None]
    np.testing.assert_allclose(_np(fi - fin), _np(s0 * decay), **F32_TOL)
    first = torch.einsum("bin,bhdn,bih->bihd", C[:, 0], s0, torch.exp(cum[:, 0]))
    np.testing.assert_allclose(_np(yi[:, 0]), _np(first), **F32_TOL)


def _tf32(x):
    """x rounded to TF32 (float32 with its low 13 mantissa bits cleared),
    to nearest, ties away from zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32) + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _emulate_tc_scan(states, totals, C, cum, passes=3):
    """The kernel's arithmetic in plain PyTorch: the state recurrence in
    f32, chunk by chunk; each chunk's product from TF32 parts, C and the
    state each split as hi = TF32(x) and lo = TF32(x - hi), summed as
    hi.hi + hi.lo + lo.hi in f32 (3xTF32; ``passes=1``: hi.hi alone,
    single-pass TF32); y scaled by exp(cum)."""
    B, nc, nh, hd, N = states.shape
    s = torch.zeros(B, nh, hd, N)
    ys = []
    for c in range(nc):
        ch, sh = _tf32(C[:, c]), _tf32(s)
        y = torch.einsum("bin,bhdn->bihd", ch, sh)
        if passes == 3:
            cl, sl = _tf32(C[:, c] - ch), _tf32(s - sh)
            y = (torch.einsum("bin,bhdn->bihd", cl, sh)
                 + torch.einsum("bin,bhdn->bihd", ch, sl) + y)
        ys.append(y * torch.exp(cum[:, c])[..., None])
        s = s * torch.exp(totals[:, c])[:, :, None, None] + states[:, c]
    return torch.stack(ys, 1), s


@pytest.mark.parametrize("B,nc,nh,hd,N,Q", [
    (2, 4, 3, 8, 16, 32), (1, 8, 2, 16, 32, 64),
    (1, 3, 2, 64, 64, 256),       # zamba2's head dim, state and chunk
])
def test_tensor_core_rounding_against_pallas_interpret(B, nc, nh, hd, N, Q):
    """The kernel's 3xTF32 products, emulated, against the reference's
    Pallas kernel in interpret mode and the plain version at the 1e-5
    tolerance; single-pass TF32 products miss it many times over, which is
    why the kernel takes three."""
    arrays = _scan_inputs(B, nc, nh, hd, N, Q, seed=13)
    t = [torch.from_numpy(a) for a in arrays]
    y, fin = _emulate_tc_scan(*t)
    pallas = jops.ssd_state_scan(*(jnp.asarray(a) for a in arrays))
    for yr, fr in (pallas, sc.ssd_state_scan_ref(*t)):
        np.testing.assert_allclose(_np(y), _np(yr), **F32_TOL)
        np.testing.assert_allclose(_np(fin), _np(fr), **F32_TOL)
    y1, _ = _emulate_tc_scan(*t, passes=1)
    yr = _np(pallas[0])
    over = np.abs(_np(y1) - yr) / (F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(yr))
    assert over.max() > 5.0, over.max()


#: Mamba2's own step-size range (its dt_bias init draws dt log-uniformly
#: from it)
DT_RANGE = (1e-3, 1e-1)


def _ssd_args(Bb, S, nh, hd, N, seed=3, dt_range=DT_RANGE):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bb, S, nh, hd), dtype=np.float32)
    dt = np.exp(rng.uniform(*np.log(dt_range), size=(Bb, S, nh))).astype(
        np.float32)
    A = -np.linspace(1.0, 16.0, nh, dtype=np.float32)
    Bm = rng.standard_normal((Bb, S, N), dtype=np.float32)
    Cm = rng.standard_normal((Bb, S, N), dtype=np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("ctx", [REF, PALLAS], ids=["plain", "pallas"])
@pytest.mark.parametrize("S,chunk", [(64, 64), (96, 16), (256, 64),
                                     (512, 256)])
def test_ssd_chunked_matches_reference(S, chunk, ctx):
    args = _ssd_args(2, S, 4, 8, 16)
    y, fin = TM.ssd_chunked(*(torch.from_numpy(a) for a in args),
                            chunk=chunk, ctx=ctx)
    yr, fr = JM.ssd_chunked(*(jnp.asarray(a) for a in args), chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(yr), **F32_TOL)
    np.testing.assert_allclose(_np(fin), _np(fr), **F32_TOL)


def _recurrence(x, dt, A, B, C):
    """The SSM token by token in float64: h_t = exp(dt_t A) h_{t-1} +
    dt_t x_t B_t, y_t = C_t . h_t."""
    x, dt, A, B, C = (a.astype(np.float64) for a in (x, dt, A, B, C))
    h = np.zeros((x.shape[0], x.shape[2], x.shape[3], B.shape[-1]))
    ys = []
    for t in range(x.shape[1]):
        h = h * np.exp(dt[:, t] * A)[:, :, None, None] + np.einsum(
            "bn,bh,bhd->bhdn", B[:, t], dt[:, t], x[:, t])
        ys.append(np.einsum("bn,bhdn->bhd", C[:, t], h))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("ctx", [REF, PALLAS], ids=["plain", "pallas"])
@pytest.mark.parametrize("S,chunk", [(256, 64), (512, 256)])
def test_ssd_chunked_at_large_steps_matches_the_recurrence(S, chunk, ctx):
    """dt in [0.3, 2]: the port and the reference each within 1e-5 of
    max |y| of the float64 recurrence (each about 4e-6 on these inputs;
    they differ from each other by as much)."""
    args = _ssd_args(2, S, 4, 8, 16, seed=8, dt_range=(0.3, 2.0))
    y64, f64 = _recurrence(*args)
    y, fin = TM.ssd_chunked(*(torch.from_numpy(a) for a in args),
                            chunk=chunk, ctx=ctx)
    yr, fr = JM.ssd_chunked(*(jnp.asarray(a) for a in args), chunk=chunk)
    for got, want in ((y, y64), (yr, y64), (fin, f64), (fr, f64)):
        assert np.abs(_np(got) - want).max() <= 1e-5 * np.abs(want).max()


def test_ssd_chunked_initial_state_only_on_the_plain_path():
    args = _ssd_args(1, 64, 2, 8, 16, seed=4)
    s0 = np.random.default_rng(5).standard_normal((1, 2, 8, 16),
                                                  dtype=np.float32)
    y, fin = TM.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk=16,
                            init_state=torch.from_numpy(s0))
    yr, fr = JM.ssd_chunked(*(jnp.asarray(a) for a in args), chunk=16,
                            init_state=jnp.asarray(s0))
    np.testing.assert_allclose(_np(y), _np(yr), **F32_TOL)
    np.testing.assert_allclose(_np(fin), _np(fr), **F32_TOL)
    with pytest.raises(ValueError, match="init_state"):
        TM.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk=16,
                       init_state=torch.from_numpy(s0), ctx=PALLAS)
    with pytest.raises(ValueError, match="chunk"):
        TM.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk=24)


def test_ssd_decode_step_and_causal_conv_match_reference():
    rng = np.random.default_rng(6)
    x, dt, A, Bm, Cm = _ssd_args(3, 1, 4, 8, 16, seed=6)
    st = rng.standard_normal((3, 4, 8, 16), dtype=np.float32)
    state = torch.from_numpy(st.copy())
    y, new = TM.ssd_decode_step(*(torch.from_numpy(a[:, 0]) for a in
                                  (x, dt)), torch.from_numpy(A),
                                *(torch.from_numpy(a[:, 0]) for a in (Bm, Cm)),
                                state)
    yr, nr = JM.ssd_decode_step(*(jnp.asarray(a[:, 0]) for a in (x, dt)),
                                jnp.asarray(A),
                                *(jnp.asarray(a[:, 0]) for a in (Bm, Cm)),
                                jnp.asarray(st))
    assert new is state
    np.testing.assert_allclose(_np(y), _np(yr), **F32_TOL)
    np.testing.assert_allclose(_np(state), _np(nr), **F32_TOL)
    xc = rng.standard_normal((2, 7, 5), dtype=np.float32)
    w = rng.standard_normal((4, 5), dtype=np.float32)
    carry = rng.standard_normal((2, 3, 5), dtype=np.float32)
    for c in (None, carry):
        got = TM._causal_conv(torch.from_numpy(xc), torch.from_numpy(w),
                              None if c is None else torch.from_numpy(c))
        want = JM._causal_conv(jnp.asarray(xc), jnp.asarray(w),
                               None if c is None else jnp.asarray(c))
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), **F32_TOL)


def _mixer_pair(seed=0):
    """The reference's mixer parameters (zamba2 smoke widths) and a port
    mixer holding them in f32."""
    cfg = get_smoke_config("zamba2-7b")
    p = JM.init_mamba2_params(
        jax.random.key(seed), cfg.d_model, state=cfg.ssm_state,
        head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
        conv_kernel=cfg.conv_kernel)
    rng = np.random.default_rng(seed)
    # nonzero norms, so that each enters the comparison, and dt_bias as
    # Mamba2 draws it: softplus^-1 of dt log-uniform in DT_RANGE
    dt = np.exp(rng.uniform(*np.log(DT_RANGE), size=p["dt_bias"].shape))
    p = dict(p, norm=0.1 * rng.standard_normal(p["norm"].shape),
             out_norm=0.1 * rng.standard_normal(p["out_norm"].shape),
             dt_bias=dt + np.log(-np.expm1(-dt)))
    p = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    m = TM.Mamba2(cfg, "cpu").float()
    with torch.no_grad():
        for k, v in p.items():
            getattr(m, k).copy_(torch.from_numpy(np.array(v)))
    return cfg, p, m


@pytest.mark.parametrize("ctx", [REF, PALLAS], ids=["plain", "pallas"])
def test_mixer_prefill_then_decode_matches_reference(ctx):
    """The whole mixer in f32: a 512-token prefill (two chunks of 256)
    and 4 decode steps from a state, against the reference's."""
    cfg, p, m = _mixer_pair()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 512, cfg.d_model), dtype=np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x), ctx)
    want, _ = JM.mamba2_mixer(jnp.asarray(x), p, jax_smoke("zamba2-7b"))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    st = TM.init_mamba2_state(2, cfg, cfg.d_model, "cpu")
    st["conv"] = st["conv"].float()
    st["ssm"].normal_(generator=torch.Generator().manual_seed(8))
    # copies: the port updates ``st`` in place, and jnp.asarray may alias
    # a numpy buffer on the CPU
    jst = {k: jnp.asarray(v.numpy().copy()) for k, v in st.items()}
    for t in range(4):
        xt = x[:, t:t + 1]
        with torch.no_grad():
            got = m(torch.from_numpy(xt), ctx, st)
        want, jst = JM.mamba2_mixer(jnp.asarray(xt), p, jax_smoke("zamba2-7b"),
                                    decode_state=jst)
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(_np(st[k]), _np(jst[k]), **F32_TOL)


def test_cpu_calls_run_the_plain_version_and_do_not_count():
    arrays = [torch.from_numpy(a) for a in _scan_inputs(1, 3, 2, 4, 8, 16)]
    before = sc.ssd_state_scan.launches
    y, fin = sc.ssd_state_scan(*arrays)
    assert sc.ssd_state_scan.launches == before
    yr, fr = sc.ssd_state_scan_ref(*arrays)
    assert torch.equal(y, yr) and torch.equal(fin, fr)
    assert KERNELS["ssd_state_scan"] is sc.ssd_state_scan


@pytest.mark.parametrize("bad", ["dtype", "totals", "C", "cum", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    states, totals, C, cum = (torch.from_numpy(a)
                              for a in _scan_inputs(1, 3, 2, 4, 8, 16))
    if bad == "dtype":
        C = C.double()
    elif bad == "totals":
        totals = totals[:, :2]
    elif bad == "C":
        C = C[..., :4]
    elif bad == "cum":
        cum = cum[..., :1]
    else:
        states = states[0]
    with pytest.raises((TypeError, ValueError)):
        sc.ssd_state_scan(states, totals, C, cum)


@pytest.mark.gpu
@pytest.mark.parametrize("B,nc,nh,hd,N,Q,strided", [
    (2, 4, 3, 8, 16, 32, False), (1, 16, 8, 64, 64, 256, False),
    (2, 5, 4, 64, 64, 100, True), (1, 3, 2, 48, 40, 70, True),
    (1, 128, 112, 64, 64, 256, False),   # zamba2, one 32768-token request
])
def test_kernel_matches_plain_version_on_gpu(B, nc, nh, hd, N, Q, strided):
    """The CUDA kernel against its plain version on the card, one launch
    per call, on contiguous and strided inputs (needs a card; skipped
    elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    states, totals, C, cum = (torch.from_numpy(a).cuda() for a in
                              _scan_inputs(B, nc, nh, hd, N, Q, seed=9))
    if strided:
        totals = cum[:, :, -1]
        states = states.transpose(3, 4).contiguous().transpose(3, 4)
    before = sc.ssd_state_scan.launches
    y, fin = sc.ssd_state_scan(states, totals, C, cum)
    torch.cuda.synchronize()
    assert sc.ssd_state_scan.launches == before + 1
    yr, fr = sc.ssd_state_scan_ref(states, totals, C, cum)
    np.testing.assert_allclose(_np(y.cpu()), _np(yr.cpu()), **F32_TOL)
    np.testing.assert_allclose(_np(fin.cpu()), _np(fr.cpu()), **F32_TOL)
