"""Torch port, ``ops/frft.py`` (frft, frft2, dfrft) and ``ops/nufft.py``
(the nine NUFFTs) on the CPU.

The same numpy inputs, made from a seed, go through the JAX package on the
CPU and through the port on CPU tensors, values and gradients
(``jax.grad``), beside the oracles of the JAX package's own tests
(``tests/test_frft.py``: the continuous-kernel quadrature and the integer
orders; ``tests/test_nufft.py``: the direct NUDFT in float64).
Tolerance: 1e-5 relative L2 against the JAX package, and against the
oracles the JAX tests' own bars: frft 2e-5 in the core interval and 5e-5
at other sizes and for the group properties (``tests/test_frft.py:49-85``),
NUFFT 5e-5 and type 3 2e-4 (``tests/test_nufft.py:33-128``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu.ops.frft import _dfrft_basis as j_dfrft_basis
from fft_wgpu_tpu_torch.ops import bigfft, frft, nufft

torch.set_num_threads(1)

FRFT_CORE_TOL = 2e-5   # tests/test_frft.py, the quadrature in the core interval
FRFT_TOL = 5e-5        # tests/test_frft.py, other sizes and the group properties
NUFFT_TOL = 5e-5       # tests/test_nufft.py, types 1 and 2 against the direct NUDFT
NUFFT3_TOL = 2e-4      # tests/test_nufft.py, type 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ---------------------------------------------------------------------- #
# frft, frft2, dfrft
# ---------------------------------------------------------------------- #
def _grid(n):
    return (np.arange(n) - n // 2) / np.sqrt(n)


def _sig(n, seed=0, rows=1):
    """Admissible (time-frequency concentrated) rows, as test_frft.py's."""
    x = _grid(n)
    shift = np.random.default_rng(seed).uniform(-0.5, 0.5, (rows, 1))
    return (np.exp(-(x - shift) ** 2) * (1 + 0.3 * np.cos(2 * np.pi * x))
            + 0.1 * np.exp(-((x - 1.0) ** 2))).astype(np.complex64)


def _direct(f, a):
    """Quadrature of the continuous FrFT kernel (f64), along the last axis."""
    f = np.asarray(f, complex)
    n = f.shape[-1]
    alpha = np.mod(a, 4.0) * np.pi / 2
    x = _grid(n)
    cot, csc = 1 / np.tan(alpha), 1 / np.sin(alpha)
    A = np.exp(-1j * (np.pi * np.sign(np.sin(alpha)) / 4 - alpha / 2)) / np.sqrt(
        abs(np.sin(alpha)))
    K = A * np.exp(1j * np.pi * (cot * (x[:, None] ** 2 + x[None, :] ** 2)
                                 - 2 * csc * x[:, None] * x[None, :]))
    return f @ K.T / np.sqrt(n)


@pytest.mark.parametrize("n", [128, 127])
@pytest.mark.parametrize("a", [0, 0.5, 0.9, 1, 1.7, 2, 3, -0.3])
def test_frft_matches_jax(n, a, rng, assert_close):
    f = _sig(n, seed=n, rows=3) + 0.01 * crand(rng, 3, n)
    got = ft.frft(_t(f), a)
    assert got.dtype == torch.complex64
    assert_close(_np(got), np.asarray(ftt.frft(f, a)))
    shft = (np.arange(n) + n // 2) % n
    if a in (0.9, 1):  # the quadrature (well sampled near a = 1), on admissible rows
        clean = _sig(n, seed=n, rows=3)
        assert_close(_np(ft.frft(_t(clean), a)), _direct(clean, a), FRFT_TOL)
    if a == 1:  # the centered unitary DFT
        want = np.empty_like(f)
        want[:, shft] = np.fft.fft(f[:, shft]) / np.sqrt(n)
        assert_close(_np(got), want, 1e-6)
    if a == 2:  # parity
        assert_close(_np(got), np.concatenate([f[:, :1], f[:, 1:][:, ::-1]], -1), 1e-7)


def test_frft_oracle_group_and_real_input(assert_close):
    f = _sig(128)[0]
    for a in (0.6, 1.25, 1.4):
        assert_close(_np(ft.frft(_t(f), a)), _direct(f, a), FRFT_CORE_TOL, what=f"a={a}")
    for a, b in ((0.6, 0.7), (1.7, 0.9), (0.9, -0.4)):
        assert_close(_np(ft.frft(ft.frft(_t(f), a), b)), _np(ft.frft(_t(f), a + b)), FRFT_TOL)
    F = ft.frft(_t(_sig(192)[0]), 2.6)
    assert abs(float(torch.linalg.vector_norm(F)) / np.linalg.norm(_sig(192)[0]) - 1) < 1e-5
    assert_close(_np(ft.frft(F, -2.6)), _sig(192)[0], FRFT_TOL)
    x = np.exp(-_grid(64) ** 2).astype(np.float32)  # real input promotes
    got = ft.frft(_t(x), 1.0)
    assert got.dtype == torch.complex64
    assert_close(_np(got), _direct(x, 1.0))
    assert_close(_np(got), np.asarray(ftt.frft(x, 1.0)))


def test_frft_axes_and_frft2_match_jax(assert_close):
    f = np.outer(_sig(64, seed=4)[0], _sig(96, seed=5)[0]).astype(np.complex64)
    for axis in (0, -1):
        assert_close(_np(ft.frft(_t(f), 0.8, axis=axis)), np.asarray(ftt.frft(f, 0.8, axis=axis)))
    for a, axes in (((0.7, 1.2), (-2, -1)), (0.5, (1, 0)), (1.0, (-2, -1))):
        got = ft.frft2(_t(f), a, axes=axes)
        assert_close(_np(got), np.asarray(ftt.frft2(f, a, axes=axes)), what=f"{a} {axes}")
    rec = ft.frft2(ft.frft2(_t(f), (0.7, 1.2)), (-0.7, -1.2))
    assert_close(_np(rec), f, 1e-4)  # tests/test_frft.py's roundtrip bar
    f3 = np.stack([f[:, :32]] * 2)  # a batch before the axis
    assert_close(_np(ft.frft(_t(f3), 0.6, axis=1)), np.asarray(ftt.frft(f3, 0.6, axis=1)))


@pytest.mark.parametrize("n", [16, 17, 100])
def test_dfrft_matches_jax_unitary_and_additive(n, rng, assert_close):
    x = crand(rng, 3, n)
    V, h = frft._dfrft_basis(n)
    Vj, hj = j_dfrft_basis(n)
    np.testing.assert_array_equal(V, Vj)
    np.testing.assert_array_equal(h, hj)
    for a in (0.37, 1.0, 2.0):
        assert_close(_np(ft.dfrft(_t(x), a)), np.asarray(ftt.dfrft(x, a)))
    F = _np(ft.dfrft(_t(x), 0.37))
    np.testing.assert_allclose(np.linalg.norm(F, axis=-1), np.linalg.norm(x, axis=-1),
                               rtol=1e-5)
    assert_close(_np(ft.dfrft(ft.dfrft(_t(x), 0.6), 0.7)), _np(ft.dfrft(_t(x), 1.3)))
    assert_close(_np(ft.dfrft(ft.dfrft(_t(x), 0.8), -0.8)), x)
    assert_close(_np(ft.dfrft(_t(x), 1.0)), np.fft.fft(x) / np.sqrt(n))
    assert_close(_np(ft.dfrft(_t(x.T), 0.9, axis=0)).T, np.asarray(ftt.dfrft(x, 0.9)))


def test_grad_frft_matches_jax(rng, assert_close):
    # d/d(re, im) sum(w * Re frft(x, 0.5)): the plan's transforms' adjoints
    f = _sig(96, rows=2)
    w = rng.standard_normal((2, 96)).astype(np.float32)

    def loss_j(re, im):
        return jnp.sum(w * jnp.real(ftt.frft((re, im), 0.5)))

    want = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(f.real), jnp.asarray(f.imag))
    re, im = _t(f.real).requires_grad_(), _t(f.imag).requires_grad_()
    (_t(w) * ft.frft((re, im), 0.5).real).sum().backward()
    assert_close(_np(re.grad), np.asarray(want[0]))
    assert_close(_np(im.grad), np.asarray(want[1]))


def test_frft_routes():
    # at n = 4096 the two convolutions ask the plan for 2^15 and 2^16 (the
    # whole-row kernel on the card, at 256 rows); at n <= 1365 both are
    # row-kernel lengths; a transform along axis 0 stays there on the card
    # where n, L1 and L2 all lie in the axis kernels' envelope
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert frft._conv_lengths(4096) == (1 << 15, 1 << 16)
    assert frft._conv_lengths(1365) == (8192, 16384)
    assert frft._conv_lengths(1024) == (8192, 16384)
    for L in (1 << 15, 1 << 16):
        assert ft.get_plan(L)._resolve_executor(cuda) == "fourstep"
        assert bigfft._supported(L, 256)
    assert ft.get_plan(8192)._resolve_executor(cuda) == "pallas"
    assert frft._along_axis((1024, 1024), 0, cuda)
    assert frft._along_axis((8, 1024, 16), 1, cuda)
    assert not frft._along_axis((4096, 4096), 0, cuda)
    assert not frft._along_axis((1024, 1024), 0, cpu)
    assert frft._along_axis((1024, 1024), -1, cpu)


# ---------------------------------------------------------------------- #
# NUFFT
# ---------------------------------------------------------------------- #
def _modes(n):
    return np.arange(-(n // 2), n - n // 2)


def _phase(freqs, pts, isign):
    """exp(isign * i * sum_d freqs_d pts_d) as [K, M] (float64)."""
    return np.exp(1j * isign * sum(np.asarray(f, np.float64)[:, None]
                                   * np.asarray(p, np.float64)[None, :]
                                   for f, p in zip(freqs, pts)))


def _mode_grid(ns):
    return [g.ravel() for g in np.meshgrid(*(_modes(n) for n in ns), indexing="ij")]


@pytest.mark.parametrize("isign", [+1, -1])
@pytest.mark.parametrize("ns", [(33,), (16, 24), (8, 12, 10)], ids=["1d", "2d", "3d"])
def test_nufft_types_1_and_2_match_jax_and_direct(ns, isign, rng, assert_close):
    dims, M = len(ns), 150
    pts = [rng.uniform(0, 2 * np.pi, M).astype(np.float32) for _ in ns]
    c = crand(rng, 2, M)  # a batch of two
    name = f"nufft{dims}d"
    got = getattr(ft, name + "1")(*map(_t, pts), _t(c), ns if dims > 1 else ns[0], isign=isign)
    assert got.dtype == torch.complex64 and got.shape == (2, *ns)
    assert_close(_np(got), np.asarray(getattr(ftt, name + "1")(*pts, c, ns if dims > 1 else ns[0],
                                                               isign=isign)))
    want = (_phase(_mode_grid(ns), pts, isign) @ c.T.astype(np.complex128)).T
    assert_close(_np(got).reshape(2, -1), want, NUFFT_TOL)
    f = crand(rng, 2, *ns)
    got = getattr(ft, name + "2")(*map(_t, pts), _t(f), isign=isign)
    assert got.shape == (2, M)
    assert_close(_np(got), np.asarray(getattr(ftt, name + "2")(*pts, f, isign=isign)))
    want = f.reshape(2, -1).astype(np.complex128) @ _phase(_mode_grid(ns), pts, isign)
    assert_close(_np(got), want, NUFFT_TOL)


@pytest.mark.parametrize("isign", [+1, -1])
@pytest.mark.parametrize("dims", [1, 2, 3])
def test_nufft_type_3_matches_jax_and_direct(dims, isign, rng, assert_close):
    M, K = 120, 70
    lo, hi = ((-3.0, 7.0), (-40.0, 25.0)) if dims == 1 else ((-2.0, 2.0), (-8.0, 8.0))
    pts = [rng.uniform(*lo, M).astype(np.float32) for _ in range(dims)]
    freqs = [rng.uniform(*hi, K).astype(np.float32) for _ in range(dims)]
    c = crand(rng, 2, M)
    name = f"nufft{dims}d3"
    args = (*pts, c, *freqs)
    got = getattr(ft, name)(*map(_t, args), isign=isign)
    assert got.shape == (2, K)
    want = np.asarray(ftt.device_get_complex(getattr(ftt, name)(*args, isign=isign)))
    assert_close(_np(got), want)
    assert_close(_np(got), (_phase(freqs, pts, isign) @ c.T.astype(np.complex128)).T,
                 NUFFT3_TOL)


def test_nufft_adjoint_points_and_devices(rng, assert_close):
    M, n = 150, 48
    x = rng.uniform(-7, 13, M).astype(np.float32)  # any real points, wrapped
    c, f = crand(rng, M), crand(rng, n)
    lhs = np.vdot(_np(ft.nufft1d2(_t(x), _t(f), isign=-1)), c)
    rhs = np.vdot(f, _np(ft.nufft1d1(_t(x), _t(c), n, isign=+1)))
    assert abs(lhs - rhs) / abs(rhs) < NUFFT_TOL
    # numpy points join the values' device; (re, im) pairs are values
    got = ft.nufft1d1(x, (_t(c.real), _t(c.imag)), n)
    assert got.device.type == "cpu"
    assert_close(_np(got), np.asarray(ftt.nufft1d1(x, c, n)))
    # integer modes as type-3 points agree with type 2 (test_nufft.py)
    xs = rng.uniform(0, 2 * np.pi, 120).astype(np.float32)
    f32 = crand(rng, 32)
    assert_close(_np(ft.nufft1d3(_t(_modes(32).astype(np.float32)), _t(f32), _t(xs), isign=-1)),
                 _np(ft.nufft1d2(_t(xs), _t(f32), isign=-1)), NUFFT3_TOL)


def test_nufft_at_many_modes_keeps_float32_accuracy(rng, assert_close):
    # the points' grid positions are float64: at 2^14 modes the port stays
    # at its float32 transform error against the direct sum (the JAX
    # package's float32 positions give about 8e-4 here)
    n, M = 1 << 14, 1 << 14
    x = rng.uniform(0, 2 * np.pi, M).astype(np.float32)
    c = crand(rng, M)
    sub = rng.choice(n, 256, replace=False)
    got = _np(ft.nufft1d1(_t(x), _t(c), n))[sub]
    assert_close(got, _phase([_modes(n)[sub]], [x], 1) @ c.astype(np.complex128), NUFFT_TOL)
    f = crand(rng, n)
    got = _np(ft.nufft1d2(_t(x[:256]), _t(f)))
    assert_close(got, _phase([x[:256]], [_modes(n)], -1) @ f.astype(np.complex128), NUFFT_TOL)


@pytest.mark.parametrize("name", ["nufft1d1", "nufft2d2"])
def test_grad_nufft_matches_jax(name, rng, assert_close):
    # d/d(re, im) sum(w * Re f) with respect to the values: the spread
    # (index_add) or gather and the plan's transforms' adjoints
    M = 90
    if name == "nufft1d1":
        pts, shape, out, extra = [rng.uniform(0, 2 * np.pi, M)], (2, M), (2, 40), (40,)
    else:
        pts, shape, out, extra = [rng.uniform(0, 2 * np.pi, M) for _ in range(2)], \
            (2, 16, 12), (2, M), ()
    pts = [p.astype(np.float32) for p in pts]
    v = crand(rng, *shape)
    w = rng.standard_normal(out).astype(np.float32)

    def loss_j(re, im):
        return jnp.sum(w * jnp.real(getattr(ftt, name)(*pts, (re, im), *extra)))

    want = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(v.real), jnp.asarray(v.imag))
    re, im = _t(v.real).requires_grad_(), _t(v.imag).requires_grad_()
    (_t(w) * getattr(ft, name)(*map(_t, pts), (re, im), *extra).real).sum().backward()
    assert_close(_np(re.grad), np.asarray(want[0]))
    assert_close(_np(im.grad), np.asarray(want[1]))


def test_nufft_grids_chunks_and_type3_geometry():
    cuda = torch.device("cuda")
    # path 9's fine grids: 2^16 modes -> 2^17 points (the whole-row
    # kernel), 256^2 -> 512^2 and 128^3 -> 256^3 (the row and axis kernels)
    assert nufft._fine_n(1 << 16) == 1 << 17 and bigfft._supported(1 << 17, 1)
    assert nufft._fine_n(256) == 512 and nufft._fine_n(128) == 256
    assert ft.get_plan(512)._resolve_executor(cuda) == "pallas"
    # a chunk's stencil holds at most _STENCIL_BYTES; 2-D at 2^18 points
    # is one chunk, 3-D at 2^20 points about 27
    per_point = 14 ** 3 * (12 + 8)
    chunks = nufft._chunks(1 << 20, 3, 1)
    assert max(hi - lo for lo, hi in chunks) * per_point <= nufft._STENCIL_BYTES
    assert len(chunks) == 27 and chunks[-1][1] == 1 << 20
    assert nufft._chunks(1 << 18, 2, 1) == [(0, 1 << 18)]
    assert nufft._chunks(0, 1, 1) == [(0, 0)]
    # type 3: extents X = 50, S = 63 give n = 4050 and a fine grid of 8100
    # (the composite row kernel); X = 100, S = 80 leave the envelope
    from fft_wgpu_tpu_torch.ops import cuda_fft

    assert nufft._t3_geom((-50.0, 50.0), (-63.0, 63.0))[4] == 4050
    assert nufft._fine_n(4050) == 8100 and cuda_fft._gen_supported(8100)
    assert not cuda_fft._ax0_supported(nufft._fine_n(nufft._t3_geom((-100.0, 100.0),
                                                                     (-80.0, 80.0))[4]))
