"""Torch port, the DCT family on the CPU: ``ops/dct.py`` (scipy.fft's
DCT/DST types I-IV and their N-D forms), ``ops/chebyshev.py`` and
``ops/mdct.py``.

The same numpy inputs, made from a seed, go through the JAX package on the
CPU and through the port on CPU tensors, values and gradients
(``jax.grad``), beside the scipy / numpy oracles of the JAX package's own
tests (``tests/test_dct.py``, ``test_chebyshev.py``, ``test_mdct.py``).
The routes are checked from the calls the port makes: every C2C goes
through ``Plan._execute_split_axis`` along the transform's own axis (on a
CUDA tensor the row, axis(-2) or axis(-3) kernel with no transpose), and
DCT-I and DST-I through the R2C route.  Tolerance: 1e-5 relative L2 unless
a JAX test's own bar is named.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft as sfft
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.ops import chebyshev, dct as dct_mod, rfft as rfft_mod
from fft_wgpu_tpu_torch.plan.plan import Plan

torch.set_num_threads(1)

FNS = ("dct", "idct", "dst", "idst")
NORMS = (None, "ortho", "forward")
CHEB = np.polynomial.chebyshev


def _t(x):
    # a CPU tensor asks the port for the CPU
    return torch.from_numpy(np.array(x))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def rrand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


LONG_TAIL = ("dct", "chebyshev", "mdct", "fftlog", "spectral", "fourier_filters", "structured",
             "cepstrum", "envelope", "channelizer", "wigner")


def test_exports_match_jax():
    # the eleven modules keep the JAX package's module names and public names
    import importlib

    names = set()
    for mod in LONG_TAIL:
        j = importlib.import_module(f"fft_wgpu_tpu.ops.{mod}")
        p = importlib.import_module(f"fft_wgpu_tpu_torch.ops.{mod}")
        assert set(p.__all__) == set(j.__all__), mod
        names |= set(j.__all__)
    assert len(names) == 45 and names <= set(ft.__all__)
    assert all(callable(getattr(ft, n)) for n in names)


def test_numpy_input_and_sizes_need_a_card(rng, monkeypatch):
    # non-tensor input, and the size-only tables without device=, go to the
    # current CUDA device: with none they raise, never run on the CPU unasked
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = rrand(rng, 4, 64)
    for call in (lambda: ft.dct(x), lambda: ft.dctn(x), lambda: ft.cheb_coeffs(x),
                 lambda: ft.mdct(x, 16), lambda: ft.fht(x, 0.1, 0.0),
                 lambda: ft.spectral_derivative(x), lambda: ft.fourier_gaussian(x, 1.0),
                 lambda: ft.circulant_matvec(x[0], x), lambda: ft.real_cepstrum(x),
                 lambda: ft.envelope(x), lambda: ft.channelize(x, 8, taps=2),
                 lambda: ft.wigner_ville(x[0]), lambda: ft.cheb_points(8),
                 lambda: ft.grf_sample(np.exp(-np.arange(8) / 2.0), torch.Generator()),
                 lambda: ft.clenshaw_curtis_weights(8), lambda: ft.sine_window(8),
                 lambda: ft.prototype_lowpass(8), lambda: ft.wigner_ville_frequencies(8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # a numpy operand joins the device of the tensor it is paired with
    assert ft.circulant_matvec(x[0], _t(x)).device.type == "cpu"


# ---------------------------------------------------------------------- #
# dct / idct / dst / idst
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("type", [1, 2, 3, 4])
def test_dct_dst_match_jax_and_scipy(type, norm, rng, assert_close):
    # n = 64: DCT-I's extension 126 and DST-I's 130 are not powers of two;
    # n = 33 (odd): DCT-I's extension is 64, DST-I's 68
    for n in (64, 33):
        x = rrand(rng, 3, n)
        for name in FNS:
            got = _np(getattr(ft, name)(_t(x), type=type, norm=norm))
            assert got.dtype == np.float32
            what = f"{name} type {type} norm {norm} n {n}"
            assert_close(got, np.asarray(getattr(ftt, name)(x, type=type, norm=norm)),
                         what=what)
            assert_close(got, getattr(sfft, name)(x.astype(np.float64), type=type, norm=norm),
                         what=what + " vs scipy")


@pytest.mark.parametrize("type", [1, 2, 3, 4])
def test_dct_dst_along_a_leading_axis(type, rng, assert_close):
    x = rrand(rng, 4, 24, 3)
    for name in FNS:
        for axis in (0, 1):
            got = _np(getattr(ft, name)(_t(x), type=type, axis=axis))
            assert_close(got, np.asarray(getattr(ftt, name)(x, type=type, axis=axis)),
                         what=f"{name} type {type} axis {axis}")


@pytest.mark.parametrize("name", ["dctn", "idctn", "dstn", "idstn"])
def test_nd_forms_match_jax_and_scipy(name, rng, assert_close):
    x = rrand(rng, 6, 16, 5)
    for type in (1, 2, 3, 4):
        # s pads axis 0 (6 -> 12) and trims axis 1 (16 -> 10)
        for kw in ({"s": (12, 10), "axes": (0, 1), "norm": "ortho"},
                   {"axes": (2, 0), "norm": None}):
            got = _np(getattr(ft, name)(_t(x), type=type, **kw))
            what = f"{name} type {type} {kw}"
            assert_close(got, np.asarray(getattr(ftt, name)(x, type=type, **kw)), what=what)
            assert_close(got, getattr(sfft, name)(x.astype(np.float64), type=type, **kw),
                         what=what + " vs scipy")
    got = _np(getattr(ft, name)(_t(x), s=(8, 4)))  # s alone: the last len(s) axes
    assert_close(got, getattr(sfft, name)(x.astype(np.float64), s=(8, 4)))


def test_roundtrips(rng, assert_close):
    x = rrand(rng, 4, 96)
    for t in (1, 2, 3, 4):
        for norm in NORMS:
            assert_close(_np(ft.idct(ft.dct(_t(x), type=t, norm=norm), type=t, norm=norm)), x,
                         what=f"dct {t} {norm}")
            assert_close(_np(ft.idst(ft.dst(_t(x), type=t, norm=norm), type=t, norm=norm)), x,
                         what=f"dst {t} {norm}")
    y = rrand(rng, 8, 16, 12)
    assert_close(_np(ft.idctn(ft.dctn(_t(y)))), y)
    assert_close(_np(ft.idstn(ft.dstn(_t(y), norm="ortho"), norm="ortho")), y)


def test_errors_match_jax(rng):
    x = rrand(rng, 8)
    for name in FNS:
        for mod in (ft, ftt):
            with pytest.raises(NotImplementedError):
                getattr(mod, name)(x if mod is ftt else _t(x), type=5)
            with pytest.raises(ValueError, match="invalid norm"):
                getattr(mod, name)(x if mod is ftt else _t(x), norm="bogus")
    for mod in (ft, ftt):
        with pytest.raises(ValueError, match="DCT-I requires n >= 2"):
            mod.dct(np.ones(1, np.float32) if mod is ftt else _t(np.ones(1, np.float32)),
                    type=1)
        with pytest.raises(ValueError, match="out of bounds"):
            mod.dctn(x if mod is ftt else _t(x), axes=(1,))
        with pytest.raises(ValueError, match="same length"):
            mod.dctn(x if mod is ftt else _t(x), s=(8,), axes=(0, 0))


GRADS = {
    "dct2": lambda m, x: m.dct(x, type=2, norm="ortho"),
    "dct4": lambda m, x: m.dct(x, type=4),
    "dct2_axis0": lambda m, x: m.dct(x, type=2, axis=0),
    "dctn": lambda m, x: m.dctn(x, type=2),
}


@pytest.mark.parametrize("name", list(GRADS))
def test_gradients_match_jax_grad(name, rng, assert_close):
    # d/dx of sum(w * f(x)): the port's autograd against jax.grad
    f = GRADS[name]
    x = rrand(rng, 16, 32)
    w = rng.random((16, 32)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(w * f(ftt, v)))(jnp.asarray(x))
    v = _t(x).requires_grad_()
    (_t(w) * f(ft, v)).sum().backward()
    assert_close(_np(v.grad), np.asarray(want), what=name)


def test_c2c_runs_along_the_transform_axis(rng, monkeypatch):
    # every C2C is the plan's along the axis itself (on a CUDA tensor the
    # axis(-2) / axis(-3) kernels, no transpose): dctn of a plane asks for
    # axis 0 then axis 1; DCT-I and DST-I take the R2C route instead
    seen = []
    run = Plan._execute_split_axis

    def spy(self, re, im, sign, scale, axis, out=None):
        seen.append((self.n, axis % re.ndim, tuple(re.shape)))
        return run(self, re, im, sign, scale, axis, out)

    monkeypatch.setattr(Plan, "_execute_split_axis", spy)
    ft.dctn(_t(rrand(rng, 8, 16)))
    assert seen == [(8, 0, (8, 16)), (16, 1, (8, 16))]
    seen.clear()
    for t in (2, 3, 4):
        ft.dct(_t(rrand(rng, 4, 16, 3)), type=t, axis=1)
        ft.dst(_t(rrand(rng, 4, 16, 3)), type=t, axis=0)
    assert seen == [(16, 1, (4, 16, 3)), (4, 0, (4, 16, 3))] * 3
    r2c = []
    monkeypatch.setattr(dct_mod, "rfft_last_split",
                        lambda v, s: (r2c.append(v.shape[-1]), rfft_mod.rfft_last_split(v, s))[1])
    seen.clear()
    ft.dct(_t(rrand(rng, 3, 2049)), type=1)
    ft.dst(_t(rrand(rng, 3, 2047)), type=1)
    assert r2c == [4096, 4096] and seen == []


# ---------------------------------------------------------------------- #
# chebyshev
# ---------------------------------------------------------------------- #
def test_cheb_points_and_weights_match_jax(assert_close):
    for n in (1, 8, 33):
        assert_close(_np(ft.cheb_points(n, device="cpu")), np.asarray(ftt.cheb_points(n)))
        for iv in ((-1.0, 1.0), (0.0, 3.0)):
            assert_close(_np(ft.clenshaw_curtis_weights(n, iv, device="cpu")),
                         np.asarray(ftt.clenshaw_curtis_weights(n, iv)))
    assert ft.cheb_points(4, np.float64, device="cpu").dtype == torch.float64
    for mod in (ft, ftt):
        with pytest.raises(ValueError):
            mod.cheb_points(0, device="cpu") if mod is ft else mod.cheb_points(0)
        with pytest.raises(ValueError):
            (mod.clenshaw_curtis_weights(0, device="cpu") if mod is ft
             else mod.clenshaw_curtis_weights(0))


def test_cheb_transforms_match_jax_and_numpy(rng, assert_close):
    u = rrand(rng, 4, 33)
    a = ft.cheb_coeffs(_t(u))
    assert_close(_np(a), np.asarray(ftt.cheb_coeffs(u)))
    assert_close(_np(ft.cheb_values(a)), np.asarray(ftt.cheb_values(np.asarray(_np(a)))))
    assert_close(_np(ft.cheb_values(a)), u)
    assert_close(_np(ft.cheb_coeffs(_t(u.T), axis=0)), _np(a).T)
    # u = 0.5 T0 + 2 T1 - 1.5 T3 + 0.25 T5 at the points: the coefficients
    coef = np.array([0.5, 2.0, 0.0, -1.5, 0.0, 0.25])
    x = _np(ft.cheb_points(8, device="cpu")).astype(np.float64)
    got = _np(ft.cheb_coeffs(_t(CHEB.chebval(x, coef).astype(np.float32)))).astype(np.float64)
    np.testing.assert_allclose(got, np.pad(coef, (0, 3)), atol=2e-6)
    with pytest.raises(ValueError, match="at least 2 samples"):
        ft.cheb_coeffs(_t(np.ones(1, np.float32)))


@pytest.mark.parametrize("order,n,bar", [(1, 16, 1e-5), (2, 24, 1e-4), (3, 24, 1e-3)])
def test_cheb_derivative_matches_jax_and_chebder(order, n, bar, rng, assert_close):
    # order 1 at the 1e-5 bar; orders 2 and 3 at test_chebyshev.py's bars for
    # repeated differentiation (each order amplifies the float32 noise ~n^2)
    coef = rng.standard_normal(10)
    x = _np(ft.cheb_points(n, device="cpu")).astype(np.float64)
    u = np.stack([CHEB.chebval(x, coef), np.exp(x)]).astype(np.float32)
    for iv in ((-1.0, 1.0), (0.0, np.pi)):
        got = _np(ft.cheb_derivative(_t(u), order=order, interval=iv))
        want = np.asarray(ftt.cheb_derivative(u, order=order, interval=iv))
        assert_close(got, want, tol=bar, what=f"order {order} interval {iv}")
    want = np.stack([CHEB.chebval(x, CHEB.chebder(coef, order)), np.exp(x)])
    assert_close(_np(ft.cheb_derivative(_t(u), order=order)), want,
                 tol=1e-3, what="vs chebder (test_chebyshev.py's bar)")
    got = _np(ft.cheb_derivative(_t(u.T.copy()), order=order, axis=0))
    assert_close(got.T, _np(ft.cheb_derivative(_t(u), order=order)))
    with pytest.raises(ValueError, match="order must be >= 1"):
        ft.cheb_derivative(_t(u), order=0)


def test_cheb_integrate_matches_jax(rng, assert_close):
    n = 24
    x = _np(ft.cheb_points(n, device="cpu")).astype(np.float64)
    assert abs(float(ft.cheb_integrate(_t(np.exp(x).astype(np.float32)))) - (np.e - 1 / np.e)) \
        < 1e-5
    u = rrand(rng, 3, n + 1)
    for axis, v in ((-1, u), (0, u.T.copy())):
        assert_close(_np(ft.cheb_integrate(_t(v), axis=axis, interval=(0, 3))),
                     np.asarray(ftt.cheb_integrate(v, axis=axis, interval=(0, 3))))


def test_cheb_derivative_table_is_the_recurrence():
    # the closed-form matrix against the recurrence b_k = b_{k+2} + 2(k+1)a_{k+1}
    rng = np.random.default_rng(5)
    a = rng.standard_normal(12)
    b = np.zeros(13)
    for k in range(10, -1, -1):
        b[k] = b[k + 2] + 2 * (k + 1) * a[k + 1]
    b[0] *= 0.5
    got = _np(chebyshev._der_coeffs(_t(a.astype(np.float32))))
    np.testing.assert_allclose(got, b[:12], rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------- #
# mdct
# ---------------------------------------------------------------------- #
def _direct_mdct(x):
    n2 = x.shape[-1]
    N = n2 // 2
    t = np.arange(n2)[None, :]
    k = np.arange(N)[:, None]
    M = np.cos(np.pi / N * (t + 0.5 + N / 2) * (k + 0.5))
    return x.astype(np.float64) @ M.T


def _direct_imdct(X):
    N = X.shape[-1]
    t = np.arange(2 * N)[:, None]
    k = np.arange(N)[None, :]
    M = np.cos(np.pi / N * (t + 0.5 + N / 2) * (k + 0.5))
    return (1.0 / N) * X.astype(np.float64) @ M.T


@pytest.mark.parametrize("N", [8, 128])
def test_mdct_frames_match_jax_and_the_cosine_sum(N, rng, assert_close):
    x = rrand(rng, 3, 2 * N)
    X = rrand(rng, 3, N)
    got = _np(ft.mdct_frame(_t(x)))
    assert_close(got, np.asarray(ftt.mdct_frame(x)))
    assert_close(got, _direct_mdct(x))
    got = _np(ft.imdct_frame(_t(X)))
    assert_close(got, np.asarray(ftt.imdct_frame(X)))
    assert_close(got, _direct_imdct(X))


def test_mdct_signal_level_matches_jax_and_reconstructs(rng, assert_close):
    N = 32
    x = rrand(rng, 2, 8 * N)
    assert_close(_np(ft.sine_window(2 * N, device="cpu")), np.asarray(ftt.sine_window(2 * N)))
    for window in (None, False, np.hanning(2 * N).astype(np.float32)):
        C = ft.mdct(_t(x), N, window=window)
        assert C.shape == (2, 7, N)
        assert_close(_np(C), np.asarray(ftt.mdct(x, N, window=window)), what=f"{window}")
        y = ft.imdct(C, window=window)
        assert_close(_np(y), np.asarray(ftt.imdct(np.asarray(_np(C)), window=window)))
    y = _np(ft.imdct(ft.mdct(_t(x), N)))  # TDAC: the interior is exact
    assert y.shape == x.shape
    assert_close(y[:, N:-N], x[:, N:-N])
    for mod in (ft, ftt):
        with pytest.raises(ValueError, match="multiple of 4"):
            mod.mdct_frame(np.zeros(10, np.float32) if mod is ftt else torch.zeros(10))
        with pytest.raises(ValueError, match="must be even"):
            mod.imdct_frame(np.zeros(9, np.float32) if mod is ftt else torch.zeros(9))
        with pytest.raises(ValueError, match="multiple of N"):
            mod.mdct(np.zeros(100, np.float32) if mod is ftt else torch.zeros(100), 16)
