"""Torch port, the transform-domain solvers on the CPU: ``ops/fftlog.py``
(scipy.fft's fast Hankel transform), ``ops/spectral.py`` (spectral
derivatives), ``ops/fourier_filters.py`` (scipy.ndimage's fourier_*) and
``ops/structured.py`` (circulant, Toeplitz and BCCB operators, Gaussian
random fields).

The same numpy inputs, made from a seed, go through the JAX package on the
CPU and through the port on CPU tensors, values and gradients
(``jax.grad``), beside the scipy / numpy oracles of the JAX package's own
tests (``tests/test_fftlog.py``, ``test_spectral.py``,
``test_fourier_filters.py``, ``test_structured.py``).  Tolerance: 1e-5
relative L2, or the JAX test's own bar where it names one: ``fht`` /
``ifht`` 2e-4 (test_fftlog.py), ``toeplitz_solve`` 1e-4
(test_structured.py), ``fourier_ellipsoid`` 1e-4 (test_fourier_filters.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft as sfft
import scipy.linalg as sla
import scipy.ndimage as ndi
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu.ops import structured as j_structured
from fft_wgpu_tpu_torch.ops import fftlog, spectral, structured
from fft_wgpu_tpu_torch.ops import rfft as rfft_mod

torch.set_num_threads(1)

FHT_BAR = 2e-4  # tests/test_fftlog.py
TOEPLITZ_BAR = 1e-4  # tests/test_structured.py
ELLIPSOID_BAR = 1e-4  # tests/test_fourier_filters.py


def _t(x):
    # a CPU tensor asks the port for the CPU
    return torch.from_numpy(np.array(x))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def rrand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------- #
# fftlog
# ---------------------------------------------------------------------- #
def _signal(n, dln, seed=0, rows=()):
    rng = np.random.default_rng(seed)
    # smooth positive log-spaced signal (the FFTLog use case)
    r = np.exp((np.arange(n) - (n - 1) / 2) * dln)
    return (r**2 * np.exp(-(r**2) / 2)
            * (1 + 0.1 * rng.standard_normal(rows + (n,)))).astype(np.float64)


@pytest.mark.parametrize("n", [128, 127])
@pytest.mark.parametrize("mu,bias", [(0.0, 0.0), (2.0, 0.1), (1.0, -0.2)])
def test_fht_ifht_match_jax_and_scipy(n, mu, bias, assert_close):
    dln = 0.08
    offset = float(sfft.fhtoffset(dln, mu, bias=bias))
    a = _signal(n, dln, rows=(2,))
    a32 = a.astype(np.float32)
    for name in ("fht", "ifht"):
        got = _np(getattr(ft, name)(_t(a32), dln, mu, offset=offset, bias=bias))
        what = f"{name} n {n} mu {mu} bias {bias}"
        assert_close(got, np.asarray(getattr(ftt, name)(a32, dln, mu, offset=offset,
                                                        bias=bias)), tol=FHT_BAR, what=what)
        assert_close(got, getattr(sfft, name)(a, dln, mu, offset=offset, bias=bias),
                     tol=FHT_BAR, what=what + " vs scipy")


def test_fht_roundtrip_offset_and_errors(assert_close):
    n, dln, mu = 128, 0.05, 0.5
    for dl, m, bias in [(0.1, 0.0, 0.0), (0.05, 2.0, 0.3), (0.2, 0.5, -0.4)]:
        assert abs(ft.fhtoffset(dl, m, initial=0.1, bias=bias)
                   - sfft.fhtoffset(dl, m, initial=0.1, bias=bias)) < 1e-12
    offset = float(ft.fhtoffset(dln, mu))
    a = _signal(n, dln, seed=7).astype(np.float32)
    back = ft.ifht(ft.fht(_t(a), dln, mu, offset=offset), dln, mu, offset=offset)
    assert_close(_np(back), a, tol=FHT_BAR)
    for mod in (ft, ftt):
        with pytest.raises(TypeError, match="require real input"):
            mod.fht(np.ones(16, np.complex64) if mod is ftt else torch.ones(16, dtype=torch.complex64),
                    0.1, 0.0)
    # the singular cases warn as the JAX package does: u_0 infinite for the
    # forward transform, zero for the inverse
    for name, mu, bias in (("fht", -1.5, 0.5), ("ifht", -0.5, 0.5), ("ifht", 1.0, 2.0)):
        for mod in (ft, ftt):
            with pytest.warns(UserWarning, match="singular (inverse )?transform"):
                out = getattr(mod, name)(a if mod is ftt else _t(a), dln, mu, bias=bias)
            assert np.isfinite(_np(out)).all()


def test_fht_lanczos_copy_matches_scipy_loggamma():
    from scipy.special import loggamma

    for z in [0.75 + 3.2j, 1.5 + 0.0j, 0.25 + 1.0j, 2.5 - 4.0j, 0.1 + 0.1j]:
        assert abs(fftlog._lanczos_loggamma(complex(z)) - loggamma(z)) < 1e-10


def test_fht_gradient_matches_jax_grad(rng, assert_close):
    n, dln, mu = 128, 0.08, 0.5
    a = _signal(n, dln, rows=(2,)).astype(np.float32)
    w = rng.random((2, n)).astype(np.float32)
    for name, bias in (("fht", 0.0), ("ifht", 0.1)):
        want = jax.grad(lambda v: jnp.sum(w * getattr(ftt, name)(v, dln, mu, bias=bias)))(
            jnp.asarray(a))
        v = _t(a).requires_grad_()
        (_t(w) * getattr(ft, name)(v, dln, mu, bias=bias)).sum().backward()
        assert_close(_np(v.grad), np.asarray(want), tol=FHT_BAR, what=name)


# ---------------------------------------------------------------------- #
# spectral calculus
# ---------------------------------------------------------------------- #
def _grid(n):
    return np.linspace(0, 2 * np.pi, n, endpoint=False)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_spectral_derivative_matches_jax(order, rng, assert_close):
    for shape, axis, length in (((3, 128), -1, 2 * np.pi), ((64, 5), 0, 3.0),
                                ((2, 63, 4), 1, 1.5)):
        f = rrand(rng, *shape)
        got = _np(ft.spectral_derivative(_t(f), order=order, axis=axis, length=length))
        assert_close(got, np.asarray(ftt.spectral_derivative(f, order=order, axis=axis,
                                                             length=length)),
                     what=f"{shape} axis {axis} order {order}")


def test_spectral_calculus_analytic_oracles(assert_close):
    x = _grid(128)
    got = _np(ft.spectral_derivative(_t(np.sin(3 * x).astype(np.float32))))
    assert_close(got, 3 * np.cos(3 * x))
    got = _np(ft.spectral_derivative(_t(np.cos(5 * x).astype(np.float32)), order=2))
    assert_close(got, -25 * np.cos(5 * x), tol=1e-4)  # test_spectral.py's order-2 bar
    x = _grid(64)
    X, Y = np.meshgrid(x, x, indexing="ij")
    f = (np.sin(2 * X) * np.cos(Y)).astype(np.float32)
    gx, gy = ft.spectral_gradient(_t(f))
    jx, jy = ftt.spectral_gradient(f)
    assert_close(_np(gx), np.asarray(jx))
    assert_close(_np(gy), np.asarray(jy))
    assert np.linalg.norm(_np(gx) - 2 * np.cos(2 * X) * np.cos(Y)) < 1e-3
    x = _grid(32)
    X, Y = np.meshgrid(x, x, indexing="ij")
    f = (np.sin(X) * np.cos(3 * Y)).astype(np.float32)
    assert_close(_np(ft.spectral_laplacian(_t(f))), -10 * f, tol=1e-4)


def test_spectral_laplacian_and_gradient_match_jax(rng, assert_close):
    for shape, lengths in (((16, 24), None), ((8, 12, 10), (1.0, 2.0, 3.0)), ((9, 15), None)):
        f = rrand(rng, *shape)
        assert_close(_np(ft.spectral_laplacian(_t(f), lengths)),
                     np.asarray(ftt.spectral_laplacian(f, lengths)), what=f"{shape}")
    f = rrand(rng, 8, 12, 10)
    for g, j in zip(ft.spectral_gradient(_t(f), (1.0, 2.0, 3.0)),
                    ftt.spectral_gradient(f, (1.0, 2.0, 3.0))):
        assert_close(_np(g), np.asarray(j))


def test_spectral_derivative_gradient_matches_jax_grad(rng, assert_close):
    f = rrand(rng, 4, 64)
    w = rng.random((4, 64)).astype(np.float32)
    for order, axis in ((1, -1), (2, 0)):
        want = jax.grad(lambda v: jnp.sum(w * ftt.spectral_derivative(v, order, axis)))(
            jnp.asarray(f))
        v = _t(f).requires_grad_()
        (_t(w) * ft.spectral_derivative(v, order, axis)).sum().backward()
        assert_close(_np(v.grad), np.asarray(want), what=f"order {order} axis {axis}")


def test_spectral_derivative_is_rfft_then_irfft(rng, monkeypatch):
    # the route: one rfft and one irfft of the field (on the card the R2C
    # kernel's complex64 sink and the C2R kernel's complex64 source)
    calls = []
    for name in ("rfft", "irfft"):
        fn = getattr(rfft_mod, name)
        monkeypatch.setattr(spectral, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append((_n, tuple(a[0].shape), k.get("axis"))), _f(*a, **k))[1])
    ft.spectral_derivative(_t(rrand(rng, 16, 32)), axis=0)
    assert calls == [("rfft", (16, 32), 0), ("irfft", (9, 32), 0)]
    assert rfft_mod._rfft_c64(torch.device("cuda"), 4096)
    assert rfft_mod._irfftn_c64((4096, 2049), torch.complex64, torch.device("cuda"), [4096],
                                [1])


# ---------------------------------------------------------------------- #
# fourier_filters
# ---------------------------------------------------------------------- #
FILTERS = {
    "gaussian": [2.0, (1.0, 3.0)],
    "uniform": [5, (2.0, 4.5)],
    "shift": [(1.5, -2.25), 3.0],
}


@pytest.mark.parametrize("name", list(FILTERS))
def test_fourier_filters_match_jax_and_scipy(name, rng, assert_close):
    img = rrand(rng, 24, 32)
    fn, jfn, sfn = (getattr(m, f"fourier_{name}") for m in (ft, ftt, ndi))
    for p in FILTERS[name]:
        X = np.fft.fft2(img).astype(np.complex64)
        got = _np(fn(_t(X), p))
        assert got.dtype == np.complex64
        assert_close(got, np.asarray(jfn(X, p)), what=f"{name} {p}")
        assert_close(got, sfn(X, p), what=f"{name} {p} vs scipy")
        # the R2C half spectrum of a length-32 signal on the last axis
        H = np.fft.rfft2(img).astype(np.complex64)
        got = _np(fn(_t(H), p, n=img.shape[-1]))
        assert_close(got, np.asarray(jfn(H, p, n=img.shape[-1])), what=f"{name} {p} n=32")
        assert_close(got, sfn(H, p, n=img.shape[-1]), what=f"{name} {p} n=32 vs scipy")
    # real input is read as a spectrum with a zero imaginary part
    assert_close(_np(fn(_t(img), FILTERS[name][0])), np.asarray(jfn(img, FILTERS[name][0])))


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_fourier_ellipsoid_matches_jax_and_scipy(rank, rng, assert_close):
    X = np.fft.fftn(rrand(rng, *(16,) * rank)).astype(np.complex64)
    got = _np(ft.fourier_ellipsoid(_t(X), 4.0))
    assert_close(got, np.asarray(ftt.fourier_ellipsoid(X, 4.0)), tol=ELLIPSOID_BAR)
    assert_close(got, ndi.fourier_ellipsoid(X, 4.0), tol=ELLIPSOID_BAR)


def test_fourier_filter_errors_and_roundtrip(rng):
    for mod in (ft, ftt):
        X = np.zeros((2, 2, 2, 2), np.complex64)
        with pytest.raises(ValueError, match="rank <= 3"):
            mod.fourier_ellipsoid(X if mod is ftt else _t(X), 2.0)
        with pytest.raises(ValueError, match="scalar or length-2"):
            mod.fourier_gaussian(X[0, 0] if mod is ftt else _t(X[0, 0]), (1.0, 2.0, 3.0))
    img = rrand(rng, 24, 32)
    Y = ft.fourier_shift(_t(np.fft.rfft2(img).astype(np.complex64)), (3, 5), n=32)
    y = np.fft.irfft2(_np(Y), s=img.shape)
    np.testing.assert_allclose(y, np.roll(img, (3, 5), (0, 1)), atol=1e-4)


# ---------------------------------------------------------------------- #
# structured
# ---------------------------------------------------------------------- #
def test_circulant_and_toeplitz_matvecs_match_jax_and_scipy(rng, assert_close):
    for n in (64, 50):
        c, r = rrand(rng, n), rrand(rng, n)
        r[0] = c[0]
        x = rrand(rng, 3, n)
        got = _np(ft.circulant_matvec(_t(c), _t(x)))
        assert_close(got, np.asarray(ftt.circulant_matvec(c, x)))
        assert_close(got, x.astype(np.float64) @ sla.circulant(c).T)
        got = _np(ft.toeplitz_matvec(_t(c), _t(r), _t(x)))
        assert_close(got, np.asarray(ftt.toeplitz_matvec(c, r, x)))
        assert_close(got, x.astype(np.float64) @ sla.toeplitz(c, r).T)
        c[0] += n  # diagonally dominant: well conditioned
        got = _np(ft.circulant_solve(_t(c), _t(x)))
        assert_close(got, np.asarray(ftt.circulant_solve(c, x)))
        assert_close(got, np.linalg.solve(sla.circulant(c), x.astype(np.float64).T).T)


@pytest.mark.parametrize("n,batch", [(96, (2,)), (40, ())])
def test_toeplitz_solve_matches_jax_and_scipy(n, batch, rng, assert_close):
    # SPD Toeplitz: exponential covariance; a Gaussian one with a nugget
    c = (np.exp(-np.arange(n) / 7.0) if batch else
         np.exp(-((np.arange(n) / 5.0) ** 2)) + 0.01 * (np.arange(n) == 0)).astype(np.float32)
    b = rrand(rng, *batch, n)
    got = _np(ft.toeplitz_solve(_t(c), _t(b)))
    assert_close(got, np.asarray(ftt.toeplitz_solve(c, b)), tol=TOEPLITZ_BAR)
    want = np.stack([sla.solve_toeplitz(c.astype(np.float64), bi)
                     for bi in b.reshape(-1, n).astype(np.float64)]).reshape(b.shape)
    assert_close(got, want, tol=TOEPLITZ_BAR, what="(PCG vs scipy solve_toeplitz)")
    # the same stopping rule: max_iter caps the iterations as in the JAX package
    assert_close(_np(ft.toeplitz_solve(_t(c), _t(b), max_iter=3)),
                 np.asarray(ftt.toeplitz_solve(c, b, max_iter=3)), tol=TOEPLITZ_BAR)


def test_bccb_matches_jax_and_the_dense_matrix(rng, assert_close):
    k = (0.05 * rng.standard_normal((6, 8))).astype(np.float32)
    k[0, 0] += 1.0
    x = rrand(rng, 3, 6, 8)
    y = ft.bccb_matvec(_t(k), _t(x))
    assert_close(_np(y), np.asarray(ftt.bccb_matvec(k, x)))
    B = np.zeros((48, 48))
    for i in range(6):
        for j in range(8):
            for p in range(6):
                for q in range(8):
                    B[i * 8 + j, p * 8 + q] = k[(i - p) % 6, (j - q) % 8]
    assert_close(_np(y).reshape(3, 48), x.reshape(3, 48).astype(np.float64) @ B.T)
    for reg in (0.0, 1e-3):
        got = _np(ft.bccb_solve(_t(k), y, reg=reg))
        assert_close(got, np.asarray(ftt.bccb_solve(k, np.asarray(_np(y)), reg=reg)))
    assert_close(_np(ft.bccb_solve(_t(k), y)), x)


def test_structured_errors_match_jax():
    for mod in (ft, ftt):
        t = (lambda a: a) if mod is ftt else _t
        with pytest.raises(ValueError, match=r"got \(2, 2\) vs \(2,\)"):
            mod.circulant_matvec(t(np.ones((2, 2), np.float32)), t(np.ones(2, np.float32)))
        with pytest.raises(ValueError, match="c must be 1-D"):
            mod.circulant_solve(t(np.ones(4, np.float32)), t(np.ones(5, np.float32)))
        with pytest.raises(ValueError, match="equal length"):
            mod.toeplitz_matvec(t(np.ones(4, np.float32)), t(np.ones(5, np.float32)),
                                t(np.ones(4, np.float32)))
        with pytest.raises(ValueError, match="k must be 2-D"):
            mod.bccb_matvec(t(np.ones((4, 4), np.float32)), t(np.ones((4, 5), np.float32)))
    g = torch.Generator().manual_seed(0)
    for acf, what in ((np.ones(1), "at least 2 lags"),
                      (1.0 - np.arange(24) / 6.0, "nonnegative definite")):
        with pytest.raises(ValueError, match=what):
            ft.grf_sample(acf, g)
        with pytest.raises(ValueError, match=what):
            ftt.grf_sample(acf, jax.random.PRNGKey(0))


def test_grf_from_noise_matches_numpy_and_jax(rng, assert_close):
    # the same noise through the port's synthesis, float64 numpy and the
    # JAX package's (its FFT of er + i*ei, sliced as its _grf_impl does)
    n = 33
    acf = np.exp(-np.arange(n) / 5.0)
    sqrt_lam, n_lags = structured._grf_embedding(acf)
    assert n_lags == n and sqrt_lam.size == 2 * (n - 1)
    er, ei = rrand(rng, 3, 64), rrand(rng, 3, 64)
    got = _np(structured._grf_from_noise(_t(sqrt_lam.astype(np.float32)), _t(er), _t(ei),
                                         5, n))
    F = np.fft.fft((er + 1j * ei) * sqrt_lam, axis=-1)
    assert_close(got, np.concatenate([F.real[:, :n], F.imag[:, :n]])[:5])
    jr, ji = j_structured._fft_last(jnp.asarray(er * sqrt_lam.astype(np.float32)),
                                    jnp.asarray(ei * sqrt_lam.astype(np.float32)), -1, None)
    assert_close(got, np.concatenate([np.asarray(jr)[:, :n], np.asarray(ji)[:, :n]])[:5])


def test_grf_exact_covariance():
    """Sample covariance of circulant-embedding GRF matches the acf."""
    n = 32
    acf = np.exp(-np.arange(n) / 5.0)
    num = 8192
    s = _np(ft.grf_sample(_t(acf), torch.Generator().manual_seed(0), num))
    assert s.shape == (num, n) and s.dtype == np.float32
    emp = np.array([
        np.mean([np.mean(s[:, i] * s[:, i + k]) for i in range(n - k)])
        for k in range(8)
    ])
    assert np.abs(emp - acf[:8]).max() < 0.06
    again = _np(ft.grf_sample(_t(acf), torch.Generator().manual_seed(0), num))
    assert np.array_equal(s, again)  # the generator's seed fixes the draw


def test_structured_gradients_flow(rng, assert_close):
    # the solves are differentiable compositions: jax.grad of the same loss
    c = rrand(rng, 32)
    c[0] += 32
    b = rrand(rng, 2, 32)
    w = rng.random((2, 32)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(w * ftt.circulant_solve(c, v)))(jnp.asarray(b))
    v = _t(b).requires_grad_()
    (_t(w) * ft.circulant_solve(_t(c), v)).sum().backward()
    assert_close(_np(v.grad), np.asarray(want))
