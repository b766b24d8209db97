"""Torch port, ``ops/conv2d.py`` on the CPU: convolve2d / correlate2d with
every mode and boundary, deconvolve, wiener, savgol_coeffs,
savgol_filter, morlet.

The same numpy inputs, made from a seed, go through the JAX package on the
CPU and through the port on CPU tensors, values and gradients
(``jax.grad``), beside the scipy oracles of the JAX package's own test
(``tests/test_conv2d.py``).  Tolerance: 1e-5 relative L2 against the JAX
package; against scipy the JAX test's own bars (1e-5 for real
convolve2d / correlate2d, 1e-4 for complex boundaries, even templates,
the Savitzky-Golay filter and even-window wiener, 2e-4 for wiener).  Host
float64 functions are held to the JAX function's output at
``atol=1e-12``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu.ops import conv2d as j_c2d
from fft_wgpu_tpu_torch.ops import cuda_fft, helpers

torch.set_num_threads(1)

HOST = dict(rtol=0, atol=1e-12)
WIENER_TOL = 2e-4  # tests/test_conv2d.py::test_wiener_matches_scipy
EDGE_TOL = 1e-4    # tests/test_conv2d.py: complex boundaries, savgol, even wiener


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def rrand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("corr", [False, True], ids=["convolve2d", "correlate2d"])
@pytest.mark.parametrize("boundary", ["fill", "wrap", "symm"])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_conv2d_modes_and_boundaries_match_jax_and_scipy(corr, boundary, mode, rng,
                                                         assert_close):
    # an even template dimension (4, 6): correlation's k//2 'same' offset
    name = "correlate2d" if corr else "convolve2d"
    a = rrand(rng, 23, 17)
    k = rrand(rng, 4, 6) if corr else rrand(rng, 5, 3)
    got = getattr(ft, name)(_t(a), _t(k), mode=mode, boundary=boundary)
    assert got.dtype == torch.float32
    assert_close(_np(got), np.asarray(getattr(ftt, name)(a, k, mode=mode, boundary=boundary)))
    want = getattr(sps, name)(a, k, mode=mode, boundary=boundary)
    assert got.shape == want.shape
    assert_close(_np(got), want)


@pytest.mark.parametrize("corr", [False, True], ids=["convolve2d", "correlate2d"])
@pytest.mark.parametrize("boundary", ["fill", "wrap", "symm"])
def test_conv2d_complex_matches_jax_and_scipy(corr, boundary, rng, assert_close):
    name = "correlate2d" if corr else "convolve2d"
    a = crand(rng, 16, 12)
    k = crand(rng, 4, 6) if corr else crand(rng, 4, 3)
    for mode in ("full", "same", "valid"):
        got = getattr(ft, name)(_t(a), _t(k), mode=mode, boundary=boundary)
        assert got.dtype == torch.complex64
        assert_close(_np(got), np.asarray(getattr(ftt, name)(a, k, mode=mode,
                                                              boundary=boundary)))
        assert_close(_np(got), getattr(sps, name)(a, k, mode=mode, boundary=boundary),
                     EDGE_TOL)


def test_conv2d_fillvalues_and_mixed_inputs_match_jax(rng, assert_close):
    a = rrand(rng, 12, 9)
    k = rrand(rng, 3, 5)
    for fv in (2.5, 1.5 + 0.5j):
        got = ft.convolve2d(_t(a), _t(k), mode="same", boundary="fill", fillvalue=fv)
        assert_close(_np(got), np.asarray(ftt.convolve2d(a, k, mode="same", fillvalue=fv)))
        assert_close(_np(got), sps.convolve2d(a.astype(np.complex128), k, mode="same",
                                              fillvalue=fv), EDGE_TOL)
    kc = crand(rng, 3, 3)  # a real image against a complex template
    assert_close(_np(ft.correlate2d(_t(a), _t(kc), mode="same")),
                 np.asarray(ftt.correlate2d(a, kc, mode="same")))
    # a list kernel goes to the image's device
    assert_close(_np(ft.convolve2d(_t(a), k.tolist())), np.asarray(ftt.convolve2d(a, k)))


def test_conv2d_errors_match_jax(rng):
    a = rng.standard_normal((5, 9))
    for args, kw in (((a, rng.standard_normal((7, 3))), {"mode": "valid"}),
                     ((a, a), {"mode": "bogus"}),
                     ((a[0], a), {}),
                     ((a, a[:2, :2]), {"boundary": "bogus"})):
        with pytest.raises(ValueError) as want:
            ftt.convolve2d(*args, **kw)
        with pytest.raises(ValueError) as got:
            ft.convolve2d(*(_t(v) for v in args), **kw)
        assert str(got.value) == str(want.value)
    for fn, args in ((ft.wiener, (_t(crand(rng, 8, 8)),)),
                     (ft.wiener, (_t(rrand(rng, 8, 8)), (3, 3, 3))),
                     (ft.savgol_filter, (_t(np.zeros(5, np.float32)), 7, 2)),
                     (ft.savgol_filter, (_t(np.zeros(9, np.float32)), 7, 2, 0, 1.0, -1, "x")),
                     (ft.savgol_coeffs, (5, 5)),
                     (ft.deconvolve, ([1.0, 2.0], [0.0, 1.0]))):
        with pytest.raises(ValueError):
            fn(*args)


def test_wiener_matches_jax_and_scipy(rng, assert_close):
    im = rrand(rng, 24, 20)
    for mysize, noise, bar in ((5, None, WIENER_TOL), ((3, 7), 0.5, WIENER_TOL),
                               ((4, 6), None, EDGE_TOL), (None, None, WIENER_TOL)):
        got = _np(ft.wiener(_t(im), mysize=mysize, noise=noise))
        assert_close(got, np.asarray(ftt.wiener(im, mysize=mysize, noise=noise)))
        assert_close(got, sps.wiener(im.astype(np.float64), mysize=mysize, noise=noise), bar)
    x = rrand(rng, 64)
    assert_close(_np(ft.wiener(_t(x), mysize=9)), np.asarray(ftt.wiener(x, mysize=9)))


@pytest.mark.parametrize("mode", ["interp", "mirror", "nearest", "constant", "wrap"])
def test_savgol_filter_modes_match_jax_and_scipy(mode, rng, assert_close):
    x = np.cumsum(rrand(rng, 6, 80), axis=-1).astype(np.float32)
    got = _np(ft.savgol_filter(_t(x), 11, 3, mode=mode, cval=1.0))
    assert_close(got, np.asarray(ftt.savgol_filter(x, 11, 3, mode=mode, cval=1.0)))
    assert_close(got, sps.savgol_filter(x.astype(np.float64), 11, 3, mode=mode, cval=1.0),
                 EDGE_TOL)
    # along axis 0, a derivative, and one row
    xt = np.ascontiguousarray(x.T)
    got = _np(ft.savgol_filter(_t(xt), 9, 3, deriv=1, delta=0.1, axis=0, mode=mode))
    assert_close(got, np.asarray(ftt.savgol_filter(xt, 9, 3, deriv=1, delta=0.1, axis=0,
                                                   mode=mode)))
    assert_close(_np(ft.savgol_filter(_t(x[0]), 7, 2, mode=mode)),
                 np.asarray(ftt.savgol_filter(x[0], 7, 2, mode=mode)))


def test_host_design_functions_match_jax(rng):
    for args, kw in (((5, 2), {"deriv": 0, "delta": 0.5}), ((9, 4), {"deriv": 2, "delta": 0.5}),
                     ((7, 3), {"pos": 2, "use": "dot"}), ((6, 2), {}), ((5, 1), {"deriv": 3})):
        got = ft.savgol_coeffs(*args, **kw)
        np.testing.assert_allclose(got, j_c2d.savgol_coeffs(*args, **kw), **HOST)
        np.testing.assert_allclose(got, sps.savgol_coeffs(*args, **kw), rtol=0, atol=1e-10)
    div = np.array([1.0, 0.5, -0.25])
    sig = np.convolve(div, rng.standard_normal(17))
    for args in ((sig, div), ([1.0, 2.0], [1.0, 1.0, 1.0])):
        for g, w, o in zip(ft.deconvolve(*args), ftt.deconvolve(*args), sps.deconvolve(*args)):
            np.testing.assert_allclose(g, w, **HOST)
            np.testing.assert_allclose(g, o, rtol=0, atol=1e-10)
    for args, kw in (((64,), {"w": 5.0, "s": 1.2}), ((33,), {"complete": False})):
        np.testing.assert_allclose(ft.morlet(*args, **kw), ftt.morlet(*args, **kw), **HOST)


def test_grad_convolve2d_matches_jax(rng, assert_close):
    # d/da sum(w * convolve2d(a, k, 'same')): the R2C / C2R routes' adjoints
    a, k = rrand(rng, 20, 24), rrand(rng, 5, 4)
    w = rrand(rng, 20, 24)
    want = jax.grad(lambda v: jnp.sum(w * ftt.convolve2d(v, k, mode="same")))(jnp.asarray(a))
    v = _t(a).requires_grad_()
    (_t(w) * ft.convolve2d(v, _t(k), mode="same")).sum().backward()
    assert_close(_np(v.grad), np.asarray(want))


def test_conv2d_transform_shapes_and_pads():
    # 1080 x 1920 with a 31 x 31 kernel and the 'symm' boundary (pads of 30
    # a side): 5-smooth even lengths in the composite or pow2 kernels'
    # envelope on the card
    shape = [helpers.next_fast_len(v + 3 * 30, real=True) for v in (1080, 1920)]
    assert shape == [1200, 2048]
    assert cuda_fft._gen_supported(1200) and cuda_fft._supported(2048)
    x = torch.arange(5.0)
    for mode in ("edge", "wrap", "symmetric", "reflect"):
        for width in (2, 7, 13):  # wider than the signal: the pads fold
            np.testing.assert_array_equal(helpers._pad_axis(x, width, width - 1, 0, mode).numpy(),
                                          np.pad(x.numpy(), (width, width - 1), mode=mode))
    np.testing.assert_array_equal(
        helpers._pad_axis(x, 7, 6, 0, "reflect", odd=True).numpy(),
        np.asarray(jnp.pad(jnp.arange(5.0), (7, 6), mode="reflect", reflect_type="odd")))
