"""Torch port, waveforms and multirate on the CPU: ``ops/waveforms.py``
(chirp, sweep_poly, gausspulse, sawtooth, square, unit_impulse,
max_len_seq, vectorstrength) and ``ops/multirate.py`` (the FIR designs,
upfirdn, resample_poly, decimate, freqz, group_delay).

The same numpy inputs, made from a seed, go through the JAX package on the
CPU and through the port on CPU tensors, values and gradients
(``jax.grad``), beside the scipy oracles of the JAX package's own tests
(``tests/test_waveforms.py``, ``tests/test_multirate.py``).  Host float64
functions are held to the JAX function's output at ``atol=1e-12``, and a
CPU tensor ``t`` for a waveform to the numpy result at the same bar.
Device functions: 1e-5 relative L2 against the JAX package, and against
scipy the JAX test's own bars: upfirdn 2e-5, resample_poly and decimate
5e-5 (``tests/test_multirate.py:83-159``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu.ops import multirate as j_mr
from fft_wgpu_tpu_torch.ops import multirate, rfft

torch.set_num_threads(1)

UPFIRDN_TOL = 2e-5   # tests/test_multirate.py, upfirdn against scipy
RESAMPLE_TOL = 5e-5  # tests/test_multirate.py, resample_poly / decimate against scipy
HOST = dict(rtol=0, atol=1e-12)


def _t(x):
    # a CPU tensor asks the port for the CPU
    return torch.from_numpy(np.array(x))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def rrand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _same_error(jax_call, port_call):
    """Both calls raise the same exception type with the same message."""
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(want.type) as got:
        port_call()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------- #
# waveforms: host float64, and a CPU tensor t computed where it lies
# ---------------------------------------------------------------------- #
T_GRID = np.linspace(0, 10, 501)


def _waveform_cases():
    tp = np.linspace(-1, 1, 1001) * 1e-2
    ts = np.linspace(-15, 15, 2001)
    cases = [(f"chirp {m} vz={vz}", "chirp", T_GRID,
              dict(f0=1.5, t1=10, f1=6.0, method=m, phi=33, vertex_zero=vz))
             for m in ("linear", "quadratic", "logarithmic", "hyperbolic") for vz in (True, False)]
    cases += [("chirp hyperbolic down", "chirp", T_GRID, dict(f0=6.0, t1=10, f1=1.5,
                                                             method="hyperbolic")),
              ("chirp log equal", "chirp", T_GRID, dict(f0=4.0, t1=10, f1=4.0, method="log")),
              ("chirp complex", "chirp", T_GRID, dict(f0=1.0, t1=10, f1=5.0, complex=True)),
              ("sweep_poly", "sweep_poly", T_GRID, dict(poly=[0.025, -0.36, 1.25, 2.0], phi=12)),
              ("sweep_poly poly1d", "sweep_poly", T_GRID, dict(poly=np.poly1d([0.1, 1.0]))),
              ("gausspulse", "gausspulse", tp, dict(fc=1000, bw=0.5)),
              ("gausspulse quad env", "gausspulse", tp,
               dict(fc=700, bw=0.3, bwr=-9, retquad=True, retenv=True))]
    cases += [(f"sawtooth {w}", "sawtooth", ts, dict(width=w)) for w in (1.0, 0.0, 0.25, 1.5)]
    cases += [(f"square {d}", "square", ts, dict(duty=d)) for d in (0.5, 0.1, 1.0, -0.1)]
    cases += [("sawtooth array width", "sawtooth", ts, dict(width=np.full_like(ts, 0.3)))]
    return cases


@pytest.mark.parametrize("what,name,t,kw", _waveform_cases(), ids=lambda v: v
                         if isinstance(v, str) else "")
def test_waveforms_match_jax_and_scipy_and_take_a_tensor_t(what, name, t, kw):
    want = getattr(ftt, name)(t, **kw)
    got = getattr(ft, name)(t, **kw)
    oracle = getattr(sps, name)(t, **{k: v for k, v in kw.items() if k != "complex"})
    on_tensor = getattr(ft, name)(_t(t), **kw)
    for g, w, o, tt in zip(*(v if isinstance(v, tuple) else (v,)
                             for v in (got, want, oracle, on_tensor))):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **HOST)
        if not kw.get("complex"):
            np.testing.assert_allclose(g, o, **HOST)
        else:
            np.testing.assert_allclose(g.real, o, **HOST)
        assert isinstance(tt, torch.Tensor) and tt.device.type == "cpu"
        assert tt.dtype == (torch.complex128 if kw.get("complex") else torch.float64)
        np.testing.assert_allclose(tt.numpy(), g, **HOST)


def test_host_waveforms_and_errors_match_jax():
    assert np.isclose(ft.gausspulse("cutoff", fc=1000, bw=0.5, tpr=-60),
                      ftt.gausspulse("cutoff", fc=1000, bw=0.5, tpr=-60))
    for args in ((7,), (7, 2), ((5, 6), "mid"), ((4, 4), (1, 2))):
        np.testing.assert_array_equal(ft.unit_impulse(*args), ftt.unit_impulse(*args))
        np.testing.assert_array_equal(ft.unit_impulse(*args), sps.unit_impulse(*args))
    for nbits in (3, 8, 11):
        got, want = ft.max_len_seq(nbits), sps.max_len_seq(nbits)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    ev = np.array([0.1, 0.2, 1.1, 2.1, 3.05])
    for period in (1.0, np.array([0.5, 1.0, 2.0])):
        for g, w, o in zip(ft.vectorstrength(ev, period), ftt.vectorstrength(ev, period),
                           sps.vectorstrength(ev, period)):
            np.testing.assert_allclose(g, w, **HOST)
            np.testing.assert_allclose(g, o, **HOST)
    for name, args, kw in (
            ("vectorstrength", (ev, -1.0), {}),
            ("vectorstrength", (np.ones((2, 2)), 1.0), {}),
            ("vectorstrength", (ev, np.ones((2, 2))), {}),
            ("chirp", (T_GRID, 1.0, 10, -2.0), {"method": "logarithmic"}),
            ("chirp", (T_GRID, 1.0, 10, 2.0), {"method": "bogus"}),
            ("gausspulse", ("nope",), {}),
            ("gausspulse", (T_GRID,), {"bw": 0}),
            ("max_len_seq", (33,), {}),
            ("max_len_seq", (4,), {"state": np.zeros(4)})):
        _same_error(lambda: getattr(ftt, name)(*args, **kw),
                    lambda: getattr(ft, name)(*args, **kw))


# ---------------------------------------------------------------------- #
# FIR design and frequency response: host float64
# ---------------------------------------------------------------------- #
def _design_cases():
    return [
        ("firwin", (31, 0.3), {}), ("firwin", (32, 0.5), {}),
        ("firwin", (31, [0.2, 0.6]), {"pass_zero": False}),
        ("firwin", (31, 0.4), {"pass_zero": "highpass"}),
        ("firwin", (64, 0.25), {"window": ("kaiser", 8.0)}),
        ("firwin", (21, 0.3), {"window": "blackman"}),
        ("firwin", (55, 0.35), {"width": 0.05}),
        ("firwin", (31, 1000.0), {"fs": 8000.0}),
        ("firwin", (31, 0.3), {"window": "nuttall"}),  # the port's window zoo, on the CPU
        ("firwin2", (41, [0.0, 0.3, 0.3, 1.0], [1.0, 1.0, 0.0, 0.0]), {}),
        ("firwin2", (40, [0.0, 0.5, 1.0], [0.0, 1.0, 1.0]), {"antisymmetric": True}),
        ("firwin2", (33, [0.0, 1000.0, 4000.0], [1.0, 0.5, 0.0]), {"fs": 8000.0}),
        ("firls", (51, [0, 0.1, 0.2, 0.4, 0.45, 1.0], [0, 0, 1, 1, 0, 0]),
         {"weight": [1.0, 2.0, 0.5]}),
        ("firls", (73, [0, 200, 250, 500], [1, 0.5, 0, 0]), {"fs": 1000.0}),
        ("remez", (65, [0, 0.075, 0.1, 0.2, 0.225, 0.5], [0, 1, 0]), {"weight": [1, 2, 5]}),
        ("remez", (40, [0, 0.1, 0.125, 0.5], [1, 0]), {}),
        ("remez", (31, [0.025, 0.475], [1]), {"type": "hilbert"}),
        ("remez", (20, [0.025, 0.475], [1]), {"type": "hilbert"}),
        ("remez", (25, [0.025, 0.225], [2.0]), {"type": "differentiator"}),
    ]


@pytest.mark.parametrize("name,args,kw", _design_cases(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_fir_designs_match_jax_and_scipy(name, args, kw):
    got = getattr(ft, name)(*args, **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_allclose(got, getattr(j_mr, name)(*args, **kw), **HOST)
    ref = getattr(sps, name)(*args, **kw)
    bar = {"firwin": 5e-6, "firwin2": 5e-6, "firls": 1e-12, "remez": 1e-10}[name]
    if kw.get("type") != "differentiator":  # test_multirate.py: ill-conditioned taps
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < bar


def test_kaiser_helpers_freqz_group_delay_match_jax():
    assert ft.kaiser_atten(211, 0.0375) == j_mr.kaiser_atten(211, 0.0375)
    for a in (10.0, 30.0, 65.0):
        assert ft.kaiser_beta(a) == j_mr.kaiser_beta(a) == pytest.approx(sps.kaiser_beta(a))
    for ripple, width in ((65, 0.05), (21.5, 0.1), (80, 0.01)):
        assert ft.kaiserord(ripple, width) == j_mr.kaiserord(ripple, width) \
            == sps.kaiserord(ripple, width)
    b = sps.firwin(31, 0.4)
    bb, aa = [1.0, -0.5], [1.0, 0.2, 0.1]
    for args, kw in (((b,), {}), ((bb, aa), {"worN": 256, "whole": True}),
                     ((bb, aa), {"worN": np.linspace(10, 400, 17), "fs": 1000.0})):
        for g, w, o in zip(ft.freqz(*args, **kw), ftt.freqz(*args, **kw),
                           sps.freqz(*args, **kw)):
            np.testing.assert_allclose(g, w, **HOST)
            np.testing.assert_allclose(g, o, **HOST)
    for system, w in (((b, [1.0]), 128), ((bb, aa), 64)):
        for g, want, o in zip(ft.group_delay(system, w), ftt.group_delay(system, w),
                              sps.group_delay(system, w)):
            np.testing.assert_allclose(g, want, **HOST)
            np.testing.assert_allclose(g, o, rtol=0, atol=1e-9)
    for name, args, kw in (("firwin", (30, 0.5), {"pass_zero": False}),
                           ("firwin", (31, 0.3), {"pass_zero": "bandstop"}),
                           ("firwin2", (40, [0.0, 0.5, 1.0], [1.0, 1.0, 0.5]), {}),
                           ("firls", (30, [0, 0.2, 0.3, 1.0], [1, 1, 0, 0]), {}),
                           ("remez", (31, [0, 0.6], [1]), {}),
                           ("kaiserord", (5, 0.1), {})):
        _same_error(lambda: getattr(j_mr, name)(*args, **kw),
                    lambda: getattr(ft, name)(*args, **kw))


# ---------------------------------------------------------------------- #
# upfirdn, resample_poly, decimate: the port's transforms
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("up,down,n,n_h", [(1, 1, 50, 7), (3, 5, 64, 21), (7, 2, 33, 16),
                                           (4, 3, 300, 129)])
def test_upfirdn_real_matches_jax_and_scipy(up, down, n, n_h, rng, assert_close):
    x = rrand(rng, 2, n)
    h = rng.standard_normal(n_h)
    got = ft.upfirdn(h, _t(x), up, down)
    assert got.dtype == torch.float32
    assert_close(_np(got), np.asarray(ftt.upfirdn(h, x, up, down)))
    assert_close(_np(got), sps.upfirdn(h, x.astype(np.float64), up, down), UPFIRDN_TOL)


@pytest.mark.parametrize("mode", ["constant", "edge", "wrap", "symmetric", "reflect",
                                  "antisymmetric", "antireflect", "smooth"])
def test_upfirdn_modes_match_jax_and_scipy(mode, rng, assert_close):
    h = rng.standard_normal(11)
    cval = 1.5 if mode == "constant" else 0.0
    for x in (rrand(rng, 40), rrand(rng, 20)):
        hh = h if x.size == 40 else rng.standard_normal(41)  # the signal shorter than h
        got = _np(ft.upfirdn(hh, _t(x), 2, 3, mode=mode, cval=cval))
        assert_close(got, np.asarray(ftt.upfirdn(hh, x, 2, 3, mode=mode, cval=cval)), what=mode)
        assert_close(got, sps.upfirdn(hh, x.astype(np.float64), 2, 3, mode=mode, cval=cval),
                     UPFIRDN_TOL, what=mode)


@pytest.mark.parametrize("kind", ["complex x", "complex h", "both", "complex x mode"])
def test_upfirdn_complex_and_axis_match_jax(kind, rng, assert_close):
    x = crand(rng, 3, 48) if kind != "complex h" else rrand(rng, 3, 48)
    h = rng.standard_normal(9) + (1j * rng.standard_normal(9) if kind != "complex x" and
                                  kind != "complex x mode" else 0)
    kw = {"mode": "reflect"} if kind == "complex x mode" else {}
    xt = np.ascontiguousarray(np.moveaxis(x, 0, 1))  # along axis 0
    got = ft.upfirdn(h, _t(xt), 2, 3, axis=0, **kw)
    assert got.dtype == torch.complex64
    assert_close(_np(got), np.asarray(ftt.upfirdn(h, xt, 2, 3, axis=0, **kw)))
    assert_close(_np(got), sps.upfirdn(h, xt.astype(np.complex128), 2, 3, axis=0, **kw),
                 UPFIRDN_TOL)


@pytest.mark.parametrize("padtype,cval", [("constant", None), ("constant", 2.0), ("mean", None),
                                          ("median", None), ("maximum", None),
                                          ("minimum", None), ("edge", None), ("wrap", None),
                                          ("symmetric", None), ("smooth", None)])
def test_resample_poly_padtypes_match_jax_and_scipy(padtype, cval, rng, assert_close):
    x = rrand(rng, 120) + 3.0
    got = _np(ft.resample_poly(_t(x), 3, 4, padtype=padtype, cval=cval))
    assert_close(got, np.asarray(ftt.resample_poly(x, 3, 4, padtype=padtype, cval=cval)))
    assert_close(got, sps.resample_poly(x.astype(np.float64), 3, 4, padtype=padtype,
                                        cval=cval), RESAMPLE_TOL)


def test_resample_poly_rates_windows_and_complex_match_jax(rng, assert_close):
    x = rrand(rng, 2, 200)
    for up, down in ((2, 1), (1, 2), (160, 147), (5, 5)):
        got = _np(ft.resample_poly(_t(x), up, down))
        assert_close(got, np.asarray(ftt.resample_poly(x, up, down)))
        assert_close(got, sps.resample_poly(x.astype(np.float64), up, down, axis=-1),
                     RESAMPLE_TOL)
    xa = rrand(rng, 70, 5)
    w = sps.firwin(41, 1.0 / 3.0)
    for window in (w, _t(w), list(w)):
        assert_close(_np(ft.resample_poly(_t(xa), 3, 1, axis=0, window=window)),
                     np.asarray(ftt.resample_poly(xa, 3, 1, axis=0, window=w)))
    z = crand(rng, 90) + (2 - 1j)
    for padtype in ("constant", "mean"):
        got = ft.resample_poly(_t(z), 2, 3, padtype=padtype)
        assert got.dtype == torch.complex64
        assert_close(_np(got), np.asarray(ftt.resample_poly(z, 2, 3, padtype=padtype)))
        assert_close(_np(got), sps.resample_poly(z.astype(np.complex128), 2, 3,
                                                 padtype=padtype), RESAMPLE_TOL)


@pytest.mark.parametrize("q,zero_phase", [(2, True), (5, True), (3, False)])
def test_decimate_matches_jax_and_scipy(q, zero_phase, rng, assert_close):
    x = rrand(rng, 2, 240)
    got = _np(ft.decimate(_t(x), q, zero_phase=zero_phase))
    assert_close(got, np.asarray(ftt.decimate(x, q, zero_phase=zero_phase)))
    assert_close(got, sps.decimate(x.astype(np.float64), q, ftype="fir",
                                   zero_phase=zero_phase), RESAMPLE_TOL)


def test_multirate_errors_match_jax():
    x = np.zeros(16, np.float32)
    for name, args, kw in (("upfirdn", ([1.0], x, 0, 1), {}),
                           ("upfirdn", (np.ones((2, 2)), x), {}),
                           ("upfirdn", ([], x), {}),
                           ("upfirdn", ([1.0, 2.0], x, 2, 1), {"mode": "bogus"}),
                           ("resample_poly", (x, 0, 1), {}),
                           ("resample_poly", (x, 2, 3), {"padtype": "bogus"}),
                           ("resample_poly", (x, 2, 3), {"window": np.ones((2, 2))}),
                           ("resample_poly", (x.astype(np.complex64), 2, 3),
                            {"padtype": "median"}),
                           ("decimate", (x, 2), {"ftype": "iir"}),
                           ("decimate", (x, 0), {})):
        port_args = tuple(_t(a) if a is x or (isinstance(a, np.ndarray) and a.size == 16)
                          else a for a in args)
        _same_error(lambda: getattr(j_mr, name)(*args, **kw),
                    lambda: getattr(ft, name)(*port_args, **kw))


def test_grad_upfirdn_matches_jax(rng, assert_close):
    # d/dx sum(w * upfirdn(h, x, 4, 3)): the R2C and C2R routes' adjoints
    x = rrand(rng, 3, 50)
    h = rng.standard_normal(13)
    w = rrand(rng, 3, multirate._output_len(13, 50, 4, 3))
    want = jax.grad(lambda v: jnp.sum(w * ftt.upfirdn(h, v, 4, 3)))(jnp.asarray(x))
    v = _t(x).requires_grad_()
    (_t(w) * ft.upfirdn(h, v, 4, 3)).sum().backward()
    assert_close(_np(v.grad), np.asarray(want))


def test_upfirdn_routes_and_taps_upload():
    # path 9's resample_poly of [2, 2^18] at 147/160: nfft 2^26, taps of
    # 3201 points (+ pads), half-length rows of 2^25 through the four-step
    cuda = torch.device("cuda")
    h = ft.firwin(2 * 1600 + 1, 1.0 / 160, window=("kaiser", 5.0))
    lfull = (2**18 - 1) * 147 + h.size + 160
    assert 1 << (lfull - 1).bit_length() == 1 << 26
    assert ft.get_plan(1 << 25)._resolve_executor(cuda) == "fourstep"
    # the taps' spectrum broadcasts as one row: on the card the product C2R
    # kernel takes it (savgol_filter's FIR pass through fftconvolve)
    fake = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    assert rfft._one_row(fake(5, 7, 513), fake(1, 1, 513))
    assert not rfft._one_row(fake(5, 7, 513), fake(5, 1, 513))
    assert not rfft._one_row(fake(513), fake(1, 513))
    # one upload per tap array and device
    multirate._taps_table.cache_clear()
    x = torch.zeros(2, 64)
    for _ in range(3):
        ft.upfirdn(h[:31], x, 2, 1)
    assert multirate._taps_table.cache_info().misses == 1
