"""Torch port, cepstra and time-frequency analysis on the CPU:
``ops/cepstrum.py`` (real and complex cepstra, minimum phase, ``unwrap``),
``ops/envelope.py``, ``ops/channelizer.py`` (the WOLA channelizer) and
``ops/wigner.py`` (the Wigner-Ville distribution).

The same numpy inputs, made from a seed, go through the JAX package on the
CPU and through the port on CPU tensors, values and gradients
(``jax.grad``), beside the scipy / numpy oracles of the JAX package's own
tests (``tests/test_cepstrum.py``, ``test_envelope.py``,
``test_channelizer.py``, ``test_wigner.py``).  Tolerance: 1e-5 relative
L2, or the JAX test's own bar against its oracle where it names one:
minimum_phase 5e-4 (homomorphic) and 5e-3 (hilbert) against scipy,
envelope ``rtol=2e-4, atol=2e-5`` against scipy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.ops import cepstrum

torch.set_num_threads(1)

ENVELOPE_RTOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_envelope.py


def _t(x):
    # a CPU tensor asks the port for the CPU
    return torch.from_numpy(np.array(x))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def rrand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ---------------------------------------------------------------------- #
# unwrap and the cepstra
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_unwrap_matches_numpy(dtype, rng):
    # jumps of exactly +pi and -pi (numpy keeps both as they are), of just
    # over pi either way, of 2 pi, and random phases along both axes
    pi = dtype(np.pi)
    steps = np.array([0.5, pi, -pi, 0.1, -pi, pi, 2 * pi, -2 * pi, 3.5, -3.5, 0.2],
                     dtype=dtype)
    p = np.concatenate([[0.0], np.cumsum(steps)]).astype(dtype)
    np.testing.assert_array_equal(_np(cepstrum.unwrap(_t(p))), np.unwrap(p))
    q = (rng.uniform(-np.pi, np.pi, (5, 40)) * 3).astype(dtype)
    for dim in (0, 1):
        np.testing.assert_allclose(_np(cepstrum.unwrap(_t(q), dim=dim)), np.unwrap(q, axis=dim),
                                   rtol=1e-6, atol=1e-5)


def _rceps_np(x):
    return np.fft.ifft(np.log(np.abs(np.fft.fft(x, axis=-1))), axis=-1).real


@pytest.mark.parametrize("n", [256, 255])
def test_real_cepstrum_matches_jax_and_numpy(n, rng, assert_close):
    x = rrand(rng, 5, n) + 3.0
    got = _np(ft.real_cepstrum(_t(x)))
    assert_close(got, np.asarray(ftt.real_cepstrum(x)))
    assert_close(got, _rceps_np(x.astype(np.float64)))
    y = rrand(rng, n, 4) + 2.0
    for m in (64, 300):  # a trim and a pad along axis 0
        got = _np(ft.real_cepstrum(_t(y), n=m, axis=0))
        assert_close(got, np.asarray(ftt.real_cepstrum(y, n=m, axis=0)), what=f"n={m}")


def test_real_cepstrum_echo_spike():
    """A signal with an echo at lag d shows the cepstral peak at d."""
    n, d, a = 512, 40, 0.5
    base = np.random.default_rng(11).standard_normal(n // 4).astype(np.float32)
    x = np.zeros(n, np.float32)
    x[: n // 4] = base
    x[d: d + n // 4] += a * base
    c = _np(ft.real_cepstrum(_t(x)))
    interior = c[8: n // 2]
    assert np.argmax(interior) + 8 == d
    assert abs(c[d] - a / 2) < 0.05


def test_complex_cepstrum_matches_jax_and_roundtrips(rng, assert_close):
    n = 128
    t = np.arange(n, dtype=np.float32)
    rows = np.stack([
        np.sin(2 * np.pi * t / n * 5) * np.exp(-t / 40.0)
        + 8.0 * np.exp(-((t - 3.0) ** 2) / 4.0),
        (0.9 ** t),
        np.roll(0.8 ** t, 7),  # a circular delay: nd != 0
    ]).astype(np.float32)
    c, nd = ft.complex_cepstrum(_t(rows))
    jc, jnd = ftt.complex_cepstrum(rows)
    assert_close(_np(c), np.asarray(jc))
    np.testing.assert_array_equal(_np(nd), np.asarray(jnd))
    assert _np(nd)[2] != 0
    back = ft.inverse_complex_cepstrum(c, nd)
    assert_close(_np(back), np.asarray(ftt.inverse_complex_cepstrum(jc, jnd)))
    assert_close(_np(back), rows, tol=2e-5)  # test_cepstrum.py's round-trip bar
    # along axis 0, ndelay as a numpy array
    c0, nd0 = ft.complex_cepstrum(_t(rows.T.copy()), axis=0)
    assert_close(_np(c0).T, _np(c))
    assert_close(_np(ft.inverse_complex_cepstrum(c0, _np(nd0), axis=0)).T, _np(back))


@pytest.mark.parametrize("method,half,bar", [("homomorphic", True, 5e-4),
                                             ("homomorphic", False, 5e-4),
                                             ("hilbert", True, 5e-3)])
def test_minimum_phase_matches_jax_and_scipy(method, half, bar, assert_close):
    h = ss.firwin(31 if method == "homomorphic" else 65, 0.2 if half else 0.3)
    got = _np(ft.minimum_phase(_t(h), method=method, half=half))
    want = np.asarray(ftt.minimum_phase(h, method=method, half=half))
    assert got.shape == want.shape
    assert_close(got, want, what=f"{method} half={half}")
    assert_close(got, ss.minimum_phase(h, method=method, half=half), tol=bar,
                 what="vs scipy (test_cepstrum.py's bar)")
    # a short n_fft: the Hilbert method's log of the stopband's floor is
    # sensitive to rounding, so it is held to its named bar there
    assert_close(_np(ft.minimum_phase(_t(h), method=method, n_fft=1024, half=half)),
                 np.asarray(ftt.minimum_phase(h, method=method, n_fft=1024, half=half)),
                 tol=1e-5 if method == "homomorphic" else bar)


def test_minimum_phase_is_minimum_phase_and_errors():
    hm = _np(ft.minimum_phase(_t(ss.firwin(21, 0.4)))).astype(np.float64)
    assert np.all(np.abs(np.roots(hm)) < 1.0 + 1e-6)
    for mod in (ft, ftt):
        t = (lambda a: a) if mod is ftt else _t
        for kw, what in (({"method": "hilbert", "half": False}, "half=False"),
                         ({"method": "bogus"}, "method must be")):
            with pytest.raises(ValueError, match=what):
                mod.minimum_phase(t(np.ones(64, np.float32)), **kw)
        for h, kw, what in ((np.ones((3, 3), np.float32), {}, "1-D filter"),
                            (np.ones(1, np.float32), {}, "at least 2 taps"),
                            (np.ones(64, np.float32), {"n_fft": 32}, "n_fft must be")):
            with pytest.raises(ValueError, match=what):
                mod.minimum_phase(t(h), **kw)


def test_cepstrum_gradients_match_jax_grad(rng, assert_close):
    x = rrand(rng, 3, 64) + 3.0
    w = rng.random((3, 64)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(w * ftt.real_cepstrum(v)))(jnp.asarray(x))
    v = _t(x).requires_grad_()
    (_t(w) * ft.real_cepstrum(v)).sum().backward()
    assert_close(_np(v.grad), np.asarray(want), what="real_cepstrum")


# ---------------------------------------------------------------------- #
# envelope
# ---------------------------------------------------------------------- #
def _sig(rng, n, cplx, batch=()):
    return crand(rng, *batch, n) if cplx else rrand(rng, *batch, n)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n", [64, 65])
def test_envelope_matches_jax_and_scipy(cplx, n, rng, assert_close):
    # every band and residual against scipy; against the JAX package each
    # band with one residual mode, the three modes in turn (its envelope
    # compiles anew at each call)
    x = _sig(rng, n, cplx)
    x64 = x.astype(np.complex128 if cplx else np.float64)
    modes = ("lowpass", "all", None)
    for i, bp in enumerate([(1, None), (3, 15), (None, None), (-10, -2), (-8, 9), (2, 20)]):
        for residual in modes:
            got = _np(ft.envelope(_t(x), bp, residual=residual))
            what = f"bp {bp} residual {residual}"
            np.testing.assert_allclose(got, ss.envelope(x64, bp, residual=residual),
                                       **ENVELOPE_RTOL, err_msg=what)
            if residual == modes[i % 3]:
                assert_close(got, np.asarray(ftt.envelope(x, bp, residual=residual)),
                             what=what)


@pytest.mark.parametrize("cplx", [False, True])
def test_envelope_resampled_matches_jax_and_scipy(cplx, rng, assert_close):
    for i, (n, n_out) in enumerate([(64, 32), (64, 96), (64, 33), (65, 32), (65, 128),
                                    (63, 48)]):
        x = _sig(rng, n, cplx)
        x64 = x.astype(np.complex128 if cplx else np.float64)
        for residual in ("lowpass", "all"):
            got = _np(ft.envelope(_t(x), (2, 14), n_out=n_out, residual=residual))
            what = f"n {n} n_out {n_out} {residual}"
            np.testing.assert_allclose(got, ss.envelope(x64, (2, 14), n_out=n_out,
                                                        residual=residual),
                                       **ENVELOPE_RTOL, err_msg=what)
            if residual == ("lowpass", "all")[i % 2]:
                assert_close(got, np.asarray(ftt.envelope(x, (2, 14), n_out=n_out,
                                                          residual=residual)), what=what)


def test_envelope_squared_axis_and_errors(rng, assert_close):
    x = _sig(rng, 64, False, (3, 2))
    got = _np(ft.envelope(_t(x), (1, 20), squared=True))
    assert_close(got, np.asarray(ftt.envelope(x, (1, 20), squared=True)))
    xt = np.swapaxes(x, 0, 2).copy()
    got = _np(ft.envelope(_t(xt), (1, 20), axis=0))
    assert_close(got, np.asarray(ftt.envelope(xt, (1, 20), axis=0)))
    np.testing.assert_allclose(got, ss.envelope(xt.astype(np.float64), (1, 20), axis=0),
                               **ENVELOPE_RTOL)
    n = 512
    t = np.arange(n) / n
    a = 1.0 + 0.5 * np.cos(2 * np.pi * 4 * t)
    env, _ = ft.envelope(_t((a * np.cos(2 * np.pi * 64 * t)).astype(np.float32)), (32, 96))
    np.testing.assert_allclose(_np(env), a, atol=1e-3)
    x = _sig(rng, 32, False)
    for kw in ({"bp_in": (5, 3)}, {"residual": "bogus"}, {"n_out": -4}, {"bp_in": (1, 2, 3)},
               {"axis": 2}):
        for mod in (ft, ftt):
            with pytest.raises(ValueError):
                mod.envelope(x if mod is ftt else _t(x), **kw)


# ---------------------------------------------------------------------- #
# channelizer
# ---------------------------------------------------------------------- #
def _wola_ref(x, h, n_ch):
    """Direct numpy WOLA reference: frame, window, fold, DFT."""
    t = len(h)
    frames = len(x) // n_ch - t // n_ch + 1
    out = np.zeros((frames, n_ch), np.complex128)
    for m in range(frames):
        seg = x[m * n_ch: m * n_ch + t] * h
        out[m] = np.fft.fft(seg.reshape(t // n_ch, n_ch).sum(0))
    return out


@pytest.mark.parametrize("cplx", [False, True])
def test_channelize_matches_jax_and_direct_wola(cplx, rng, assert_close):
    for n_ch, taps, window in ((8, 4, "hamming"), (16, 8, "hann"), (8, 2, "boxcar")):
        # a signal length that is not a multiple of n_ch
        x = _sig(rng, 64 * n_ch + 5, cplx, (2,))
        h = _np(ft.prototype_lowpass(n_ch, taps, window, device="cpu"))
        assert_close(h, np.asarray(ftt.prototype_lowpass(n_ch, taps, window)))
        got = _np(ft.channelize(_t(x), n_ch, taps=taps, window=window))
        assert got.dtype == np.complex64 and got.shape == (2, 64 - taps + 1, n_ch)
        assert_close(got, np.asarray(ftt.channelize(x, n_ch, taps=taps, window=window)))
        assert_close(got, np.stack([_wola_ref(r.astype(np.complex128), h.astype(np.float64),
                                              n_ch) for r in x]))


def test_channelize_tone_prototype_and_errors():
    n_ch, taps = 16, 8
    k = 5
    x = np.exp(2j * np.pi * (k / n_ch) * np.arange(256 * n_ch)).astype(np.complex64)
    mag = np.abs(_np(ft.channelize(_t(x), n_ch, taps=taps))[taps:-taps]).mean(0)
    assert mag[k] > 0.99
    assert np.delete(mag, k).max() < 1e-3
    z = np.zeros(64, np.float32)
    y = ft.channelize(_t(z), 8, proto=np.ones(32, np.float32) / 32)
    assert y.shape == (64 // 8 - 4 + 1, 8)
    for mod in (ft, ftt):
        t = (lambda a: a) if mod is ftt else _t
        with pytest.raises(ValueError, match="multiple of n_ch"):
            mod.channelize(t(z), 8, proto=np.ones(30))
        with pytest.raises(ValueError, match="too short"):
            mod.channelize(t(np.zeros(16, np.float32)), 8, taps=8)
        with pytest.raises(ValueError, match="unknown window"):
            mod.prototype_lowpass(8, window="nope")


# ---------------------------------------------------------------------- #
# wigner
# ---------------------------------------------------------------------- #
def _direct_wvd(x, window=None):
    """Symmetric-sum definition, f64; window is the centered PWVD lag
    taper (center sample = lag 0)."""
    x = np.asarray(x, complex)
    n = len(x)
    W = np.zeros((n, n))
    mid = len(window) // 2 if window is not None else 0
    k = np.arange(n)
    for t in range(n):
        L = min(t, n - 1 - t)
        tau = np.arange(-L, L + 1)
        r = x[t + tau] * np.conj(x[t - tau])
        if window is not None:
            idx = mid + np.abs(tau)
            r = r * np.where(idx < len(window), window[np.minimum(idx, len(window) - 1)], 0.0)
        W[t] = (r[None, :] * np.exp(-2j * np.pi * k[:, None] * tau[None, :] / n)).sum(1).real
    return W


@pytest.mark.parametrize("window", [None, "hann21", "hann5"])
def test_wigner_ville_matches_jax_and_the_direct_sum(window, rng, assert_close):
    w = None if window is None else np.hanning(int(window[4:]))
    for x in (crand(rng, 48), rrand(rng, 2, 32)):
        f, W = ft.wigner_ville(_t(x), fs=2.0, window=w)
        jf, jW = ftt.wigner_ville(x, fs=2.0, window=w)
        assert W.dtype == torch.float32 and tuple(W.shape) == x.shape + (x.shape[-1],)
        assert_close(_np(W), np.asarray(jW))
        np.testing.assert_allclose(_np(f), jf, rtol=1e-7)
        assert_close(_np(W).reshape(-1, x.shape[-1], x.shape[-1])[0],
                     _direct_wvd(x.reshape(-1, x.shape[-1])[0], w))
    np.testing.assert_allclose(_np(ft.wigner_ville_frequencies(48, device="cpu")),
                               np.arange(48) / 96.0)


def test_wigner_ville_marginal_and_errors():
    t = np.arange(64)
    x = np.exp(1j * 2 * np.pi * (0.05 * t + 0.15 / 64 * t * t / 2)).astype(np.complex64)
    _, W = ft.wigner_ville(_t(x))
    np.testing.assert_allclose(_np(W).sum(axis=1), 64 * np.abs(x) ** 2, rtol=1e-4)
    for mod in (ft, ftt):
        for window in (np.ones((4, 4)), np.ones(100)):
            with pytest.raises(ValueError, match="window must be 1-D"):
                mod.wigner_ville(x[:32] if mod is ftt else _t(x[:32]), window=window)
