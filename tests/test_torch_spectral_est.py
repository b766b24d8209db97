"""Torch port, the spectral estimators on the CPU: ``ops/windows.py``, the
window functions of ``ops/stft.py`` and ``ops/spectral_est.py`` (windows,
``get_window``, ``dpss``, ``periodogram``, ``welch``, ``csd``,
``coherence``, ``spectrogram``, ``multitaper``, ``lombscargle``, the COLA
and NOLA checks).

The same numpy inputs go through the JAX package on the CPU and through
the port on CPU tensors, values and gradients (``jax.grad``), plus the
scipy oracles of the JAX package's own tests (``tests/test_spectral_est.py``,
``tests/test_windows.py``).  A CPU tensor takes the composed route, as the
JAX package does off the TPU; the kernel routes of a CUDA tensor are run
here by pretending the tensors lie on the card (``_on_card``), so that
the entry points of ``ops/cuda_welch.py`` run their plain versions, and
the route each call takes is recorded.  Tolerance: 1e-5 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu.ops import spectral_est as j_se
from fft_wgpu_tpu.ops import stft as j_stft
from fft_wgpu_tpu.ops import windows as j_windows
from fft_wgpu_tpu_torch.ops import cuda_fft, cuda_welch, spectral_est, stft, windows

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _t(x):
    # a CPU tensor asks the port for the CPU
    return torch.from_numpy(np.array(x))


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return v.numpy() if not v.is_complex() else v.numpy().astype(np.complex128)
    return np.asarray(v)


def rrand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture
def routes(monkeypatch):
    """Pretend CPU tensors lie on the card, and record which of the ten
    entry points each call reaches."""
    seen = []
    monkeypatch.setattr(spectral_est, "_on_card", lambda t: True)
    for name in ("welch_accum_split", "spec_psd_split", "csd_accum_split",
                 "coherence_accum_split", "welch_accum_c2c_split", "welch_accum_c2c_c64",
                 "spec_rfft_split",
                 "spec_rfft_c64", "spec_c2c_split", "spec_c2c_c64"):
        fn = getattr(cuda_welch, name)

        def spy(*a, _fn=fn, _name=name, **k):
            seen.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(cuda_welch, name, spy)
    return seen


# ---------------------------------------------------------------------- #
# windows
# ---------------------------------------------------------------------- #
def test_exports_match_jax():
    names = (set(j_windows.__all__) | set(j_se.__all__)
             | {"hann_window", "hamming_window", "blackman_window", "bartlett_window"})
    assert names <= set(ft.__all__)
    assert {"stft", "istft", "ShortTimeFFT"} <= set(ft.__all__)
    assert ft.ShortTimeFFT.__name__ == ftt.ShortTimeFFT.__name__


WINDOWS = [(name, ()) for name in j_windows.__all__
           if name not in ("gaussian_window", "general_gaussian_window",
                           "general_cosine_window", "general_hamming_window")]
WINDOWS += [("gaussian_window", (7.0,)), ("general_gaussian_window", (1.5, 5.0)),
            ("general_cosine_window", ([0.5, 0.3, 0.2],)),
            ("general_hamming_window", (0.6,)), ("chebwin_window", (60.0,)),
            ("taylor_window", (5, 40.0)), ("exponential_window", (None, 3.0)),
            ("hann_window", ()), ("hamming_window", ()), ("blackman_window", ()),
            ("bartlett_window", ()), ("tukey_window", (0.3,)), ("tukey_window", (1.0,)),
            ("tukey_window", (0.0,)), ("kaiser_window", (5.0,)), ("flattop_window", ())]


@pytest.mark.parametrize("name,args", WINDOWS, ids=lambda v: str(v))
def test_window_equals_jax(name, args):
    mod = {"hann_window": (stft, j_stft), "hamming_window": (stft, j_stft),
           "blackman_window": (stft, j_stft), "bartlett_window": (stft, j_stft),
           "tukey_window": (spectral_est, j_se), "kaiser_window": (spectral_est, j_se),
           "flattop_window": (spectral_est, j_se)}.get(name, (windows, j_windows))
    mine, ref = getattr(mod[0], name), getattr(mod[1], name)
    for n in (1, 2, 7, 64, 65):
        for periodic in (False, True):
            if name == "kaiser_bessel_derived_window" and (periodic or n % 2):
                with pytest.raises(ValueError):
                    ref(n, *args, periodic=periodic)
                with pytest.raises(ValueError):
                    mine(n, *args, periodic=periodic, device=CPU)
                continue
            w = mine(n, *args, periodic=periodic, device=CPU)
            assert w.dtype == torch.float32 and w.device == CPU
            np.testing.assert_array_equal(w.numpy(), np.asarray(ref(n, *args, periodic=periodic)),
                                          err_msg=f"{name}{args} n={n} periodic={periodic}")


def test_windows_follow_the_card(monkeypatch):
    # no device given: the current CUDA device, which raises where there is none
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ft.hann_window(8), lambda: ft.taylor_window(8),
                 lambda: ft.get_window("hann", 8), lambda: ft.dpss(16, 2.0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("window,n,kw", [
    ("hann", 64, {}), ("hamming", 33, {"fftbins": False}), ("boxcar", 16, {}),
    ("triangle", 17, {}), ("sinc", 20, {}), ("poisson", 31, {}), ("halfcosine", 12, {}),
    ("tukey", 40, {}), (("tukey", 0.25), 33, {}), (("kaiser", 5.0), 128, {}),
    (("gaussian", 3.0), 32, {"fftbins": False}), (("general_gaussian", 1.5, 7.0), 51, {}),
    (("dpss", 2.5), 64, {}), (("chebwin", 80.0), 45, {}), (("kaiser_bessel_derived", 4.0), 32,
                                                            {"fftbins": False})],
    ids=str)
def test_get_window_equals_jax_and_scipy(window, n, kw):
    got = ft.get_window(window, n, device=CPU, **kw).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_se.get_window(window, n, **kw)))
    if window[0] != "dpss":  # the JAX package's dpss window is the symmetric one
        np.testing.assert_allclose(got, ss.get_window(window, n, **kw), rtol=2e-6, atol=2e-7)


def test_get_window_arrays_and_errors(rng):
    w = rrand(rng, 16)
    np.testing.assert_array_equal(ft.get_window(_t(w), 16).numpy(), w)
    np.testing.assert_array_equal(ft.get_window(w, 16, device=CPU).numpy(), w)
    for bad, n, match in (("nope", 8, "unknown"), ("kaiser", 8, "requires parameters"),
                          (("nope", 1.0), 8, "unknown"), (w, 15, "length"),
                          (w.reshape(4, 4), 16, "1-D")):
        with pytest.raises(ValueError, match=match):
            ft.get_window(bad, n, device=CPU)


@pytest.mark.parametrize("M,NW,K,kw", [(64, 2.5, 3, {}), (129, 4.0, 7, {}),
                                       (200, 4.0, 6, {"norm": "approximate"}),
                                       (64, 2.5, 3, {"norm": "subsample"}),
                                       (64, 2.5, 3, {"sym": False}), (100, 2.5, None, {}),
                                       (100, 2.5, None, {"norm": "subsample"})])
def test_dpss_equals_jax_and_scipy(M, NW, K, kw):
    w, lam = ft.dpss(M, NW, K, return_ratios=True, device=CPU, **kw)
    jw, jlam = j_se.dpss(M, NW, K, return_ratios=True, **kw)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(lam, jlam)
    sw, slam = ss.windows.dpss(M, NW, K, return_ratios=True, **kw)
    np.testing.assert_allclose(w.numpy(), sw, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(lam, slam, rtol=1e-6)
    with pytest.raises(ValueError):
        ft.dpss(M, M / 2.0, K, device=CPU)


@pytest.mark.parametrize("window,nperseg,noverlap", [
    ("hann", 256, 128), ("hann", 256, 100), ("boxcar", 64, 0), ("hamming", 100, 50),
    (("tukey", 0.5), 128, 64), ("bartlett", 128, 96), ("blackman", 512, 384)])
def test_cola_nola_equal_jax_and_scipy(window, nperseg, noverlap):
    for mine, ref, oracle in ((ft.check_COLA, ftt.check_COLA, ss.check_COLA),
                              (ft.check_NOLA, ftt.check_NOLA, ss.check_NOLA)):
        assert mine(window, nperseg, noverlap) == ref(window, nperseg, noverlap)
        assert mine(window, nperseg, noverlap) == oracle(window, nperseg, noverlap)
    with pytest.raises(ValueError):
        ft.check_COLA("hann", 64, 64)


def test_helpers_equal_jax(rng):
    for n in (1, 2, 3, 8, 101):
        assert spectral_est._median_bias(n) == j_se._median_bias(n)
    for detrend in (False, None, "constant", "linear"):
        fr = rrand(rng, 3, 5, 64)
        got = spectral_est._detrend_seg(_t(fr), detrend)
        np.testing.assert_allclose(got.numpy(), np.asarray(j_se._detrend_seg(fr, detrend)),
                                   rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="detrend"):
        spectral_est._detrend_seg(_t(fr), 0)
    for shape in ((5, 7), (4, 8), (1, 3)):
        v = rrand(rng, *shape)
        np.testing.assert_array_equal(spectral_est._median(_t(v), 0).numpy(),
                                      np.median(v, axis=0))


def test_complex_rule_reads_lists_as_data(rng):
    x = rrand(rng, 2, 512)
    assert not spectral_est._is_complex(x.tolist())  # two rows, not a pair
    assert spectral_est._is_complex((x[0], x[1]))
    assert spectral_est._is_complex(_t(x[0] + 1j * x[1]))
    assert not spectral_est._is_complex(_t(x))
    f, P = ft.welch(_t(x), nperseg=128)
    assert P.shape == (2, 65)
    f, Pp = ft.welch((_t(x[0]), _t(x[1])), nperseg=128)  # a pair: one complex signal
    _, want = ss.welch(x[0] + 1j * x[1], nperseg=128)
    np.testing.assert_allclose(Pp.numpy(), want, rtol=1e-4, atol=1e-9)


def test_numpy_input_needs_a_card(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = rrand(rng, 1024)
    for call in (lambda: ft.welch(x), lambda: ft.spectrogram(x), lambda: ft.csd(x, x),
                 lambda: ft.lombscargle(x, x, x[:8])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("card", [False, True], ids=["composed", "kernel routes"])
def test_estimators_promote_each_input_once(card, rng, monkeypatch):
    """Each input is promoted once per estimator call (numpy input is then
    copied to the card once), coherence's three estimates included; a real
    input gets no imaginary plane."""
    calls = []
    promote = spectral_est._promote

    def spy(*a, **k):
        calls.append(1)
        out = promote(*a, **k)
        assert out[1] is None
        return out

    monkeypatch.setattr(spectral_est, "_promote", spy)
    monkeypatch.setattr(spectral_est, "_on_card", lambda t: card)
    x, y = _t(rrand(rng, 2048)), _t(rrand(rng, 2048))
    for what, call, want in (("welch", lambda: ft.welch(x), 1),
                             ("periodogram", lambda: ft.periodogram(x), 1),
                             ("spectrogram", lambda: ft.spectrogram(x), 1),
                             ("multitaper", lambda: ft.multitaper(x[:512]), 1),
                             ("csd", lambda: ft.csd(x, y), 2),
                             ("coherence", lambda: ft.coherence(x, y), 2),
                             ("coherence of unequal shapes",
                              lambda: ft.coherence(x, torch.stack([y, y])), 2)):
        calls.clear()
        call()
        assert len(calls) == want, what


# ---------------------------------------------------------------------- #
# the estimators against the JAX package and scipy
# ---------------------------------------------------------------------- #
def _x(rng, kind, *shape):
    return crand(rng, *shape) if kind == "c" else rrand(rng, *shape)


# name -> (input kinds and shapes, call(module, *inputs), the scipy oracle or None)
CASES = {
    "welch": ([("r", (4096,))], lambda m, x: m.welch(x, fs=1e3),
              lambda x: ss.welch(x, fs=1e3)),
    "welch_300_100": ([("r", (3000,))], lambda m, x: m.welch(x, fs=2.0, nperseg=300,
                                                              noverlap=100),
                      lambda x: ss.welch(x, fs=2.0, nperseg=300, noverlap=100)),
    "welch_odd_nfft": ([("r", (2000,))], lambda m, x: m.welch(x, nperseg=255),
                       lambda x: ss.welch(x, nperseg=255)),
    "welch_nfft_1000": ([("r", (3000,))], lambda m, x: m.welch(x, nperseg=500, nfft=1000),
                        lambda x: ss.welch(x, nperseg=500, nfft=1000)),
    "welch_median_batched": ([("r", (3, 2048))],
                             lambda m, x: m.welch(x, nperseg=256, average="median"),
                             lambda x: ss.welch(x, nperseg=256, average="median")),
    "welch_axis0": ([("r", (2048, 3))], lambda m, x: m.welch(x, nperseg=128, axis=0),
                    lambda x: ss.welch(x, nperseg=128, axis=0)),
    "welch_linear": ([("r", (2048,))], lambda m, x: m.welch(x, nperseg=256, detrend="linear"),
                     lambda x: ss.welch(x, nperseg=256, detrend="linear")),
    "welch_complex": ([("c", (2048,))], lambda m, x: m.welch(x, nperseg=256),
                      lambda x: ss.welch(x, nperseg=256)),
    "welch_two_sided": ([("r", (2048,))],
                        lambda m, x: m.welch(x, nperseg=256, return_onesided=False),
                        lambda x: ss.welch(x, nperseg=256, return_onesided=False)),
    "welch_spectrum": ([("r", (2, 2048))],
                       lambda m, x: m.welch(x, nperseg=256, scaling="spectrum",
                                            detrend=False),
                       lambda x: ss.welch(x, nperseg=256, scaling="spectrum", detrend=False)),
    "periodogram": ([("r", (4, 1000))],
                    lambda m, x: m.periodogram(x, fs=10.0, window="hann", nfft=1024),
                    lambda x: ss.periodogram(x, fs=10.0, window="hann", nfft=1024)),
    "periodogram_linear": ([("r", (1000,))], lambda m, x: m.periodogram(x, detrend="linear"),
                           lambda x: ss.periodogram(x, detrend="linear")),
    "csd": ([("r", (2048,)), ("r", (2048,))], lambda m, x, y: m.csd(x, y, fs=1e3, nperseg=256),
            lambda x, y: ss.csd(x, y, fs=1e3, nperseg=256)),
    "csd_complex_median": ([("c", (2048,)), ("r", (2048,))],
                           lambda m, x, y: m.csd(x, y, nperseg=128, average="median"),
                           lambda x, y: ss.csd(x, y, nperseg=128, average="median")),
    "coherence": ([("r", (2, 2048)), ("r", (2, 2048))],
                  lambda m, x, y: m.coherence(x, y, nperseg=256),
                  lambda x, y: ss.coherence(x, y, nperseg=256)),
    "coherence_complex": ([("c", (2048,)), ("c", (2048,))],
                          lambda m, x, y: m.coherence(x, y, nperseg=128),
                          lambda x, y: ss.coherence(x, y, nperseg=128)),
    "spectrogram_psd": ([("r", (4096,))], lambda m, x: m.spectrogram(x, fs=1e3),
                        lambda x: ss.spectrogram(x, fs=1e3)),
    "spectrogram_magnitude": ([("r", (2, 2048))],
                              lambda m, x: m.spectrogram(x, nperseg=128, noverlap=64,
                                                         mode="magnitude"),
                              lambda x: ss.spectrogram(x, nperseg=128, noverlap=64,
                                                       mode="magnitude")),
    "spectrogram_complex": ([("r", (2048,))],
                            lambda m, x: m.spectrogram(x, nperseg=256, mode="complex"),
                            lambda x: ss.spectrogram(x, nperseg=256, mode="complex")),
    "spectrogram_angle": ([("r", (2048,))],
                          lambda m, x: m.spectrogram(x, nperseg=256, mode="angle"), None),
    "spectrogram_phase": ([("r", (2048,))],
                          lambda m, x: m.spectrogram(x, nperseg=256, mode="phase"), None),
    "spectrogram_complex_input": ([("c", (2048,))],
                                  lambda m, x: m.spectrogram(x, nperseg=256, window="hann"),
                                  lambda x: ss.spectrogram(x, nperseg=256, window="hann")),
    "spectrogram_complex_input_complex": ([("c", (2, 2048))],
                                          lambda m, x: m.spectrogram(x, nperseg=256,
                                                                     mode="complex"),
                                          lambda x: ss.spectrogram(x, nperseg=256,
                                                                   mode="complex")),
    "spectrogram_two_sided_magnitude": ([("r", (2048,))],
                                        lambda m, x: m.spectrogram(x, nperseg=128,
                                                                   return_onesided=False,
                                                                   mode="magnitude"),
                                        lambda x: ss.spectrogram(x, nperseg=128,
                                                                 return_onesided=False,
                                                                 mode="magnitude")),
    "spectrogram_complex_linear": ([("r", (2048,))],
                                   lambda m, x: m.spectrogram(x, nperseg=256, mode="complex",
                                                              detrend="linear"),
                                   lambda x: ss.spectrogram(x, nperseg=256, mode="complex",
                                                            detrend="linear")),
    "csd_two_sided": ([("r", (2, 2048)), ("r", (2, 2048))],
                      lambda m, x, y: m.csd(x, y, nperseg=256, return_onesided=False),
                      lambda x, y: ss.csd(x, y, nperseg=256, return_onesided=False)),
    "welch_complex_median": ([("c", (2048,))],
                             lambda m, x: m.welch(x, nperseg=256, average="median"),
                             lambda x: ss.welch(x, nperseg=256, average="median")),
    "spectrogram_complex_input_magnitude": ([("c", (2, 2048))],
                                            lambda m, x: m.spectrogram(x, nperseg=256,
                                                                       mode="magnitude"),
                                            lambda x: ss.spectrogram(x, nperseg=256,
                                                                     mode="magnitude")),
    "spectrogram_complex_input_angle": ([("c", (2048,))],
                                        lambda m, x: m.spectrogram(x, nperseg=256,
                                                                   mode="angle"), None),
    "spectrogram_complex_input_phase": ([("c", (2048,))],
                                        lambda m, x: m.spectrogram(x, nperseg=256,
                                                                   mode="phase"), None),
    # (the JAX package's axis order here is not scipy's: held to the JAX package)
    "spectrogram_complex_input_axis0": ([("c", (2048, 2))],
                                        lambda m, x: m.spectrogram(x, nperseg=128, axis=0,
                                                                   mode="complex"), None),
    "spectrogram_two_sided_complex": ([("r", (2, 2048))],
                                      lambda m, x: m.spectrogram(x, nperseg=256,
                                                                 return_onesided=False,
                                                                 mode="complex"),
                                      lambda x: ss.spectrogram(x, nperseg=256,
                                                               return_onesided=False,
                                                               mode="complex")),
    "csd_complex_complex_median": ([("c", (2, 2048)), ("c", (2, 2048))],
                                   lambda m, x, y: m.csd(x, y, nperseg=256, noverlap=64,
                                                         average="median"),
                                   lambda x, y: ss.csd(x, y, nperseg=256, noverlap=64,
                                                       average="median")),
    "multitaper_adaptive": ([("r", (2, 1024))], lambda m, x: m.multitaper(x, NW=3.0), None),
    "multitaper_unity_odd": ([("r", (999,))],
                             lambda m, x: m.multitaper(x, NW=2.5, weights="unity"), None),
    "multitaper_eigen_complex": ([("c", (512,))],
                                 lambda m, x: m.multitaper(x, NW=2.0, K=3, weights="eigen",
                                                           nfft=600), None),
}


def _run_port(call, xs):
    return call(ft, *[_t(x) for x in xs])


@pytest.mark.parametrize("name", list(CASES))
def test_estimator_matches_jax_and_scipy(name, rng, assert_close):
    specs, call, oracle = CASES[name]
    xs = [_x(rng, kind, *shape) for kind, shape in specs]
    got, want = _run_port(call, xs), call(ftt, *xs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w)) and g.device == CPU, name
        assert_close(_np(g), np.asarray(w), what=name)
    if oracle is not None:
        ref = oracle(*[x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)
                       for x in xs])
        for g, w in zip(got, ref):
            assert_close(_np(g), w, what=f"{name} vs scipy")
    assert (cuda_fft.launches, cuda_fft.r2c_launches, cuda_welch.welch_launches,
            cuda_welch.psd_launches, cuda_welch.spec_launches,
            cuda_welch.spec_c2c_launches) == (0, 0, 0, 0, 0, 0)


# the call, the entry point the route must reach (None: the composed route;
# a list: the entry points in order)
ROUTES = {
    "welch": "welch_accum_split", "welch_300_100": None, "welch_odd_nfft": None,
    "welch_nfft_1000": None, "welch_median_batched": "spec_psd_split",
    "welch_axis0": "welch_accum_split", "welch_linear": None,
    "welch_complex": "welch_accum_c2c_c64", "welch_two_sided": "welch_accum_c2c_c64",
    "welch_spectrum": "welch_accum_split", "welch_complex_median": "spec_c2c_c64",
    "periodogram": "welch_accum_split", "periodogram_linear": None, "csd": "csd_accum_split",
    "csd_complex_median": ["spec_c2c_c64"] * 2,  # x, then y with no imaginary plane
    "csd_complex_complex_median": ["spec_c2c_c64"] * 2,
    "csd_two_sided": ["spec_c2c_c64"] * 2,
    "coherence": "coherence_accum_split",
    # Pxy from the two-sided spectra of x and y, then Pxx and Pyy
    "coherence_complex": ["spec_c2c_c64"] * 2 + ["welch_accum_c2c_c64"] * 2,
    "spectrogram_psd": "spec_psd_split", "spectrogram_magnitude": "spec_psd_split",
    "spectrogram_complex": "spec_rfft_c64", "spectrogram_angle": "spec_rfft_split",
    "spectrogram_phase": "spec_rfft_split", "spectrogram_complex_input": "spec_c2c_c64",
    "spectrogram_complex_input_complex": "spec_c2c_c64",
    "spectrogram_complex_input_magnitude": "spec_c2c_c64",
    "spectrogram_complex_input_angle": "spec_c2c_c64",
    "spectrogram_complex_input_phase": "spec_c2c_c64",
    "spectrogram_complex_input_axis0": "spec_c2c_c64",
    "spectrogram_two_sided_complex": "spec_c2c_c64",
    "spectrogram_two_sided_magnitude": "spec_c2c_c64", "spectrogram_complex_linear": None,
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_card_routes_match_jax(name, routes, rng, assert_close):
    """On the card each call takes the route of the table in
    ``spectral_est``'s docstring; the values are the JAX package's either way."""
    specs, call, _ = CASES[name]
    xs = [_x(rng, kind, *shape) for kind, shape in specs]
    got, want = _run_port(call, xs), call(ftt, *xs)
    want_routes = ROUTES[name]
    if not isinstance(want_routes, list):
        want_routes = [want_routes] if want_routes else []
    assert routes == want_routes, name
    for g, w in zip(got, want):
        assert_close(_np(g), np.asarray(w), what=name)


def test_kernel_route_windows_and_envelope(routes, rng, assert_close):
    x, y = rrand(rng, 3000), rrand(rng, 3000)
    # scipy's spectrogram default overlap, a hop that does not divide nperseg
    got = ft.spectrogram(_t(x), nperseg=512, window="hann")[2]
    assert_close(got.numpy(), np.asarray(ftt.spectrogram(x, nperseg=512, window="hann")[2]))
    assert routes == ["spec_psd_split"]
    # nfft 8192 on a signal of 3000: nperseg clipped to 3000, one segment, in the envelope
    with pytest.warns(UserWarning, match="nperseg"):
        got = ft.welch(_t(x), nperseg=4096, nfft=8192)[1]
    with pytest.warns(UserWarning, match="nperseg"):
        want = ftt.welch(x, nperseg=4096, nfft=8192)[1]
    assert_close(got.numpy(), np.asarray(want))
    # unequal shapes: no B17, the per-segment spectra of each signal (B20);
    # detrend=0 raises before any launch, as JAX does
    routes.clear()
    got = ft.csd(_t(x), _t(np.stack([y, y])), nperseg=256)[1]
    assert_close(_np(got), np.asarray(ftt.csd(x, np.stack([y, y]), nperseg=256)[1]))
    assert routes == ["spec_rfft_split"] * 2
    routes.clear()
    with pytest.raises(ValueError, match="detrend"):
        ft.welch(_t(x), nperseg=256, detrend=0)
    assert routes == []


def test_two_sided_routes_take_the_complex64_source_and_sink(rng, monkeypatch,
                                                             assert_close):
    """On the card B22 reads a complex64 input as it lies (no split: its
    planes are views, promote_to_split is never called) and a real one with
    no imaginary plane; spectrogram's complex mode is the sink's transposed
    view with sqrt(norm) folded into its store, no merge; csd takes its
    products as complex tensors."""
    def refuse(name):
        def fail(*a, **k):
            raise AssertionError(f"the card route ran {name}")
        return fail

    calls = []
    c64, promote = cuda_welch.spec_c2c_c64, spectral_est.promote_to_split
    monkeypatch.setattr(spectral_est, "_on_card", lambda t: True)
    monkeypatch.setattr(spectral_est, "promote_to_split", refuse("promote_to_split"))
    monkeypatch.setattr(cuda_welch, "spec_c2c_c64", lambda x, *a, **k: calls.append(
        (x.dtype, k.get("im") is None, k.get("scale"))) or c64(x, *a, **k))
    monkeypatch.setattr(cuda_welch, "spec_c2c_split", refuse("spec_c2c_split"))
    x, y = crand(rng, 2, 2048), crand(rng, 2, 2048)
    norm = 1.0 / float((ss.get_window(("tukey", 0.25), 256) ** 2).sum())
    with monkeypatch.context() as m:
        m.setattr(spectral_est, "merge", refuse("merge"))
        for mode in ("psd", "magnitude", "complex", "angle", "phase"):
            calls.clear()
            got = ft.spectrogram(_t(x), nperseg=256, mode=mode)[2]
            want = ftt.spectrogram(x, nperseg=256, mode=mode)[2]
            assert_close(_np(got), np.asarray(want), what=mode)
            scale = None if mode in ("angle", "phase") else pytest.approx(np.sqrt(norm))
            assert calls == [(torch.complex64, True, scale)], mode
            if mode == "complex":
                assert got.dtype == torch.complex64 and not got.is_contiguous()
    calls.clear()
    got = ft.csd(_t(x), _t(y), nperseg=256, average="median")[1]
    assert_close(_np(got), np.asarray(ftt.csd(x, y, nperseg=256, average="median")[1]))
    assert calls == [(torch.complex64, True, None)] * 2
    calls.clear()
    monkeypatch.setattr(spectral_est, "promote_to_split", promote)
    r = rrand(rng, 2, 2048)  # real input taken two-sided: no imaginary plane (im None)
    got = ft.spectrogram(_t(r), nperseg=256, return_onesided=False)[2]
    assert_close(_np(got), np.asarray(ftt.spectrogram(r, nperseg=256,
                                                      return_onesided=False)[2]))
    assert calls == [(torch.float32, True, pytest.approx(np.sqrt(norm)))]


# name -> the grids (f, and spectrogram's t) an estimator returns for x
GRIDS = {
    "periodogram": lambda x: ft.periodogram(x)[:1],
    "welch": lambda x: ft.welch(x, nperseg=256)[:1],
    "welch two-sided": lambda x: ft.welch(x, nperseg=256, return_onesided=False)[:1],
    "csd": lambda x: ft.csd(x, x.flip(-1), nperseg=256)[:1],
    "coherence": lambda x: ft.coherence(x, x.flip(-1), nperseg=256)[:1],
    "multitaper": lambda x: ft.multitaper(x[:512])[:1],
    "spectrogram": lambda x: ft.spectrogram(x, nperseg=256)[:2],
    "spectrogram complex": lambda x: ft.spectrogram(torch.complex(x, x.flip(-1)),
                                                    nperseg=256, mode="complex")[:2],
}


@pytest.mark.parametrize("card", [False, True], ids=["composed", "kernel routes"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_returned_grids_are_fresh(name, card, rng, monkeypatch):
    """The grids f and t are the caller's own tensors: scipy's in-place
    ``f /= 1e3`` on one call's grid, or an edit through ``.numpy()``,
    leaves every later call's grid as it was."""
    monkeypatch.setattr(spectral_est, "_on_card", lambda t: card)
    x = _t(rrand(rng, 2048))
    first = GRIDS[name](x)
    want = [g.clone() for g in first]
    for g in first:
        g /= 1e3
        g.numpy()[:1] = 7.0
    again = GRIDS[name](x)
    assert len(again) == len(want)
    for got, w, old in zip(again, want, first):
        assert torch.equal(got, w), name
        assert got.untyped_storage().data_ptr() != old.untyped_storage().data_ptr(), name


@pytest.mark.parametrize("kw", [{}, {"normalize": True}, {"normalize": "amplitude"},
                                {"floating_mean": True}, {"weights": "w"},
                                {"floating_mean": True, "normalize": "amplitude"}],
                         ids=str)
def test_lombscargle_matches_jax_and_scipy(kw, rng, assert_close):
    t = np.sort(rng.uniform(0, 10, 300))
    # an offset of 0.5 and frequencies from 0.5: with a large offset, or
    # below one cycle over the span, the floating mean's CC - C*C and
    # YC - Y*C cancel to ~1e-4 relative error in float32, in the JAX
    # package as here
    y = np.sin(2.3 * t) + 0.3 * rng.standard_normal(300) + 0.5
    f = np.linspace(0.5, 6.0, 200)
    if "weights" in kw:
        kw = dict(kw, weights=rng.uniform(0.5, 1.5, 300))
    got = ft.lombscargle(_t(t.astype(np.float32)), _t(y.astype(np.float32)),
                         _t(f.astype(np.float32)), **kw)
    want = ftt.lombscargle(t.astype(np.float32), y.astype(np.float32), f.astype(np.float32),
                           **kw)
    assert_close(_np(got), np.asarray(want))
    assert_close(_np(got), ss.lombscargle(t, y, f, **kw), what="vs scipy float64")


# ---------------------------------------------------------------------- #
# gradients: against jax.grad of the JAX package's estimators
# ---------------------------------------------------------------------- #
GRADS = {
    "welch": (1, lambda m, x: m.welch(x, nperseg=256)[1]),
    "csd": (2, lambda m, x, y: m.csd(x, y, nperseg=256, noverlap=96)[1]),
    "spectrogram": (1, lambda m, x: m.spectrogram(x, nperseg=256)[2]),
    "welch_two_sided": (1, lambda m, x: m.welch(x, nperseg=256, return_onesided=False)[1]),
    "spectrogram_complex": (1, lambda m, x: m.spectrogram(x, nperseg=256, mode="complex")[2]),
    "csd_two_sided": (2, lambda m, x, y: m.csd(x, y, nperseg=256, noverlap=96,
                                                return_onesided=False)[1]),
    "spectrogram_two_sided": (1, lambda m, x: m.spectrogram(x, nperseg=256,
                                                            return_onesided=False)[2]),
}


@pytest.mark.parametrize("name", list(GRADS))
def test_gradients_match_jax_grad(name, rng, monkeypatch, assert_close):
    nin, call = GRADS[name]
    xs = [rrand(rng, 2, 2048) for _ in range(nin)]
    out = call(ftt, *xs)
    w = rng.random(np.shape(out)).astype(np.float32)

    def jloss(*v):
        o = call(ftt, *v)
        return jnp.sum(w * jnp.abs(o) ** 2) if jnp.iscomplexobj(o) else jnp.sum(w * o)

    want = jax.grad(jloss, argnums=tuple(range(nin)))(*[jnp.asarray(x) for x in xs])
    for card in (False, True):  # the composed route, then the kernel route
        monkeypatch.setattr(spectral_est, "_on_card", lambda t, c=card: c)
        ins = [_t(x).requires_grad_() for x in xs]
        o = call(ft, *ins)
        loss = (_t(w) * (o.abs() ** 2 if o.is_complex() else o)).sum()
        loss.backward()
        for v, g in zip(ins, want):
            assert_close(_np(v.grad), np.asarray(g), what=f"{name} kernel route={card}")
