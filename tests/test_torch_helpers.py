"""Torch port, the fused-epilogue modules on the CPU: ``ops/helpers.py``
(shifts, frequency grids, fast lengths, the convolutions, correlation,
the analytic signal, the Hartley transform, detrending, resampling),
``ops/fastconv.py``
(``SpectralFilter``) and ``ops/cwt.py`` (``cwt``, ``CWT``).

The same numpy inputs go through the JAX package on the CPU and through
the port on CPU tensors, values and gradients (``jax.grad``), plus the
scipy oracles the JAX package's own tests use (``tests/test_helpers.py``,
``test_fastconv.py``, ``test_cwt.py``).  On a CUDA tensor these modules
reach the kernels of ``tests/test_torch_fused.py``; their routes there are
checked from the predicates here and on the card in
``tests/test_torch_cuda.py``.  Tolerance: 1e-5 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu.ops import cwt as j_cwt
from fft_wgpu_tpu.ops import helpers as j_helpers
from fft_wgpu_tpu_torch.ops import cuda_fft, cwt, fastconv, helpers

torch.set_num_threads(1)

CPU, CUDA = torch.device("cpu"), torch.device("cuda", 0)


def _t(x):
    # a CPU tensor asks the port for the CPU
    return torch.from_numpy(np.array(x))


def _np(z):
    return z.detach().numpy() if isinstance(z, torch.Tensor) else np.asarray(z)


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def rrand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def assert_no_launches():
    assert (cuda_fft.launches, cuda_fft.r2c_launches, cuda_fft.filt_launches,
            cuda_fft.filt_c64_launches, cuda_fft.bank_launches,
            cuda_fft.c2r_prod_launches) == (0, 0, 0, 0, 0, 0)


def _card_route(monkeypatch, module, spied, refuse=True):
    """Pretend CPU tensors lie on the card for ``module``'s route, refuse
    any split, merge or plan there (unless not ``refuse``), and record the
    cuda_fft entry points of ``spied`` it calls, in order."""
    calls = []

    def refused(name):
        def fail(*a, **k):
            raise AssertionError(f"the card route ran {name}")
        return fail

    monkeypatch.setattr(module, "_on_card", lambda t: True)
    for name in ("merge", "promote_to_split", "get_plan") if refuse else ():
        if hasattr(module, name):
            monkeypatch.setattr(module, name, refused(name))
    for name in spied:
        fn = getattr(cuda_fft, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append((_name, tuple(a[0].shape), a[0].dtype, k.get("n_in")))
            return _fn(*a, **k)

        monkeypatch.setattr(cuda_fft, name, spy)
    return calls


def test_exports_match_jax():
    # the JAX package's names from helpers, fastconv and cwt
    names = set(j_helpers.__all__) | {
        "SpectralFilter", "spectral_filter", "cwt", "CWT", "ricker", "morlet2"}
    assert names <= set(ft.__all__)
    assert "resample" in names
    for name in names:
        assert callable(getattr(ft, name)), name


# ---------------------------------------------------------------------- #
# shifts, grids, lengths, workers
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("axes", [None, 0, (1,), (0, 1)])
def test_shifts_match_jax(axes, rng):
    x = crand(rng, 5, 8)
    for name in ("fftshift", "ifftshift"):
        got = getattr(ft, name)(_t(x), axes=axes)
        np.testing.assert_array_equal(_np(got), np.asarray(getattr(ftt, name)(x, axes=axes)))
        np.testing.assert_array_equal(_np(got), getattr(np.fft, name)(x, axes=axes))
    np.testing.assert_array_equal(_np(ft.ifftshift(ft.fftshift(_t(x)))), x)


@pytest.mark.parametrize("n", [1, 7, 8, 1000])
def test_freqs_match_jax(n):
    for name in ("fftfreq", "rfftfreq"):
        got = getattr(ft, name)(n, 0.25, device="cpu")
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(_np(got), np.asarray(getattr(ftt, name)(n, 0.25)))


def test_freqs_default_to_the_card():
    # no device given: the current CUDA device, which raises where there is none
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ft.fftfreq(8)


def test_fast_lens_match_jax_and_scipy():
    import scipy.fft as sf

    for t in list(range(1, 600)) + [4095, 4097, 16383, 65537, 1 << 20]:
        for real in (False, True):
            assert ft.next_fast_len(t, real) == ftt.next_fast_len(t, real), (t, real)
            assert ft.prev_fast_len(t, real) == ftt.prev_fast_len(t, real), (t, real)
        assert ft.next_fast_len(t) == sf.next_fast_len(t, True)  # scipy's 5-smooth
    with pytest.raises(ValueError):
        ft.prev_fast_len(0)


def test_conv_fast_len():
    for lf in (2, 100, 1999, 8191, 1 << 21, (1 << 21) + 1):
        # the CPU: the JAX package off the TPU; the card: the power of two
        assert helpers._conv_fast_len(lf, CPU) == j_helpers._conv_fast_len(lf)
        p2 = 1 << max(lf - 1, 1).bit_length()
        want = p2 if p2 <= 1 << 21 else ft.next_fast_len(lf, real=True)
        assert helpers._conv_fast_len(lf, CUDA) == want


def test_workers_shims():
    assert ft.get_workers() == 1
    with ft.set_workers(4) as w:
        assert w.workers == 4 and ft.get_workers() == 4
    assert ft.get_workers() == 1


# ---------------------------------------------------------------------- #
# convolution and correlation
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fft_convolve_matches_jax(mode, rng, assert_close):
    a, b = rrand(rng, 2, 300), rrand(rng, 2, 41)
    got = ft.fft_convolve(_t(a), _t(b), mode=mode)
    assert_close(_np(got), np.asarray(ftt.fft_convolve(a, b, mode=mode)))
    assert_close(_np(got), ss.fftconvolve(a, b, mode=mode, axes=-1))
    ac, bc = crand(rng, 70), crand(rng, 9)
    assert_close(_np(ft.fft_convolve(_t(ac), _t(bc), mode=mode)),
                 np.convolve(ac, bc, mode=mode))


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fftconvolve_matches_jax(mode, rng, assert_close):
    a, b = rrand(rng, 3, 500), rrand(rng, 3, 60)
    got = ft.fftconvolve(_t(a), _t(b), mode=mode, axes=-1)
    assert got.dtype == torch.float32
    assert_close(_np(got), np.asarray(ftt.fftconvolve(a, b, mode=mode, axes=-1)))
    assert_close(_np(got), ss.fftconvolve(a, b, mode=mode, axes=-1))
    A, B = rrand(rng, 20, 30), rrand(rng, 5, 7)  # N-D: the C2C axis, then C2R
    assert_close(_np(ft.fftconvolve(_t(A), _t(B), mode=mode)),
                 np.asarray(ftt.fftconvolve(A, B, mode=mode)))
    Ac, Bc = crand(rng, 12, 17), crand(rng, 4, 3)
    assert_close(_np(ft.fftconvolve(_t(Ac), _t(Bc), mode=mode)),
                 ss.fftconvolve(Ac, Bc, mode=mode))


def test_fftconvolve_axes_broadcast_and_errors(rng, assert_close):
    a, b = rrand(rng, 4, 64), rrand(rng, 1, 9)  # a size-1 axis broadcasts
    assert_close(_np(ft.fftconvolve(_t(a), _t(b), axes=1)), ss.fftconvolve(a, b, axes=1))
    a, b = rrand(rng, 40, 3), rrand(rng, 7, 3)  # a leading convolved axis
    assert_close(_np(ft.fftconvolve(_t(a), _t(b), axes=0)),
                 np.asarray(ftt.fftconvolve(a, b, axes=0)))
    with pytest.raises(ValueError, match="rank"):
        ft.fftconvolve(_t(a), _t(b[0]))
    with pytest.raises(ValueError, match="broadcastable"):
        ft.fftconvolve(_t(rrand(rng, 3, 8)), _t(rrand(rng, 2, 8)), axes=1)
    with pytest.raises(ValueError, match="valid"):
        ft.fftconvolve(_t(rrand(rng, 8, 2)), _t(rrand(rng, 2, 8)), mode="valid")
    with pytest.raises(ValueError, match="mode"):
        ft.fftconvolve(_t(a), _t(b), mode="bogus")


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_oaconvolve_matches_jax(mode, rng, assert_close):
    a, b = rrand(rng, 3000), rrand(rng, 33)
    got = ft.oaconvolve(_t(a), _t(b), mode=mode)
    assert_close(_np(got), np.asarray(ftt.oaconvolve(a, b, mode=mode)))
    assert_close(_np(got), ss.oaconvolve(a, b, mode=mode))
    # the operands swapped: 'same' follows the first as passed
    assert_close(_np(ft.oaconvolve(_t(b), _t(a), mode=mode)), ss.oaconvolve(b, a, mode=mode))
    ac, bc = crand(rng, 700), crand(rng, 12)
    assert_close(_np(ft.oaconvolve(_t(ac), _t(bc), mode=mode)),
                 ss.oaconvolve(ac, bc, mode=mode))


def test_oaconvolve_axes(rng, assert_close):
    a, b = rrand(rng, 3, 900), rrand(rng, 3, 20)  # one axis, batched kernel
    got = ft.oaconvolve(_t(a), _t(b), axes=-1)
    assert_close(_np(got), np.asarray(ftt.oaconvolve(a, b, axes=-1)))
    assert_close(_np(got), ss.oaconvolve(a, b, axes=-1))
    got = ft.oaconvolve(_t(a.T.copy()), _t(rrand(rng, 20)[:, None]), axis=0)
    assert got.shape == (919, 3)
    A, B = rrand(rng, 30, 40), rrand(rng, 4, 5)  # every axis: fftconvolve
    assert_close(_np(ft.oaconvolve(_t(A), _t(B))), ss.oaconvolve(A, B))


@pytest.mark.parametrize("cplx", [False, True])
def test_fftcorrelate_matches_jax(cplx, rng, assert_close):
    gen = crand if cplx else rrand
    a, b = gen(rng, 3, 200), gen(rng, 3, 31)
    got = ft.fftcorrelate(_t(a), _t(b), axes=-1)
    assert_close(_np(got), np.asarray(ftt.fftcorrelate(a, b, axes=-1)))
    assert_close(_np(got), np.stack([ss.correlate(u, v) for u, v in zip(a, b)]))
    A, B = gen(rng, 12, 10), gen(rng, 3, 4)
    assert_close(_np(ft.correlate(_t(A), _t(B), mode="same")),
                 ss.correlate(A, B, mode="same"))
    assert_close(_np(ft.convolve(_t(A), _t(B))), ss.convolve(A, B))


def test_conv_shims_and_lags():
    assert ft.choose_conv_method(None, None) == "fft"
    assert ft.choose_conv_method(None, None, measure=True) == ("fft", {})
    with pytest.raises(ValueError):
        ft.convolve(_t(np.ones(3)), _t(np.ones(3)), method="bogus")
    for mode in ("full", "same", "valid"):
        for la, lb in ((10, 4), (4, 10), (7, 7)):
            np.testing.assert_array_equal(ft.correlation_lags(la, lb, mode),
                                          ss.correlation_lags(la, lb, mode))


# ---------------------------------------------------------------------- #
# analytic signal, Hartley transform, detrend
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [512, 1000, 255])
def test_hilbert_matches_jax(n, rng, assert_close):
    x = rrand(rng, 3, n)
    got = ft.hilbert(_t(x))
    assert got.dtype == torch.complex64
    assert_close(_np(got), np.asarray(ftt.hilbert(x)))
    assert_close(_np(got), ss.hilbert(x))
    assert_close(_np(ft.hilbert(_t(x.T.copy()), N=n + 6, axis=0)),
                 ss.hilbert(x.T, N=n + 6, axis=0))
    with pytest.raises(ValueError, match="real"):
        ft.hilbert(_t(crand(rng, 4)))
    with pytest.raises(ValueError, match="one of"):
        ft.hilbert(_t(x), n=4, N=5)
    assert_no_launches()


@pytest.mark.parametrize("n", [512, 256])
def test_hilbert_card_route_matches_jax(n, rng, monkeypatch, assert_close):
    """On the card, pow2 n: the R2C kernel's complex64 sink, then the
    filtered kernel's complex64 entry on its n/2 + 1 bins with the
    one-sided weights; no zero plane, no split, no merge.  Other n keeps
    the plan's route."""
    calls = _card_route(monkeypatch, helpers, ("rfft_rows_c64", "fft_filtered_c64"))
    x = rrand(rng, 3, n)
    got = ft.hilbert(_t(x))
    assert got.dtype == torch.complex64 and got.shape == (3, n)
    assert calls == [("rfft_rows_c64", (3, n), torch.float32, None),
                     ("fft_filtered_c64", (3, n // 2 + 1), torch.complex64, None)]
    assert_close(_np(got), np.asarray(ftt.hilbert(x)))
    assert_close(_np(got), ss.hilbert(x))
    calls.clear()
    got = ft.hilbert(_t(x.T.copy()), axis=0)  # the axis moved to the back and back
    assert_close(_np(got), ss.hilbert(x.T, axis=0))
    assert [c[0] for c in calls] == ["rfft_rows_c64", "fft_filtered_c64"]
    assert_no_launches()


def test_hilbert2_matches_jax(rng, assert_close):
    x = rrand(rng, 2, 12, 9)
    assert_close(_np(ft.hilbert2(_t(x))), np.asarray(ftt.hilbert2(x)))
    assert_close(_np(ft.hilbert2(_t(x[0]), N=(14, 10))), ss.hilbert2(x[0], N=(14, 10)))
    with pytest.raises(ValueError):
        ft.hilbert2(_t(x[0, 0]))


@pytest.mark.parametrize("n", [64, 63])
def test_dht_matches_jax(n, rng, assert_close):
    x = rrand(rng, 3, n)
    got = ft.dht(_t(x))
    assert_close(_np(got), np.asarray(ftt.dht(x)))
    F = np.fft.fft(x)
    assert_close(_np(got), F.real - F.imag)
    assert_close(_np(ft.idht(got)), x)
    assert_close(_np(ft.dht(_t(x.T.copy()), axis=0)), (F.real - F.imag).T)
    with pytest.raises(ValueError):
        ft.dht(_t(crand(rng, 8)))


def test_detrend_matches_jax(rng, assert_close):
    x = rrand(rng, 4, 300) + np.linspace(0, 5, 300, dtype=np.float32)
    for kw in ({}, {"type": "constant"}, {"bp": [50, 200]}, {"axis": 0}):
        got = ft.detrend(_t(x), **kw)
        assert_close(_np(got), np.asarray(ftt.detrend(x, **kw)), what=str(kw))
        assert_close(_np(got), ss.detrend(x.astype(np.float64), **kw), what=str(kw))
    xc = crand(rng, 2, 50)
    assert_close(_np(ft.detrend(_t(xc))), ss.detrend(xc))
    with pytest.raises(ValueError):
        ft.detrend(_t(x), type="bogus")
    with pytest.raises(ValueError):
        ft.detrend(_t(x), bp=[400])


# ---------------------------------------------------------------------- #
# SpectralFilter
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [1024, 1000, 509])
def test_spectral_filter_matches_jax(n, rng, assert_close):
    # pow2 (on the card: B1 then B9), composite (the plan: B13 on the card)
    # and prime n (the plan: Bluestein)
    x, H, h = crand(rng, 4, n), crand(rng, n), crand(rng, n)
    f = ft.SpectralFilter(H)
    assert isinstance(f, torch.nn.Module) and f.n == n
    assert f.hr.dtype == torch.float32 and f.hr.shape == (n,)
    got = f(_t(x))
    assert got.dtype == torch.complex64
    assert_close(_np(got), np.asarray(ftt.SpectralFilter(H)(x)))
    assert_close(_np(f.apply(_t(x))), np.fft.ifft(np.fft.fft(x) * H))
    assert_close(_np(f.forward(_t(x))), _np(got))
    g = ft.SpectralFilter(_t(h), domain="time")  # circular convolution with h
    assert_close(_np(g(_t(x))), np.fft.ifft(np.fft.fft(x) * np.fft.fft(h)))
    assert_close(_np(ft.spectral_filter(_t(x), h, domain="time")),
                 np.asarray(ftt.spectral_filter(x, h, domain="time")))
    assert_no_launches()


@pytest.mark.parametrize("n", [1024, 256])
def test_spectral_filter_card_route_matches_jax(n, rng, monkeypatch, assert_close):
    """On the card a complex64 input of pow2 n takes the row kernel's
    complex64 entry, then the filtered kernel's: no split, no merge.
    Planar input (a real tensor) keeps the planar entries."""
    calls = _card_route(monkeypatch, fastconv, ("fft_batched_c64", "fft_filtered_c64",
                                                "fft_filtered_split"))
    x, H = crand(rng, 4, n), crand(rng, n)
    got = ft.SpectralFilter(H)(_t(x))
    assert got.dtype == torch.complex64 and got.shape == (4, n)
    assert calls == [("fft_batched_c64", (4, n), torch.complex64, None),
                     ("fft_filtered_c64", (4, n), torch.complex64, None)]
    assert_close(_np(got), np.asarray(ftt.SpectralFilter(H)(x)))
    assert_close(_np(got), np.fft.ifft(np.fft.fft(x) * H))
    monkeypatch.undo()
    calls = _card_route(monkeypatch, fastconv, ("fft_filtered_split",), refuse=False)
    r = rrand(rng, 4, n)
    got = ft.SpectralFilter(H)(_t(r))
    assert [c[0] for c in calls] == ["fft_filtered_split"]
    assert_close(_np(got), np.asarray(ftt.SpectralFilter(H)(r)))
    assert_no_launches()


def test_spectral_filter_complex_row_follows_its_buffers(rng):
    # the complex64 route's row is made from hr and hi once, and again after
    # either changes in place or moves
    f = ft.SpectralFilter(crand(rng, 256))
    h1 = f._response_c64()
    assert f._response_c64() is h1 and h1.dtype == torch.complex64
    torch.testing.assert_close(h1, torch.complex(f.hr, f.hi), rtol=0, atol=0)
    with torch.no_grad():
        f.hi.mul_(2.0)
    h2 = f._response_c64()
    assert h2 is not h1
    torch.testing.assert_close(h2, torch.complex(f.hr, f.hi), rtol=0, atol=0)


def test_spectral_filter_validation():
    with pytest.raises(ValueError):
        ft.SpectralFilter(np.ones((2, 8)))
    with pytest.raises(ValueError):
        ft.SpectralFilter(np.ones(8), n=16)
    with pytest.raises(ValueError):
        ft.SpectralFilter(np.ones(8), domain="bogus")
    with pytest.raises(ValueError):
        ft.SpectralFilter(np.ones(8, np.complex64))(torch.zeros(2, 16))
    # the response is a buffer: it follows the module and the signal
    f = ft.SpectralFilter(np.ones(8))
    assert dict(f.named_buffers()).keys() == {"hr", "hi"}
    assert f.to(torch.float32).hr.device.type == "cpu"


def test_grad_through_spectral_filter_matches_jax(rng, assert_close):
    n = 256
    re, im = rrand(rng, 3, n), rrand(rng, 3, n)
    H, w = crand(rng, n), rng.random((3, n)).astype(np.float32)
    jf = ftt.SpectralFilter(H)

    def jloss(a, b):
        return jnp.sum(w * jnp.abs(jf.apply(jax.lax.complex(a, b))) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    tre, tim = _t(re).requires_grad_(), _t(im).requires_grad_()
    (_t(w) * ft.SpectralFilter(H)(torch.complex(tre, tim)).abs() ** 2).sum().backward()
    assert_close(tre.grad.numpy() + 1j * tim.grad.numpy(),
                 np.asarray(jg[0]) + 1j * np.asarray(jg[1]))


def test_grad_through_spectral_filter_card_route_matches_jax(rng, monkeypatch, assert_close):
    # the complex64 route's gradient: the filtered kernel's adjoint, then
    # the row kernel's (plain versions here), against jax.grad
    n = 256
    x, H, w = crand(rng, 3, n), crand(rng, n), rng.random((3, n)).astype(np.float32)
    jf = ftt.SpectralFilter(H)
    ja, jb = jax.grad(lambda a, b: jnp.sum(w * jnp.abs(jf.apply(jax.lax.complex(a, b))) ** 2),
                      argnums=(0, 1))(x.real, x.imag)
    monkeypatch.setattr(fastconv, "_on_card", lambda t: True)
    tx = _t(x).requires_grad_()
    (_t(w) * ft.SpectralFilter(H)(tx).abs() ** 2).sum().backward()
    assert_close(tx.grad.numpy(), np.asarray(ja) + 1j * np.asarray(jb))
    assert_no_launches()


def test_grad_through_fftconvolve_matches_jax(rng, assert_close):
    a, b = rrand(rng, 2, 300), rrand(rng, 2, 40)
    w = rng.random((2, 339)).astype(np.float32)

    def jloss(u, v):
        return jnp.sum(w * ftt.fftconvolve(u, v, axes=-1) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(a, b)
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    (_t(w) * ft.fftconvolve(ta, tb, axes=-1) ** 2).sum().backward()
    assert_close(ta.grad.numpy(), np.asarray(jg[0]), what="d/da")
    assert_close(tb.grad.numpy(), np.asarray(jg[1]), what="d/db")


# ---------------------------------------------------------------------- #
# the continuous wavelet transform
# ---------------------------------------------------------------------- #
def _cwt_direct(x, widths, gen):
    """The scipy.signal.cwt reference loop (f64)."""
    out = []
    for wd in widths:
        m = min(max(int(10 * wd), 1), len(x))
        out.append(np.convolve(x, np.conj(gen(m, wd)[::-1]), mode="same"))
    return np.stack(out)


@pytest.mark.parametrize("wavelet", ["ricker", "morlet2"])
def test_cwt_matches_jax(wavelet, rng, assert_close):
    x = rrand(rng, 300)
    widths = [1, 3, 7.5, 12, 31]
    got = ft.cwt(_t(x), widths, wavelet)
    assert got.dtype == (torch.float32 if wavelet == "ricker" else torch.complex64)
    assert_close(_np(got), np.asarray(ftt.cwt(x, widths, wavelet)))
    gen = ft.ricker if wavelet == "ricker" else ft.morlet2
    assert_close(_np(got), _cwt_direct(x.astype(np.float64), widths, gen))
    p = ft.CWT(300, widths, wavelet, device="cpu")
    assert_close(_np(p(_t(x))), np.asarray(ftt.CWT(300, widths, wavelet)(x)))
    assert_close(_np(p.apply(x)), _np(got))  # numpy input goes to the plan's device
    assert_no_launches()


def test_cwt_tables_and_validation(rng, assert_close):
    for fn in ("ricker", "morlet2"):
        np.testing.assert_array_equal(getattr(ft, fn)(37, 2.5), getattr(ftt, fn)(37, 2.5))
    bank, lmax, cplx = cwt._build_bank(100, [1, 4, 20], "morlet2", 6.0)
    jbank, jlmax, jcplx = j_cwt._build_bank(100, [1, 4, 20], "morlet2", 6.0)
    np.testing.assert_array_equal(bank, jbank)
    assert (lmax, cplx) == (jlmax, jcplx)
    x = rrand(rng, 128)
    assert_close(_np(ft.cwt(_t(x), [4, 8], "morlet2", w=6.5)),
                 np.asarray(ftt.cwt(x, [4, 8], "morlet2", w=6.5)))
    with pytest.raises(ValueError):
        ft.cwt(torch.zeros(2, 2), [1.0])
    with pytest.raises(ValueError):
        ft.cwt(torch.zeros(16), [])
    with pytest.raises(ValueError):
        ft.cwt(torch.zeros(16), [1.0], "nosuch")
    p = ft.CWT(16, [1.0], device="cpu")
    with pytest.raises(ValueError):
        p(torch.zeros(17))


def test_pick_nfft():
    # the CPU: next_fast_len, as the JAX package off the TPU; the card: the
    # pow2 of the row kernel's envelope, as the JAX package on the TPU
    for lfull in (100, 9471, 16385):
        assert cwt._pick_nfft(lfull, "cpu") == j_cwt._pick_nfft(lfull)
    assert cwt._pick_nfft(100, CUDA) == 128
    assert cwt._pick_nfft(9471, CUDA) == 16384
    assert cwt._pick_nfft(16385, CUDA) == ft.next_fast_len(16385)


def test_grad_through_cwt_matches_jax(rng, assert_close):
    x, widths = rrand(rng, 200), np.arange(1, 6)
    w = rng.random((5, 200)).astype(np.float32)
    jp = ftt.CWT(200, widths)
    jg = jax.grad(lambda s: jnp.sum(w * jp.apply(s) ** 2))(jnp.asarray(x))
    t = _t(x).requires_grad_()
    (_t(w) * ft.CWT(200, widths, device="cpu")(t) ** 2).sum().backward()
    assert_close(t.grad.numpy(), np.asarray(jg))


def test_kernel_shapes_of_the_card_path():
    # on a CUDA tensor the modules pick their kernels by envelope before any
    # launch: hilbert and SpectralFilter take the filtered kernel at pow2 n
    # in 128..16384, the CWT plan the bank kernel there, the convolutions
    # the product C2R through rfft.irfft_prod_last_split
    # (tests/test_torch_fused.py); the card path's shapes land inside
    assert cuda_fft._supported(4096) and not cuda_fft._supported(1000)
    assert cwt._pick_nfft(8192 + 1279, CUDA) == 16384  # CWT(8192, 1..128)
    assert helpers._conv_fast_len(4096 + 4095, CUDA) == 8192  # fftconvolve 2048x4096
    assert 1 << max(3, (8 * 129 - 1).bit_length()) == 2048  # oaconvolve's nfft, 129 taps


# ---------------------------------------------------------------------- #
# resample
# ---------------------------------------------------------------------- #
RESAMPLE = [  # (kind, shape, num, axis, window, domain)
    ("r", (64,), 100, 0, None, "time"),               # even up
    ("r", (3, 64), 40, -1, None, "time"),             # even down, batched
    ("r", (63, 2), 100, 0, ("kaiser", 5.0), "time"),  # odd up, window, axis 0
    ("r", (63,), 31, 0, "hann", "time"),              # odd down to odd
    ("r", (64,), 33, 0, "ones", "time"),              # an array window, odd target
    ("r", (64,), 101, 0, None, "freq"),               # a spectrum, two-sided
    ("c", (64,), 100, 0, None, "time"),               # complex up
    ("c", (65, 3), 40, 0, "hann", "time"),            # complex odd down, window
    ("c", (64,), 48, 0, None, "freq"),                # complex spectrum down
    ("c", (2, 96), 96, 1, None, "time"),              # same length
]


@pytest.mark.parametrize("case", RESAMPLE, ids=lambda c: "-".join(map(str, c)))
def test_resample_matches_jax_and_scipy(case, rng, assert_close):
    kind, shape, num, axis, window, domain = case
    x = crand(rng, *shape) if kind == "c" else rrand(rng, *shape)
    if window == "ones":
        window = np.ones(shape[axis])
    got = ft.resample(_t(x), num, axis=axis, window=window, domain=domain)
    want = np.asarray(ftt.resample(x, num, axis=axis, window=window, domain=domain))
    assert tuple(got.shape) == want.shape and got.device == CPU
    assert got.dtype == (torch.complex64 if np.iscomplexobj(want) else torch.float32)
    assert_close(_np(got), want, what="resample vs JAX")
    ref = ss.resample(x.astype(np.complex128 if kind == "c" else np.float64), num, axis=axis,
                      window=window, domain=domain)
    assert_close(_np(got), ref, what="resample vs scipy")
    assert_no_launches()


def test_resample_t_and_validation(rng, assert_close):
    x = rrand(rng, 64)
    t = np.arange(64) * 0.1
    y, ty = ft.resample(_t(x), 100, t=t)
    want, twant = ftt.resample(x, 100, t=t)
    assert_close(_np(y), np.asarray(want))
    np.testing.assert_allclose(ty, twant)
    _, ty = ft.resample(_t(x), 100, t=_t(t))
    np.testing.assert_allclose(ty, twant)
    y = ft.resample(_t(x), 80, window=lambda f: np.exp(-f * f))
    assert_close(_np(y), np.asarray(ftt.resample(x, 80, window=lambda f: np.exp(-f * f))))
    with pytest.raises(ValueError, match="domain"):
        ft.resample(_t(x), 10, domain="space")
    with pytest.raises(ValueError, match="num"):
        ft.resample(_t(x), 0)
    with pytest.raises(ValueError, match="window length"):
        ft.resample(_t(x), 10, window=np.ones(5))


def test_grad_through_resample_matches_jax(rng, assert_close):
    x = rrand(rng, 2, 96)
    w = rng.random((2, 150)).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(w * ftt.resample(v, 150, axis=1) ** 2))(jnp.asarray(x))
    t = _t(x).requires_grad_()
    (_t(w) * ft.resample(t, 150, axis=1) ** 2).sum().backward()
    assert_close(t.grad.numpy(), np.asarray(jg))


# ---------------------------------------------------------------------- #
# C8 and C9 (ROADMAP §C): empty operands and a zero length, held to scipy
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_empty_operands_follow_scipy(mode, rng):
    # an empty signal against 3 taps: fftconvolve, convolve and correlate
    # returned a 2-point array, oaconvolve raised; scipy's fftconvolve and
    # oaconvolve return an empty array, its convolve and correlate raise
    # (for mode 'same' of an empty first operand: an empty array)
    h = rng.standard_normal(3).astype(np.float32)
    e = np.zeros(0, np.float32)
    for a, b in ((e, h), (h, e), (e, e), (e.astype(np.complex64), h)):
        for name in ("fftconvolve", "oaconvolve", "convolve", "correlate"):
            try:
                want = getattr(ss, name)(a, b, mode=mode)
            except ValueError:
                with pytest.raises(ValueError):
                    getattr(ft, name)(_t(a), _t(b), mode=mode)
                continue
            got = getattr(ft, name)(_t(a), _t(b), mode=mode)
            assert got.shape == want.shape and want.size == 0, (name, a.shape, b.shape)
            assert got.dtype == (torch.complex64 if a.dtype == np.complex64 else torch.float32)


def test_periodogram_of_an_empty_signal_and_a_short_nfft_follow_scipy(rng, assert_close):
    # an empty signal raised ValueError, as did an nfft below the signal's
    # length; scipy returns empty arrays, and cuts the signal to nfft samples
    for x in (np.zeros(0, np.float32), np.zeros((3, 0), np.float32)):
        for got, want in zip(ft.periodogram(_t(x)), ss.periodogram(x)):
            assert tuple(got.shape) == want.shape == x.shape
    x = rng.standard_normal((2, 100)).astype(np.float32)
    for nfft in (0, 1, 40, 99, 100, 128):
        for got, want in zip(ft.periodogram(_t(x), nfft=nfft), ss.periodogram(x, nfft=nfft)):
            assert tuple(got.shape) == want.shape, nfft
            if want.size:
                assert_close(_np(got), want, what=f"nfft {nfft}")


def test_hilbert_zero_length_raises_as_scipy():
    # hilbert(x, N=0) raised IndexError from its weights table
    x = np.ones((3, 8), np.float32)
    for call in (lambda m, v: m.hilbert(v, N=0), lambda m, v: m.hilbert(v[:, :0]),
                 lambda m, v: m.hilbert2(v, N=(3, 0)), lambda m, v: m.hilbert2(v, N=0)):
        with pytest.raises(ValueError):
            call(ss, x)
        with pytest.raises(ValueError, match="N must be positive"):
            call(ft, _t(x))
