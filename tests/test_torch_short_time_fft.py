"""Torch port, ``ShortTimeFFT`` on the CPU against the JAX class and
``scipy.signal.ShortTimeFFT``.

The cases of the JAX package's ``tests/test_short_time_fft.py``: the index
algebra, the dual window, the four fft modes, both scalings, the four
paddings, mfft > m_num and odd mfft, ``phase_shift=None``, p0 / p1 and
k_offset, batched input and ``axis``, ``spectrogram`` and ``istft``.  The
same numpy inputs go through the JAX class, the port (CPU tensors) and
scipy in float64.  Each stft case also runs the kernel route of a CUDA
tensor by pretending the tensor lies on the card (``_on_card``): the
framed-R2C entry point (B20) then runs its plain version, with the phase
shift as its roll, and the route taken is recorded.  The kernel itself is
held against its plain version on the card in ``tests/test_torch_cuda.py``.
Tolerance: 1e-5 relative L2.
"""

import numpy as np
import pytest
import scipy.signal as ss
import torch

from fft_wgpu_tpu import ShortTimeFFT as JShortTimeFFT
from fft_wgpu_tpu_torch import ShortTimeFFT
from fft_wgpu_tpu_torch.ops import cuda_welch, short_time_fft

torch.set_num_threads(1)


def _t(x):
    # a CPU tensor asks the port for the CPU
    return torch.from_numpy(np.array(x))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _trio(m_num=16, hop=4, fs=8.0, **kw):
    w = ss.windows.hann(m_num, sym=False)
    return (ShortTimeFFT(w, hop, fs, **kw), JShortTimeFFT(w, hop, fs, **kw),
            ss.ShortTimeFFT(w, hop, fs, **kw))


def _sig(n=100, seed=0, complex_=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    if complex_:
        x = x + 1j * rng.standard_normal(n)
    return x


def _f32(x):
    return x.astype(np.complex64 if np.iscomplexobj(x) else np.float32)


@pytest.fixture(params=[False, True], ids=["composed", "kernel route"])
def card(request, monkeypatch):
    """Run each case on the composed route and on the route a CUDA tensor
    takes; record the framed-R2C entry point's calls."""
    seen = []
    monkeypatch.setattr(short_time_fft, "_on_card", lambda t: request.param)
    spec = cuda_welch.spec_rfft_c64

    def spy(*a, **k):
        seen.append(k.get("roll_s"))
        return spec(*a, **k)

    monkeypatch.setattr(cuda_welch, "spec_rfft_c64", spy)
    return request.param, seen


def check_stft(ours, jx, sp, x, card, assert_close, *, kernel, **kw):
    """The port's stft of x against the JAX class and scipy; on the kernel
    route, pow2 mfft in one-sided modes of real input takes B20 once."""
    got = ours.stft(_t(_f32(x)), **kw)
    want = np.asarray(jx.stft(_f32(x), **kw))
    ref = sp.stft(x, **kw)
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape == ref.shape
    assert_close(_np(got), want, what="vs JAX")
    assert_close(_np(got), ref, what="vs scipy")
    on_card, seen = card
    assert seen == ([ours._p_s()] if on_card and kernel else [])
    return got


class TestIndexAlgebra:
    @pytest.mark.parametrize("m,hop", [(16, 4), (15, 4), (16, 5), (9, 2), (8, 8)])
    def test_boundaries_match_jax_and_scipy(self, m, hop):
        w = ss.windows.gaussian(m, m / 6)
        ours, jx, sp = ShortTimeFFT(w, hop, 10.0), JShortTimeFFT(w, hop, 10.0), \
            ss.ShortTimeFFT(w, hop, 10.0)
        for ref in (jx, sp):
            assert ours.p_min == ref.p_min and ours.k_min == ref.k_min
            assert ours.m_num_mid == ref.m_num_mid
            for n in (40, 57):
                assert ours.p_max(n) == ref.p_max(n)
                assert ours.k_max(n) == ref.k_max(n)
                assert ours.p_num(n) == ref.p_num(n)
                assert ours.upper_border_begin(n) == ref.upper_border_begin(n)
                np.testing.assert_allclose(ours.t(n), ref.t(n))
            assert ours.lower_border_end == ref.lower_border_end
            np.testing.assert_allclose(ours.f, ref.f)
            assert ours.f_pts == ref.f_pts
            assert ours.delta_t == ref.delta_t and ours.delta_f == ref.delta_f

    def test_dual_window_and_invertible(self):
        ours, jx, sp = _trio()
        np.testing.assert_allclose(ours.dual_win, sp.dual_win, atol=1e-12)
        np.testing.assert_array_equal(ours.dual_win, jx.dual_win)
        assert ours.invertible == sp.invertible
        assert not ShortTimeFFT(np.ones(8), 9, 1.0).invertible

    def test_validation(self):
        with pytest.raises(ValueError):
            ShortTimeFFT(np.hanning(8).astype(complex) * 1j, 2, 1.0)
        with pytest.raises(ValueError):
            _trio(fft_mode="onesided2X")
        with pytest.raises(ValueError):
            ShortTimeFFT(np.ones(8), 2, 1.0, mfft=4)
        with pytest.raises(ValueError):
            ShortTimeFFT(np.ones(8), 2, 1.0, phase_shift=8)
        with pytest.raises(ValueError):
            ShortTimeFFT(np.ones(8), 0, 1.0)
        w = torch.from_numpy(ss.windows.hann(8, sym=False))  # a tensor window
        np.testing.assert_array_equal(ShortTimeFFT(w, 2, 1.0).win, w.numpy())


class TestSTFT:
    @pytest.mark.parametrize("mode,kw", [
        ("onesided", {}), ("onesided2X", {"scale_to": "magnitude"}),
        ("twosided", {}), ("centered", {})])
    def test_fft_modes(self, mode, kw, card, assert_close):
        ours, jx, sp = _trio(m_num=128, hop=32, fft_mode=mode, **kw)
        check_stft(ours, jx, sp, _sig(1000), card, assert_close,
                   kernel=mode.startswith("onesided"))

    @pytest.mark.parametrize("mode", ["twosided", "centered"])
    def test_complex_input(self, mode, card, assert_close):
        ours, jx, sp = _trio(fft_mode=mode)
        check_stft(ours, jx, sp, _sig(80, complex_=True), card, assert_close, kernel=False)

    def test_complex_input_rejected_onesided(self):
        ours, _, _ = _trio()
        with pytest.raises(ValueError):
            ours.stft(_t(_sig(50, complex_=True).astype(np.complex64)))

    @pytest.mark.parametrize("padding", ["zeros", "edge", "even", "odd"])
    def test_padding_modes(self, padding, card, assert_close):
        ours, jx, sp = _trio(m_num=128, hop=24)  # hop !| m_num
        check_stft(ours, jx, sp, _sig(500, seed=3), card, assert_close, kernel=True,
                   padding=padding)

    @pytest.mark.parametrize("mfft,phase_shift", [(256, 0), (256, 37), (256, -100),
                                                  (200, 0), (129, 5)])
    def test_mfft_oversample_odd_and_phase_shift(self, mfft, phase_shift, card,
                                                  assert_close):
        # mfft > m_num with a phase shift: the roll brings the zero pad to
        # the front of the frame
        ours, jx, sp = _trio(m_num=128, hop=32, mfft=mfft, phase_shift=phase_shift)
        check_stft(ours, jx, sp, _sig(640, seed=1), card, assert_close,
                   kernel=mfft & (mfft - 1) == 0)

    def test_phase_shift_none(self, card, assert_close):
        ours, jx, sp = _trio(m_num=128, hop=32, phase_shift=None)
        assert ours._p_s() == 0
        check_stft(ours, jx, sp, _sig(600), card, assert_close, kernel=True)

    @pytest.mark.parametrize("scale", ["magnitude", "psd"])
    def test_scalings(self, scale, card, assert_close):
        ours, jx, sp = _trio(m_num=128, hop=32, scale_to=scale)
        assert ours.scaling == sp.scaling
        np.testing.assert_allclose(ours.win, sp.win, atol=1e-12)
        assert np.isclose(ours.fac_magnitude, sp.fac_magnitude)
        assert np.isclose(ours.fac_psd, sp.fac_psd)
        check_stft(ours, jx, sp, _sig(700, seed=2), card, assert_close, kernel=True)

    def test_onesided2X_psd(self, card, assert_close):
        ours, jx, sp = _trio(m_num=128, hop=32, fft_mode="onesided2X", scale_to="psd")
        check_stft(ours, jx, sp, _sig(900, seed=4), card, assert_close, kernel=True)

    def test_slice_range_and_k_offset(self, card, assert_close):
        ours, jx, sp = _trio(m_num=128, hop=32)
        check_stft(ours, jx, sp, _sig(1000), card, assert_close, kernel=True,
                   p0=2, p1=20, k_offset=3)

    def test_batched_and_axis(self, card, assert_close):
        ours, jx, sp = _trio(m_num=128, hop=32)
        x = np.stack([_sig(640, seed=i) for i in range(3)])
        check_stft(ours, jx, sp, x, card, assert_close, kernel=True)
        card[1].clear()
        check_stft(ours, jx, sp, np.ascontiguousarray(x.T), card, assert_close, kernel=True,
                   axis=0)

    def test_spectrogram(self, card, assert_close):
        ours, jx, sp = _trio(m_num=128, hop=32)
        x, y = _sig(640), _sig(640, seed=9)
        got = ours.spectrogram(_t(_f32(x)))
        assert_close(_np(got), np.asarray(jx.spectrogram(_f32(x))), what="vs JAX")
        assert_close(_np(got), sp.spectrogram(x), what="vs scipy")
        got = ours.spectrogram(_t(_f32(x)), _t(_f32(y)))
        assert_close(_np(got), sp.spectrogram(x, y), what="cross vs scipy")

    def test_fft_mode_mutation(self, assert_close):
        ours, _, sp = _trio()
        x = _sig(64, seed=12)
        ours.stft(_t(_f32(x)))
        ours.fft_mode = sp.fft_mode = "twosided"
        assert_close(_np(ours.stft(_t(_f32(x)))), sp.stft(x))

    def test_list_input_goes_to_the_card(self, monkeypatch):
        ours, _, _ = _trio()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ours.stft(list(np.arange(32.0)))

    def test_device_argument(self, assert_close):
        w = ss.windows.hann(16, sym=False)
        ours = ShortTimeFFT(w, 4, 8.0, device="cpu")
        x = list(np.arange(32.0))  # non-tensor input goes to `device`
        got = ours.stft(x)
        assert got.device.type == "cpu"
        assert_close(_np(got), ss.ShortTimeFFT(w, 4, 8.0).stft(np.asarray(x)))
        assert {k[1] for k in ours._tables} == {"cpu"}


class TestISTFT:
    @pytest.mark.parametrize("mode,kw", [
        ("onesided", {}), ("onesided2X", {"scale_to": "psd"}),
        ("twosided", {}), ("centered", {})])
    def test_roundtrip(self, mode, kw):
        ours, _, _ = _trio(fft_mode=mode, **kw)
        x = _sig(100, seed=5)
        xr = ours.istft(ours.stft(_t(x.astype(np.float32))), k1=len(x))
        assert np.abs(_np(xr) - x).max() < 1e-5

    @pytest.mark.parametrize("kw", [{}, {"mfft": 24, "phase_shift": 3}, {"mfft": 25},
                                    {"phase_shift": None}, {"fft_mode": "centered"}])
    def test_matches_jax_and_scipy_istft(self, kw, assert_close):
        ours, jx, sp = _trio(**kw)
        x = _sig(100, seed=6)
        S = sp.stft(x).astype(np.complex64)
        got = ours.istft(_t(S), k1=len(x))
        assert_close(_np(got), np.asarray(jx.istft(S, k1=len(x))), what="vs JAX")
        assert_close(_np(got), sp.istft(sp.stft(x), k1=len(x)), what="vs scipy")

    def test_k0_k1_window_and_axes(self, assert_close):
        ours, _, sp = _trio()
        x = _sig(100, seed=7)
        S = sp.stft(x)
        got = ours.istft(_t(S.astype(np.complex64)), k0=12, k1=80)
        assert_close(_np(got), sp.istft(S, k0=12, k1=80))
        got = ours.istft(_t(np.ascontiguousarray(S.T).astype(np.complex64)), k1=100,
                         f_axis=-1, t_axis=-2)
        assert_close(_np(got), sp.istft(S, k1=100))

    def test_complex_roundtrip(self):
        ours, _, _ = _trio(fft_mode="twosided")
        x = _sig(96, seed=8, complex_=True)
        xr = ours.istft(ours.stft(_t(x.astype(np.complex64))), k1=len(x))
        assert xr.dtype == torch.complex64
        assert np.abs(_np(xr) - x).max() < 1e-5

    def test_odd_window_roundtrip(self, assert_close):
        w = ss.windows.hann(7, sym=False)
        ours, sp = ShortTimeFFT(w, 2, 1.0), ss.ShortTimeFFT(w, 2, 1.0)
        x = _sig(40, seed=11)
        S = ours.stft(_t(x.astype(np.float32)))
        assert_close(_np(S), sp.stft(x))
        assert np.abs(_np(ours.istft(S, k1=len(x))) - x).max() < 1e-5

    def test_validation(self):
        ours, _, _ = _trio()
        S = ours.stft(_t(_sig(64).astype(np.float32)))
        with pytest.raises(ValueError):
            ours.istft(S[:-1], k1=64)  # wrong f_pts
        with pytest.raises(ValueError):
            ours.istft(S, k0=-1000, k1=64)
        with pytest.raises(ValueError):
            ours.istft(S, f_axis=-1, t_axis=-1)


@pytest.mark.parametrize("phase_shift", [0, 40])
def test_gradient_matches_jax_grad(phase_shift, card, assert_close):
    """d/dx of a weighted |stft(x)|^2 against jax.grad of the JAX class
    (its composed CPU path), on the composed route and the kernel route."""
    import jax
    import jax.numpy as jnp

    w = ss.windows.hann(128, sym=False)
    ours = ShortTimeFFT(w, 32, 1.0, mfft=256, phase_shift=phase_shift)
    jx = JShortTimeFFT(w, 32, 1.0, mfft=256, phase_shift=phase_shift)
    x = _sig(600).astype(np.float32)
    S = np.asarray(jx.stft(x))
    wt = np.random.default_rng(1).random(S.shape).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(wt * jnp.abs(jx.stft(v)) ** 2))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    (_t(wt) * ours.stft(xt).abs() ** 2).sum().backward()
    assert_close(_np(xt.grad), np.asarray(want))
    assert card[1] == ([ours._p_s()] if card[0] else [])


@pytest.mark.parametrize("fft_mode", ["onesided", "onesided2X"])
def test_kernel_route_takes_the_complex64_sink(fft_mode, monkeypatch, assert_close):
    """On the card, real input in a one-sided mode with pow2 mfft runs B20's
    complex64 sink once and returns its transposed, moved view (the
    onesided2X multiplier on the complex tensor): no merge."""
    def refuse(*a, **k):
        raise AssertionError("the kernel route merged planes")

    seen = []
    spec = cuda_welch.spec_rfft_c64
    monkeypatch.setattr(short_time_fft, "_on_card", lambda t: True)
    monkeypatch.setattr(short_time_fft, "merge", refuse)
    monkeypatch.setattr(cuda_welch, "spec_rfft_c64",
                        lambda *a, **k: seen.append(k["roll_s"]) or spec(*a, **k))
    ours, jx, sp = _trio(m_num=128, hop=32, fft_mode=fft_mode, scale_to="magnitude")
    x = _sig(900, seed=5).reshape(3, 300)
    got = ours.stft(_t(_f32(x)), axis=-1)
    assert seen == [ours._p_s()]
    assert got.dtype == torch.complex64 and tuple(got.shape) == jx.stft(_f32(x)).shape
    assert_close(_np(got), np.asarray(jx.stft(_f32(x))), what="vs JAX")
    assert_close(_np(got), sp.stft(x), what="vs scipy")
