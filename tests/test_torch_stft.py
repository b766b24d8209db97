"""Torch port, ``stft`` and ``istft`` on the CPU against the JAX package.

The same numpy inputs, made from a seed, go through
``fft_wgpu_tpu.stft`` / ``istft`` and ``fft_wgpu_tpu_torch.stft`` /
``istft`` (CPU tensors: the plan's plain path): center on and off, a
window shorter than n_fft, a hop that does not divide n_fft, batched
input, odd n_fft and the round trip; and ``istft``'s COLA divisor, built
on the device by the slab overlap-add, against numpy's ``np.add.at``.
The framed-R2C kernel (B20) that ``stft`` launches on a CUDA tensor is
held against its plain version in ``tests/test_torch_cuda.py``.
Tolerance: 1e-5 relative L2.
"""

import numpy as np
import pytest
import torch

import fft_wgpu_tpu as fj
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.ops import cuda_welch
from fft_wgpu_tpu_torch.ops import stft as t_stft

torch.set_num_threads(1)


def _t(x):
    # a CPU tensor asks the port for the CPU
    return torch.from_numpy(np.array(x))


CASES = [  # (shape, n_fft, hop, center, win_length)
    ((3000,), 256, 64, True, None),        # defaults but n_fft
    ((3000,), 256, None, False, None),     # hop n_fft // 4, no center
    ((2, 1500), 200, 60, True, 150),       # win_length < n_fft, hop !| n_fft
    ((2, 3, 700), 128, 48, False, 100),    # 2 x 3 batch, hop !| n_fft
    ((1201,), 255, 100, True, None),       # odd n_fft
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}-{c[4]}")
def test_stft_matches_jax(case, rng, assert_close):
    shape, n_fft, hop, center, wl = case
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(fj.stft(x, n_fft, hop, center=center, win_length=wl))
    got = ft.stft(_t(x), n_fft, hop, center=center, win_length=wl)
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    assert got.device.type == "cpu"
    assert_close(got.numpy(), want, what="stft vs JAX")
    assert cuda_welch.spec_launches == 0


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}-{c[4]}")
def test_stft_kernel_route_matches_jax(case, rng, monkeypatch, assert_close):
    """The route of a CUDA tensor, run by pretending the tensor lies on the
    card: pow2 n_fft takes the framed-R2C entry point's complex64 sink (B20)
    once, with nperseg = nfft = n_fft and no detrend; the rest compose."""
    shape, n_fft, hop, center, wl = case
    calls = []
    spec = cuda_welch.spec_rfft_c64
    monkeypatch.setattr(t_stft, "_on_card", lambda t: True)
    monkeypatch.setattr(cuda_welch, "spec_rfft_c64",
                        lambda *a, **k: calls.append(a[2:]) or spec(*a, **k))
    x = rng.standard_normal(shape).astype(np.float32)
    got = ft.stft(_t(x), n_fft, hop, center=center, win_length=wl)
    assert_close(got.numpy(), np.asarray(fj.stft(x, n_fft, hop, center=center,
                                                 win_length=wl)), what="stft vs JAX")
    pow2 = n_fft & (n_fft - 1) == 0
    assert calls == ([(n_fft, hop or n_fft // 4, n_fft, False)] if pow2 else [])


@pytest.mark.parametrize("center", [True, False])
def test_stft_kernel_route_takes_the_complex64_sink(center, rng, monkeypatch, assert_close):
    """On the card, pow2 n_fft runs B20's complex64 sink once on the
    unpadded signal (the centering's reflect pad is the kernel's ``pad``)
    and returns its transposed view: no merge, no pad in torch."""
    def refuse(*a, **k):
        raise AssertionError("the kernel route merged or padded in torch")

    calls = []
    spec = cuda_welch.spec_rfft_c64
    monkeypatch.setattr(t_stft, "_on_card", lambda t: True)
    monkeypatch.setattr(t_stft, "merge", refuse)
    monkeypatch.setattr(t_stft, "_reflect_pad", refuse)
    monkeypatch.setattr(cuda_welch, "spec_rfft_c64",
                        lambda *a, **k: calls.append((a[0].shape, k)) or spec(*a, **k))
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    got = ft.stft(_t(x), 256, 64, center=center)
    assert calls == [((2, 3000), {"pad": 128 if center else 0})]
    assert got.dtype == torch.complex64 and not got.is_contiguous()
    assert_close(got.numpy(), np.asarray(fj.stft(x, 256, 64, center=center)), what="stft vs JAX")


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}-{c[4]}")
def test_istft_matches_jax(case, rng, assert_close):
    shape, n_fft, hop, center, wl = case
    x = rng.standard_normal(shape).astype(np.float32)
    Z = np.asarray(fj.stft(x, n_fft, hop, center=center, win_length=wl))
    for length in (None, shape[-1], shape[-1] + 37):
        want = np.asarray(fj.istft(Z, n_fft, hop, center=center, length=length,
                                   win_length=wl))
        got = ft.istft(_t(Z), n_fft, hop, center=center, length=length, win_length=wl)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert_close(got.numpy(), want, what=f"istft vs JAX, length {length}")


def test_round_trip(rng, assert_close):
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    for n_fft, hop in ((512, 128), (400, 100), (256, 96)):
        Z = ft.stft(_t(x), n_fft, hop)
        y = ft.istft(Z, n_fft, hop, length=4096)
        assert_close(y.numpy(), x, what=f"round trip n_fft {n_fft} hop {hop}")


def test_explicit_window_and_pair_input(rng, assert_close):
    x = rng.standard_normal(2000).astype(np.float32)
    w = np.hanning(300).astype(np.float32)
    want = np.asarray(fj.stft(x, 512, 128, window=w, win_length=300))
    got = ft.stft(_t(x), 512, 128, window=_t(w), win_length=300)
    assert_close(got.numpy(), want, what="tensor window")
    assert_close(ft.stft(_t(x), 512, 128, window=w).numpy(), want, what="numpy window")
    y = ft.istft((got.real, got.imag), 512, 128, window=w, length=2000)
    assert_close(y.numpy(), np.asarray(fj.istft(want, 512, 128, window=w, length=2000)),
                 what="istft of an (re, im) pair")


@pytest.mark.parametrize("n_fft,hop,num", [(512, 128, 8193), (400, 96, 61), (64, 64, 5),
                                           (200, 60, 37)])
def test_cola_norm_matches_numpy_add_at(n_fft, hop, num, assert_close):
    """The divisor istft builds on the device equals the JAX package's
    host np.add.at one (ops/stft.py:174-180)."""
    w = np.asarray(fj.hann_window(n_fft))
    t = n_fft + hop * (num - 1)
    wsq = (w ** 2).astype(np.float32)
    want = np.zeros(t, np.float32)
    np.add.at(want, (np.arange(num)[:, None] * hop + np.arange(n_fft)[None, :]).ravel(),
              np.tile(wsq, num))
    want = np.where(want > 1e-8, want, 1.0)
    got = t_stft._cola_norm(_t(w), num, hop, t)
    assert got.shape == (t,)
    assert_close(got.numpy(), want, what="COLA divisor")


def test_ola_slabs_matches_jax(rng, assert_close):
    from fft_wgpu_tpu.ops.stft import _ola_slabs as j_ola

    for num, flen, hop in ((7, 16, 4), (9, 15, 4), (5, 10, 3), (4, 8, 8)):
        f = rng.standard_normal((2, num, flen)).astype(np.float32)
        t = flen + hop * (num - 1)
        assert_close(t_stft._ola_slabs(_t(f), hop, t).numpy(), np.asarray(j_ola(f, hop, t)),
                     what=f"ola {num}x{flen} hop {hop}")


def test_validation():
    x = torch.zeros(1000)
    with pytest.raises(ValueError, match="shorter than n_fft"):
        ft.stft(torch.zeros(100), n_fft=256, center=False)
    with pytest.raises(ValueError, match="exceeds n_fft"):
        ft.stft(x, n_fft=256, window=torch.ones(300))
    with pytest.raises(ValueError, match="win_length"):
        ft.stft(x, n_fft=256, window=torch.ones(100), win_length=120)


def test_gradient_through_stft(rng, assert_close):
    """d/dx of a weighted |stft(x)|^2 against jax.grad of the JAX
    package's stft."""
    import jax
    import jax.numpy as jnp

    x = rng.standard_normal(1000).astype(np.float32)
    w = rng.random((129, 1 + 1000 // 64)).astype(np.float32)

    def jloss(v):
        Z = fj.stft(v, 256, 64)
        return jnp.sum(w * (jnp.real(Z) ** 2 + jnp.imag(Z) ** 2))

    want = jax.grad(jloss)(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    (_t(w) * ft.stft(xt, 256, 64).abs() ** 2).sum().backward()
    assert_close(xt.grad.numpy(), np.asarray(want), what="d stft")
