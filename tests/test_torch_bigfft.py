"""Torch port, the whole-row large-N entry point (ops/bigfft.py) on the CPU.

On a CPU tensor ``fft_big_split`` runs its plain version (the port's
mixed-radix path plus the scale).  It is held against the JAX package's
Pallas kernel ``bigfft.fft_big_split`` run in interpret mode, as
``tests/test_bigfft.py`` and ``tests/test_ad.py`` run it, values and
gradient, and so is the complex64 entry ``fft_big_c64``.  A plain model of
the kernel's own decomposition (``bigfft._big_passes``) is held against
float64 numpy.  The kernel itself (a thread-block cluster per row) needs the
card: ``tests/test_torch_cuda.py``.  Tolerance: 1e-5 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_wgpu_tpu.ops import bigfft as j_big
from fft_wgpu_tpu_torch.ops import bigfft, cuda_fft

torch.set_num_threads(1)

N = 1 << 15


def planes(rng, *shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def cplx(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("sign,scale", [(-1, None), (1, 1.0 / N)])
def test_matches_jax_kernel(rows, sign, scale, rng, assert_close):
    re, im = planes(rng, rows, N)
    want = cplx(j_big.fft_big_split(re, im, sign, scale, interpret=True))
    got = bigfft.fft_big_split(torch.from_numpy(re), torch.from_numpy(im), sign, scale)
    assert got[0].shape == (rows, N) and got[0].dtype == torch.float32
    assert_close(cplx(got), want)
    assert bigfft.launches == 0  # CPU tensors never reach the kernel


def test_impulse_natural_order():
    # delta at p -> X[k] = exp(-2pi i k p / n): catches any output reordering
    p = 12345
    re = torch.zeros(N)
    re[p] = 1.0
    got = cplx(bigfft.fft_big_split(re, torch.zeros(N), -1))
    k = np.arange(N)
    want = np.exp(-2j * np.pi * k * p / N)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_high_rank_and_reference(rng, assert_close):
    re, im = planes(rng, 2, 2, N)
    got = bigfft.fft_big_split(torch.from_numpy(re), torch.from_numpy(im), -1)
    assert_close(cplx(got), np.fft.fft(re + 1j * im, axis=-1))
    ref = bigfft.fft_big_split_reference(torch.from_numpy(re), torch.from_numpy(im), -1)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_model_matches_numpy_float64():
    # the plain model of the kernel's own decomposition (each block's
    # compiled passes over its decimated row, the table twiddle, the C-point
    # butterfly across the blocks, the natural-order store) at every n
    rng = np.random.default_rng(3)
    for e in (15, 16, 17, 18):
        n = 1 << e
        x = (rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n))).astype(np.complex64)
        for sign, scale in ((-1, None), (1, 1.0 / n)):
            got = cplx(bigfft._big_passes(torch.from_numpy(x.real.copy()),
                                          torch.from_numpy(x.imag.copy()), sign, scale))
            x64 = x.astype(np.complex128)
            want = np.fft.fft(x64) if sign < 0 else np.fft.ifft(x64)
            assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6, (e, sign)


@pytest.mark.parametrize("e", [15, 16, 17, 18])
@pytest.mark.parametrize("p", [0, 1, 12345, -1])
def test_model_impulse_natural_order(e, p):
    n = 1 << e
    p %= n
    re = torch.zeros(n)
    re[p] = 1.0
    got = cplx(bigfft._big_passes(re, torch.zeros(n), -1))
    want = np.exp(-2j * np.pi * np.arange(n) * p / n)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


def test_twiddle_table_layout():
    # lane roots [C][32], warp roots w_n^(32m), then Q's pass roots; the
    # butterfly step's twiddle w_n^(b*k2) of block b's output k2 is the
    # warp root of (k2 // 32) * b times the lane root of (b, k2 mod 32)
    for e in (15, 16, 17, 18):
        n = 1 << e
        c = bigfft._cluster(n)
        q = n // c
        for sign in (-1, 1):
            cos, sin = bigfft._big_roots_np(n, sign)
            w = cos + 1j * sin
            k1, lane = np.arange(c)[:, None], np.arange(32)[None, :]
            np.testing.assert_allclose(w[:32 * c].reshape(c, 32),
                                       np.exp(sign * 2j * np.pi * k1 * lane / n), atol=1e-7)
            warp = w[32 * c:32 * c + n // 32]
            np.testing.assert_allclose(warp, np.exp(sign * 2j * np.pi * 32 * np.arange(n // 32) / n),
                                       atol=1e-7)
            pc, ps = cuda_fft._pass_roots_np(q, sign)
            np.testing.assert_array_equal(w[32 * c + n // 32:], pc + 1j * ps)
            b, k2 = np.arange(c)[:, None], np.arange(q)[None, :]
            np.testing.assert_allclose(warp[(k2 // 32) * b] * w[b * 32 + k2 % 32],
                                       np.exp(sign * 2j * np.pi * b * k2 / n), atol=3e-7)


@pytest.mark.parametrize("sign,scale", [(-1, None), (1, 1.0 / N), (1, None)])
def test_c64_entry_matches_jax_kernel(sign, scale, rng, assert_close):
    # the three plan modes (forward, inverse, inverse_unnormalized) at 2^15
    x = (rng.standard_normal((2, N)) + 1j * rng.standard_normal((2, N))).astype(np.complex64)
    want = cplx(j_big.fft_big_split(x.real, x.imag, sign, scale, interpret=True))
    got = bigfft.fft_big_c64(torch.from_numpy(x), sign, scale)
    assert got.dtype == torch.complex64 and got.shape == x.shape
    assert_close(got.numpy(), want)
    assert bigfft.launches == 0


def test_c64_grad_matches_jax(rng, assert_close):
    re, im, wr, wi = (rng.standard_normal((1, N)).astype(np.float32) for _ in range(4))

    def jloss(a, b):
        xr, xi = j_big.fft_big_split(a, b, 1, 1.0 / N, interpret=True)
        return jnp.sum(xr * wr + xi * wi)

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    x = torch.from_numpy(re + 1j * im).to(torch.complex64).requires_grad_()
    y = bigfft.fft_big_c64(x, 1, 1.0 / N)
    (y.real * torch.from_numpy(wr) + y.imag * torch.from_numpy(wi)).sum().backward()
    assert_close(x.grad.numpy(), np.asarray(jg[0]) + 1j * np.asarray(jg[1]))
    assert bigfft.launches == 0


def test_envelope():
    # Hopper's envelope: 2^15..2^18 (16 blocks x 16384 points), any row count
    assert (bigfft.BIG_MIN_N, bigfft.BIG_MAX_N) == (1 << 15, 1 << 18)
    for e in range(10, 24):
        assert bigfft._supported(1 << e, 1) == (15 <= e <= 18), e
        assert bigfft._supported(1 << e, 4096) == (15 <= e <= 18), e
    assert not bigfft._supported(3 << 14)
    assert not bigfft._supported(1 << 15, 2 ** 29)  # grid x extent
    assert bigfft._supported(1 << 16, 2 ** 28 - 1) and not bigfft._supported(1 << 16, 2 ** 28)
    assert [bigfft._cluster(1 << e) for e in range(15, 19)] == [4, 8, 8, 16]


@pytest.mark.parametrize("shape", [(1, 1 << 14), (1, 3 << 14), (2, 1 << 19)])
def test_out_of_envelope_raises(shape):
    z = torch.zeros(shape)
    with pytest.raises(bigfft.Unsupported):
        bigfft.fft_big_split(z, z, -1)
    with pytest.raises(bigfft.Unsupported):
        bigfft.fft_big_split_reference(z, z, -1)


def test_bad_arguments_raise():
    z = torch.zeros(1, N)
    with pytest.raises(ValueError, match="sign"):
        bigfft.fft_big_split(z, z, 0)
    with pytest.raises(ValueError, match="float32"):
        bigfft.fft_big_split(z, z.double(), -1)


def test_grad_matches_jax(rng, assert_close):
    re, im, wr, wi = (rng.standard_normal((1, N)).astype(np.float32)
                      for _ in range(4))

    def jloss(a, b):
        xr, xi = j_big.fft_big_split(a, b, -1, interpret=True)
        return jnp.sum(xr * wr + xi * wi)

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    tre = torch.from_numpy(re).requires_grad_()
    tim = torch.from_numpy(im).requires_grad_()
    xr, xi = bigfft.fft_big_split(tre, tim, -1)
    (xr * torch.from_numpy(wr) + xi * torch.from_numpy(wi)).sum().backward()
    assert_close(tre.grad.numpy(), np.asarray(jg[0]), what="d/dre")
    assert_close(tim.grad.numpy(), np.asarray(jg[1]), what="d/dim")
    assert bigfft.launches == 0
