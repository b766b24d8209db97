"""Torch port, the four-step's two kernel entry points (ops/cuda_fft.py) on
the CPU: the axis(-2) FFT and the transposed-rows FFT with the outer twiddle
(formed as the kernel forms it, a product of two table roots).

On a CPU tensor ``fft_axis0_split`` and ``fft_rows_transposed_split`` run
their plain versions.  They are held against the JAX package's Pallas
kernels run in interpret mode, as ``tests/test_pallas.py`` and
``tests/test_ad.py`` run them, values and gradients.  The kernels
themselves need the card: ``tests/test_torch_cuda.py``.  Tolerance: 1e-5
relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_wgpu_tpu.ops import pallas_fft as j_pf
from fft_wgpu_tpu_torch.ops import cuda_fft

torch.set_num_threads(1)


def planes(rng, *shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def cplx(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def torch_pair(re, im):
    return torch.from_numpy(re), torch.from_numpy(im)


def assert_no_launches():
    assert (cuda_fft.launches, cuda_fft.ax0_launches, cuda_fft.rows_t_launches) \
        == (0, 0, 0)  # CPU tensors never reach a kernel


@pytest.mark.parametrize("shape", [(512, 100), (3, 1024, 130), (2, 256, 256)])
def test_axis0_matches_jax_kernel(shape, rng, assert_close):
    re, im = planes(rng, *shape)
    n = shape[-2]
    for sign, scale in ((-1, None), (1, 1.0 / n)):
        want = cplx(j_pf.fft_axis0_split(re, im, sign, scale, interpret=True))
        got = cuda_fft.fft_axis0_split(*torch_pair(re, im), sign, scale)
        assert got[0].shape == shape and got[0].dtype == torch.float32
        assert_close(cplx(got), want, what=f"sign={sign}")
        assert_close(cplx(got), (np.fft.fft if sign < 0 else np.fft.ifft)(
            re + 1j * im, axis=-2))
    assert_no_launches()


@pytest.mark.parametrize("shape,outer", [((3, 200, 512), None),
                                         ((64, 512), (64, 1 << 15)),
                                         ((16, 1024), (16, 1 << 22)),
                                         ((3, 4096), (3, 3 << 12))])
def test_rows_transposed_matches_jax_kernel(shape, outer, rng, assert_close):
    re, im = planes(rng, *shape)
    rows, n = shape[-2:]
    for sign, scale in ((-1, None), (1, 1.0 / n)):
        want = cplx(j_pf.fft_rows_transposed_split(re, im, sign, scale, outer=outer,
                                                   interpret=True))
        got = cuda_fft.fft_rows_transposed_split(*torch_pair(re, im), sign, scale,
                                                 outer=outer)
        assert got[0].shape == shape[:-2] + (n, rows)
        assert_close(cplx(got), want, what=f"sign={sign}")
    assert_no_launches()


@pytest.mark.parametrize("rows,n,outer_n", [(64, 512, 1 << 15), (1024, 4096, 1 << 22),
                                            (3, 4096, 3 << 12), (100, 256, 3 << 12)])
def test_outer_plane_two_level_matches_exact_index(rows, n, outer_n):
    # the kernel's roots hi[e >> S] * lo[e & (2^S - 1)] against the JAX
    # contract's exact-index gather, both signs; and the tables' own values
    for sign in (-1, 1):
        got = cuda_fft._outer_plane_two_level(rows, n, outer_n, sign, "cpu")
        want = cuda_fft._outer_plane(rows, n, outer_n, sign, "cpu")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        assert err <= 3e-7, (sign, err)
    hi, lo, S = cuda_fft._outer_tables(outer_n, -1, "cpu")
    assert 2 ** S >= outer_n ** 0.5 and lo.shape[0] == 2 ** S
    assert hi.shape[0] == -(-outer_n // 2 ** S)
    q = np.arange(hi.shape[0]) * 2 ** S
    np.testing.assert_allclose(hi[:, 0].numpy() + 1j * hi[:, 1].numpy(),
                               np.exp(-2j * np.pi * (q % outer_n) / outer_n), atol=1e-7)


def test_rows_transposed_outer_twiddle_is_exact_index(rng, assert_close):
    # the four-step identity: rows of n2 with outer=(n1, n1*n2), stored
    # transposed, after an axis(-2) pass, give the flat length-n1*n2 FFT
    n1, n2 = 128, 256
    re, im = planes(rng, 2, n1 * n2)
    br, bi = cuda_fft.fft_axis0_split(torch.from_numpy(re).reshape(2, n1, n2),
                                      torch.from_numpy(im).reshape(2, n1, n2), -1)
    dr, di = cuda_fft.fft_rows_transposed_split(br, bi, -1, outer=(n1, n1 * n2))
    got = cplx((dr.reshape(2, -1), di.reshape(2, -1)))
    assert_close(got, np.fft.fft(re + 1j * im, axis=-1))


@pytest.mark.parametrize("entry", ["axis0", "rows_t"])
def test_reference_is_the_cpu_route(entry, rng):
    re, im = torch_pair(*planes(rng, 2, 256, 128))
    if entry == "axis0":
        a = cuda_fft.fft_axis0_split(re, im, 1, 0.5)
        b = cuda_fft.fft_axis0_split_reference(re, im, 1, 0.5)
    else:
        a = cuda_fft.fft_rows_transposed_split(re, im, 1, 0.5, outer=(256, 1 << 15))
        b = cuda_fft.fft_rows_transposed_split_reference(re, im, 1, 0.5,
                                                         outer=(256, 1 << 15))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n", [64, 1000, 32768])
def test_envelopes_raise(n):
    # the axis(-2) entry raises exactly outside the JAX kernel's envelope
    # (composite 1000 is inside both); the transposed-rows entry takes pow2
    # n in 128..16384 only
    z = torch.zeros(n, 4)
    if j_pf._ax0_supported(n):
        assert n == 1000
        for fn in (cuda_fft.fft_axis0_split, cuda_fft.fft_axis0_split_reference):
            assert fn(z, z, -1)[0].shape == (n, 4)
    else:
        with pytest.raises(cuda_fft.Unsupported):
            cuda_fft.fft_axis0_split(z, z, -1)
        with pytest.raises(cuda_fft.Unsupported):
            cuda_fft.fft_axis0_split_reference(z, z, -1)
    zt = torch.zeros(4, n)
    with pytest.raises(cuda_fft.Unsupported):
        cuda_fft.fft_rows_transposed_split(zt, zt, -1)
    with pytest.raises(cuda_fft.Unsupported):
        cuda_fft.fft_rows_transposed_split_reference(zt, zt, -1)


def test_ax0_envelope_is_the_pow2_part_of_jax():
    # pow2 n match the JAX kernel, and so do its composite n (the composite
    # axis(-2) kernel, csrc/ax0_gen_fft.cu): the envelopes are equal
    for e in range(20):
        assert cuda_fft._ax0_supported(1 << e) == j_pf._ax0_supported(1 << e)
    assert j_pf._ax0_supported(1000) and cuda_fft._ax0_supported(1000)
    for n in range(2, 16500):
        assert cuda_fft._ax0_supported(n) == j_pf._ax0_supported(n), n


def test_bad_arguments_raise():
    z = torch.zeros(256, 4)
    with pytest.raises(ValueError, match="sign"):
        cuda_fft.fft_axis0_split(z, z, 0)
    with pytest.raises(ValueError, match="float32"):
        cuda_fft.fft_axis0_split(z, z.double(), -1)
    with pytest.raises(ValueError, match=r"\[\.\.\., n, m\]"):
        cuda_fft.fft_axis0_split(torch.zeros(256), torch.zeros(256), -1)
    zt = torch.zeros(4, 256)
    with pytest.raises(ValueError, match="sign"):
        cuda_fft.fft_rows_transposed_split(zt, zt, 2)
    with pytest.raises(ValueError, match="outer_n"):
        cuda_fft.fft_rows_transposed_split(zt, zt, -1, outer=(4, 0))
    with pytest.raises(ValueError, match=r"\[\.\.\., R, n\]"):
        cuda_fft.fft_rows_transposed_split(torch.zeros(256), torch.zeros(256), -1)


def test_grad_axis0_matches_jax(rng, assert_close):
    # tests/test_ad.py's loss: sum(Xr * wr + Xi * wi) through the kernel
    re, im, wr, wi = (rng.standard_normal((2, 256, 256)).astype(np.float32)
                      for _ in range(4))

    def jloss(a, b):
        xr, xi = j_pf.fft_axis0_split(a, b, -1, interpret=True)
        return jnp.sum(xr * wr + xi * wi)

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    tre = torch.from_numpy(re).requires_grad_()
    tim = torch.from_numpy(im).requires_grad_()
    xr, xi = cuda_fft.fft_axis0_split(tre, tim, -1)
    (xr * torch.from_numpy(wr) + xi * torch.from_numpy(wi)).sum().backward()
    assert_close(tre.grad.numpy(), np.asarray(jg[0]), what="d/dre")
    assert_close(tim.grad.numpy(), np.asarray(jg[1]), what="d/dim")
    assert_no_launches()


@pytest.mark.parametrize("outer", [None, (2, 2 * 256), (8, 1 << 15)])
def test_grad_rows_transposed_matches_jax(outer, rng, assert_close):
    rows = 2 if outer is None else outer[0]
    re, im = planes(rng, rows, 256)
    wr, wi = planes(rng, 256, rows)

    def jloss(a, b):
        xr, xi = j_pf.fft_rows_transposed_split(a, b, -1, 1.0 / 256, outer=outer,
                                                interpret=True)
        return jnp.sum(xr * wr + xi * wi)

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    tre = torch.from_numpy(re).requires_grad_()
    tim = torch.from_numpy(im).requires_grad_()
    xr, xi = cuda_fft.fft_rows_transposed_split(tre, tim, -1, 1.0 / 256, outer=outer)
    (xr * torch.from_numpy(wr) + xi * torch.from_numpy(wi)).sum().backward()
    assert_close(tre.grad.numpy(), np.asarray(jg[0]), what="d/dre")
    assert_close(tim.grad.numpy(), np.asarray(jg[1]), what="d/dim")
    assert_no_launches()


def test_empty_batch():
    z = torch.zeros(0, 256, 4)
    assert cuda_fft.fft_axis0_split(z, z, -1)[0].shape == (0, 256, 4)
    zt = torch.zeros(0, 4, 256)
    assert cuda_fft.fft_rows_transposed_split(zt, zt, -1)[0].shape == (0, 256, 4)
