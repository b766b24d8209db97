"""Torch port, the composite-length kernels' mixed-radix passes (B13
``csrc/gen_fft.cu``, B14 ``csrc/r2c_gen_fft.cu`` and the composite axis(-2)
kernel B2c ``csrc/ax0_gen_fft.cu`` on ``csrc/mixed_fft.cuh``): the planner
over the whole envelope, and the passes' plain version
(``cuda_fft._mixed_radix``, ``_mixed_radix_real`` and
``_mixed_radix_axis``, which follow the kernels step by step) against the
JAX kernels (``pallas_fft.fft_rows_general_split``,
``rfft_rows_general_split`` and ``fft_axis0_split`` in interpret mode) and
float64 numpy.

Lengths: one for each pass type of the plan (powers of 2 with 3 and 5;
13^3, 7^4, 11^4, 5^6; the generic primes 251, 127, 43 and 17 * 241; 7 and 13
where 1024 threads hold more butterflies; R2C's half length 17 * 19 with
its generic pass last).  Tolerance: 1e-5 relative L2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_wgpu_tpu.ops import pallas_fft as j_pf
from fft_wgpu_tpu_torch.ops import cuda_fft

torch.set_num_threads(1)

SMALL = {2, 3, 4, 5, 7, 8, 9, 11, 13, 16}
NS = [1920, 3072, 12288, 2197, 2401, 14641, 15625, 1004, 16129, 16383, 4095, 4097,
      14406, 16224, 646]
SLOTS, MAX_THREADS = 8, 1024  # kGenericSlots, kMixMaxThreads of mixed_fft.cuh


def _is_prime(p):
    return p > 1 and all(p % d for d in range(2, int(p ** 0.5) + 1))


def _check_plan(n, plan):
    assert np.prod(plan, dtype=np.int64) == n, (n, plan)
    assert 2 <= len(plan) <= 16, (n, plan)
    generic = [r for r in plan if r not in SMALL]
    for i, r in enumerate(plan):
        if r not in SMALL:
            assert 17 <= r <= 251 and _is_prime(r), (n, plan)
            assert i in (0, len(plan) - 1), (n, plan)  # first or last pass
    assert len(generic) <= 2
    if len(generic) == 2:
        assert plan[0] <= plan[-1] and plan[0] in generic and plan[-1] in generic
    # every prime from 17 on is its own pass, smaller primes never are generic
    big = [p for p in range(17, 257) if n % p == 0 and _is_prime(p)]
    assert sorted(generic) == sorted(p for p in big for _ in range(_mult(n, p)))


def _mult(n, p):
    k = 0
    while n % p == 0:
        n //= p
        k += 1
    return k


def test_plan_covers_the_envelope():
    ns = [n for n in range(cuda_fft.GEN_MIN_N, cuda_fft.FUSED_MAX_N + 1)
          if cuda_fft._gen_supported(n)]
    assert len(ns) == 7573
    for n in ns:
        _check_plan(n, cuda_fft._mixed_radix_plan(n))
        if n % 2 == 0:
            # R2C's half-length plan; its last pass stays in shared memory,
            # so a generic prime there must fit one unit a thread
            plan = cuda_fft._mixed_radix_plan(n // 2)
            _check_plan(n // 2, plan)
            p = plan[-1]
            if p not in SMALL:
                units = n // 2 // p * -(-((p - 1) // 2 + 1) // SLOTS)
                assert units <= MAX_THREADS, (n, plan)


def test_plan_examples():
    assert cuda_fft._mixed_radix_plan(4095) == (9, 5, 7, 13)
    assert sorted(cuda_fft._mixed_radix_plan(1000)) == [5, 5, 5, 8]
    assert cuda_fft._mixed_radix_plan(1920) == (3, 5, 16, 8)
    assert cuda_fft._mixed_radix_plan(4097) == (17, 241)
    assert cuda_fft._mixed_radix_plan(16383) == (43, 3, 127)
    assert cuda_fft._mixed_radix_plan(12288) == (3, 16, 16, 16)
    for n in (1031 * 2, 17 ** 3):  # a prime > 256; three primes >= 17
        with pytest.raises(cuda_fft.Unsupported):
            cuda_fft._mixed_radix_plan(n)


def _np_fft(x, sign, scale):
    x = x.astype(np.complex128)
    y = np.fft.fft(x, axis=-1) if sign < 0 else np.fft.ifft(x, axis=-1) * x.shape[-1]
    return y * (1.0 if scale is None else scale)


@pytest.mark.parametrize("n", NS)
def test_mixed_radix_matches_jax_kernel_and_numpy(n, rng, assert_close):
    x = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))).astype(np.complex64)
    re, im = np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
    for sign, scale in ((-1, None), (1, None), (-1, 1.0 / n), (1, 1.0 / n)):
        yr, yi = cuda_fft._mixed_radix(torch.from_numpy(re), torch.from_numpy(im), sign,
                                       scale)
        got = yr.numpy() + 1j * yi.numpy()
        assert yr.dtype == torch.float32 and got.shape == (2, n)
        assert_close(got, _np_fft(x, sign, scale), what=f"numpy sign={sign} scale={scale}")
        jr, ji = j_pf.fft_rows_general_split(jnp.asarray(re), jnp.asarray(im), sign, scale,
                                             interpret=True)
        assert_close(got, np.asarray(jr) + 1j * np.asarray(ji),
                     what=f"jax sign={sign} scale={scale}")


@pytest.mark.parametrize("pad_out", [False, True])
@pytest.mark.parametrize("n", NS)
def test_mixed_radix_real_matches_jax_kernel_and_numpy(n, pad_out, rng, assert_close):
    x = rng.standard_normal((2, n)).astype(np.float32)
    mp = n // 2 + 1
    for scale in (None, 1.0 / n):
        Xr, Xi = cuda_fft._mixed_radix_real(torch.from_numpy(x), scale, pad_out)
        assert Xr.shape == (2, cuda_fft.pad_bins(n) if pad_out else mp)
        assert not Xr[:, mp:].any() and not Xi[:, mp:].any()  # exact zeros
        got = Xr.numpy() + 1j * Xi.numpy()
        want = np.fft.rfft(x.astype(np.float64), axis=-1) * (1.0 if scale is None else scale)
        assert_close(got[:, :mp], want, what=f"numpy scale={scale}")
        jr, ji = j_pf.rfft_rows_general_split(jnp.asarray(x), scale, pad_out=pad_out,
                                              interpret=True)
        assert_close(got, np.asarray(jr) + 1j * np.asarray(ji), what=f"jax scale={scale}")


@pytest.mark.parametrize("n", [1000, 1080, 4095, 4097, 16383])
def test_mixed_radix_axis_matches_jax_kernel_and_numpy(n, rng, assert_close):
    # B2c's plain version: the passes along axis -2 of [2, n, 7] (a leading
    # batch, a ragged m)
    shape = (2, n, 7)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    re, im = np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
    for sign, scale in ((-1, None), (1, None), (-1, 1.0 / n), (1, 1.0 / n)):
        yr, yi = cuda_fft._mixed_radix_axis(torch.from_numpy(re), torch.from_numpy(im), sign,
                                            scale)
        got = yr.numpy() + 1j * yi.numpy()
        assert yr.dtype == torch.float32 and got.shape == shape
        want = np.moveaxis(_np_fft(np.moveaxis(x, -2, -1), sign, scale), -1, -2)
        assert_close(got, want, tol=1e-6, what=f"numpy sign={sign} scale={scale}")
        jr, ji = j_pf.fft_axis0_split(jnp.asarray(re), jnp.asarray(im), sign, scale,
                                      interpret=True)
        assert_close(got, np.asarray(jr) + 1j * np.asarray(ji),
                     what=f"jax sign={sign} scale={scale}")
