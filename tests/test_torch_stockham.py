"""Torch port, mixed-radix path (ops/stockham.py) against the JAX package.

The same numpy inputs go through ``fft_wgpu_tpu.ops.stockham`` (XLA on
CPU) and the port.  Tolerance: 1e-5 relative L2 (the ``assert_close``
fixture), the repo's oracle bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_wgpu_tpu.ops import stockham as j_st
from fft_wgpu_tpu_torch.ops import stockham as t_st

torch.set_num_threads(1)


def _pair(rng, *shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _c(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _t(pair):
    return tuple(torch.from_numpy(a) for a in pair)


@pytest.mark.parametrize("n", [1, 8, 120, 128, 262, 1000, 4096])
@pytest.mark.parametrize("sign", [-1, 1])
def test_fft_last_axis_matches_jax(n, sign, rng, assert_close):
    re, im = _pair(rng, 3, n)
    got = _c(t_st.fft_last_axis(*_t((re, im)), sign))
    want = _c(j_st.fft_last_axis(re, im, sign))
    assert_close(got, want)
    ref = np.fft.fft(re + 1j * im) if sign < 0 else np.fft.ifft(re + 1j * im) * n
    assert_close(got, ref)


@pytest.mark.parametrize("n", [16, 100])
@pytest.mark.parametrize("sign", [-1, 1])
def test_dft_direct_matches_jax(n, sign, rng, assert_close):
    re, im = _pair(rng, 2, 3, n)
    got = _c(t_st._dft_direct(*_t((re, im)), sign))
    want = _c(j_st._dft_direct(re, im, sign))
    assert_close(got, want)


@pytest.mark.parametrize("scale", [None, 1.0, 0.25, 1.0 / 3])
def test_apply_scale_matches_jax(scale, rng):
    re, im = _pair(rng, 4, 8)
    got = t_st.apply_scale(*_t((re, im)), scale)
    want = j_st.apply_scale(re, im, scale)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_non_contiguous_rows(rng, assert_close):
    re, im = _pair(rng, 256, 6)
    tre, tim = _t((re, im))
    got = _c(t_st.fft_last_axis(tre.T, tim.T, -1))
    assert_close(got, np.fft.fft(re.T + 1j * im.T))


@pytest.mark.parametrize("n", [514, 1031, 2 * 131 * 3])
def test_bluestein_lengths_raise(n, rng, assert_close):
    # a prime factor > MAX_DIRECT at n >= BLUESTEIN_MIN needs Bluestein:
    # these lengths raised NotImplementedError until Bluestein was ported;
    # now they raise nothing and match the JAX package's Bluestein
    assert n >= t_st.BLUESTEIN_MIN
    re, im = (rng.standard_normal((2, n)).astype(np.float32) for _ in range(2))
    for sign in (-1, 1):
        tr, ti = t_st.fft_last_axis(torch.from_numpy(re), torch.from_numpy(im), sign)
        jr, ji = j_st.fft_last_axis(jnp.asarray(re), jnp.asarray(im), sign)
        assert_close(tr.numpy() + 1j * ti.numpy(), np.asarray(jr) + 1j * np.asarray(ji))


def test_bluestein_min_matches_jax():
    from fft_wgpu_tpu.ops.bluestein import BLUESTEIN_MIN

    assert t_st.BLUESTEIN_MIN == BLUESTEIN_MIN


@pytest.mark.parametrize("tf32", [False, True])
def test_cmatmul_leaves_tf32_setting(tf32, rng, assert_close):
    # the products run in full float32 and leave the caller's TF32 setting
    # as they found it (a CPU tensor never touches it; the card's half of
    # this check is in tests/test_torch_cuda.py)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        ar, ai, wr, wi = (torch.from_numpy(a) for a in (*_pair(rng, 3, 8), *_pair(rng, 8, 5)))
        yr, yi = t_st._cmatmul(ar, ai, wr, wi)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        with t_st.full_float32(ar):
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    want = (ar.numpy() + 1j * ai.numpy()) @ (wr.numpy() + 1j * wi.numpy())
    assert_close(yr.numpy() + 1j * yi.numpy(), want)
