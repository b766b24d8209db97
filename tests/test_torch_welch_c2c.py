"""Torch port, B21's kernel design on the CPU: the kind ``c2c`` of
``test_acc_passes_match_jax`` (``cuda_welch._acc_passes``: one complex
frame a segment) from each of its three sources (complex64, planes, a real
signal with no imaginary plane), against the JAX kernel in interpret mode
(the JAX composed form outside its envelope), float64 numpy and the entry
point, at nfft 128..4096 and ``test_torch_welch.py``'s frame layouts.

These cases take 22-29 s each at nfft 4096 (the JAX kernel in interpret
mode), so they have a file of their own, which the test run's
``--dist loadfile`` gives a worker of its own; the other kinds stay in
``test_torch_welch.py``, whose inputs and references this file imports.
Tolerance: 1e-5 relative L2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_wgpu_tpu.ops import pallas_welch as j_pw
from fft_wgpu_tpu.ops import spectral_est as j_se
from fft_wgpu_tpu_torch.ops import cuda_welch
from test_torch_welch import ACC_CASES, ACC_FRAMES, _np, _t, inputs, numpy_c2c

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ACC_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("nfft", [1 << e for e in range(7, 13)])
@pytest.mark.parametrize("kind", ["c2c"])
def test_acc_passes_match_jax(kind, nfft, case, rng, assert_close):
    layout, lead, num, detrend = case
    nperseg, hop = ACC_FRAMES[layout](nfft)
    t = nperseg + (num - 1) * hop + hop // 3
    x, y, win = inputs(rng, lead, t, nperseg)
    _check_c2c_passes(x, y, win, (nperseg, hop, nfft, detrend), num, assert_close)


def _check_c2c_passes(re, im, win, args, num, assert_close):
    """B21's kernel design from each of its sources (complex64, planes, a
    real signal with no imaginary plane) against the JAX kernel in
    interpret mode (the JAX composed form outside its envelope, and for
    the real source, JAX's with a zero imaginary plane), float64 numpy and
    the entry point."""
    def jax_composed(v_im):
        Xr, Xi = j_se._spec_segments_split(jnp.asarray(re), jnp.asarray(v_im),
                                           jnp.asarray(win), *args)
        return np.asarray(jnp.sum(Xr * Xr + Xi * Xi, axis=-2))

    if j_pw.fused_welch_ok(re.shape[-1], *args, c2c=True):
        want, wnum = j_pw.welch_accum_c2c_split(re, im, win, *args, interpret=True)
        want = np.asarray(want)
        assert wnum == num
    else:
        want = jax_composed(im)
    zero = np.zeros_like(re)
    for source, x, y, jax_want, v_im in (
            ("c64", _t(re + 1j * im), None, want, im), ("planes", _t(re), _t(im), want, im),
            ("real", _t(re), None, jax_composed(zero), zero)):
        (got,) = cuda_welch._acc_passes("c2c", x, y, _t(win), *args)
        what = f"c2c one complex frame a transform, {source}"
        assert got.shape == (*re.shape[:-1], args[2]) and got.dtype == torch.float32
        assert_close(_np(got), jax_want, what=f"{what} vs JAX")
        assert_close(_np(got), numpy_c2c(re, v_im, win, *args)[0], what=f"{what} vs numpy")
        # on the CPU the entry point is the composed form, which the
        # kernel's epilogue equals
        entry, enum = cuda_welch.welch_accum_c2c_c64(x, _t(win), *args, im=y)
        assert enum == num
        assert_close(_np(got), _np(entry), what=f"{what} vs the entry point")

