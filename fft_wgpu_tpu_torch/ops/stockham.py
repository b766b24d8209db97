"""Mixed-radix FFT core in plain torch (the ``"xla"`` executor of the plan).

Port of ``fft_wgpu_tpu.ops.stockham``: a recursive four-step (Cooley-Tukey)
decomposition whose base cases are direct DFT matmuls, with natural-order
output and no bit-reversal pass.

Math (one level), for n = n1*n2, x row-major viewed as A[n1, n2]:
    B[k1, n2] = DFT_n1 over axis 0 of A
    C[k1, n2] = B * tw,  tw[k1, n2] = exp(sign*2pi*i*k1*n2/n)
    D[k1, k2] = DFT_n2 over axis 1 of C
    X[k1 + n1*k2] = D[k1, k2]    (i.e. flatten of D transposed)

Everything operates on split (re, im) float32 tensors on whatever device
they lie on; the transform axis is always the last one.  The matmuls run
in full float32: on a CUDA device TF32 is switched off around each one
(:func:`full_float32`, which restores the caller's setting), because TF32
keeps about three decimal digits and misses the 1e-5 relative-L2 bar;
``set_dot_precision("fast")`` switches it on there instead.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core import factor as _factor
from ..core import twiddle as _tw
from ..utils import precision as _precision

__all__ = ["fft_last_axis", "apply_scale", "full_float32", "BLUESTEIN_MIN"]

# Non-smooth lengths from this size on take Bluestein (as
# fft_wgpu_tpu.ops.bluestein.BLUESTEIN_MIN); below it the direct DFT serves.
BLUESTEIN_MIN = 512

# Device copies of the f64-generated tables, keyed by (table, args, device).
_TABLES: dict = {}


def _const(kind: str, args: tuple, device):
    key = (kind, args, str(device))
    pair = _TABLES.get(key)
    if pair is None:
        wr, wi = getattr(_tw, kind)(*args)
        pair = (torch.from_numpy(wr).to(device), torch.from_numpy(wi).to(device))
        _TABLES[key] = pair
    return pair


@contextlib.contextmanager
def full_float32(t):
    """Matmuls on ``t``'s device in full float32 inside the block: on a CUDA
    tensor TF32 is off there (it would cut a product to ~1e-3 relative
    error), or on under ``set_dot_precision("fast")`` (the mode read here,
    ``utils/precision.py``), and the caller's setting is restored after it;
    the CPU has no TF32, so a CPU tensor leaves the setting alone."""
    if not t.is_cuda:
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = _precision.get_dot_precision() == "fast"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _cmatmul(ar, ai, wr, wi):
    """(ar + i*ai) @ (wr + i*wi) in full float32."""
    with full_float32(ar):
        return ar @ wr - ai @ wi, ar @ wi + ai @ wr


def _dft_direct(re, im, sign):
    """Direct DFT over the last axis via one (complex) matmul: y = x @ W."""
    n = re.shape[-1]
    wr, wi = _const("dft_matrix_np", (n, sign), re.device)
    return _cmatmul(re, im, wr, wi)


def fft_last_axis(re, im, sign, scale=None):
    """DFT over the last axis of a split (re, im) pair, times ``scale``.

    A length with a prime factor above ``MAX_DIRECT`` from ``BLUESTEIN_MIN``
    on goes to Bluestein, which folds the scale into its last pass (on a
    CUDA tensor the chirp passes); any other length runs the mixed-radix
    recursion."""
    n = re.shape[-1]
    if n >= BLUESTEIN_MIN and not _factor.is_smooth(n):
        # imported here: bluestein's kernels import this module
        from . import bluestein

        return bluestein.fft_bluestein_split(re, im, sign, scale)
    return apply_scale(*_mixed_radix(re, im, sign), scale)


def _mixed_radix(re, im, sign):
    """Mixed-radix DFT over the last axis of a split (re, im) pair: the
    two-factor recursion for a smooth length, one direct DFT matmul at its
    leaves and for a non-smooth length below BLUESTEIN_MIN."""
    n = re.shape[-1]
    if n == 1:
        return re, im
    if n <= _factor.MAX_DIRECT or not _factor.is_smooth(n):
        return _dft_direct(re, im, sign)

    n1, n2 = _factor.balanced_split(n)
    lead = re.shape[:-1]
    re = re.reshape(*lead, n1, n2)
    im = im.reshape(*lead, n1, n2)

    # DFT over n1 (axis -2): transpose so it becomes the last axis.
    br, bi = _mixed_radix(re.transpose(-1, -2), im.transpose(-1, -2), sign)

    # Twiddle in the transposed layout: tw^T[n2, k1].
    twr, twi = _const("twiddle_np", (n1, n2, sign, True), re.device)
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr

    # Back to [..., k1, n2]; DFT over n2 (last axis).
    dr, di = _mixed_radix(cr.transpose(-1, -2), ci.transpose(-1, -2), sign)

    # Natural-order output: X viewed as [k2, k1] and flattened.
    return (dr.transpose(-1, -2).reshape(*lead, n),
            di.transpose(-1, -2).reshape(*lead, n))


def apply_scale(re, im, scale):
    if scale is None or scale == 1.0:
        return re, im
    s = float(np.float32(scale))
    return re * s, im * s
