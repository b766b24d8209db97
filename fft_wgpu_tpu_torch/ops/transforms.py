"""Functional FFT API (numpy.fft-compatible surface over the plan layer).

Module-level `fft`/`ifft` etc. pull a cached
:class:`~fft_wgpu_tpu_torch.plan.plan.Plan` and execute it — "plan once,
run many", as in ``fft_wgpu_tpu.ops.transforms``.

`norm` follows numpy.fft: None/"backward" (ifft scales 1/N), "ortho"
(1/sqrt(N) both ways), "forward".
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.complex_utils import merge, promote_to_split
from ..core.twiddle import FORWARD, INVERSE
from ..plan.plan import get_plan

__all__ = ["fft", "ifft", "ifft_unnormalized", "normalize"]


def _length(x, axis: int) -> int:
    return (x.shape if isinstance(x, torch.Tensor) else np.shape(x))[axis]


def _norm_scales(n: int, norm):
    if norm in (None, "backward"):
        return None, 1.0 / n
    if norm == "ortho":
        s = 1.0 / math.sqrt(n)
        return s, s
    if norm == "forward":
        return 1.0 / n, None
    raise ValueError(f"invalid norm {norm!r}")


def _run_1d(x, n, axis, sign, scale, executor):
    if n is None or n == _length(x, axis):  # a complex64 CUDA tensor: no split
        y = get_plan(_length(x, axis), executor)._execute_c64(x, axis, sign, scale)
        if y is not None:
            return y
    re, im = promote_to_split(x)
    if n is not None and re.shape[axis] != n:
        re, im = _pad_or_trim(re, im, n, axis)
    p = get_plan(re.shape[axis], executor)
    return merge(*p._execute_split_axis(re, im, sign, scale, axis))


def _resize_axis(a, n, axis):
    """``a`` trimmed or zero-padded to length n along ``axis``."""
    cur = a.shape[axis]
    if cur > n:
        return a.narrow(axis, 0, n)
    shape = list(a.shape)
    shape[axis] = n - cur
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _pad_or_trim(re, im, n, axis):
    return _resize_axis(re, n, axis), _resize_axis(im, n, axis)


def _positive(length: int) -> int:
    """``length``; a length below 1 raises ``ValueError``, as numpy.fft
    does.  Every entry point checks its output lengths with it before it
    forms a scale, picks a route or launches a kernel."""
    if length < 1:
        raise ValueError(f"fft length must be >= 1, got {length}")
    return length


def _checked_length(x, n, axis: int) -> int:
    """The transform's length: ``n``, or the length of ``axis``, checked by
    :func:`_positive`."""
    return _positive(_length(x, axis) if n is None else n)


def fft(x, n=None, axis: int = -1, norm=None, *, executor: str = "auto"):
    """1-D C2C forward FFT along `axis` (reference Forward)."""
    fscale, _ = _norm_scales(_checked_length(x, n, axis), norm)
    return _run_1d(x, n, axis, FORWARD, fscale, executor)


def ifft(x, n=None, axis: int = -1, norm=None, *, executor: str = "auto"):
    """1-D C2C inverse FFT, scaled per `norm` (reference Inverse with fused
    1/N)."""
    _, iscale = _norm_scales(_checked_length(x, n, axis), norm)
    return _run_1d(x, n, axis, INVERSE, iscale, executor)


def ifft_unnormalized(x, n=None, axis: int = -1, *, executor: str = "auto"):
    """Unnormalized inverse FFT (reference Onlyinverse).  Compose with
    :func:`normalize` for the reference's two-pass inverse."""
    _checked_length(x, n, axis)
    return _run_1d(x, n, axis, INVERSE, None, executor)


def normalize(x, n=None, axis: int = -1):
    """Standalone 1/N scale (reference Normalize)."""
    length = n if n is not None else _length(x, axis)
    return get_plan(length, "auto").normalize(x, axis=axis)
