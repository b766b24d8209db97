"""scipy.ndimage-parity Fourier-domain filters (torch port of
``fft_wgpu_tpu.ops.fourier_filters``).

Multiplicative filters applied to an already-transformed array
(scipy.ndimage.fourier_* semantics): `input` holds the FFT of an image;
`n=-1` means a full complex FFT along `axis`, `n>=0` the R2C half
spectrum of a length-n signal on `axis`.  The multipliers are built on the
host in float64, cast once to float32 (complex64 for the shift's phase
ramp) and uploaded once per shape, parameters and device; a call is one
product on the spectrum's device and launches no FFT of its own.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.complex_utils import host_table, is_pair, merge, promote_to_split
from .helpers import _tensor

__all__ = ["fourier_shift", "fourier_gaussian", "fourier_uniform",
           "fourier_ellipsoid"]


def _spectrum(x) -> torch.Tensor:
    """``x`` as a complex64 tensor: a tensor on its device, an (re, im)
    pair merged, anything else on the current CUDA device."""
    return merge(*promote_to_split(x)) if is_pair(x) else _tensor(x).to(torch.complex64)


def _freqs(shape, n, axis):
    """Per-axis frequency grids (cycles/sample, f64): fftfreq everywhere,
    rfft bins on `axis` when n >= 0 (scipy conventions)."""
    rank = len(shape)
    axis = axis % rank
    out = []
    for ax in range(rank):
        m = shape[ax]
        if n >= 0 and ax == axis:
            f = np.arange(m, dtype=np.float64) / n
        else:
            f = np.fft.fftfreq(m)
        out.append(f)
    return out


def _norm_sizes(val, rank, what):
    arr = np.asarray(val, np.float64)
    if arr.ndim == 0:
        arr = np.full(rank, float(arr))
    if arr.shape != (rank,):
        raise ValueError(f"{what} must be a scalar or length-{rank}")
    return tuple(arr.tolist())


def _separable(shape, per_axis_vals):
    mult = np.ones(shape, np.float64)
    for ax, vals in enumerate(per_axis_vals):
        sh = [1] * len(shape)
        sh[ax] = len(vals)
        mult = mult * vals.reshape(sh)
    return mult


def _axis_sum(shape, per_axis_vals):
    """sum over axes of each axis's values broadcast along it (f64)."""
    total = np.zeros(shape, np.float64)
    for ax, vals in enumerate(per_axis_vals):
        sh = [1] * len(shape)
        sh[ax] = len(vals)
        total = total + vals.reshape(sh)
    return total


@functools.lru_cache(maxsize=8)
def _multiplier(kind, shape, params, n, axis, device):
    """The float32 multiplier of ``kind`` (complex64 for "shift") on
    ``device``, from float64 host tables."""
    freqs = _freqs(shape, n, axis)
    if kind == "gaussian":
        return host_table(_separable(shape, [np.exp(-2.0 * (np.pi * s * f) ** 2)
                                             for s, f in zip(params, freqs)]), device)
    if kind == "uniform":
        return host_table(_separable(shape, [np.sinc(s * f)
                                             for s, f in zip(params, freqs)]), device)
    if kind == "shift":
        ph = _axis_sum(shape, [-2.0 * np.pi * s * f for s, f in zip(params, freqs)])
        return host_table(np.cos(ph) + 1j * np.sin(ph), device, np.complex64)
    rank = len(shape)  # "ellipsoid"
    r2 = _axis_sum(shape, [(s * f) ** 2 for s, f in zip(params, freqs)])
    arg = np.pi * np.sqrt(r2)
    safe = np.maximum(arg, 1e-300)
    with np.errstate(invalid="ignore", divide="ignore"):
        if rank == 1:
            mult = np.where(arg == 0, 1.0, np.sin(safe) / safe)
        elif rank == 2:
            from scipy.special import j1

            mult = np.where(arg == 0, 1.0, 2.0 * j1(safe) / safe)
        else:
            mult = np.where(
                arg == 0, 1.0,
                3.0 * (np.sin(safe) / safe ** 3 - np.cos(safe) / safe ** 2))
    return host_table(mult, device)


def _apply(kind, input, params, what, n, axis):
    x = _spectrum(input)
    sizes = _norm_sizes(params, x.ndim, what)
    return x * _multiplier(kind, tuple(x.shape), sizes, int(n), int(axis), x.device)


def fourier_gaussian(input, sigma, n: int = -1, axis: int = -1):
    """Multiply the transform by a Gaussian kernel's transform
    (scipy.ndimage.fourier_gaussian parity)."""
    return _apply("gaussian", input, sigma, "sigma", n, axis)


def fourier_uniform(input, size, n: int = -1, axis: int = -1):
    """Multiply the transform by a uniform (box) kernel's transform
    (scipy.ndimage.fourier_uniform parity)."""
    return _apply("uniform", input, size, "size", n, axis)


def fourier_shift(input, shift, n: int = -1, axis: int = -1):
    """Multiply the transform by the phase ramp of a real-space shift
    (scipy.ndimage.fourier_shift parity)."""
    return _apply("shift", input, shift, "shift", n, axis)


def fourier_ellipsoid(input, size, n: int = -1, axis: int = -1):
    """Multiply the transform by an ellipsoid kernel's transform
    (scipy.ndimage.fourier_ellipsoid parity; 1-D box, 2-D disk via the
    jinc, 3-D sphere — scipy supports rank <= 3)."""
    x = _spectrum(input)
    if x.ndim > 3:
        raise ValueError("fourier_ellipsoid supports rank <= 3 (scipy)")
    sizes = _norm_sizes(size, x.ndim, "size")
    return x * _multiplier("ellipsoid", tuple(x.shape), sizes, int(n), int(axis), x.device)
