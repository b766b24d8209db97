"""Spectral Poisson solver — the canonical FFT-framework application (torch
port of ``fft_wgpu_tpu.models.poisson``'s local solve).

Solves  laplacian(u) = f  on a periodic box via diagonalization in Fourier
space: u_hat = -f_hat / |k|^2 (zero-mean gauge), through the N-D R2C/C2R
pair ``rfftn`` / ``irfftn``.  The distributed pencil solve waits for the
port of ``parallel/``.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ..core.complex_utils import host_table, to_device
from ..ops.rfft import irfftn, rfftn

__all__ = ["solve_poisson"]


def _ksq_grids(shape, lengths):
    """|k|^2 grid for an rfftn-shaped spectrum of a real field."""
    *rest, last = shape
    ks = []
    for n, L in zip(rest, lengths[:-1]):
        ks.append((2 * np.pi / L) * np.fft.fftfreq(n) * n)
    ks.append((2 * np.pi / lengths[-1]) * np.arange(last // 2 + 1))
    grids = np.meshgrid(*ks, indexing="ij")
    ksq = sum(g**2 for g in grids).astype(np.float32)
    ksq[(0,) * len(shape)] = 1.0  # avoid div-by-zero at the DC mode
    return ksq


@functools.lru_cache(maxsize=16)
def _tables(shape, lengths, device):
    """|k|^2 and the zero-mean mask (DC killed) of an rfftn spectrum, as
    float32 tensors on ``device``, built once per (shape, lengths, device)."""
    spec_shape = shape[:-1] + (shape[-1] // 2 + 1,)
    mask = np.ones(spec_shape, np.float32)
    mask[(0,) * len(shape)] = 0.0  # zero-mean gauge: kill the DC mode
    return host_table(_ksq_grids(shape, lengths), device), host_table(mask, device)


def solve_poisson(f, lengths=None):
    """u with laplacian(u) = f (periodic, zero-mean).  f: real [..grid..];
    a tensor is solved on its own device, other input on the current CUDA
    device."""
    f = to_device(f)
    shape = tuple(f.shape)
    lengths = tuple(lengths or (2 * math.pi,) * f.ndim)
    ksq, mask = _tables(shape, lengths, f.device)
    F = rfftn(f)
    U = -F / ksq * mask
    return irfftn(U, s=shape)
