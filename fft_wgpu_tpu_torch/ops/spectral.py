"""Spectral calculus: derivatives of periodic fields via the FFT (torch
port of ``fft_wgpu_tpu.ops.spectral``).

d/dx is a multiply by i*k in Fourier space.  Real fields ride the real
transforms: ``rfft`` and ``irfft`` along one axis (on the card, for pow2
n, the R2C kernel's complex64 sink and the C2R kernel's complex64 source:
one launch each, no split and no merge), ``rfftn`` and ``irfftn`` for the
Laplacian.  The wavenumber tables are built in float64 on the host and
uploaded once per shape and device.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ..core.complex_utils import host_table, real_part
from .rfft import irfft, irfftn, rfft, rfftn

__all__ = ["spectral_derivative", "spectral_gradient", "spectral_laplacian"]


def _k_last(n: int, length: float):
    """rfft wavenumbers of n points over ``length`` (float64)."""
    return (2.0 * np.pi / length) * np.arange(n // 2 + 1, dtype=np.float64)


def _k_full(n: int, length: float):
    """fft wavenumbers of n points over ``length`` (float64)."""
    return (2.0 * np.pi / length) * np.fft.fftfreq(n).astype(np.float64) * n


@functools.lru_cache(maxsize=64)
def _ik_power(n: int, order: int, length: float, device):
    """(i k)^order on the rfft bins, from float32 wavenumbers as the JAX
    package takes them, raised in complex128 and cast once to complex64."""
    k = _k_last(n, length).astype(np.float32).astype(np.float64)
    return host_table((1j * k) ** order, device, np.complex64)


@functools.lru_cache(maxsize=8)
def _minus_ksq(shape: tuple, lengths: tuple, device):
    """-|k|^2 on the rfftn grid of ``shape``, as float32."""
    ks = [_k_full(n, L).astype(np.float32).astype(np.float64)
          for n, L in zip(shape[:-1], lengths[:-1])]
    ks.append(_k_last(shape[-1], lengths[-1]).astype(np.float32).astype(np.float64))
    grids = np.meshgrid(*ks, indexing="ij")
    return host_table(-sum(g**2 for g in grids), device)


def spectral_derivative(f, order: int = 1, axis: int = -1, length: float = 2 * math.pi):
    """order-th derivative of a real periodic field along `axis`."""
    f = real_part(f)
    n = f.shape[axis]
    ik = _ik_power(n, order, float(length), f.device)
    ik = ik.reshape((-1,) + (1,) * (f.ndim - 1 - axis % f.ndim))
    return irfft(rfft(f, axis=axis) * ik, n=n, axis=axis)


def spectral_gradient(f, lengths=None):
    """Tuple of first derivatives of a real periodic field along each axis."""
    f = real_part(f)
    lengths = lengths or (2 * math.pi,) * f.ndim
    return tuple(
        spectral_derivative(f, order=1, axis=ax, length=lengths[ax])
        for ax in range(f.ndim)
    )


def spectral_laplacian(f, lengths=None):
    """Laplacian of a real periodic field (sum of -|k|^2 in Fourier space,
    done in one rfftn/irfftn round trip)."""
    f = real_part(f)
    lengths = tuple(float(L) for L in (lengths or (2 * math.pi,) * f.ndim))
    shape = tuple(f.shape)
    return irfftn(rfftn(f) * _minus_ksq(shape, lengths, f.device), s=shape)
