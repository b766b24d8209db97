"""Chebyshev spectral methods on the DCT-I path (torch port of
``fft_wgpu_tpu.ops.chebyshev``): transforms between values on
Chebyshev-Gauss-Lobatto points and Chebyshev coefficients, spectral
differentiation, and Clenshaw-Curtis quadrature.

Values at x_j = cos(pi j / n), j = 0..n, relate to Chebyshev coefficients
through a DCT-I (``ops/dct.py``: the R2C route of the even extension, the
R2C kernel on the card for n a power of two).  The derivative recurrence
is one matmul with a float64 host table cast once to float32 and uploaded
once per length and device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.complex_utils import default_device, host_table, real_part
from .dct import dct

__all__ = ["cheb_points", "cheb_coeffs", "cheb_values", "cheb_derivative",
           "clenshaw_curtis_weights", "cheb_integrate"]


def cheb_points(n: int, dtype=np.float32, *, device=None):
    """The n+1 Chebyshev-Gauss-Lobatto points x_j = cos(pi j / n),
    j = 0..n, in the standard descending order (x_0 = 1, x_n = -1), on
    ``device`` (the current CUDA device by default)."""
    if n < 1:
        raise ValueError("n must be >= 1")
    return host_table(np.cos(np.pi * np.arange(n + 1) / n), device or default_device(),
                      dtype)


@functools.lru_cache(maxsize=None)
def _ends(n: int, value: float, device):
    """[value, 1, ..., 1, value] of n + 1 points."""
    e = np.ones(n + 1)
    e[0] = e[-1] = value
    return host_table(e, device)


def cheb_coeffs(u, axis: int = -1):
    """Chebyshev coefficients a_k of values u at cheb_points(n) along
    `axis` (u has n+1 samples): u(x) = sum_k a_k T_k(x).

    Computed as a scaled DCT-I of the sample values.
    """
    u = real_part(u).movedim(axis, -1)
    n = u.shape[-1] - 1
    if n < 1:
        raise ValueError("need at least 2 samples")
    a = dct(u, type=1, axis=-1) / n
    return (a * _ends(n, 0.5, a.device)).movedim(-1, axis)


def cheb_values(a, axis: int = -1):
    """Inverse of cheb_coeffs: evaluate the Chebyshev series with
    coefficients `a` at the n+1 Chebyshev points (DCT-I synthesis)."""
    a = real_part(a).movedim(axis, -1)
    n = a.shape[-1] - 1
    u = dct(a * _ends(n, 2.0, a.device), type=1, axis=-1) * 0.5
    return u.movedim(-1, axis)


@functools.lru_cache(maxsize=8)
def _der_table(n: int, device):
    """The transposed derivative matrix: b = a @ table with
    b_k = sum_{j >= k+1, j-k odd} 2 j a_j, halved at k = 0 (the recurrence
    b_k = b_{k+2} + 2 (k+1) a_{k+1} in closed form), float64 on the host."""
    k = np.arange(n + 1)
    j = np.arange(n + 1)
    M = ((j[None, :] > k[:, None]) & (((j[None, :] - k[:, None]) % 2) == 1)
         ).astype(np.float64) * (2.0 * j[None, :])
    M[0, :] *= 0.5
    return host_table(M.T, device)


def _der_coeffs(a):
    """The coefficients of the derivative of the series ``a`` (last axis)."""
    return a @ _der_table(a.shape[-1] - 1, a.device)


def cheb_derivative(u, order: int = 1, axis: int = -1,
                    interval=(-1.0, 1.0)):
    """Spectral derivative of values `u` sampled at the n+1 Chebyshev
    points of `interval`, returned at the same points.

    Transforms to coefficient space (DCT-I), applies the derivative
    recurrence `order` times, and transforms back; the affine map from
    [-1, 1] to `interval` contributes (2/(b-a))^order.
    """
    if order < 1:
        raise ValueError("order must be >= 1")
    a, b = map(float, interval)
    scale = (2.0 / (b - a)) ** order
    c = cheb_coeffs(real_part(u).movedim(axis, -1), axis=-1)
    for _ in range(order):
        c = _der_coeffs(c)
    return (cheb_values(c, axis=-1) * scale).movedim(-1, axis)


def clenshaw_curtis_weights(n: int, interval=(-1.0, 1.0), *, device=None):
    """Clenshaw-Curtis quadrature weights for the n+1 Chebyshev points
    on `interval` (float64 on the host, Trefethen's ``clencurt``), on
    ``device`` (the current CUDA device by default)."""
    if n < 1:
        raise ValueError("n must be >= 1")
    a, b = map(float, interval)
    theta = np.pi * np.arange(n + 1) / n
    w = np.zeros(n + 1)
    ii = np.arange(1, n)
    v = np.ones(n - 1)
    if n % 2 == 0:
        w[0] = w[n] = 1.0 / (n * n - 1)
        for k in range(1, n // 2):
            v -= 2.0 * np.cos(2.0 * k * theta[ii]) / (4.0 * k * k - 1)
        v -= np.cos(n * theta[ii]) / (n * n - 1)
    else:
        w[0] = w[n] = 1.0 / (n * n)
        for k in range(1, (n - 1) // 2 + 1):
            v -= 2.0 * np.cos(2.0 * k * theta[ii]) / (4.0 * k * k - 1)
    w[ii] = 2.0 * v / n
    return host_table((b - a) / 2.0 * w, device or default_device())


def cheb_integrate(u, axis: int = -1, interval=(-1.0, 1.0)):
    """Clenshaw-Curtis integral of values `u` at the n+1 Chebyshev
    points of `interval` along `axis` (spectrally accurate for smooth
    integrands)."""
    u = real_part(u)
    w = clenshaw_curtis_weights(u.shape[axis] - 1, interval, device=u.device)
    return torch.tensordot(u, w, dims=([axis % u.ndim], [0]))
