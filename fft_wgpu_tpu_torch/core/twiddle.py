"""Twiddle-factor and DFT-matrix generation (numpy only).

Every trigonometric table is generated in float64 and cast to float32
once, as in ``fft_wgpu_tpu.core.twiddle``.  The JAX package builds its f64
tables in a native C++ helper (``native/src/fftcore.cpp``); this port
computes the same angles in numpy, with the same integer angle reduction,
so the two packages produce identical f32 tables for the same (n, sign).

Conventions
-----------
* ``sign = -1`` is the forward transform (``exp(-2*pi*i*k*n/N)``),
  ``sign = +1`` the inverse — matching numpy.fft.
* DFT matrix ``W[k, m] = exp(sign * 2*pi*i * k * m / n)`` is symmetric,
  so ``x @ W`` transforms the last axis.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["dft_matrix_np", "twiddle_np", "roots_np", "halfcomplex_twiddle_np",
           "FORWARD", "INVERSE"]

FORWARD = -1
INVERSE = +1


@functools.lru_cache(maxsize=None)
def dft_matrix_np(n: int, sign: int, dtype=np.float32):
    """(Wr, Wi) numpy arrays of shape [n, n]; W[k, m] = exp(sign*2pi*i*k*m/n).

    The angle is reduced as (k*m) mod n in integers before scaling, as the
    JAX package's native generator does, so large products lose no bits.
    """
    k = np.arange(n, dtype=np.int64)
    theta = (sign * 2.0 * np.pi / n) * (np.outer(k, k) % n).astype(np.float64)
    return (np.ascontiguousarray(np.cos(theta), dtype=dtype),
            np.ascontiguousarray(np.sin(theta), dtype=dtype))


@functools.lru_cache(maxsize=None)
def twiddle_np(n1: int, n2: int, sign: int, transposed: bool = False, dtype=np.float32):
    """Four-step inter-factor twiddles ``tw[k1, n2] = exp(sign*2pi*i*k1*n2/(n1*n2))``.

    ``transposed=True`` returns the [n2, k1] layout.
    """
    n = n1 * n2
    k1 = np.arange(n1, dtype=np.float64)
    m2 = np.arange(n2, dtype=np.float64)
    theta = (sign * 2.0 * np.pi / n) * np.outer(k1, m2)
    twr, twi = np.cos(theta), np.sin(theta)
    if transposed:
        twr, twi = twr.T, twi.T
    return np.ascontiguousarray(twr, dtype=dtype), np.ascontiguousarray(twi, dtype=dtype)


@functools.lru_cache(maxsize=None)
def roots_np(n: int, sign: int, dtype=np.float32):
    """The n-th roots of unity ``w[m] = exp(sign*2pi*i*m/n)``, m = 0..n-1.

    This is row 1 of :func:`dft_matrix_np` without building the matrix:
    the per-(n, sign) table the row kernel reads its pass twiddles from.
    """
    theta = (sign * 2.0 * np.pi / n) * np.arange(n, dtype=np.float64)
    return np.cos(theta).astype(dtype), np.sin(theta).astype(dtype)


@functools.lru_cache(maxsize=None)
def halfcomplex_twiddle_np(n: int, sign: int, dtype=np.float32):
    """Twiddles exp(sign*2pi*i*k/n) for k = 0..n/2 (R2C/C2R recombination)."""
    m = n // 2
    k = np.arange(m + 1, dtype=np.float64)
    theta = (sign * 2.0 * np.pi / n) * k
    return (np.cos(theta).astype(dtype), np.sin(theta).astype(dtype))
