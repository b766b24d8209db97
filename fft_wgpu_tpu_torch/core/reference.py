"""Naive O(N^2) DFT oracle (numpy, float64).

Role: the trusted, obviously-correct reference the test suite checks the
framework against — the counterpart of the reference repo's rustfft oracle
(fft_wgpu examples/basic_inverse.rs:217-253).  Deliberately slow and simple.
"""

from __future__ import annotations

import numpy as np

__all__ = ["naive_dft", "naive_idft"]


def naive_dft(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Forward DFT along `axis` by direct summation in complex128."""
    x = np.asarray(x, dtype=np.complex128)
    x = np.moveaxis(x, axis, -1)
    n = x.shape[-1]
    k = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(k, k) / n)
    y = x @ w.T
    return np.moveaxis(y, -1, axis)


def naive_idft(x: np.ndarray, axis: int = -1, normalize: bool = True) -> np.ndarray:
    """Inverse DFT along `axis`; `normalize=False` skips the 1/N scale
    (the reference's `Onlyinverse` semantics, src/processor.rs:566-670)."""
    x = np.asarray(x, dtype=np.complex128)
    x = np.moveaxis(x, axis, -1)
    n = x.shape[-1]
    k = np.arange(n)
    w = np.exp(+2j * np.pi * np.outer(k, k) / n)
    y = x @ w.T
    if normalize:
        y = y / n
    return np.moveaxis(y, -1, axis)
