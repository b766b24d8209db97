"""Bluestein (chirp-z) FFT for lengths with large prime factors: the port's
counterpart of ``fft_wgpu_tpu.ops.bluestein``.

Any n becomes two power-of-two FFTs of length m >= 2n - 1 through the
chirp-z identity

    X[k] = conj(c[k]) * IFFT( FFT(conj(c)*x, m) * FFT(b, m) )[k],
    c[j] = exp(+i*pi*j^2/n),  b[j] = c[j] for |j| < n (wrapped)

with the chirp tables generated in f64 on the host (j^2 mod 2n reduction,
so precision holds at large n).

On a CUDA tensor with m <= 16384 the whole transform is one launch of
``chirp_full`` (``csrc/chirp_fft.cu``, through
``cuda_fft.fft_chirp_full_split``): the chirp multiply and the zero-pad
ride the first FFT's loads, the filter multiply the second's loads, the
slice and the post-chirp multiply its stores, and each m-point row stays
in shared memory between the two; its gradient is one more launch of the
same kernel.  Otherwise (a CPU tensor, or a larger m on the card) the
composed path runs: chirp multiply, pad, an m-point FFT through the plan,
filter multiply, inverse FFT, post-chirp.  The route is picked by the
envelope predicate, never by catching an error.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import cuda_fft, stockham
from .stockham import BLUESTEIN_MIN

__all__ = ["fft_bluestein_split", "BLUESTEIN_MIN"]

# Device copies of the chirp tables, keyed by (n, sign, device).
_TABLES: dict = {}


@functools.lru_cache(maxsize=None)
def _chirp_np(n: int, sign: int):
    """(c_re, c_im, Bf_re, Bf_im, m): chirp c[j]=exp(sign*i*pi*j^2/n) and
    the precomputed FFT of the wrapped conjugate-chirp filter b, length m
    (a copy of the JAX package's, bit for bit)."""
    m = _pad_length(n)
    j = np.arange(n, dtype=np.int64)
    # j^2 mod 2n keeps the f64 phase argument small at large n
    phase = (np.pi / n) * ((j * j) % (2 * n)).astype(np.float64)
    c = np.cos(phase) + 1j * np.sin(phase)  # exp(+i*pi*j^2/n)
    if sign == -1:
        c = np.conj(c)  # forward chirp is exp(-i*pi*j^2/n)
    b = np.zeros(m, dtype=np.complex128)
    b[:n] = np.conj(c)
    b[m - n + 1:] = np.conj(c)[1:][::-1]
    Bf = np.fft.fft(b)
    return (
        c.real.astype(np.float32),
        c.imag.astype(np.float32),
        Bf.real.astype(np.float32),
        Bf.imag.astype(np.float32),
        m,
    )


def _chirp_tables(n: int, sign: int, device):
    """(cr, ci, bfr, bfi) of :func:`_chirp_np` as tensors on ``device``, and m."""
    key = (n, sign, str(device))
    tabs = _TABLES.get(key)
    if tabs is None:
        *arrays, m = _chirp_np(n, sign)
        tabs = _TABLES[key] = (tuple(torch.from_numpy(a).to(device) for a in arrays), m)
    return tabs


def _pad_length(n: int) -> int:
    """m, the least power of two >= 2n - 1."""
    return 1 << (2 * n - 2).bit_length()


def fft_bluestein_split(re, im, sign, scale=None):
    """Chirp-z DFT over the last axis of a split (re, im) pair (any n)."""
    from ..plan.plan import get_plan

    n = re.shape[-1]
    (cr, ci, bfr, bfi), m = _chirp_tables(n, sign, re.device)
    if re.device.type == "cuda" and cuda_fft._chirp_supported(m, n):
        sc = (1.0 / m) * (1.0 if scale is None else float(scale))
        return cuda_fft.fft_chirp_full_split(re, im, cr, ci, bfr, bfi, cr, ci, m, n, sc)

    # a = c * x, zero-padded to m
    ar = re * cr - im * ci
    ai = re * ci + im * cr
    pad = (0, m - n)
    ar = torch.nn.functional.pad(ar, pad)
    ai = torch.nn.functional.pad(ai, pad)

    p = get_plan(m, "auto")
    Ar, Ai = p._execute_split(ar, ai, -1, None)
    # pointwise multiply with the filter spectrum
    Pr = Ar * bfr - Ai * bfi
    Pi = Ar * bfi + Ai * bfr
    yr, yi = p._execute_split(Pr, Pi, +1, 1.0 / m)

    yr = yr[..., :n]
    yi = yi[..., :n]
    out_r = yr * cr - yi * ci
    out_i = yr * ci + yi * cr
    return stockham.apply_scale(out_r, out_i, scale)
