"""Fast Hankel transform via FFTLog (Hamilton 2000), scipy.fft.fht parity
(torch port of ``fft_wgpu_tpu.ops.fftlog``).

The u_m coefficient table depends only on (n, dln, mu, offset, bias) and is
computed on the host in complex128 (log-gamma: ``scipy.special`` where it
imports, else a Lanczos copy), cast once to a float32 pair and uploaded
once per table and device.  The transform is R2C -> coefficient product ->
C2R -> index reversal (a log-space convolution): on the card the R2C and
C2R kernels for pow2 n, and ``rfft``'s routes for every other n (the
composite R2C kernel for an odd composite n on the card, else a C2C).
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch

from ..core.complex_utils import host_table, real_part
from .rfft import irfft_last_split, rfft_last_split

__all__ = ["fht", "ifht", "fhtoffset"]

_LN_2 = math.log(2.0)


def _loggamma(z):
    """Complex log-gamma on the host (f64).  Uses scipy when present;
    otherwise a Lanczos(g=7) evaluation with reflection for Re(z) < 0.5."""
    try:
        from scipy.special import loggamma as _lg

        return _lg(z)
    except ImportError:
        pass
    z = np.asarray(z, dtype=complex)
    return np.vectorize(_lanczos_loggamma)(z)


_LANCZOS_G = 7
_LANCZOS_C = np.array([
    0.99999999999980993, 676.5203681218851, -1259.1392167224028,
    771.32342877765313, -176.61502916214059, 12.507343278686905,
    -0.13857109526572012, 9.9843695780195716e-6, 1.5056327351493116e-7,
])


def _lanczos_loggamma(z):
    if z.real < 0.5:
        # reflection: logΓ(z) = log(π/sin(πz)) − logΓ(1−z)
        return (math.log(math.pi) - np.log(np.sin(np.pi * z))
                - _lanczos_loggamma(1.0 - z))
    z = z - 1.0
    x = _LANCZOS_C[0]
    for i in range(1, _LANCZOS_G + 2):
        x = x + _LANCZOS_C[i] / (z + i)
    t = z + _LANCZOS_G + 0.5
    return (0.5 * math.log(2 * math.pi) + (z + 0.5) * np.log(t) - t
            + np.log(x))


def _fhtcoeff(n, dln, mu, offset=0.0, bias=0.0):
    """FFTLog u_m coefficients (complex128, length n//2 + 1)."""
    lnkr, q = offset, bias
    xp = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.linspace(0, np.pi * (n // 2) / (n * dln), n // 2 + 1)
    u = np.empty(n // 2 + 1, dtype=complex)
    v = np.empty(n // 2 + 1, dtype=complex)
    u.real[:] = xm
    u.imag[:] = y
    v[:] = _loggamma(u)
    u.real[:] = xp
    u[:] = _loggamma(u)
    y = y * (2 * (_LN_2 - lnkr))
    u.real -= v.real
    u.real += _LN_2 * q
    u.imag += v.imag
    u.imag += y
    with np.errstate(over="ignore"):
        np.exp(u, out=u)
    # even n: the real-FFT Nyquist coefficient must be real
    if n % 2 == 0:
        u.imag[-1] = 0
    if not np.isfinite(u[0]):
        # Γ poles at m=0: u_0 = 2^q Γ(xp)/Γ(xm) (Pochhammer form)
        try:
            from scipy.special import poch

            u[0] = 2**q * poch(xm, xp - xm)
        except ImportError:
            u[0] = 2**q * np.exp(_lanczos_loggamma(complex(xp))
                                 - _lanczos_loggamma(complex(xm))).real
    return u


def fhtoffset(dln, mu, initial=0.0, bias=0.0):
    """Optimal low-ringing FFTLog offset near `initial`
    (scipy.fft.fhtoffset parity)."""
    lnkr, q = initial, bias
    xp = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.pi / (2 * dln)
    zp = _loggamma(xp + 1j * y)
    zm = _loggamma(xm + 1j * y)
    arg = (_LN_2 - lnkr) / dln + (zp.imag + zm.imag) / np.pi
    return lnkr + (arg - np.round(arg)) * dln


@functools.lru_cache(maxsize=64)
def _tables(n, dln, mu, offset, bias, inverse, device):
    """(warning or None, cr, ci, pre, post) of one transform: the
    coefficient product c (u, or 1/conj(u) for the inverse) and, with a
    bias, the pre- and post-weights, each float32 on ``device``."""
    u = _fhtcoeff(n, dln, mu, offset=offset, bias=bias)
    warning = None
    if not inverse:
        if np.isinf(u[0]):
            warning = "singular transform; consider changing the bias"
            u = u.copy()
            u[0] = 0
        c = u
    else:
        if u[0] == 0:
            warning = "singular inverse transform; consider changing the bias"
            u = u.copy()
            u[0] = np.inf
        with np.errstate(divide="ignore"):
            c = 1.0 / np.conj(u)  # A /= conj(u); u_0 = inf divides to 0
        c[~np.isfinite(c)] = 0.0
    pre = post = None
    if bias != 0:
        j_c = (n - 1) / 2
        j = np.arange(n)
        if not inverse:
            pre = np.exp(-bias * (j - j_c) * dln)
            post = np.exp(-bias * ((j - j_c) * dln + offset))
        else:
            pre = np.exp(bias * ((j - j_c) * dln + offset))
            post = np.exp(bias * (j - j_c) * dln)
        pre, post = host_table(pre, device), host_table(post, device)
    return warning, host_table(c.real, device), host_table(c.imag, device), pre, post


def _fht_impl(a, dln, mu, offset, bias, inverse):
    if a.is_complex() if isinstance(a, torch.Tensor) else np.iscomplexobj(a):
        raise TypeError("fht/ifht require real input (log-spaced samples)")
    v = real_part(a)
    n = v.shape[-1]
    warning, cr, ci, pre, post = _tables(n, float(dln), float(mu), float(offset),
                                         float(bias), inverse, v.device)
    if warning is not None:
        warnings.warn(warning, stacklevel=3)
    if pre is not None:
        v = v * pre
    Ar, Ai = rfft_last_split(v, None)
    Br = Ar * cr - Ai * ci
    Bi = Ar * ci + Ai * cr
    out = irfft_last_split(Br, Bi, n, 1.0 / n).flip(-1)
    return out if post is None else out * post


def fht(a, dln, mu, offset=0.0, bias=0.0):
    """Fast Hankel transform of order `mu` on a log-spaced grid
    (scipy.fft.fht parity; FFTLog — Hamilton 2000, A&AS 312, 257)."""
    return _fht_impl(a, dln, mu, offset, bias, inverse=False)


def ifht(A, dln, mu, offset=0.0, bias=0.0):
    """Inverse of :func:`fht` (scipy.fft.ifht parity)."""
    return _fht_impl(A, dln, mu, offset, bias, inverse=True)
