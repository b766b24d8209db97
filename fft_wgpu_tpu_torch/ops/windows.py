"""Window functions (scipy.signal.windows parity), the port of
``fft_wgpu_tpu.ops.windows``.

Every table is generated on the host in float64 numpy and cast once to
float32, as the JAX package does, so each window is bit-identical to its
counterpart there.  ``periodic=True`` is scipy's ``sym=False`` (fftbins):
the symmetric window of length n + 1 with its last sample dropped.  The
result is a float32 tensor on ``device``, the current CUDA device when
none is given (as ``fftfreq``).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.complex_utils import default_device

__all__ = [
    "boxcar_window",
    "triang_window",
    "parzen_window",
    "bohman_window",
    "nuttall_window",
    "blackmanharris_window",
    "cosine_window",
    "exponential_window",
    "barthann_window",
    "lanczos_window",
    "gaussian_window",
    "general_gaussian_window",
    "general_cosine_window",
    "general_hamming_window",
    "chebwin_window",
    "taylor_window",
    "kaiser_bessel_derived_window",
]


def _extend(n: int, periodic: bool) -> tuple[int, bool]:
    """scipy's _extend: a periodic window is the length-(n+1) symmetric one
    with its last sample dropped."""
    return (n + 1, True) if periodic else (n, False)


def _finish(w: np.ndarray, n: int, device=None) -> torch.Tensor:
    """The first n samples of the float64 table ``w``, cast once to
    float32, on ``device`` (the current CUDA device by default)."""
    arr = np.ascontiguousarray(w[:n]).astype(np.float32)
    return torch.from_numpy(arr).to(device or default_device())


def _ones(n: int, device=None) -> torch.Tensor:
    return _finish(np.ones(n), n, device)


def boxcar_window(n: int, *, periodic: bool = False, device=None):
    """All-ones window (scipy.signal.windows.boxcar)."""
    del periodic
    return _ones(n, device)


def triang_window(n: int, *, periodic: bool = False, device=None):
    """Triangular window (scipy.signal.windows.triang, not bartlett: the
    endpoints are nonzero)."""
    if n == 1:
        return _ones(1, device)
    m, _ = _extend(n, periodic)
    k = np.arange(1, (m + 1) // 2 + 1, dtype=np.float64)
    if m % 2 == 0:
        half = (2 * k - 1.0) / m
        w = np.concatenate([half, half[::-1]])
    else:
        half = 2 * k / (m + 1.0)
        w = np.concatenate([half, half[-2::-1]])
    return _finish(w, n, device)


def parzen_window(n: int, *, periodic: bool = False, device=None):
    """Parzen (de la Vallee Poussin) window, scipy parity."""
    if n == 1:
        return _ones(1, device)
    m, _ = _extend(n, periodic)
    k = np.arange(-(m - 1) / 2.0, (m - 1) / 2.0 + 0.5, 1.0)
    na = np.extract(k < -(m - 1) / 4.0, k)
    nb = np.extract(abs(k) <= (m - 1) / 4.0, k)
    wa = 2 * (1 - np.abs(na) / (m / 2.0)) ** 3.0
    wb = (1 - 6 * (np.abs(nb) / (m / 2.0)) ** 2.0
          + 6 * (np.abs(nb) / (m / 2.0)) ** 3.0)
    w = np.concatenate([wa, wb, wa[::-1]])
    return _finish(w, n, device)


def bohman_window(n: int, *, periodic: bool = False, device=None):
    """Bohman window, scipy parity."""
    if n == 1:
        return _ones(1, device)
    m, _ = _extend(n, periodic)
    fac = np.abs(np.linspace(-1, 1, m)[1:-1])
    w = (1 - fac) * np.cos(np.pi * fac) + 1.0 / np.pi * np.sin(np.pi * fac)
    w = np.r_[0.0, w, 0.0]
    return _finish(w, n, device)


def general_cosine_window(n: int, a, *, periodic: bool = False, device=None):
    """Weighted sum of cosines (scipy general_cosine)."""
    if n == 1:
        return _ones(1, device)
    m, _ = _extend(n, periodic)
    fac = np.linspace(-np.pi, np.pi, m)
    w = np.zeros(m, np.float64)
    for j, aj in enumerate(np.asarray(a, np.float64)):
        w += aj * np.cos(j * fac)
    return _finish(w, n, device)


def nuttall_window(n: int, *, periodic: bool = False, device=None):
    """Nuttall 4-term minimum-sidelobe window (scipy parity)."""
    return general_cosine_window(
        n, [0.3635819, 0.4891775, 0.1365995, 0.0106411], periodic=periodic,
        device=device)


def blackmanharris_window(n: int, *, periodic: bool = False, device=None):
    """4-term Blackman-Harris window (scipy parity)."""
    return general_cosine_window(
        n, [0.35875, 0.48829, 0.14128, 0.01168], periodic=periodic, device=device)


def cosine_window(n: int, *, periodic: bool = False, device=None):
    """Half-cycle sine window (scipy cosine)."""
    if n == 1:
        return _ones(1, device)
    m, _ = _extend(n, periodic)
    w = np.sin(np.pi / m * (np.arange(0, m, dtype=np.float64) + 0.5))
    return _finish(w, n, device)


def exponential_window(n: int, center: float | None = None, tau: float = 1.0,
                       *, periodic: bool = False, device=None):
    """Exponential (Poisson) window, scipy parity."""
    if n == 1:
        return _ones(1, device)
    if not periodic and center is not None:
        raise ValueError("center may only be set for periodic windows "
                         "(scipy: if sym, center must be None)")
    m, _ = _extend(n, periodic)
    if center is None:
        center = (m - 1) / 2.0
    k = np.arange(0, m, dtype=np.float64)
    w = np.exp(-np.abs(k - center) / tau)
    return _finish(w, n, device)


def barthann_window(n: int, *, periodic: bool = False, device=None):
    """Bartlett-Hann window, scipy parity."""
    if n == 1:
        return _ones(1, device)
    m, _ = _extend(n, periodic)
    k = np.arange(0, m, dtype=np.float64)
    fac = np.abs(k / (m - 1.0) - 0.5)
    w = 0.62 - 0.48 * fac + 0.38 * np.cos(2 * np.pi * fac)
    return _finish(w, n, device)


def lanczos_window(n: int, *, periodic: bool = False, device=None):
    """Lanczos (sinc) window, scipy parity."""
    if n == 1:
        return _ones(1, device)
    m, _ = _extend(n, periodic)
    k = np.arange(0, m, dtype=np.float64)
    w = np.sinc(2.0 * k / (m - 1) - 1.0)
    return _finish(w, n, device)


def gaussian_window(n: int, std: float, *, periodic: bool = False, device=None):
    """Gaussian window, scipy parity."""
    if n == 1:
        return _ones(1, device)
    m, _ = _extend(n, periodic)
    k = np.arange(0, m, dtype=np.float64) - (m - 1.0) / 2.0
    w = np.exp(-(k ** 2) / (2.0 * std * std))
    return _finish(w, n, device)


def general_gaussian_window(n: int, p: float, sig: float,
                            *, periodic: bool = False, device=None):
    """Generalized Gaussian window exp(-0.5*|k/sig|^(2p)), scipy parity."""
    if n == 1:
        return _ones(1, device)
    m, _ = _extend(n, periodic)
    k = np.arange(0, m, dtype=np.float64) - (m - 1.0) / 2.0
    w = np.exp(-0.5 * np.abs(k / sig) ** (2 * p))
    return _finish(w, n, device)


def general_hamming_window(n: int, alpha: float, *, periodic: bool = False,
                           device=None):
    """Generalized Hamming alpha - (1-alpha)cos(2 pi k/(M-1)), scipy parity."""
    return general_cosine_window(n, [alpha, 1.0 - alpha], periodic=periodic,
                                 device=device)


def chebwin_window(n: int, at: float = 100.0, *, periodic: bool = False,
                   device=None):
    """Dolph-Chebyshev window with ``at``-dB equiripple sidelobes
    (scipy.signal.windows.chebwin parity): the inverse DFT of the sampled
    Chebyshev polynomial T_{n-1}(beta*cos(pi k/n)), a host float64 table."""
    if np.abs(at) < 45:
        warnings.warn("This window is not suitable for spectral analysis "
                      "for attenuation values lower than about 45dB because "
                      "the equivalent noise bandwidth of a Chebyshev window "
                      "does not grow monotonically with increasing sidelobe "
                      "attenuation when the attenuation is smaller than "
                      "about 45 dB.", stacklevel=2)
    if n == 1:
        return _ones(1, device)
    m, _ = _extend(n, periodic)

    order = m - 1.0
    beta = np.cosh(1.0 / order * np.arccosh(10 ** (np.abs(at) / 20.0)))
    k = np.arange(0, m, dtype=np.float64) * 1.0
    x = beta * np.cos(np.pi * k / m)
    # the Chebyshev polynomial T_order(x): cos inside |x| <= 1, cosh outside
    p = np.zeros(x.shape, np.float64)
    p[x > 1] = np.cosh(order * np.arccosh(x[x > 1]))
    p[x < -1] = (2 * (m % 2) - 1) * np.cosh(order * np.arccosh(-x[x < -1]))
    p[np.abs(x) <= 1] = np.cos(order * np.arccos(x[np.abs(x) <= 1]))

    if m % 2:
        w = np.real(np.fft.fft(p))
        half = (m + 1) // 2
        w = w[:half]
        w = np.concatenate((w[half - 1:0:-1], w))
    else:
        p = p * np.exp(1.0j * np.pi / m * np.arange(m))
        w = np.real(np.fft.fft(p))
        half = m // 2 + 1
        w = np.concatenate((w[half - 1:0:-1], w[1:half]))
    w = w / np.max(w)
    return _finish(w, n, device)


def taylor_window(n: int, nbar: int = 4, sll: float = 30.0,
                  norm: bool = True, *, periodic: bool = False, device=None):
    """Taylor window (near-sidelobe controlled), scipy.signal.windows.taylor
    parity."""
    if n == 1:
        return _ones(1, device)
    m, _ = _extend(n, periodic)

    B = 10 ** (sll / 20.0)
    A = np.arccosh(B) / np.pi
    s2 = nbar ** 2 / (A ** 2 + (nbar - 0.5) ** 2)
    ma = np.arange(1, nbar, dtype=np.float64)

    Fm = np.empty(nbar - 1, np.float64)
    signs = np.empty_like(ma)
    signs[::2] = 1
    signs[1::2] = -1
    m2 = ma * ma
    for mi, _ in enumerate(ma):
        numer = signs[mi] * np.prod(1 - m2[mi] / s2 / (A ** 2 + (ma - 0.5) ** 2))
        denom = 2 * np.prod(1 - m2[mi] / m2[:mi]) * np.prod(1 - m2[mi] / m2[mi + 1:])
        Fm[mi] = numer / denom

    def W(x):
        return 1 + 2 * np.dot(
            Fm, np.cos(2 * np.pi * ma[:, np.newaxis] * (x - m / 2.0 + 0.5) / m))

    w = W(np.arange(0, m, dtype=np.float64))
    if norm:
        w *= 1.0 / W((m - 1) / 2)
    return _finish(w, n, device)


def kaiser_bessel_derived_window(n: int, beta: float = 8.6,
                                 *, periodic: bool = False, device=None):
    """Kaiser-Bessel-derived (KBD) window, the MDCT window with the
    Princen-Bradley property; scipy parity: symmetric and even-length only."""
    if periodic:
        raise ValueError("Kaiser-Bessel-derived windows are only defined as "
                         "symmetric windows")
    if n < 1:
        return _finish(np.zeros(0), 0, device)
    if n % 2:
        raise ValueError("Kaiser-Bessel-derived windows are only defined "
                         "for even number of points")
    half = n // 2
    k = np.arange(0, half + 1, dtype=np.float64)
    alpha = half / 2.0
    kaiser = np.i0(beta * np.sqrt(np.clip(1 - ((k - alpha) / alpha) ** 2,
                                          0.0, None))) / np.i0(beta)
    csum = np.cumsum(kaiser)
    w_half = np.sqrt(csum[:-1] / csum[-1])
    w = np.concatenate((w_half, w_half[::-1]))
    return _finish(w, n, device)
