"""Cepstral analysis: real and complex cepstra and minimum-phase
reconstruction, the homomorphic-deconvolution layer over the transforms
(torch port of ``fft_wgpu_tpu.ops.cepstrum``).

    real_cepstrum(x)          irfft(log |rfft(x)|)            real -> real
    complex_cepstrum(x)       ifft(log X) with unwrapped,     real -> (real, ndelay)
                              linear-phase-corrected angle
    inverse_complex_cepstrum  exact inverse of the above
    minimum_phase(h)          homomorphic minimum-phase filter
                              (scipy.signal.minimum_phase parity,
                              Oppenheim & Schafer eq. 13.42b)

``real_cepstrum`` rides the real transforms (on the card the R2C and C2R
kernels for pow2 n: log |X| is real and even, so its inverse is the C2R of
the half spectrum); the others run the plan's C2C along the last axis
(the row kernel for pow2 n up to 16384; ``minimum_phase`` at scipy's
default n_fft of 2^16 the whole-row kernel).  torch has no ``unwrap``:
:func:`unwrap` is numpy's rule (period 2 pi, discont pi, a jump of exactly
+pi kept as +pi).  Parity targets are MATLAB's rceps/cceps/icceps
conventions and scipy.signal.minimum_phase.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.complex_utils import host_table, real_part, to_device
from ..core.twiddle import FORWARD, INVERSE
from .nd import fftn_split
from .rfft import _rfft_split, irfft
from .transforms import _resize_axis

__all__ = ["real_cepstrum", "complex_cepstrum", "inverse_complex_cepstrum",
           "minimum_phase"]


def _fft_last(re, im, sign, scale):
    return fftn_split(re, im, (re.ndim - 1,), sign, scale)


def unwrap(p, dim: int = -1):
    """numpy.unwrap(p, axis=dim) on a float tensor: period 2 pi, discont
    pi; a jump of exactly -pi stays -pi and one of exactly +pi stays +pi
    (numpy's tie rule), and a jump below pi in size is not corrected."""
    dd = torch.diff(p, dim=dim)
    ddmod = torch.remainder(dd + math.pi, 2 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0), math.pi, ddmod)
    ph_correct = torch.where(dd.abs() < math.pi, 0.0, ddmod - dd)
    head = p.narrow(dim, 0, 1)
    return torch.cat([head, p.narrow(dim, 1, p.shape[dim] - 1)
                      + ph_correct.cumsum(dim)], dim=dim)


def real_cepstrum(x, n: int | None = None, axis: int = -1):
    """Real cepstrum irfft(log |rfft(x)|) along `axis` (MATLAB rceps).

    The log magnitude is floored at 1e-12 * max|X| per row to keep exact
    spectral zeros from producing -inf."""
    x = real_part(x).movedim(axis, -1)
    if n is not None and x.shape[-1] != n:
        x = _resize_axis(x, n, -1)
    n = x.shape[-1]
    re, im = _rfft_split(x, None, -1, None)
    mag = torch.sqrt(re * re + im * im)
    floor = 1e-12 * mag.amax(-1, keepdim=True)
    logmag = torch.log(torch.maximum(mag, floor))
    return irfft((logmag, torch.zeros_like(logmag)), n=n, axis=-1).movedim(-1, axis)


def complex_cepstrum(x, axis: int = -1):
    """Complex cepstrum along `axis` (MATLAB cceps): ifft(log X) using the
    unwrapped phase with its linear component removed.  Returns
    (cepstrum, ndelay) where `ndelay` is the removed circular delay in
    samples — pass both to :func:`inverse_complex_cepstrum` to invert.
    Input must be real with no exact spectral zeros; as with MATLAB's
    cceps/icceps, the roundtrip is exact only when the unwrapped
    corrected phase is truly odd-symmetric (pulse-dominated or
    minimum-phase signals) — the discarded imaginary cepstral residue
    measures the deviation otherwise."""
    x = real_part(x).movedim(axis, -1)
    n = x.shape[-1]
    re, im = _fft_last(x, torch.zeros_like(x), FORWARD, None)
    logmag = 0.5 * torch.log(re * re + im * im)
    ph = unwrap(torch.atan2(im, re), dim=-1)
    # remove the linear phase (circular delay), MATLAB cceps convention:
    # nd = round(ph[n//2] / pi), ph -= pi * nd * arange(n) / (n//2)
    nd = torch.round(ph[..., n // 2] / math.pi)
    ramp = torch.arange(n, dtype=torch.float32, device=x.device)
    ph = ph - math.pi * nd[..., None] * ramp / (n // 2)
    cr, _ = _fft_last(logmag, ph, INVERSE, 1.0 / n)
    return cr.movedim(-1, axis), nd


def inverse_complex_cepstrum(ceps, ndelay, axis: int = -1):
    """Exact inverse of :func:`complex_cepstrum` (MATLAB icceps)."""
    c = real_part(ceps).movedim(axis, -1)
    nd = to_device(ndelay, c.device)
    n = c.shape[-1]
    Cr, Ci = _fft_last(c, torch.zeros_like(c), FORWARD, None)
    ramp = torch.arange(n, dtype=torch.float32, device=c.device)
    ph = Ci + math.pi * nd[..., None] * ramp / (n // 2)
    mag = torch.exp(Cr)
    xr, _ = _fft_last(mag * torch.cos(ph), mag * torch.sin(ph), INVERSE, 1.0 / n)
    return xr.movedim(-1, axis)


@functools.lru_cache(maxsize=16)
def _mp_tables(kind: str, n_fft: int, n_half: int, device):
    """minimum_phase's float32 tables: the homomorphic fold window
    2u[n] - d[n]; the Hilbert method's linear-phase undo (cos, sin) and
    its quefrency signs."""
    if kind == "fold":
        win = np.zeros(n_fft)
        win[0] = 1.0
        stop = n_fft // 2
        win[1:stop] = 2.0
        if n_fft % 2:
            win[stop] = 1.0
        return host_table(win, device)
    w = (2.0 * np.pi * n_half / n_fft) * np.arange(n_fft)
    sig = np.zeros(n_fft)
    sig[1: n_fft // 2] = 1.0
    sig[n_fft // 2 + 1:] = -1.0
    return host_table(np.cos(w), device), host_table(np.sin(w), device), host_table(sig, device)


def minimum_phase(h, method: str = "homomorphic",
                  n_fft: int | None = None, *, half: bool = True):
    """Minimum-phase filter from a linear-phase FIR `h`
    (scipy.signal.minimum_phase parity).

    method='homomorphic': cepstral folding; with `half=True` (default)
    the magnitude response is the square root of the original and
    (len(h)+1)//2 taps are returned; `half=False` keeps the full
    magnitude and length.  method='hilbert' (Damera-Venkata DHT method,
    half-magnitude only) matches scipy's boosted/scaled spectrum form.
    """
    h = real_part(h)
    if h.ndim != 1:
        raise ValueError("minimum_phase expects a 1-D filter")
    m = int(h.shape[0])
    if m < 2:
        raise ValueError("filter must have at least 2 taps")
    if method not in ("homomorphic", "hilbert"):
        raise ValueError(
            f"method must be 'homomorphic' or 'hilbert', got {method!r}")
    if method == "hilbert" and not half:
        raise ValueError("half=False is not supported for method='hilbert'")
    if n_fft is None:
        n_fft = 2 ** int(np.ceil(np.log2(2 * (m - 1) / 0.01)))
    n_fft = int(n_fft)
    if n_fft < m:
        raise ValueError(f"n_fft must be >= len(h) == {m}")
    n_half = m // 2
    n_out = (n_half + m % 2) if half else m
    hp = torch.nn.functional.pad(h, (0, n_fft - m))
    re, im = _fft_last(hp, torch.zeros_like(hp), FORWARD, None)
    if method == "hilbert":
        return _minimum_phase_hilbert(re, im, n_fft, n_half)[:n_out]
    # homomorphic window 2u[n] - d[n]: double positive quefrencies, zero
    # negative ones (Oppenheim & Schafer 3rd ed eq 13.42b)
    mag = torch.sqrt(re * re + im * im)
    # scipy's guard: lift exact zeros to 1e-7 * smallest positive value
    pos_min = torch.where(mag > 0, mag, math.inf).min()
    logmag = (0.5 if half else 1.0) * torch.log(mag + 1e-7 * pos_min)
    cep, _ = _fft_last(logmag, torch.zeros_like(logmag), INVERSE, 1.0 / n_fft)
    cep = cep * _mp_tables("fold", n_fft, n_half, h.device)
    Cr, Ci = _fft_last(cep, torch.zeros_like(cep), FORWARD, None)
    e = torch.exp(Cr)
    hr, _ = _fft_last(e * torch.cos(Ci), e * torch.sin(Ci), INVERSE, 1.0 / n_fft)
    return hr[:n_out]


def _minimum_phase_hilbert(re, im, n_fft, n_half):
    """Damera-Venkata/Evans/McCaslin discrete-Hilbert-transform method
    (scipy.signal.minimum_phase method='hilbert'): linear-phase shift to
    a real zero-phase response, boost/scale into [0, 1], sqrt, then the
    modified DHT reconstruction exp(H{log|.|})."""
    cw, sw, sig = _mp_tables("hilbert", n_fft, n_half, re.device)
    # undo the linear phase: Re( FFT(h) * e^{+j w n_half} )
    H = re * cw - im * sw
    dp = H.max() - 1.0
    ds = -H.min()
    S = 4.0 / (torch.sqrt(1.0 + dp + ds) + torch.sqrt(1.0 - dp + ds)) ** 2
    mag = torch.sqrt((H + ds) * S) + 1e-10
    # modified discrete Hilbert transform: -j sign(freq) in quefrency
    logm = torch.log(mag)
    lr, li = _fft_last(logm, torch.zeros_like(logm), INVERSE, 1.0 / n_fft)
    er, ei = _fft_last(sig * lr, sig * li, FORWARD, None)
    pr = torch.exp(er) * torch.cos(ei)
    pi = torch.exp(er) * torch.sin(ei)
    hr, _ = _fft_last(mag * pr, mag * pi, INVERSE, 1.0 / n_fft)
    return hr
