"""Continuous wavelet transform, FFT-accelerated across all scales (torch
port of ``fft_wgpu_tpu.ops.cwt``).

    cwt(x, widths, wavelet="ricker")  ->  [len(widths), len(x)]

scipy.signal.cwt semantics (removed from scipy 1.15): row i is
`convolve(x, wavelet(N_i, w_i)[::-1].conj(), mode="same")` with
N_i = min(10*w_i, len(x)).  The filter bank is zero-padded to one FFT
length and applied as one batched spectral multiply: a forward transform
of the signal, the bank's spectrum, and one batched inverse.

The :class:`CWT` plan computes the bank spectrum once; on a CUDA tensor
each ``apply`` is the row kernel on the padded signal, then the
filter-bank kernel (``cuda_fft.fft_bank_split``: the signal spectrum
times every bank row at load, never materialised at bank size).

Wavelets: `ricker` (Mexican hat, real) and `morlet2` (complex Morlet,
scipy conventions), or any callable wavelet(points, width) -> np.ndarray
(real or complex, float64: tables are generated in float64 and cast once).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..core.complex_utils import default_device, merge, to_device
from ..core.twiddle import FORWARD, INVERSE
from . import cuda_fft
from .helpers import next_fast_len
from .nd import fftn_split

__all__ = ["cwt", "CWT", "ricker", "morlet2"]


def ricker(points: int, a: float) -> np.ndarray:
    """Mexican-hat (Ricker) wavelet, scipy.signal.ricker parity (f64)."""
    A = 2.0 / (np.sqrt(3.0 * a) * np.pi ** 0.25)
    vec = np.arange(points, dtype=np.float64) - (points - 1.0) / 2.0
    xsq = (vec / a) ** 2
    return A * (1.0 - xsq) * np.exp(-xsq / 2.0)


def morlet2(points: int, s: float, w: float = 5.0) -> np.ndarray:
    """Complex Morlet wavelet, scipy.signal.morlet2 parity (c128)."""
    x = (np.arange(points, dtype=np.float64) - (points - 1.0) / 2.0) / s
    return (np.exp(1j * w * x) * np.exp(-0.5 * x ** 2)
            * np.pi ** -0.25 * np.sqrt(1.0 / s))


_WAVELETS = {"ricker": ricker, "morlet2": morlet2}


def _build_bank(n, widths, wavelet, w):
    """Host-side f64 bank, zero-padded to the longest kernel (cast once)."""
    widths = np.atleast_1d(np.asarray(widths, np.float64))
    if widths.ndim != 1 or widths.size == 0:
        raise ValueError("widths must be a non-empty 1-D sequence")
    if callable(wavelet):
        gen = wavelet
    else:
        try:
            gen = _WAVELETS[wavelet]
        except KeyError:
            raise ValueError(
                f"unknown wavelet {wavelet!r}; expected one of "
                f"{sorted(_WAVELETS)} or a callable") from None
    if w is not None:
        gen = partial(gen, w=w)
    lengths = [min(max(int(10 * wd), 1), n) for wd in widths]
    lmax = max(lengths)
    bank = np.zeros((len(widths), lmax), np.complex128)
    cplx = False
    for i, (wd, li) in enumerate(zip(widths, lengths)):
        wl = np.conj(np.asarray(gen(li, wd))[::-1])
        cplx |= np.iscomplexobj(wl)
        # place each reversed kernel so the common 'same' slice at
        # (lmax-1)//2 lands on that kernel's own (li-1)//2 start
        off = (lmax - 1) // 2 - (li - 1) // 2
        bank[i, off:off + li] = wl
    return bank, lmax, cplx


def _pick_nfft(lfull: int, device) -> int:
    """Transform length: on a CUDA device the power of two in the row
    kernel's envelope (the filter-bank kernel needs it), as the JAX package
    picks it on the TPU; otherwise the 5-smooth next_fast_len, as it picks
    it off the TPU."""
    if torch.device(device).type == "cuda":
        p = 1 << max(7, (lfull - 1).bit_length())
        if cuda_fft._supported(p):
            return p
    return next_fast_len(lfull)


def _bank_spectrum(bank, nfft, device):
    """FFT of the zero-padded bank rows, planar float32 on ``device``."""
    pad = (0, nfft - bank.shape[-1])
    br = torch.nn.functional.pad(to_device(bank.real, device), pad)
    bi = torch.nn.functional.pad(to_device(bank.imag, device), pad)
    return fftn_split(br, bi, (1,), FORWARD, None)


def _signal(x, device=None):
    x = to_device(x, device) if not isinstance(x, torch.Tensor) else x.to(torch.float32)
    if x.ndim != 1:
        raise ValueError("cwt expects a 1-D signal")
    return x


def _same(yr, yi, lmax, n, cplx):
    """The 'same' slice of each full convolution: n points from (lmax-1)//2."""
    start = (lmax - 1) // 2
    yr, yi = yr[:, start:start + n], yi[:, start:start + n]
    return merge(yr, yi) if cplx else yr


def cwt(x, widths, wavelet="ricker", *, w: float | None = None):
    """CWT of real 1-D `x` over `widths`; returns [len(widths), len(x)],
    real for real wavelets, complex64 for complex ones.  `w` is the
    Morlet center frequency (scipy's `w`, default 5).  For replay loops
    over many signals build a :class:`CWT` plan."""
    x = _signal(x)
    n = int(x.shape[0])
    bank, lmax, cplx = _build_bank(n, widths, wavelet, w)
    nfft = _pick_nfft(n + lmax - 1, x.device)
    xp = torch.nn.functional.pad(x, (0, nfft - n))
    Xr, Xi = fftn_split(xp, torch.zeros_like(xp), (0,), FORWARD, None)
    Br, Bi = _bank_spectrum(bank, nfft, x.device)
    Yr, Yi = Xr * Br - Xi * Bi, Xr * Bi + Xi * Br
    return _same(*fftn_split(Yr, Yi, (1,), INVERSE, 1.0 / nfft), lmax, n, cplx)


class CWT:
    """Plan-style CWT: the filter-bank spectrum is computed once at build,
    on ``device`` (the current CUDA device by default; pass ``"cpu"`` for
    the CPU).  Each ``apply(x)`` is one signal transform plus one bank
    pass: on a CUDA device with a pow2 ``nfft`` the filter-bank kernel (the
    per-scale multiply at load, the signal spectrum broadcast over the
    bank); otherwise the multiply and the plan's batched inverse."""

    def __init__(self, n: int, widths, wavelet="ricker", *,
                 w: float | None = None, device=None):
        self.n = int(n)
        device = torch.device(device) if device is not None else default_device()
        bank, self._lmax, self.complex_output = _build_bank(self.n, widths, wavelet, w)
        self.nfft = _pick_nfft(self.n + self._lmax - 1, device)
        self._Br, self._Bi = _bank_spectrum(bank, self.nfft, device)
        self.device = self._Br.device  # with its index ("cuda" -> "cuda:0")

    def apply(self, x):
        x = _signal(x, self.device)
        if int(x.shape[0]) != self.n:
            raise ValueError(f"CWT plan expects a 1-D signal of length {self.n}")
        if x.device != self.device:
            raise ValueError(f"CWT plan built for {self.device}, signal on {x.device}")
        n, nfft = self.n, self.nfft
        xp = torch.nn.functional.pad(x, (0, nfft - n))
        Xr, Xi = fftn_split(xp, torch.zeros_like(xp), (0,), FORWARD, None)
        Br, Bi = self._Br, self._Bi
        if x.device.type == "cuda" and cuda_fft._supported(nfft):
            yr, yi = cuda_fft.fft_bank_split(Xr, Xi, Br, Bi, INVERSE, 1.0 / nfft)
        else:
            Yr, Yi = Xr * Br - Xi * Bi, Xr * Bi + Xi * Br
            yr, yi = fftn_split(Yr, Yi, (1,), INVERSE, 1.0 / nfft)
        return _same(yr, yi, self._lmax, n, self.complex_output)

    __call__ = apply
