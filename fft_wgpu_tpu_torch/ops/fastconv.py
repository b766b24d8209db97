"""Fused spectral filtering, the cuFFT load-callback analogue (torch port
of ``fft_wgpu_tpu.ops.fastconv``).

``y = ifft(fft(x) * H)`` is the fast-convolution serving loop (FIR
filtering, channel equalisation, deconvolution).  Composed from separate
operations it costs three round trips through device memory (forward
transform, multiply, inverse transform); here the H multiply is fused into
the inverse transform's loads, so the loop is two: on a CUDA tensor of
pow2 length 128..16384, the row kernel, then the filtered row kernel with
the 1/n folded into its store.  A complex64 CUDA tensor takes both through
their complex64 entries (``cuda_fft.fft_batched_c64``, the plan's route
of pow2 n, then ``cuda_fft.fft_filtered_c64``): two launches, no split and
no merge; other
input on the card their planar entries (``fft_filtered_split``).  Any
other length, and a CPU tensor, takes the composed form through the plan
(``get_plan(n)._execute_split``), so a composite length on the card runs
the composite-row kernel; the JAX package's composed form goes to its
``stockham`` path, because XLA was its only alternative off the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.complex_utils import merge, promote_to_split
from ..core.twiddle import FORWARD, INVERSE
from ..plan.plan import get_plan
from . import cuda_fft
from .stft import _on_card

__all__ = ["SpectralFilter", "spectral_filter"]


class SpectralFilter(torch.nn.Module):
    """Plan-style fused circular filter: build once per (n, response),
    replay on any row batch.

    Parameters
    ----------
    h : array or tensor
        Filter, length n.  ``domain='freq'`` (default) = the complex
        frequency response H[k]; ``domain='time'`` = the (possibly
        complex) circular impulse response, transformed once at build in
        float64.
    n : int, optional
        Transform length (defaults to ``len(h)``).

    ``apply(x)`` (also ``forward`` and calling the module) computes
    ``ifft(fft(x) * H)`` along the last axis of x (circular convolution
    with the impulse response) and returns complex64.  The response is held
    as float32 planar buffers ``hr`` and ``hi`` (generated in float64, cast
    once); they follow x to its device at the first call there.  The
    complex64 route reads it as one complex64 row, made from the buffers
    once per device and buffer version.  Note that ``apply`` here is the
    filter, not ``torch.nn.Module.apply``.
    """

    def __init__(self, h, n: int | None = None, *, domain: str = "freq"):
        super().__init__()
        h = h.detach().cpu().numpy() if isinstance(h, torch.Tensor) else np.asarray(h)
        self.n = int(n if n is not None else h.shape[-1])
        if h.shape[-1] != self.n:
            raise ValueError(f"filter length {h.shape[-1]} != n={self.n}")
        if h.ndim != 1:
            raise ValueError("h must be 1-D")
        if domain == "time":
            H = np.fft.fft(h.astype(np.complex128))
        elif domain == "freq":
            H = h.astype(np.complex128)
        else:
            raise ValueError(f"domain must be 'freq' or 'time', got {domain!r}")
        self.register_buffer("hr", torch.from_numpy(np.ascontiguousarray(H.real, np.float32)))
        self.register_buffer("hi", torch.from_numpy(np.ascontiguousarray(H.imag, np.float32)))

    def forward(self, x):
        """Filter x ([..., n]: a tensor on its device, anything else on the
        current CUDA device) -> complex64 of the same shape."""
        n = self.n
        if (isinstance(x, torch.Tensor) and x.dtype == torch.complex64 and _on_card(x)
                and cuda_fft._supported(n) and x.ndim >= 1 and x.shape[-1] == n):
            if self.hr.device != x.device:
                self.to(x.device)
            X = cuda_fft.fft_batched_c64(x, FORWARD)  # the plan's route of pow2 n
            return cuda_fft.fft_filtered_c64(X, self._response_c64(), INVERSE, 1.0 / n)
        re, im = promote_to_split(x)
        if re.shape[-1] != n:
            raise ValueError(f"last axis {re.shape[-1]} != plan length {n}")
        if self.hr.device != re.device:
            self.to(re.device)
        p = get_plan(n)
        Xr, Xi = p._execute_split(re, im, FORWARD, None)
        if _on_card(re) and cuda_fft._supported(n):
            yr, yi = cuda_fft.fft_filtered_split(Xr, Xi, self.hr, self.hi, INVERSE,
                                                 1.0 / n)
        else:
            cr, ci = Xr * self.hr - Xi * self.hi, Xr * self.hi + Xi * self.hr
            yr, yi = p._execute_split(cr, ci, INVERSE, 1.0 / n)
        return merge(yr, yi)

    def _response_c64(self):
        """The response as one complex64 row on the buffers' device, made
        from ``hr`` and ``hi`` once per device and buffer version."""
        key = (self.hr.device, self.hr.data_ptr(), self.hr._version, self.hi.data_ptr(),
               self.hi._version)
        if getattr(self, "_c64_key", None) != key:
            self._c64, self._c64_key = torch.complex(self.hr, self.hi), key
        return self._c64

    def apply(self, x):  # the JAX package's name for the call
        return self.forward(x)


def spectral_filter(x, h, *, domain: str = "freq"):
    """One-shot fused circular filter ``ifft(fft(x) * H)`` along the
    last axis.  Builds a throwaway :class:`SpectralFilter`; for replay
    loops construct the plan once and call it."""
    return SpectralFilter(h, domain=domain).apply(x)
