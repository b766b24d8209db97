"""Wigner-Ville distribution and its windowed (pseudo) variant (torch
port of ``fft_wgpu_tpu.ops.wigner``).

The quadratic time-frequency representation (Claasen-Mecklenbraeuker
discrete form)

    W[n, k] = sum_{tau=-L..L} x[n+tau] conj(x[n-tau]) e^{-2 pi i k tau / N}

with L the largest lag keeping both indices in range.  The instantaneous
autocorrelation r_n[tau] = x[n+tau] x*[n-tau] is Hermitian in tau, so the
symmetric sum is 2 Re(DFT of the tau >= 0 half) - r_n[0]: one batched C2C
over all N time positions (on the card the row kernel's complex64 entry
for pow2 N).  Lag tau counts sample pairs, so bin k is frequency k/(2N)
cycles/sample.  The [N, N] autocorrelation is a product of two strided
windows of the zero-padded signal (no index tables: the padding's zeros
are the invalid lags); a pseudo-WVD's lag taper is one host-built row of
N weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.complex_utils import (default_device, host_table, is_pair, merge,
                                 promote_to_split)
from .helpers import _tensor
from .transforms import fft

__all__ = ["wigner_ville", "wigner_ville_frequencies"]


def wigner_ville_frequencies(n: int, fs: float = 1.0, *, device=None):
    """Frequency grid of wigner_ville: n bins spaced fs/(2n), float32 on
    ``device`` (the current CUDA device by default)."""
    return host_table(np.arange(n) * fs / (2.0 * n), device or default_device())


def _lag_products(x):
    """r[..., t, tau] = x[t + tau] conj(x[t - tau]) for tau in [0, n), zero
    where an index leaves [0, n): windows of x padded with n zeros a side,
    x[t + tau] starting at n + t, x[t - tau] read from the reversed padding
    (its windows come in reverse order of t)."""
    n = x.shape[-1]
    xp = torch.nn.functional.pad(x, (n, n))
    ahead = xp.unfold(-1, n, 1)[..., n:2 * n, :]
    behind = xp.flip(-1).unfold(-1, n, 1)[..., n:2 * n, :].flip(-2)
    return ahead * behind.conj()


def _lag_taper(window, n: int, device):
    """The pseudo-WVD's positive-lag weights: the window's CENTER sample is
    lag 0, so lag tau weighs window[m//2 + tau], zero past the edge."""
    w = window.astype(np.float32)
    mid = len(w) // 2
    wl = np.zeros(n, np.float32)
    keep = min(len(w) - mid, n)
    wl[:keep] = w[mid:mid + keep]
    return torch.from_numpy(wl).to(device)


def wigner_ville(x, fs: float = 1.0, window=None):
    """Discrete Wigner-Ville distribution of `x` along the last axis.

    Returns (f, W) with W real of shape [..., n, n]: W[..., t, k] is the
    energy density at time t/fs and frequency f[k] = k*fs/(2n).  For a
    real signal, pass its analytic version (``hilbert``) to avoid
    cross-term aliasing.  `window` gives the pseudo-WVD: a symmetric
    lag-domain taper whose CENTER sample weights lag 0 (e.g.
    `np.hanning(2*L+1)` tapers lags to +-L); it may be shorter than n
    (zero weight beyond its reach).

    Frequency marginal: sum_k W[t, k] = n |x[t]|^2 (a window rescales it
    by window[center]).
    """
    x = merge(*promote_to_split(x)) if is_pair(x) else _tensor(x)
    x = x.to(torch.complex64)
    n = x.shape[-1]
    w = None
    if window is not None:
        if isinstance(window, torch.Tensor):
            window = window.detach().cpu().numpy()
        w = np.asarray(window, np.float64)
        if w.ndim != 1 or w.size == 0 or w.size > 2 * n - 1:
            raise ValueError(
                f"window must be 1-D with 1..{2 * n - 1} samples")
    r = _lag_products(x)
    if w is not None:
        r = r * _lag_taper(w, n, x.device)
    R = fft(r, axis=-1)
    return (wigner_ville_frequencies(n, fs, device=x.device),
            2.0 * R.real - r.real[..., :1])
