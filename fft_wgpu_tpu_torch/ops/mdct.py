"""MDCT / IMDCT, the audio codecs' lapped transform (torch port of
``fft_wgpu_tpu.ops.mdct``).

It rides the DCT-IV (``ops/dct.py``: one modulated C2C, the row kernel on
the card) through the TDAC folding identities:

    MDCT(x)_k  = sum_{t=0}^{2N-1} x_t cos[(pi/N)(t + 1/2 + N/2)(k + 1/2)]
               = DCT-IV([-rev(c) - d, a - rev(b)])_k / 2,
    IMDCT(X)_t = (1/N) sum_k X_k cos[...]
               = (1/(2N)) unfold(DCT-IV(X)),
    unfold(u1, u2) = [u2, -rev(u2), -rev(u1), -u1]

with (a, b, c, d) the input's length-N/2 quarters and (u1, u2) the DCT-IV
output halves.  The signal-level ``mdct`` / ``imdct`` use 50%-overlapped
frames (a strided view, no gather) with a Princen-Bradley window (default:
sine), giving perfect reconstruction (TDAC) in the interior; ``imdct``'s
overlap-add is ``stft._ola_slabs`` (no scatter).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.complex_utils import default_device, host_table, real_part, to_device
from .dct import dct
from .stft import _ola_slabs

__all__ = ["mdct_frame", "imdct_frame", "mdct", "imdct", "sine_window"]


def sine_window(n2: int, *, device=None):
    """Princen-Bradley sine window of length 2N: w_t = sin(pi(t+1/2)/2N)
    (satisfies w_t^2 + w_{t+N}^2 = 1 -> perfect TDAC reconstruction), on
    ``device`` (the current CUDA device by default)."""
    t = np.arange(n2, dtype=np.float64)
    return host_table(np.sin(math.pi * (t + 0.5) / n2), device or default_device())


def mdct_frame(x):
    """MDCT of (windowed) frames [..., 2N] -> [..., N]."""
    x = real_part(x)
    n2 = x.shape[-1]
    if n2 % 4:
        raise ValueError(f"frame length must be a multiple of 4, got {n2}")
    q = n2 // 4
    a, b = x[..., :q], x[..., q: 2 * q]
    c, d = x[..., 2 * q: 3 * q], x[..., 3 * q:]
    u = torch.cat([-c.flip(-1) - d, a - b.flip(-1)], dim=-1)
    return dct(u, type=4) * 0.5


def imdct_frame(X):
    """IMDCT of [..., N] -> (aliased, unwindowed) frames [..., 2N]."""
    X = real_part(X)
    n = X.shape[-1]
    if n % 2:
        raise ValueError(f"coefficient length must be even, got {n}")
    v = dct(X, type=4) * float(np.float32(1.0 / (2 * n)))
    u1, u2 = v[..., : n // 2], v[..., n // 2:]
    return torch.cat([u2, -u2.flip(-1), -u1.flip(-1), -u1], dim=-1)


def _window(window, n: int, device):
    """The analysis/synthesis window: the sine window of 2N points by
    default, False for none, else the caller's 2N points on ``device``."""
    if window is None:
        return sine_window(2 * n, device=device)
    return window if window is False else to_device(window, device)


def mdct(x, n: int, window=None):
    """Signal-level MDCT: real x [..., T] (T a multiple of N=n) ->
    coefficients [..., T/N - 1, N], 50%-overlapped sine-windowed frames
    (pass window=False for no window, or an array of length 2N)."""
    x = real_part(x)
    if x.shape[-1] % n:
        raise ValueError(
            f"signal length {x.shape[-1]} must be a multiple of N={n}")
    w = _window(window, n, x.device)
    frames = x.unfold(-1, 2 * n, n)  # [..., T//N - 1, 2N], a strided view
    return mdct_frame(frames if w is False else frames * w)


def imdct(X, window=None):
    """Inverse of :func:`mdct` by windowed overlap-add (TDAC): X
    [..., F, N] -> real signal [..., (F+1)*N].  The first and last
    half-frames carry boundary aliasing (no neighbor to cancel it) —
    interior samples reconstruct exactly."""
    X = real_part(X)
    n, nf = X.shape[-1], X.shape[-2]
    w = _window(window, n, X.device)
    # the analysis/synthesis pair above reconstructs x/2 after OLA
    # (windowed TDAC sums (w_a^2 + w_c^2)/2 = 1/2); the standard
    # synthesis factor 2 restores unity gain
    y = imdct_frame(X) * 2.0  # [..., F, 2N]
    if w is not False:
        y = y * w
    return _ola_slabs(y, n, (nf + 1) * n)
