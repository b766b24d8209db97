"""Polyphase filter-bank channelizer (WOLA), the SDR and radio-astronomy
workhorse built on batched FFTs (torch port of
``fft_wgpu_tpu.ops.channelizer``).

Splits a stream into P uniformly spaced frequency channels, each
decimated by P: frames of length T = taps*P are weighted by a prototype
lowpass h, folded (summed) into P points, and transformed — the classic
weighted-overlap-add (WOLA) structure, equivalent to a polyphase
decimating filter bank.  The fold is ``taps`` products of hop-strided
views of the signal (no frame matrix); the transform is the plan's C2C
over the P channels (on the card the row kernel for pow2 P, complex input
through its complex64 entry).

    channelize(x, P) -> [..., frames, P] complex channel series

Prototype filter: windowed-sinc lowpass with cutoff 1/(2P) (Hamming by
default), unit DC gain per channel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.complex_utils import (default_device, host_table, is_pair, merge,
                                 promote_to_split, to_device)
from .helpers import _tensor
from .transforms import fft

__all__ = ["prototype_lowpass", "channelize"]


def prototype_lowpass(n_ch: int, taps: int = 8, window: str = "hamming", *, device=None):
    """Windowed-sinc prototype lowpass of length taps*n_ch with cutoff at
    the channel half-width 1/(2 n_ch), normalized to unit DC gain, on
    ``device`` (the current CUDA device by default)."""
    t = taps * n_ch
    n = np.arange(t, dtype=np.float64) - (t - 1) / 2.0
    h = np.sinc(n / n_ch)
    if window == "hamming":
        w = np.hamming(t)
    elif window == "hann":
        w = np.hanning(t)
    elif window in (None, "boxcar"):
        w = np.ones(t)
    else:
        raise ValueError(f"unknown window {window!r}")
    h = h * w
    return host_table(h / h.sum(), device or default_device())


def channelize(x, n_ch: int, *, taps: int = 8, window: str = "hamming",
               proto=None):
    """WOLA channelizer: real or complex x [..., T] -> complex channel
    series [..., F, n_ch] with F = T//n_ch - taps + 1 frames (hop n_ch).

    Channel c of frame m is the input mixed down from center frequency
    c/n_ch (cycles/sample), lowpass-filtered by the prototype, and
    decimated by n_ch."""
    x = merge(*promote_to_split(x)) if is_pair(x) else _tensor(x)
    if not x.is_complex():
        x = x.to(torch.float32)
    h = (prototype_lowpass(n_ch, taps, window, device=x.device) if proto is None
         else to_device(proto, x.device))
    t = int(h.shape[0])
    if t % n_ch:
        raise ValueError("prototype length must be a multiple of n_ch")
    total = x.shape[-1]
    frames = total // n_ch - (t // n_ch) + 1
    if frames < 1:
        raise ValueError(
            f"signal too short: need >= {t} samples, got {total}")
    k = t // n_ch
    # fold T = taps*n_ch weighted samples into n_ch (the polyphase sum):
    # tap j of frame m reads block m + j of the signal
    blocks = x[..., :(frames + k - 1) * n_ch].reshape(*x.shape[:-1], frames + k - 1, n_ch)
    hb = h.view(k, n_ch)
    acc = blocks[..., :frames, :] * hb[0]
    for j in range(1, k):
        acc = acc + blocks[..., j:j + frames, :] * hb[j]
    return fft(acc, axis=-1)
