"""STFT / ISTFT and the four classic windows (scipy.signal-style
semantics), the port of ``fft_wgpu_tpu.ops.stft``.

``stft`` frames a real signal and transforms every frame: on a CUDA
tensor in the segment-spectrum envelope (``cuda_welch.fused_welch_ok``
with nperseg = nfft = n_fft and no detrend) one launch of the framed-R2C
kernel (B20, ``cuda_welch.spec_rfft_c64``) does both, the center pad
included (the kernel reads the reflected points in place), without the
frame matrix, into complex64 ``[..., num, bins]``, returned as its
transposed view with no merge and no copy; anywhere else the frames go
through the plan's R2C.  The default window is built once per length and
device.  ``istft``
runs the C2R (the C2R kernel for pow2 n_fft on the card), the window and a
scatter-free overlap-add of K contiguous slabs (``_ola_slabs``), and
divides by the same overlap-add of the squared window, built on the
signal's device.

Windows are float64 numpy tables cast once to float32, as in the JAX
package, on ``device`` (the current CUDA device by default).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.complex_utils import as_args, from_args, merge, to_device
from ..utils.jit_cache import cached_call, shape_key
from .rfft import _rfft_split, irfft
from .windows import _finish, _ones

__all__ = ["hann_window", "hamming_window", "blackman_window", "bartlett_window", "stft",
           "istft"]


def _k_m(n: int, periodic: bool):
    return np.arange(n, dtype=np.float64), (n if periodic else n - 1)


def hann_window(n: int, *, periodic: bool = True, device=None):
    """Hann window (periodic=True matches scipy fftbins=True)."""
    if n == 1:
        return _ones(1, device)  # numpy parity; avoids m == 0
    k, m = _k_m(n, periodic)
    return _finish(0.5 - 0.5 * np.cos(2 * np.pi * k / m), n, device)


def hamming_window(n: int, *, periodic: bool = True, device=None):
    """Hamming window (periodic=True matches scipy fftbins=True)."""
    if n == 1:
        return _ones(1, device)
    k, m = _k_m(n, periodic)
    return _finish(0.54 - 0.46 * np.cos(2 * np.pi * k / m), n, device)


def blackman_window(n: int, *, periodic: bool = True, device=None):
    """Blackman window (periodic=True matches scipy fftbins=True)."""
    if n == 1:
        return _ones(1, device)
    k, m = _k_m(n, periodic)
    w = 0.42 - 0.5 * np.cos(2 * np.pi * k / m) + 0.08 * np.cos(4 * np.pi * k / m)
    return _finish(w, n, device)


def bartlett_window(n: int, *, periodic: bool = True, device=None):
    """Bartlett (triangular) window (periodic=True = scipy fftbins)."""
    if n == 1:
        return _ones(1, device)
    k, m = _k_m(n, periodic)
    return _finish(1.0 - np.abs(2.0 * k / m - 1.0), n, device)


def _frame(x, frame_len: int, hop: int):
    """[..., t] -> [..., num_frames, frame_len], num_frames = 1 + (t -
    frame_len) // hop: a strided view of ``x`` (no copy, no gather)."""
    t = x.shape[-1]
    if t < frame_len:
        raise ValueError(
            f"signal length {t} is shorter than n_fft={frame_len}; "
            "pad the input or pass center=True"
        )
    return x.unfold(-1, frame_len, hop)


def _ola_slabs(frames, hop: int, t: int):
    """Scatter-free overlap-add of ``[..., num, flen]`` frames at stride
    ``hop`` into ``[..., t]``: pad the frames to K*hop and add K contiguous
    shifted slabs (no flat-index scatter).  A frame tensor expanded along
    its num axis (one row broadcast) is read without copying it when
    K*hop == flen."""
    num, flen = frames.shape[-2], frames.shape[-1]
    lead = frames.shape[:-2]
    K = -(-flen // hop)
    if K * hop != flen:
        frames = torch.nn.functional.pad(frames, (0, K * hop - flen))
    ch = frames.reshape(*lead, num, K, hop)
    out = frames.new_zeros((*lead, num + K - 1, hop))
    for k in range(K):
        out[..., k:k + num, :] += ch[..., :, k, :]
    return out.reshape(*lead, (num + K - 1) * hop)[..., :t]


@functools.lru_cache(maxsize=None)
def _default_window(n: int, device) -> torch.Tensor:
    """stft's default window, the periodic hann of n points, built once per
    (n, device): a call copies no table to the device.  Never evicted: a
    captured graph may read it."""
    return hann_window(n, device=device)


def _prep_window(window, n_fft: int, win_length, device):
    """Resolve the analysis window to a float32 tensor of n_fft points on
    ``device``: default hann of win_length (or n_fft), and any window
    shorter than n_fft is padded centered (torch.stft win_length
    semantics)."""
    if window is None:
        window = _default_window(win_length or n_fft, device)
    window = to_device(window, device)
    wl = window.shape[0]
    if win_length is not None and wl != win_length:
        raise ValueError(f"window length {wl} != win_length {win_length}")
    if wl > n_fft:
        raise ValueError(f"window length {wl} exceeds n_fft {n_fft}")
    if wl < n_fft:
        left = (n_fft - wl) // 2
        window = torch.nn.functional.pad(window, (left, n_fft - wl - left))
    return window


def _window_args(window, n_fft: int, win_length, device):
    """The analysis window of a cached call (``utils.jit_cache``): the
    default one, a table cached per (length, device) that the call reads
    in place, as (window, ()); any other as an argument of the call, whose
    values then go through it, as (None, (window,))."""
    win = _prep_window(window, n_fft, win_length, device)
    return (win, ()) if window is None else (None, (win,))


def _on_card(t) -> bool:
    """Whether the kernel routes apply: a CUDA tensor (where the JAX
    package checks for its TPU backend)."""
    return t.is_cuda


def _reflect_pad(x, pad: int):
    """numpy's reflect pad of ``pad`` points at both ends of the last axis
    (torch's reflect pad takes 2-D and 3-D input: the rows are flattened)."""
    lead = x.shape[:-1]
    v = torch.nn.functional.pad(x.reshape(-1, x.shape[-1]), (pad, pad), mode="reflect")
    return v.reshape(*lead, v.shape[-1])


def stft(x, n_fft: int = 512, hop_length: int | None = None, window=None,
         center: bool = True, win_length: int | None = None):
    """Short-time Fourier transform of a real signal.

    Returns complex64 ``[..., n_fft//2 + 1, num_frames]`` (librosa-style
    layout; on the card a transposed view of the kernel's
    ``[..., num_frames, n_fft//2 + 1]`` output).  A tensor is transformed on
    its device; other input goes to the current CUDA device.  B20's route
    (one launch) runs eagerly; any other replays a captured graph from its
    second call on (``utils.jit_cache``)."""
    # imported here: cuda_welch imports this module
    from . import cuda_welch

    hop = hop_length or n_fft // 4
    x = to_device(x)
    win, args = _window_args(window, n_fft, win_length, x.device)
    pad = n_fft // 2 if center else 0
    fused = (_on_card(x) and pad < x.shape[-1]
             and cuda_welch.fused_welch_ok(x.shape[-1] + 2 * pad, n_fft, hop, n_fft, False))

    def impl(v, *w):
        w = w[0] if w else win
        if fused:
            # B20: the center pad, frames, window and R2C in one pass into
            # complex64, no merge
            return cuda_welch.spec_rfft_c64(v, w, n_fft, hop, n_fft, False,
                                            pad=pad).transpose(-1, -2)
        if center:
            v = _reflect_pad(v, pad)
        Xr, Xi = _rfft_split(_frame(v, n_fft, hop) * w, None, -1, None)
        return merge(Xr.transpose(-1, -2), Xi.transpose(-1, -2))

    key = None if fused else ("stft", shape_key(x), n_fft, hop, center, win_length,
                              None if args else "default")
    return cached_call(key, impl, x, *args)


def _cola_norm(window, num: int, hop: int, t: int):
    """The overlap-added squared window of ``num`` frames at stride hop,
    ``[t]``, with entries <= 1e-8 set to 1: istft's divisor, by the same
    slab overlap-add as the frames, on the window's device."""
    wsq = window * window
    norm = _ola_slabs(wsq.expand(num, wsq.shape[0]), hop, t)
    return torch.where(norm > 1e-8, norm, torch.ones_like(norm))


def istft(Z, n_fft: int = 512, hop_length: int | None = None, window=None,
          center: bool = True, length: int | None = None,
          win_length: int | None = None):
    """Inverse STFT via windowed overlap-add (COLA normalization) of
    ``[..., n_fft//2 + 1, num_frames]`` spectra; real float32 output."""
    hop = hop_length or n_fft // 4
    zs = as_args(Z)
    win, args = _window_args(window, n_fft, win_length, zs[0].device)

    def impl(*a):
        w = a[-1] if args else win
        zr, zi = from_args(a[:-1] if args else a)
        frames = irfft((zr.transpose(-1, -2), zi.transpose(-1, -2)), n=n_fft, axis=-1)
        frames = frames * w  # [..., num, n_fft]
        num = frames.shape[-2]
        t = n_fft + hop * (num - 1)
        return _ola_slabs(frames, hop, t) / _cola_norm(w, num, hop, t)

    key = ("istft", shape_key(zs[0]), n_fft, hop, win_length, None if args else "default")
    y = cached_call(key, impl, *zs, *args)
    if center:
        # trim the left reflect-pad; the right trim happens through length
        # below when given (torch serves length= from the right pad's
        # reconstructed samples before it zero-pads)
        y = y[..., n_fft // 2:]
        if length is None:
            y = y[..., : y.shape[-1] - n_fft // 2]
    if length is not None:
        if y.shape[-1] < length:
            y = torch.nn.functional.pad(y, (0, length - y.shape[-1]))
        y = y[..., :length]
    return y
