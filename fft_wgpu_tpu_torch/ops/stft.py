"""The four classic windows and the segment framing of
``fft_wgpu_tpu.ops.stft``.

Only what the spectral estimators need is here: ``hann_window``,
``hamming_window``, ``blackman_window``, ``bartlett_window`` and
``_frame``.  ``stft``, ``istft``, ``_ola_slabs`` and ``_prep_window`` come
with the per-segment complex spectra and their kernels (ROADMAP slice 8b).

Windows are float64 numpy tables cast once to float32, as in the JAX
package, on ``device`` (the current CUDA device by default).
"""

from __future__ import annotations

import numpy as np

from .windows import _finish, _ones

__all__ = ["hann_window", "hamming_window", "blackman_window", "bartlett_window"]


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
