"""Spectral estimation: periodogram, Welch, CSD, coherence, spectrogram,
multitaper and Lomb-Scargle (scipy.signal parity), the port of
``fft_wgpu_tpu.ops.spectral_est``.

Conventions (scipy.signal's):
  * ``scaling="density"``: V**2/Hz, normalised by fs * sum(w**2);
    ``scaling="spectrum"``: V**2, normalised by sum(w)**2.
  * One-sided spectra double every bin but DC (and Nyquist for even
    nfft); complex input always gives the two-sided spectrum.
  * Welch's ``average="median"`` divides by the median's bias
    (scipy.signal._spectral_py._median_bias).

A tensor is computed on its device; other input goes to the current CUDA
device.  On a CUDA tensor a predicate picks each route before any launch,
in the cases where the JAX package takes its TPU kernels, with
``cuda_welch.fused_welch_ok`` as the gate:

  * the one-sided mean of real input (welch, periodogram): B16,
    ``welch_accum_split``;
  * the one-sided median of one real signal: B19, ``spec_psd_split``, then
    the median over segments;
  * ``csd`` of two real signals of one shape: B17; ``coherence``: B18;
  * ``spectrogram``'s one-sided psd and magnitude modes of real input: B19;
  * its one-sided complex mode of real input: B20's complex64 sink,
    ``spec_rfft_c64``, the normalisation folded into its store, returned
    as the transposed view with no merge;
  * the two-sided mean of one signal (complex input, or real input with
    ``return_onesided=False``): B21, ``welch_accum_c2c_c64``, read from the
    caller's complex64 tensor as it lies or from the planes (real input:
    no imaginary plane);
  * every other two-sided per-segment spectrum (complex input, or real
    input with ``return_onesided=False``): B22's complex64 sink,
    ``spec_c2c_c64``, read from the caller's complex64 tensor as it lies
    (:func:`_split` takes its planes as views, no copy) or from the planes
    (real input: no imaginary plane).  It serves the cross spectra and
    medians of complex input and two-sided ``csd`` (the products taken as
    complex tensors, conj(X) * Y) and every mode of the two-sided
    ``spectrogram`` (``mode="complex"`` the sink's transposed view, the
    normalisation folded into its store: one launch and nothing else);
  * every other one-sided per-segment spectrum,
    :func:`_spec_segments_split`: B20 (``spec_rfft_split``), the half
    spectra of real input (``spectrogram``'s angle and phase modes, the
    medians of cross spectra).

Outside the envelope (``detrend="linear"``, non-pow2 nfft, other shapes)
and on every CPU tensor :func:`_spec_segments_split` composes: frames,
detrend, window, then the plan's transforms (the R2C kernel for pow2 nfft
on the card, the composite R2C kernel for composite nfft, ``fftn_split``
for odd nfft and complex input).
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from ..core.complex_utils import default_device, is_pair, merge, promote_to_split, to_device
from ..core.twiddle import FORWARD
from . import cuda_welch
from . import windows as _windows
from .nd import fftn_split
from .rfft import rfft_last_split
from .stft import (_frame, _on_card, bartlett_window, blackman_window, hamming_window,
                   hann_window)
from .stockham import full_float32
from ..utils.jit_cache import cached_call, shape_key, window_key
from .windows import _finish, _ones

__all__ = [
    "get_window",
    "check_COLA",
    "check_NOLA",
    "tukey_window",
    "kaiser_window",
    "flattop_window",
    "dpss",
    "periodogram",
    "welch",
    "csd",
    "coherence",
    "multitaper",
    "spectrogram",
    "lombscargle",
]


def tukey_window(n: int, alpha: float = 0.5, *, periodic: bool = False, device=None):
    """Tukey (tapered cosine) window, scipy.signal.windows.tukey parity."""
    if n == 1 or alpha <= 0:
        return _ones(n, device)
    if alpha >= 1.0:
        return hann_window(n, periodic=periodic, device=device)
    m = n + 1 if periodic else n
    k = np.arange(m, dtype=np.float64)
    width = int(np.floor(alpha * (m - 1) / 2.0))
    w = np.ones(m, np.float64)
    edge = k[: width + 1]
    w[: width + 1] = 0.5 * (1 + np.cos(np.pi * (-1 + 2.0 * edge / alpha / (m - 1))))
    w[-(width + 1):] = w[: width + 1][::-1]
    return _finish(w, n, device)


def kaiser_window(n: int, beta: float = 8.6, *, periodic: bool = False, device=None):
    """Kaiser window (scipy.signal.windows.kaiser parity; sym = not periodic)."""
    if n == 1:
        return _ones(1, device)
    m = n + 1 if periodic else n
    k = np.arange(m, dtype=np.float64)
    alpha = (m - 1) / 2.0
    w = np.i0(beta * np.sqrt(1 - ((k - alpha) / alpha) ** 2)) / np.i0(beta)
    return _finish(w, n, device)


def flattop_window(n: int, *, periodic: bool = False, device=None):
    """Flat-top window (scipy.signal.windows.flattop coefficients)."""
    if n == 1:
        return _ones(1, device)
    m = n + 1 if periodic else n
    a = (0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368)
    k = np.arange(m, dtype=np.float64)
    fac = 2 * np.pi * k / (m - 1)
    w = np.zeros(m, np.float64)
    for j, aj in enumerate(a):
        w += (-1) ** j * aj * np.cos(j * fac)
    return _finish(w, n, device)


def _dpss_np(M: int, NW: float, Kmax: int | None, sym: bool, norm, return_ratios: bool):
    """dpss's float64 host math: (float32 windows [Kmax, M] or [M], the
    concentration ratios or None)."""
    if NW <= 0:
        raise ValueError("NW must be positive")
    squeeze = Kmax is None
    Kmax = 1 if Kmax is None else int(Kmax)
    if norm is None:
        norm = "approximate" if squeeze else 2
    if norm not in (2, "approximate", "subsample"):
        raise ValueError(f"norm must be 2, 'approximate' or 'subsample', "
                         f"got {norm!r}")
    trunc = 0
    if not sym:  # periodic window: compute at M+1, drop the last sample
        M, trunc = M + 1, 1
    if not 0 < Kmax <= M:
        raise ValueError("Kmax must be in (0, M]")
    if float(NW) >= M / 2.0:
        raise ValueError("NW must be < M/2")
    W = float(NW) / M
    from scipy.linalg import eigh_tridiagonal

    t = np.arange(M, dtype=np.float64)
    d = ((M - 1 - 2 * t) / 2.0) ** 2 * np.cos(2 * np.pi * W)
    e = t[1:] * (M - t[1:]) / 2.0
    _, wins = eigh_tridiagonal(d, e, select="i", select_range=(M - Kmax, M - 1))
    wins = wins[:, ::-1].T  # [Kmax, M], descending concentration
    # scipy's signs (Percival & Walden p. 379): symmetric tapers have a
    # positive mean; antisymmetric ones start with a positive lobe (the
    # first sample above numerical noise is positive)
    fix_even = wins[::2].sum(axis=1) < 0
    wins[::2][fix_even] *= -1
    thresh = max(1e-7, 1.0 / M)
    for i, w in enumerate(wins[1::2]):
        if w[w * w > thresh][0] < 0:
            wins[2 * i + 1] *= -1
    # concentration ratios lam_k = w^T R w, R[i,j] = sin(2 pi W (i-j)) /
    # (pi (i-j)), diagonal 2W, as an FFT linear convolution
    lam = None
    if return_ratios:
        dlt = np.arange(-(M - 1), M, dtype=np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            r = np.sin(2 * np.pi * W * dlt) / (np.pi * dlt)
        r[M - 1] = 2 * W
        L = int(2 ** np.ceil(np.log2(2 * M - 1)))
        Rf = np.fft.rfft(r, L)
        conv = np.fft.irfft(np.fft.rfft(wins, L, axis=1) * Rf, L, axis=1)
        lam = np.einsum("km,km->k", wins, conv[:, M - 1:2 * M - 1])
    if norm != 2:
        # scipy's unit peak: divide by the global max, then correct an
        # even M's peak placement ('approximate': closed form; 'subsample':
        # the exact half-sample shift through the FFT of window 0)
        wins /= wins.max()
        if M % 2 == 0:
            if norm == "approximate":
                correction = M * M / float(M * M + NW)
            else:
                s = np.fft.rfft(wins[0])
                shift = -(1 - 1.0 / M) * np.arange(1, M // 2 + 1)
                s[1:] *= 2 * np.exp(-1j * np.pi * shift)
                correction = M / s.real.sum()
            wins *= correction
    if trunc:
        wins = wins[:, :-trunc]
    out = wins.astype(np.float32)
    if squeeze:
        out = out[0]
        lam = None if lam is None else lam[0]
    return out, lam


def dpss(M: int, NW: float, Kmax: int | None = None, sym: bool = True, *,
         norm=None, return_ratios: bool = False, device=None):
    """Discrete prolate spheroidal (Slepian) tapers, scipy.signal.windows.dpss
    parity: the first ``Kmax`` eigenvectors of the symmetric tridiagonal
    concentration operator (Percival & Walden eq. 378), computed in float64
    on the host.  Float32 windows ``[Kmax, M]`` (``[M]`` when ``Kmax`` is
    None) on ``device``, with the float64 concentration ratios when
    ``return_ratios``."""
    wins, lam = _dpss_np(M, NW, Kmax, sym, norm, return_ratios)
    out = torch.from_numpy(np.ascontiguousarray(wins)).to(device or default_device())
    return (out, lam) if return_ratios else out


_WINDOWS = {
    "hann": hann_window,
    "hanning": hann_window,
    "hamming": hamming_window,
    "blackman": blackman_window,
    "bartlett": bartlett_window,
    "flattop": flattop_window,
    "triang": _windows.triang_window,
    "triangle": _windows.triang_window,
    "parzen": _windows.parzen_window,
    "bohman": _windows.bohman_window,
    "nuttall": _windows.nuttall_window,
    "blackmanharris": _windows.blackmanharris_window,
    "cosine": _windows.cosine_window,
    "halfcosine": _windows.cosine_window,
    "barthann": _windows.barthann_window,
    "lanczos": _windows.lanczos_window,
    "sinc": _windows.lanczos_window,
    "exponential": _windows.exponential_window,
    "poisson": _windows.exponential_window,
    # parameterised windows whose defaults scipy also accepts bare
    "tukey": tukey_window,
    "taylor": _windows.taylor_window,
}

# Parameterised windows of the (name, *params) tuple form.
_PARAM_WINDOWS = {
    "tukey": tukey_window,
    "kaiser": kaiser_window,
    "gaussian": _windows.gaussian_window,
    "gauss": _windows.gaussian_window,
    "general_gaussian": _windows.general_gaussian_window,
    "general_cosine": _windows.general_cosine_window,
    "general_hamming": _windows.general_hamming_window,
    "chebwin": _windows.chebwin_window,
    "cheb": _windows.chebwin_window,
    "taylor": _windows.taylor_window,
    "exponential": _windows.exponential_window,
    "poisson": _windows.exponential_window,
    "kaiser_bessel_derived": _windows.kaiser_bessel_derived_window,
}


def get_window(window, nperseg: int, fftbins=None, *, periodic: bool = True,
               device=None):
    """A window spec (a name, a (name, *params) tuple, or an array) as a
    float32 tensor of nperseg points on ``device`` (scipy.signal.get_window
    style; scipy's ``fftbins`` is accepted and sets ``periodic``).  An
    array window stays on its own device unless ``device`` is given."""
    if fftbins is not None:
        periodic = bool(fftbins)
    if isinstance(window, str):
        if window in ("boxcar", "rectangular", "ones"):
            return _ones(nperseg, device)
        fn = _WINDOWS.get(window)
        if fn is not None:
            return fn(nperseg, periodic=periodic, device=device)
        if window in _PARAM_WINDOWS:
            raise ValueError(f"window {window!r} requires parameters: pass "
                             f"a tuple like ({window!r}, param)")
        raise ValueError(f"unknown window {window!r}")
    if isinstance(window, tuple):
        name, *params = window
        if name == "dpss":
            return dpss(nperseg, *params, device=device)
        fn = _PARAM_WINDOWS.get(name)
        if fn is None:
            raise ValueError(f"unknown window {window!r}")
        return fn(nperseg, *params, periodic=periodic, device=device)
    w = to_device(window, device)
    if w.ndim != 1:
        raise ValueError("window must be 1-D")
    if w.shape[0] != nperseg:
        raise ValueError(f"window length {w.shape[0]} != nperseg {nperseg}")
    return w


def _detrend_seg(fr, detrend):
    """Per-segment detrend over the last axis ('constant'|'linear'|False)."""
    if detrend is False or detrend is None:
        return fr
    if detrend == "constant":
        return fr - fr.mean(-1, keepdim=True)
    if detrend == "linear":
        n = fr.shape[-1]
        tc = torch.arange(n, dtype=torch.float32, device=fr.device) - (n - 1) / 2.0
        slope = (fr * tc).sum(-1, keepdim=True) / (tc * tc).sum()
        return fr - fr.mean(-1, keepdim=True) - slope * tc
    raise ValueError(f"invalid detrend {detrend!r}")


def _median_bias(n: int) -> float:
    """Bias of the median of n periodogram samples (scipy parity)."""
    ii_2 = 2 * np.arange(1.0, (n - 1) // 2 + 1)
    return float(1 + np.sum(1.0 / (ii_2 + 1) - 1.0 / ii_2))


def _median(v, dim: int):
    """numpy's median along ``dim``: the mean of the two middle values for
    an even count (``torch.median`` takes the lower one)."""
    s = v.sort(dim).values
    n = v.shape[dim]
    return 0.5 * (s.select(dim, (n - 1) // 2) + s.select(dim, n // 2))


@functools.lru_cache(maxsize=None)
def _onesided_mult(nfft: int, device) -> torch.Tensor:
    """The one-sided doubling: 2 on every bin but DC and an even nfft's
    Nyquist, built once per (nfft, device) (a captured graph may read it:
    never evicted)."""
    mult = np.full(nfft // 2 + 1, 2.0, np.float32)
    mult[0] = 1.0
    if nfft % 2 == 0:
        mult[-1] = 1.0
    return torch.from_numpy(mult).to(device)


def _pad_last(v, n: int):
    return v if v.shape[-1] == n else torch.nn.functional.pad(v, (0, n - v.shape[-1]))


def _spec_segments_split(xr, xi, win, nperseg, hop, nfft, detrend):
    """Frame, detrend, window, transform: split ``[..., num, bins]``, the
    two-sided spectrum for complex input (planes xr, xi of one shape), the
    half spectrum for real (xi None).  On a CUDA tensor in the envelope B20
    does it all for real input (the two-sided spectra there take B22's
    complex64 sink, :func:`_spec_c2c`, before this is reached)."""
    if (xi is None and _on_card(xr)
            and cuda_welch.fused_welch_ok(xr.shape[-1], nperseg, hop, nfft, detrend)):
        return cuda_welch.spec_rfft_split(xr, win, nperseg, hop, nfft, detrend)
    frames_r = _pad_last(_detrend_seg(_frame(xr, nperseg, hop), detrend) * win, nfft)
    if xi is None:
        if nfft % 2 == 0:
            return rfft_last_split(frames_r, None)
        re, im = fftn_split(frames_r, torch.zeros_like(frames_r),
                            (frames_r.ndim - 1,), FORWARD, None)
        return re[..., : nfft // 2 + 1], im[..., : nfft // 2 + 1]
    frames_i = _pad_last(_detrend_seg(_frame(xi, nperseg, hop), detrend) * win, nfft)
    return fftn_split(frames_r, frames_i, (frames_r.ndim - 1,), FORWARD, None)


def _spec_c2c(xc, v, vi, axis, win, nperseg, hop, nfft, detrend, scale=None):
    """The two-sided per-segment spectra on the card, complex64 ``[...,
    num, nfft]``, by B22's complex64 sink: from the caller's complex64
    tensor ``xc`` as it lies where there is one (:func:`_c64`, moved like
    ``v``), else from the planes ``v`` and ``vi`` (None: a real signal, no
    imaginary plane read)."""
    if xc is not None:
        return cuda_welch.spec_c2c_c64(xc.movedim(axis, -1), win, nperseg, hop, nfft,
                                       detrend, scale=scale)
    return cuda_welch.spec_c2c_c64(v, win, nperseg, hop, nfft, detrend, scale=scale, im=vi)


def _power(X):
    """|X|^2 of a complex tensor, as float32."""
    return torch.view_as_real(X).square().sum(-1)


def _is_complex(x) -> bool:
    """True for complex input and explicit (re, im) pairs (a tuple of two
    tensors or arrays; a list is data).  Decided before promotion: real
    input is not given to promote_to_split, which would make it a zero
    imaginary plane (:func:`_promote`)."""
    if is_pair(x):
        return True
    if isinstance(x, torch.Tensor):
        return x.is_complex()
    return bool(np.iscomplexobj(x))


def _c64(x):
    """x itself where it is a complex64 tensor, which B22 reads as it lies
    (:func:`_spec_c2c`), else None."""
    return x if isinstance(x, torch.Tensor) and x.dtype == torch.complex64 else None


def _promote(x, device=None):
    """x as float32 planes (re, im) on ``device``, im None for real input,
    for which no imaginary plane is made."""
    if _is_complex(x):
        return promote_to_split(x, device)
    return to_device(x, device), None


def _split(x, device=None):
    """x as planes (re, im), im None for real input: the one promotion of
    an estimator's input (numpy input is copied to the card once).  A
    complex64 tensor already on ``device`` is not copied: its planes are
    views of it."""
    if _c64(x) is not None and (device is None or x.device == torch.device(device)):
        return x.real, x.imag
    return _promote(x, device)


def _call_args(xs, xc):
    """The planes ``xs`` of one input as a cached call's arguments (planes,
    complex64 tensor): a complex64 tensor ``xc``, whose planes ``xs`` are
    views (:func:`_split`), goes in as itself, so that the call copies it
    once and B22 and B21 read it as it lies.  :func:`_planes` undoes it."""
    return (None, None, xc) if xc is not None else (*xs, None)


def _planes(xr, xi, xc):
    """The planes (re, im) of :func:`_call_args`'s arguments."""
    return (xc.real, xc.imag) if xc is not None else (xr, xi)


def _split_pair(x, y):
    """_split of x and of y (None stays None); y that is not a tensor
    follows x's device."""
    xs = _split(x)
    if y is None:
        return xs, None
    return xs, _split(y, None if isinstance(y, torch.Tensor) else xs[0].device)


def _resolve_args(xs, ys, nperseg, noverlap, nfft, window, axis):
    """Fill in scipy's defaults for the split inputs ``xs`` and ``ys``
    (:func:`_split`).  ``win`` comes back as a CPU tensor (its
    normalisations are host numbers)."""
    (xr, xi), (yr, yi) = xs, ys or (None, None)
    # scipy broadcasts x and y; the equal-length case is supported
    if yr is not None and yr.shape[axis] != xr.shape[axis]:
        raise ValueError("x and y must have the same length along axis")
    n = xr.shape[axis]
    if nperseg is None:
        nperseg = min(256, n)
    if nperseg > n:
        warnings.warn(f"nperseg = {nperseg} is greater than signal length = {n}, "
                      f"using nperseg = {n}")
        nperseg = n
    if nfft is None:
        nfft = nperseg
    elif nfft < nperseg:
        raise ValueError("nfft must be >= nperseg")
    if noverlap is None:
        noverlap = nperseg // 2
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    win = get_window(window, nperseg, device="cpu")
    complex_input = xi is not None or yi is not None
    return nperseg, int(noverlap), nfft, win, complex_input


def _norm(win, fs: float, scaling: str) -> float:
    """The density or spectrum normalisation of the (CPU) window."""
    if scaling == "density":
        return 1.0 / (fs * float((win * win).sum()))
    if scaling == "spectrum":
        return 1.0 / float(win.sum()) ** 2
    raise ValueError(f"invalid scaling {scaling!r}")


@functools.lru_cache(maxsize=64)
def _grid_on(nfft: int, fs: float, onesided: bool, num: int, hop: int, nperseg: int,
             device):
    """The estimate's frequency grid, then the spectrogram's ``num`` segment
    times, as one float32 vector on ``device``, built once per key so that
    a call on the card copies no table there.  Never returned as it is:
    :func:`_grids` hands out copies."""
    f = (np.fft.rfftfreq if onesided else np.fft.fftfreq)(nfft, 1.0 / fs)
    t = (np.arange(num) * hop + nperseg / 2.0) / fs
    return torch.from_numpy(np.concatenate([f, t]).astype(np.float32)).to(device)


def _grids(nfft: int, fs: float, onesided: bool, device, num: int = 0, hop: int = 0,
           nperseg: int = 0):
    """The frequency grid f and the ``num`` segment times t (empty for
    num 0) of an estimate, fresh tensors on ``device``: one device copy of
    the cached grid, so that a caller's in-place edit of f or t (scipy's
    ``f /= 1e3``) reaches no other call."""
    g = _grid_on(nfft, float(fs), onesided, num, hop, nperseg, torch.device(device)).clone()
    nf = nfft // 2 + 1 if onesided else nfft
    return g[:nf], g[nf:]


def _freqs(nfft: int, fs: float, onesided: bool, device):
    """The estimate's frequency grid on ``device``, a fresh tensor."""
    return _grids(nfft, fs, onesided, device)[0]


@functools.lru_cache(maxsize=64)
def _named_window(window, nperseg: int, device):
    return get_window(window, nperseg, device="cpu").to(device)


def _window_on(window, win, device):
    """The CPU window ``win`` of the spec ``window`` on ``device``: a named
    window (a string, or a tuple of a name and numbers) is built there once
    per (spec, length, device), so that a call on the card copies no table
    there; an array window is copied."""
    named = isinstance(window, str) or (isinstance(window, tuple) and all(
        isinstance(p, (str, int, float)) for p in window))
    return _named_window(window, win.shape[0], device) if named else win.to(device)


def _empty_estimate(xr, yr, axis):
    """scipy's answer where a signal is empty, before any argument is
    checked: the frequencies and the estimate as one empty float32 tensor
    of x's shape (for two signals, of their broadcast outer shape and the
    shorter length), on x's device; None where no signal is empty."""
    if xr.numel() and (yr is None or yr.numel()):
        return None
    if yr is None:
        return xr.new_empty(xr.shape)
    outer = torch.broadcast_shapes(*(tuple(v.movedim(axis, -1).shape[:-1]) for v in (xr, yr)))
    return xr.new_empty((*outer, min(xr.shape[axis], yr.shape[axis]))).movedim(-1, axis)


def _csd_impl(xs, ys, fs, window, nperseg, noverlap, nfft, detrend,
              return_onesided, scaling, axis, average, xc=None, yc=None):
    """The estimate from the split inputs ``xs`` and ``ys`` (None: the
    auto-spectrum of x); ``xc`` and ``yc`` the callers' complex64 tensors
    where they were ones (:func:`_c64`).  An empty signal gives
    :func:`_empty_estimate` for the frequencies and both planes."""
    empty = _empty_estimate(xs[0], None if ys is None else ys[0], axis)
    if empty is not None:
        return empty, empty, empty, return_onesided
    nperseg, noverlap, nfft, win, complex_input = _resolve_args(
        xs, ys, nperseg, noverlap, nfft, window, axis)
    (xr, xi), (yr, yi) = xs, ys or (None, None)
    onesided = return_onesided and not complex_input
    hop = nperseg - noverlap
    norm = _norm(win, fs, scaling)
    win = _window_on(window, win, xr.device)
    same = ys is None
    wkey = window_key(window)
    key = None if wkey is None else (
        "csd", shape_key(xr), shape_key(xi), shape_key(yr), shape_key(yi), float(fs), wkey,
        nperseg, noverlap, nfft, detrend, return_onesided, scaling, axis, average)
    Pr, Pi = cached_call(
        key, lambda *a: _csd_estimate(*a, win, nperseg, hop, nfft, detrend, onesided, norm,
                                      axis, average, same),
        *_call_args((xr, xi), xc), *_call_args((yr, yi), yc))
    return _freqs(nfft, fs, onesided, Pr.device), Pr, Pi, onesided


def _csd_estimate(xr, xi, xc, yr, yi, yc, win, nperseg, hop, nfft, detrend, onesided, norm,
                  axis, average, same):
    """The device part of :func:`_csd_impl`, one cached call: (Pr, Pi) from
    the inputs as :func:`_call_args` gave them."""
    xr, xi = _planes(xr, xi, xc)
    yr, yi = _planes(yr, yi, yc)

    def mv(a):
        return None if a is None else a.movedim(axis, -1)

    xr_, xi_, yr_, yi_ = mv(xr), mv(xi), mv(yr), mv(yi)
    fused = (_on_card(xr_)
             and cuda_welch.fused_welch_ok(xr_.shape[-1], nperseg, hop, nfft, detrend))
    # two-sided output needs the full C2C path even for real input (B21 and
    # B22 read no imaginary plane of a real signal)
    if not onesided and xi_ is None and not fused:
        xi_ = torch.zeros_like(xr_)
    if not onesided and yr_ is not None and yi_ is None and not fused:
        yi_ = torch.zeros_like(yr_)

    if (onesided and xi_ is None
            and (same or (yi_ is None and yr_.shape == xr_.shape))
            and (average == "mean" or (average == "median" and same))
            and fused):
        # the segment-spectrum kernels: everything after them is on the
        # small bins vector
        args = (win, nperseg, hop, nfft, detrend)
        if not same:
            Pr, Pi, den = cuda_welch.csd_accum_split(xr_, yr_, *args)
        elif average == "mean":
            Pr, den = cuda_welch.welch_accum_split(xr_, *args)
            Pi = torch.zeros_like(Pr)
        else:  # median: the per-segment powers, then the median over segments
            P = cuda_welch.spec_psd_split(xr_, *args)
            Pr, den = _median(P, -2), _median_bias(P.shape[-2])
            Pi = torch.zeros_like(Pr)
        mult = _onesided_mult(nfft, Pr.device) * (norm / float(den))
        Pr, Pi = Pr * mult, Pi * mult
    elif not onesided and same and average == "mean" and fused:
        # B21: the two-sided sum over segments, every bin, from the caller's
        # complex64 tensor as it lies, else from the planes (real input: no
        # imaginary plane read)
        v, vi = (xc.movedim(axis, -1), None) if xc is not None else (xr_, xi_)
        psum, den = cuda_welch.welch_accum_c2c_c64(v, win, nperseg, hop, nfft, detrend, im=vi)
        Pr = psum * (norm / float(den))
        Pi = torch.zeros_like(Pr)
    else:
        if not onesided and fused:
            # B22's complex64 sink: the products taken as complex tensors
            args = (axis, win, nperseg, hop, nfft, detrend)
            X = _spec_c2c(xc, xr_, xi_, *args)
            if same:
                Pr = _power(X)  # X * conj(X)
                Pi = torch.zeros_like(Pr)
            else:
                P = X.conj() * _spec_c2c(yc, yr_, yi_, *args)  # scipy: Pxy = conj(X) * Y
                Pr, Pi = P.real, P.imag
        else:
            Xr, Xi = _spec_segments_split(xr_, xi_, win, nperseg, hop, nfft, detrend)
            if same:
                Pr = Xr * Xr + Xi * Xi  # X * conj(X)
                Pi = torch.zeros_like(Pr)
            else:
                Yr, Yi = _spec_segments_split(yr_, yi_, win, nperseg, hop, nfft, detrend)
                # scipy: Pxy = conj(X) * Y
                Pr = Xr * Yr + Xi * Yi
                Pi = Xr * Yi - Xi * Yr
        if average == "mean":
            Pr, Pi = Pr.mean(-2), Pi.mean(-2)
        elif average == "median":
            bias = _median_bias(Pr.shape[-2])
            Pr, Pi = _median(Pr, -2) / bias, _median(Pi, -2) / bias
        else:
            raise ValueError(f"invalid average {average!r}")
        Pr, Pi = Pr * norm, Pi * norm
        if onesided:
            mult = _onesided_mult(nfft, Pr.device)
            Pr, Pi = Pr * mult, Pi * mult
    return Pr.movedim(-1, axis), Pi.movedim(-1, axis)


def periodogram(x, fs: float = 1.0, window="boxcar", nfft: int | None = None,
                detrend="constant", return_onesided: bool = True,
                scaling: str = "density", axis: int = -1):
    """Power spectral density from one segment (scipy.signal parity).

    Returns (f, Pxx); Pxx is real float32.  An ``nfft`` below the signal's
    length cuts the signal to its first nfft samples, as scipy does.
    """
    xs, xc = _split(x), _c64(x)
    if nfft is not None and 0 <= nfft < xs[0].shape[axis]:
        xs = tuple(None if v is None else v.narrow(axis, 0, nfft).contiguous() for v in xs)
        xc = nfft = None
    f, Pr, _Pi, _onesided = _csd_impl(
        xs, None, fs, window, xs[0].shape[axis], 0, nfft, detrend, return_onesided,
        scaling, axis, "mean", xc)
    return f, Pr


def welch(x, fs: float = 1.0, window="hann", nperseg: int | None = None,
          noverlap: int | None = None, nfft: int | None = None,
          detrend="constant", return_onesided: bool = True,
          scaling: str = "density", axis: int = -1, average: str = "mean"):
    """Welch's averaged-periodogram PSD (scipy.signal.welch parity).

    Returns (f, Pxx); Pxx is real float32.
    """
    f, Pr, _Pi, _onesided = _csd_impl(
        _split(x), None, fs, window, nperseg, noverlap, nfft, detrend,
        return_onesided, scaling, axis, average, _c64(x))
    return f, Pr


def csd(x, y, fs: float = 1.0, window="hann", nperseg: int | None = None,
        noverlap: int | None = None, nfft: int | None = None,
        detrend="constant", return_onesided: bool = True,
        scaling: str = "density", axis: int = -1, average: str = "mean"):
    """Cross power spectral density Pxy = E[conj(X) Y] (scipy parity).

    Returns (f, Pxy) with complex64 Pxy.
    """
    f, Pr, Pi, _onesided = _csd_impl(
        *_split_pair(x, y), fs, window, nperseg, noverlap, nfft, detrend,
        return_onesided, scaling, axis, average, _c64(x), _c64(y))
    return f, merge(Pr, Pi)


def coherence(x, y, fs: float = 1.0, window="hann",
              nperseg: int | None = None, noverlap: int | None = None,
              nfft: int | None = None, detrend="constant", axis: int = -1):
    """Magnitude-squared coherence Cxy = |Pxy|^2 / (Pxx Pyy) (scipy parity).

    On the card, two real signals of one shape in the envelope take one
    sweep of B18 (conj(X)Y, |X|^2 and |Y|^2 together; the normalisations
    cancel); otherwise three estimates."""
    xs, ys = _split_pair(x, y)
    (xr, xi), (yr, yi) = xs, ys
    if xr.shape[axis] != yr.shape[axis]:  # :func:`_resolve_args`'s check, for empty signals too
        raise ValueError("x and y must have the same length along axis")
    # (an empty signal takes the three estimates: :func:`_empty_estimate`)
    if xi is None and yi is None and _on_card(xr) and xr.numel() and yr.numel():
        np_, no_, nf_, win, _c = _resolve_args(xs, ys, nperseg, noverlap, nfft, window, axis)
        hop = np_ - no_
        if (xr.shape == yr.shape
                and cuda_welch.fused_welch_ok(xr.shape[axis], np_, hop, nf_, detrend)):
            w = _window_on(window, win, xr.device)

            def impl(vr, wr):
                Pr, Pi, Sxx, Syy, _num = cuda_welch.coherence_accum_split(
                    vr.movedim(axis, -1), wr.movedim(axis, -1), w, np_, hop, nf_, detrend)
                return ((Pr * Pr + Pi * Pi) / (Sxx * Syy)).movedim(-1, axis)

            wkey = window_key(window)
            key = None if wkey is None else (
                "coh", shape_key(xr), shape_key(yr), wkey, np_, hop, nf_, detrend, axis)
            C = cached_call(key, impl, xr, yr)
            return _freqs(nf_, fs, True, C.device), C
    f, Pxyr, Pxyi, _ = _csd_impl(xs, ys, fs, window, nperseg, noverlap, nfft,
                                 detrend, True, "density", axis, "mean", _c64(x), _c64(y))
    _, Pxx, _, _ = _csd_impl(xs, None, fs, window, nperseg, noverlap, nfft,
                             detrend, True, "density", axis, "mean", _c64(x))
    _, Pyy, _, _ = _csd_impl(ys, None, fs, window, nperseg, noverlap, nfft,
                             detrend, True, "density", axis, "mean", _c64(y))
    return f, (Pxyr * Pxyr + Pxyi * Pxyi) / (Pxx * Pyy)


def multitaper(x, fs: float = 1.0, NW: float = 4.0, K: int | None = None,
               nfft: int | None = None, detrend="constant",
               return_onesided: bool = True, axis: int = -1,
               weights: str = "adaptive", n_iter: int = 10):
    """Thomson multitaper PSD estimate with DPSS tapers.

    Not in scipy.signal; conventions follow Percival & Walden.  ``K``
    defaults to ``floor(2 NW) - 1`` tapers.  ``weights``: 'unity' (the mean
    of the eigenspectra), 'eigen' (weighted by concentration) or 'adaptive'
    (Thomson's data-dependent weights, ``n_iter`` fixed-point steps).  The
    K tapered transforms run as one batched R2C (C2C for odd nfft and
    complex input).  Returns (f, Pxx) in V**2/Hz; Pxx is real float32.
    """
    xr, xi = _split(x)
    n = xr.shape[axis]
    if K is None:
        K = max(int(2 * NW) - 1, 1)
    if nfft is None:
        nfft = n
    elif nfft < n:
        raise ValueError("nfft must be >= signal length")
    onesided = return_onesided and xi is None
    if weights not in ("unity", "eigen", "adaptive"):
        raise ValueError(f"invalid weights {weights!r}")
    tapers, lam32 = _taper_tables(n, float(NW), K, xr.device)
    key = ("mt", shape_key(xr), shape_key(xi), float(fs), float(NW), K, nfft, detrend,
           onesided, weights, axis, n_iter)
    S = cached_call(key, lambda *a: _multitaper_estimate(
        *a, tapers, lam32, fs, nfft, detrend, onesided, axis, weights, n_iter),
        *_call_args((xr, xi), _c64(x)))
    return _freqs(nfft, fs, onesided, S.device), S


@functools.lru_cache(maxsize=16)
def _taper_tables(n: int, NW: float, K: int, device):
    """The K DPSS tapers of n points and their concentrations, float32 on
    ``device``, built once per (n, NW, K, device)."""
    tapers_np, lam = _dpss_np(n, NW, K, True, None, True)
    return (torch.from_numpy(np.ascontiguousarray(tapers_np)).to(device),
            torch.from_numpy(np.asarray(lam, np.float64).astype(np.float32)).to(device))


def _multitaper_estimate(xr, xi, xc, tapers, lam32, fs, nfft, detrend, onesided, axis,
                         weights, n_iter):
    """The device part of :func:`multitaper`, one cached call."""
    xr, xi = _planes(xr, xi, xc)
    dev = xr.device
    v_r = _detrend_seg(xr.movedim(axis, -1), detrend)
    # two-sided output needs the full C2C path even for real input
    if not onesided and xi is None:
        xi = torch.zeros_like(xr)
    t_r = v_r[..., None, :] * tapers  # [..., K, n]
    if xi is None:
        t_r = _pad_last(t_r, nfft)
        if nfft % 2 == 0:
            Xr, Xi = rfft_last_split(t_r, None)
        else:
            Xr, Xi = fftn_split(t_r, torch.zeros_like(t_r), (t_r.ndim - 1,), FORWARD, None)
            Xr, Xi = Xr[..., : nfft // 2 + 1], Xi[..., : nfft // 2 + 1]
    else:
        v_i = _detrend_seg(xi.movedim(axis, -1), detrend)
        t_r = _pad_last(t_r, nfft)
        t_i = _pad_last(v_i[..., None, :] * tapers, nfft)
        Xr, Xi = fftn_split(t_r, t_i, (t_r.ndim - 1,), FORWARD, None)
    Sk = (Xr * Xr + Xi * Xi) / fs  # [..., K, bins] eigenspectra
    if weights == "unity":
        S = Sk.mean(-2)
    elif weights == "eigen":
        S = (Sk * lam32[:, None]).sum(-2) / lam32.sum()
    else:
        # Thomson's adaptive weights: b_k = S / (lam_k S + (1 - lam_k) s2)
        s2 = (v_r * v_r).mean(-1, keepdim=True)[..., None]
        if xi is not None:
            s2 = s2 + (v_i * v_i).mean(-1, keepdim=True)[..., None]
        lamc = lam32[:, None]
        S = Sk[..., :2, :].mean(-2)
        for _ in range(n_iter):
            b = S[..., None, :] / (lamc * S[..., None, :] + (1 - lamc) * s2 + 1e-30)
            w = b * b * lamc
            S = (w * Sk).sum(-2) / (w.sum(-2) + 1e-30)
    if onesided:
        S = S * _onesided_mult(nfft, dev)
    return S.movedim(-1, axis)


def _unwrap(p, dim: int = -1):
    """numpy's unwrap along ``dim`` (period 2 pi)."""
    dd = p.diff(dim=dim)
    ddmod = torch.remainder(dd + np.pi, 2 * np.pi) - np.pi
    ddmod = torch.where((ddmod == -np.pi) & (dd > 0), torch.full_like(ddmod, np.pi), ddmod)
    correct = torch.where(dd.abs() < np.pi, torch.zeros_like(dd), ddmod - dd)
    first = p.narrow(dim, 0, 1)
    return torch.cat([first, p.narrow(dim, 1, p.shape[dim] - 1) + correct.cumsum(dim)], dim)


def spectrogram(x, fs: float = 1.0, window=("tukey", 0.25),
                nperseg: int | None = None, noverlap: int | None = None,
                nfft: int | None = None, detrend="constant",
                return_onesided: bool = True, scaling: str = "density",
                axis: int = -1, mode: str = "psd"):
    """Spectrogram over sliding segments (scipy.signal.spectrogram parity).

    Returns (f, t, Sxx): segment times t and Sxx ``[..., bins, num]`` (the
    last two axes frequency and time).  mode: 'psd' (default),
    'magnitude', 'complex', 'angle' or 'phase' (unwrapped along time).
    The complex mode on the card's kernels (B20 or B22, one launch) runs
    eagerly; any other call replays a captured graph from its second call
    on (``utils.jit_cache``).
    """
    xr, xi = xs = _split(x)
    nperseg, noverlap_d, nfft, win, complex_input = _resolve_args(
        xs, None, nperseg, noverlap, nfft, window, axis)
    # scipy's spectrogram default overlap is nperseg // 8, not // 2
    if noverlap is None:
        noverlap_d = nperseg // 8
    hop = nperseg - noverlap_d
    onesided = return_onesided and not complex_input
    norm = _norm(win, fs, scaling)
    win = _window_on(window, win, xr.device)
    wkey = window_key(window)
    one_launch = mode == "complex" and _on_card(xr) and cuda_welch.fused_welch_ok(
        xr.shape[axis], nperseg, hop, nfft, detrend)
    key = None if wkey is None or one_launch else (
        "spec", shape_key(xr), shape_key(xi), float(fs), wkey, nperseg, hop, nfft, detrend,
        return_onesided, scaling, axis, mode)
    out = cached_call(key, lambda *a: _spectrogram_estimate(
        *a, win, nperseg, hop, nfft, detrend, onesided, norm, axis, mode),
        *_call_args(xs, _c64(x)))
    num = 1 + (xr.shape[axis] - nperseg) // hop
    f, t = _grids(nfft, fs, onesided, out.device, num, hop, nperseg)
    return f, t, out


def _spectrogram_estimate(xr, xi, xc, win, nperseg, hop, nfft, detrend, onesided, norm, axis,
                          mode):
    """The device part of :func:`spectrogram`, one cached call."""
    xr, xi = _planes(xr, xi, xc)
    v_r = xr.movedim(axis, -1)
    v_i = None if xi is None else xi.movedim(axis, -1)
    fused = (_on_card(v_r)
             and cuda_welch.fused_welch_ok(v_r.shape[-1], nperseg, hop, nfft, detrend))
    if not onesided and v_i is None and not fused:
        v_i = torch.zeros_like(v_r)  # two-sided needs the full C2C path
    if mode in ("psd", "magnitude") and onesided and v_i is None and fused:
        # B19: the per-segment powers, without the frame matrix
        P = cuda_welch.spec_psd_split(v_r, win, nperseg, hop, nfft, detrend)
        if mode == "magnitude":
            S = P.sqrt() * float(np.sqrt(norm))
        else:
            S = P * norm * _onesided_mult(nfft, P.device)
        out = S.transpose(-1, -2)
    elif mode == "complex" and onesided and v_i is None and fused:
        # B20's complex64 sink, the normalisation folded in: no merge
        out = cuda_welch.spec_rfft_c64(v_r, win, nperseg, hop, nfft, detrend,
                                       scale=float(np.sqrt(norm))).transpose(-1, -2)
    elif not onesided and fused and mode in ("psd", "magnitude", "complex", "angle",
                                             "phase"):
        # B22's complex64 sink, sqrt(norm) folded into its store (every mode
        # but the angles, which it leaves as they are): the complex mode is
        # its transposed view, the others are computed from it
        s = None if mode in ("angle", "phase") else float(np.sqrt(norm))
        X = _spec_c2c(xc, v_r, v_i, axis, win, nperseg, hop, nfft, detrend,
                      s).transpose(-1, -2)
        if mode == "psd":
            out = _power(X)
        elif mode == "magnitude":
            out = X.abs()
        elif mode == "complex":
            out = X
        else:
            out = X.angle()
            if mode == "phase":  # scipy: unwrapped along the time axis
                out = _unwrap(out, -1)
    else:
        Xr, Xi = _spec_segments_split(v_r, v_i, win, nperseg, hop, nfft, detrend)
        if mode == "psd":
            S = (Xr * Xr + Xi * Xi) * norm
            if onesided:
                S = S * _onesided_mult(nfft, S.device)
            out = S.transpose(-1, -2)
        elif mode == "magnitude":
            out = ((Xr * Xr + Xi * Xi).sqrt() * float(np.sqrt(norm))).transpose(-1, -2)
        elif mode == "complex":
            s = float(np.sqrt(norm))
            out = merge(Xr.transpose(-1, -2) * s, Xi.transpose(-1, -2) * s)
        elif mode in ("angle", "phase"):
            out = torch.atan2(Xi, Xr).transpose(-1, -2)
            if mode == "phase":  # scipy: unwrapped along the time axis
                out = _unwrap(out, -1)
        else:
            raise ValueError(f"invalid mode {mode!r}")
    return out


def _lombscargle_core(x, y, w, freqs, floating_mean: bool):
    """Zechmeister-Kuerster generalised Lomb-Scargle (scipy 1.17's
    lombscargle): (a, b, tau, YC, YS, YY) per frequency, from [N] x [N, K]
    products in full float32."""
    with full_float32(x):
        wy = w * y
        ft = freqs[None, :] * x[:, None]  # [N, K]
        cos1, sin1 = torch.cos(ft), torch.sin(ft)
        Y = torch.dot(w, y)
        CC = w @ (cos1 * cos1)
        SS = 1.0 - CC
        CS = w @ (cos1 * sin1)
        if floating_mean:
            C, S = w @ cos1, w @ sin1
            CC, SS, CS = CC - C * C, SS - S * S, CS - C * S
        tau = 0.5 * torch.atan2(2.0 * CS, CC - SS)
        ctau, stau = torch.cos(tau), torch.sin(tau)
        # cos(ft - tau), sin(ft - tau) without the trig of ft again
        cosr = cos1 * ctau + sin1 * stau
        sinr = sin1 * ctau - cos1 * stau
        YC, YS = wy @ cosr, wy @ sinr
        CC = w @ (cosr * cosr)
        SS = 1.0 - CC
        if floating_mean:
            C, S = w @ cosr, w @ sinr
            YC, YS = YC - Y * C, YS - Y * S
            CC, SS = CC - C * C, SS - S * S
        eps = float(np.finfo(np.float32).epsneg)
        CC, SS = CC.clamp(min=eps), SS.clamp(min=eps)
        YY = torch.dot(wy, y)
        if floating_mean:
            YY = YY - Y * Y
    return YC / CC, YS / SS, tau, YC, YS, YY


def lombscargle(x, y, freqs, *, precenter=False, normalize=False,
                weights=None, floating_mean: bool = False):
    """Generalised (weighted, floating-mean) Lomb-Scargle periodogram of
    unevenly sampled data (scipy.signal.lombscargle >= 1.17 parity).

    normalize: False/'power' (A^2 N/4 units), True/'normalize' (the [0, 1]
    fraction of the variance), or 'amplitude' (the complex best fit
    a + ib, corrected by tau).  ``precenter`` subtracts y's mean first
    (scipy's deprecated knob; prefer floating_mean).  Runs on x's device.
    """
    if precenter:
        warnings.warn("the 'precenter' keyword is deprecated (scipy "
                      "1.17); use floating_mean instead",
                      DeprecationWarning, stacklevel=2)
        y = y - y.mean()
    x = to_device(x)
    y = to_device(y, x.device)
    freqs = to_device(freqs, x.device)
    if x.ndim != 1 or x.shape != y.shape or x.numel() == 0:
        raise ValueError("x and y must be equal-length non-empty 1-D arrays")
    if freqs.ndim != 1 or freqs.numel() == 0:
        raise ValueError("freqs must be a non-empty 1-D array")
    if weights is None:
        w = np.full(x.shape[0], 1.0 / x.shape[0], np.float32)
    else:
        w = np.asarray(weights.cpu() if isinstance(weights, torch.Tensor) else weights,
                       np.float64)
        if w.shape != tuple(x.shape) or (w < 0).any() or w.sum() <= 0:
            raise ValueError("weights must be non-negative, match x, and "
                             "sum to a positive value")
        w = (w / w.sum()).astype(np.float32)
    if isinstance(normalize, bool):
        normalize = "normalize" if normalize else "power"
    if normalize not in ("power", "normalize", "amplitude"):
        raise ValueError("normalize must be False/'power', "
                         "True/'normalize', or 'amplitude'")
    a, b, tau, YC, YS, YY = _lombscargle_core(
        x, y, torch.from_numpy(w).to(x.device), freqs, bool(floating_mean))
    pgram = 2.0 * (a * YC + b * YS)
    if normalize == "power":
        return pgram * (x.shape[0] / 4.0)
    if normalize == "normalize":
        return pgram * (0.5 / YY)
    # amplitude: (a + ib) e^{i tau}
    ct, st = torch.cos(tau), torch.sin(tau)
    return merge(a * ct - b * st, a * st + b * ct)


def _ola_binsums(window, nperseg: int, noverlap: int, power: float):
    """Overlap-added window (or window-power) sums over one hop period."""
    nperseg = int(nperseg)
    noverlap = int(noverlap)
    if nperseg < 1:
        raise ValueError("nperseg must be a positive integer")
    if not 0 <= noverlap < nperseg:
        raise ValueError("noverlap must satisfy 0 <= noverlap < nperseg")
    win = get_window(window, nperseg, periodic=True, device="cpu").numpy()
    w = win.astype(np.float64) ** power
    step = nperseg - noverlap
    binsums = sum(w[ii * step:(ii + 1) * step] for ii in range(nperseg // step))
    if nperseg % step != 0:
        binsums[: nperseg % step] += w[-(nperseg % step):]
    return binsums


def check_COLA(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """True if (window, hop) satisfies the Constant-OverLap-Add constraint
    (scipy.signal.check_COLA parity).  Windows are float32 tables, so a
    mathematically COLA pair deviates by ~1e-8, not 0: the tolerance floors
    at a few float32 ulps of the overlap-add level; non-COLA pairs deviate
    at O(1)."""
    binsums = _ola_binsums(window, nperseg, noverlap, 1.0)
    tol = max(float(tol), 32 * float(np.finfo(np.float32).eps) * float(np.max(binsums)))
    return bool(np.max(np.abs(binsums - np.median(binsums))) < tol)


def check_NOLA(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """True if (window, hop) satisfies the NOnzero-OverLap-Add constraint
    (scipy.signal.check_NOLA parity: the overlap-added squared window's
    minimum exceeds tol)."""
    binsums = _ola_binsums(window, nperseg, noverlap, 2.0)
    return bool(np.min(binsums) > tol)
