"""Chirp-Z transform and zoom FFT (scipy.signal-compatible): the port's
counterpart of ``fft_wgpu_tpu.ops.czt``.

The generalization of ops/bluestein.py: evaluate the z-transform on an
arbitrary logarithmic spiral  z_k = a * w^{-k}, k = 0..m-1:

    X[k] = sum_j x[j] * a^{-j} * w^{jk}

via the chirp factorization w^{jk} = w^{(j^2 + k^2 - (k-j)^2)/2} and one
power-of-two FFT convolution of length L >= n + m - 1.  All chirp tables
are generated on the host in complex128.

On a CUDA tensor with L <= 16384 the whole transform is one launch of
``chirp_full`` (``csrc/chirp_fft.cu``, through
``cuda_fft.fft_chirp_full_split``: the input chirp at the first FFT's
loads, the filter at the second's loads, the output chirp and the m-slice
at its stores, each L-point row in shared memory between the two);
otherwise (a CPU tensor, or a larger L) the composed path runs through
the plan.  The route is picked by the envelope predicate.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.complex_utils import merge, promote_to_split
from . import cuda_fft

__all__ = ["czt", "zoom_fft", "CZT", "ZoomFFT", "czt_points"]

# Device copies of the chirp tables, keyed by (n, m, w, a, device).
_TABLES: dict = {}


@functools.lru_cache(maxsize=None)
def _czt_tables(n: int, m: int, w: complex, a: complex):
    """(A, Wk, Vf, L): input chirp [n], output chirp [m], filter spectrum
    [L] (a copy of the JAX package's, bit for bit)."""
    # chirp exponents j^2/2 can overflow the phase; use complex128 pow of
    # the PHASE instead: w = rho*exp(i*phi): w^(j^2/2) computed via exp.
    logw = np.log(complex(w))
    loga = np.log(complex(a))
    jn = np.arange(n, dtype=np.float64)
    jm = np.arange(m, dtype=np.float64)
    A = np.exp(-jn * loga + (jn**2 / 2.0) * logw)        # a^{-j} w^{j^2/2}
    Wk = np.exp((jm**2 / 2.0) * logw)                    # w^{k^2/2}
    L = 1 << int(np.ceil(np.log2(n + m - 1)))
    t = np.zeros(L, dtype=np.complex128)
    idx = np.arange(m, dtype=np.float64)
    t[:m] = np.exp(-(idx**2 / 2.0) * logw)               # v[t] = w^{-t^2/2}
    tail = np.arange(1, n, dtype=np.float64)
    t[L - (n - 1):] = np.exp(-(tail[::-1] ** 2 / 2.0) * logw)
    Vf = np.fft.fft(t)
    f32 = lambda z: (z.real.astype(np.float32), z.imag.astype(np.float32))  # noqa: E731
    return f32(A), f32(Wk), f32(Vf), L


def _device_tables(n: int, m: int, w: complex, a: complex, device):
    """The tables of :func:`_czt_tables` as float32 tensors on ``device``:
    ((Ar, Ai), (Wr, Wi), (Vr, Vi)), and L."""
    key = (n, m, w, a, str(device))
    tabs = _TABLES.get(key)
    if tabs is None:
        *pairs, L = _czt_tables(n, m, w, a)
        tabs = _TABLES[key] = (tuple(tuple(torch.from_numpy(t).to(device) for t in p)
                                     for p in pairs), L)
    return tabs


def _czt_split(re, im, m: int, w: complex, a: complex):
    """The CZT over the last axis of a planar pair: [..., n] -> [..., m]."""
    from ..plan.plan import get_plan

    n = re.shape[-1]
    ((Ar, Ai), (Wr, Wi), (Vr, Vi)), L = _device_tables(n, m, w, a, re.device)
    if re.device.type == "cuda" and cuda_fft._chirp_supported(L, max(n, m)):
        return cuda_fft.fft_chirp_full_split(re, im, Ar, Ai, Vr, Vi, Wr, Wi, L, m, 1.0 / L)
    # composed path (CPU, or L outside the chirp passes' envelope)
    pad = (0, L - n)
    yr = torch.nn.functional.pad(re * Ar - im * Ai, pad)
    yi = torch.nn.functional.pad(re * Ai + im * Ar, pad)
    p = get_plan(L, "auto")
    Yr, Yi = p._execute_split(yr, yi, -1, None)
    Pr = Yr * Vr - Yi * Vi
    Pi = Yr * Vi + Yi * Vr
    gr, gi = p._execute_split(Pr, Pi, +1, 1.0 / L)
    gr, gi = gr[..., :m], gi[..., :m]
    return gr * Wr - gi * Wi, gr * Wi + gi * Wr


def _positive_points(count: int, kind: str, name: str) -> int:
    """``count``; a count below 1 raises ``ValueError``, as scipy.signal's
    CZT does."""
    if count < 1:
        raise ValueError(f"Invalid number of CZT {kind} points ({count}) specified. "
                         f"{name} must be positive.")
    return count


def _points(n: int, m) -> int:
    """The CZT's output count: ``m``, or ``n`` when ``m`` is None; both
    counts checked by :func:`_positive_points`."""
    _positive_points(n, "data", "n")
    return _positive_points(n if m is None else int(m), "output", "m")


def czt(x, m: int | None = None, w: complex | None = None,
        a: complex = 1 + 0j, *, axis: int = -1):
    """Chirp-Z transform along `axis` (scipy.signal.czt semantics).

    Defaults (m=n, w=exp(-2j*pi/m)) reduce to the DFT.
    """
    re, im = promote_to_split(x)
    m = _points(re.shape[axis], m)
    if w is None:
        w = np.exp(-2j * np.pi / m)
    yr, yi = _czt_split(re.movedim(axis, -1), im.movedim(axis, -1), m,
                        complex(w), complex(a))
    return merge(yr.movedim(-1, axis), yi.movedim(-1, axis))


def _zoom_params(fn, m: int, fs: float, endpoint: bool):
    """(f1, f2, w, a) for a zoomed DFT over the band `fn` (scipy
    zoom_fft/ZoomFFT shared derivation)."""
    if np.isscalar(fn):
        f1, f2 = 0.0, float(fn)
    else:
        f1, f2 = map(float, fn)
    k = (m - 1) if endpoint else m
    w = np.exp(-2j * np.pi * (f2 - f1) / (k * fs)) if k > 0 else 1 + 0j
    a = np.exp(2j * np.pi * f1 / fs)
    return f1, f2, w, a


def _length(x, axis: int) -> int:
    return (x.shape if isinstance(x, torch.Tensor) else np.shape(x))[axis]


def zoom_fft(x, fn, m: int | None = None, *, fs: float = 2.0,
             endpoint: bool = False, axis: int = -1):
    """Zoomed DFT over the band [f1, f2] (scipy.signal.zoom_fft semantics:
    `fn` is [f1, f2] or f2 with f1=0; `endpoint` includes f2 as the last
    sample)."""
    m = _points(_length(x, axis), m)
    _f1, _f2, w, a = _zoom_params(fn, m, fs, endpoint)
    return czt(x, m=m, w=w, a=a, axis=axis)


def czt_points(m: int, w: complex | None = None, a: complex = 1 + 0j):
    """The m z-plane points a * w^{-k} a CZT evaluates at
    (scipy.signal.czt_points parity; complex128 on the host)."""
    m = _positive_points(int(m), "output", "m")
    if w is None:
        w = np.exp(-2j * np.pi / m)
    k = np.arange(m, dtype=np.float64)
    return complex(a) * np.exp(-k * np.log(complex(w)))


class CZT:
    """Plan-style chirp-Z transform (scipy.signal.CZT parity).

    Construct once per (n, m, w, a); calling replays the cached tables and
    kernels: the build-once / execute-many contract of ``plan.Plan``.
    """

    def __init__(self, n: int, m: int | None = None,
                 w: complex | None = None, a: complex = 1 + 0j):
        self.n = int(n)
        self.m = _points(self.n, m)
        if w is None:
            w = np.exp(-2j * np.pi / self.m)
        self.w = complex(w)
        self.a = complex(a)

    def __call__(self, x, *, axis: int = -1):
        if _length(x, axis) != self.n:
            raise ValueError(
                f"CZT planned for length {self.n}, got {_length(x, axis)}")
        return czt(x, m=self.m, w=self.w, a=self.a, axis=axis)

    def points(self):
        """The z-plane points this transform evaluates at."""
        return czt_points(self.m, self.w, self.a)


class ZoomFFT(CZT):
    """Plan-style zoomed DFT over a frequency band
    (scipy.signal.ZoomFFT parity): CZT specialized to the unit circle
    between f1 and f2 at sample rate fs."""

    def __init__(self, n: int, fn, m: int | None = None, *,
                 fs: float = 2.0, endpoint: bool = False):
        n = int(n)
        m = _points(n, m)
        f1, f2, w, a = _zoom_params(fn, m, fs, endpoint)
        super().__init__(n, m, w, a)
        self.f1, self.f2, self.fs = f1, f2, float(fs)
