"""Fractional Fourier transform (Ozaktas-Kutay-Arikan fast algorithm) and
the exactly unitary discrete FrFT (torch port of ``fft_wgpu_tpu.ops.frft``).

`frft(x, a)` computes the order-`a` fractional Fourier transform on the
dimensionless grid x_n = (n - N/2) / sqrt(N): a=0 is the identity, a=1
the (centered, unitary) DFT, a=2 the parity operator, a=3 the inverse
DFT; fractional orders interpolate (F^a F^b = F^{a+b}).  Fractional orders
are accurate for signals whose energy lies inside the dimensionless
time-frequency disk |x|, |f| < sqrt(N)/2 (the JAX module's admissibility
note); integer orders are exact for every input.

The order is reduced to [0.5, 1.5] with exact integer-order operators
(parity, the centered FFT), then F^a = chirp-multiply . chirp-convolve .
chirp-multiply on a 2x sinc-upsampled grid.  Every table (the chirps, the
sinc and chirp kernels' spectra) is built in float64 on the host, cast once
to float32 and uploaded once per (n, a) and device.  The two linear
convolutions run the plan's C2C at L1 = pow2 >= 6n - 7 and L2 = pow2 >=
12n - 11 (``Plan._execute_split``: at n = 4096, 2^15 and 2^16, the
whole-row kernel on the card; at n <= 1365, the row kernel), and the
centered FFT the plan's at n.  A transform along an axis other than the
last runs along that axis through ``Plan._execute_split_axis`` (the
axis(-2) kernel on the card, no transpose) where n, L1 and L2 all lie in
the axis kernels' envelope (:func:`_along_axis`); otherwise the axis moves
to the back once.

`dfrft` is the Candan-Kutay-Ozaktas eigenvector method: a host float64
eigendecomposition per n (cached), then two [n, n] products, plain
``torch.matmul`` in full float32 (TF32 off, the caller's setting restored).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.complex_utils import host_table, merge, promote_to_split
from ..core.twiddle import FORWARD, INVERSE
from ..plan.plan import get_plan
from . import cuda_fft
from .cuda_fft import _cmul
from .helpers import _pad_axis
from .stockham import full_float32

__all__ = ["frft", "frft2", "dfrft"]


def _conv_lengths(n: int) -> tuple[int, int]:
    """(L1, L2): the sinc and chirp convolutions' pow2 lengths."""
    return (1 << int(np.ceil(np.log2(6 * n - 7))), 1 << int(np.ceil(np.log2(12 * n - 11))))


@functools.lru_cache(maxsize=64)
def _core_tables(n: int, a: float):
    """Host f64 tables for the core 0.5 <= a <= 1.5 decomposition, cast to
    float32: (pre, post, sinc_spec, chirp_spec) as (re, im) pairs, where
    pre/post are the chirps of length 4n-3 (post with the output scale and
    phase) and *_spec the spectra of the sinc-interpolation kernel (padded
    to L1) and of the chirp convolution kernel (padded to L2)."""
    alpha = a * np.pi / 2.0
    tana2 = np.tan(alpha / 2.0)
    sina = np.sin(alpha)
    # chirp grids: the original center sample j = n//2 lands at upsampled
    # index 2*(n//2), so after the (n-1) zero-pad the signal's center
    # (x = 0) sits at index 2*(n//2) + n - 1 (= 2n-1 for even n, 2n-2 odd)
    t = np.arange(4 * n - 3, dtype=np.float64) - (2 * (n // 2) + n - 1)
    pre = np.exp(-1j * np.pi / n * (tana2 / 4.0) * t * t)
    c = np.pi / n / sina / 4.0
    t2 = np.arange(-(4 * n - 4), 4 * n - 3, dtype=np.float64)
    kern = np.exp(1j * c * t2 * t2)
    # sinc interpolation kernel (length 4n-5, centered)
    ts = np.arange(-(2 * n - 3), 2 * n - 2, dtype=np.float64)
    sker = np.sinc(ts / 2.0)
    L1, L2 = _conv_lengths(n)
    sinc_spec = np.fft.fft(sker, L1)
    chirp_spec = np.fft.fft(kern, L2)
    post = pre * (np.sqrt(c / np.pi) * np.exp(-1j * (1.0 - a) * np.pi / 4.0))
    return tuple((z.real.astype(np.float32), z.imag.astype(np.float32))
                 for z in (pre, post, sinc_spec, chirp_spec))


@functools.lru_cache(maxsize=64)
def _device_tables(n: int, a: float, device):
    """:func:`_core_tables` on ``device``: one upload per (n, a) and device."""
    return tuple((host_table(re, device), host_table(im, device))
                 for re, im in _core_tables(n, a))


def _bcast(t, dim: int):
    """A 1-D table shaped to broadcast along ``dim`` (negative) of the data."""
    return t.reshape((-1,) + (1,) * (-dim - 1))


def _conv_spec(re, im, spec, L, lo, hi, dim):
    """Linear convolution along ``dim`` with a precomputed kernel spectrum:
    pad to L, multiply in the frequency domain through the plan, return the
    [lo:hi] slice of the full convolution."""
    p = get_plan(L, "auto")
    re = _pad_axis(re, 0, L - re.shape[dim], dim, "constant")
    im = _pad_axis(im, 0, L - im.shape[dim], dim, "constant")
    fr, fi = p._execute_split_axis(re, im, FORWARD, None, dim)
    pr, pi = _cmul(fr, fi, _bcast(spec[0], dim), _bcast(spec[1], dim))
    gr, gi = p._execute_split_axis(pr, pi, INVERSE, 1.0 / L, dim)
    return gr.narrow(dim, lo, hi - lo), gi.narrow(dim, lo, hi - lo)


def _centered_fft(re, im, sign, dim):
    """Unitary DFT (sign=-1) / IDFT (sign=+1) in the centered convention:
    out = unshift(F(shift(x))) / sqrt(N)."""
    n = re.shape[dim]
    s = n // 2
    re = torch.roll(re, -s, dim)
    im = torch.roll(im, -s, dim)
    # the executors compute the raw DFT sums; 1/sqrt(N) makes both unitary
    fr, fi = get_plan(n, "auto")._execute_split_axis(re, im, sign, n ** -0.5, dim)
    return torch.roll(fr, s, dim), torch.roll(fi, s, dim)


def _parity(re, im, dim):
    """Grid parity x -> -x (circular reversal keeping index 0)."""
    return (torch.roll(re.flip(dim), 1, dim), torch.roll(im.flip(dim), 1, dim))


def _interleave2(x, dim):
    """[..., n, ...] -> [..., 2n-1, ...] along ``dim``: x at even
    positions, zeros between."""
    n = x.shape[dim]
    y = torch.stack([x, torch.zeros_like(x)], dim)
    shape = list(x.shape)
    shape[dim] = 2 * n
    return y.reshape(shape).narrow(dim, 0, 2 * n - 1)


def _core(re, im, n, a, dim):
    """F^a for 0.5 <= a <= 1.5 along ``dim``."""
    pre, post, sinc_spec, chirp_spec = _device_tables(n, a, re.device)
    L1, L2 = _conv_lengths(n)
    # 2x sinc upsampling (exact for the bandlimited periodic extension)
    ur, ui = _conv_spec(_interleave2(re, dim), _interleave2(im, dim), sinc_spec, L1,
                        2 * n - 3, 4 * n - 4, dim)
    # zero-pad to 4n-3 and chirp-premultiply
    ur = _pad_axis(ur, n - 1, n - 1, dim, "constant")
    ui = _pad_axis(ui, n - 1, n - 1, dim, "constant")
    vr, vi = _cmul(ur, ui, _bcast(pre[0], dim), _bcast(pre[1], dim))
    # chirp convolution
    wr, wi = _conv_spec(vr, vi, chirp_spec, L2, 4 * n - 4, 8 * n - 7, dim)
    # chirp post-multiply (scale + phase folded into the table)
    orr, oi = _cmul(wr, wi, _bcast(post[0], dim), _bcast(post[1], dim))
    # decimate back to the original grid
    sl = [slice(None)] * orr.ndim
    sl[dim] = slice(n - 1, 3 * n - 2, 2)
    return orr[tuple(sl)], oi[tuple(sl)]


def _frft_split(re, im, a4: float, dim: int):
    """F^a along ``dim`` of a planar pair, a = a4 in [0, 4)."""
    aa = a4
    x = (re, im)
    if aa == 0.0:
        return x
    if aa == 2.0:
        return _parity(*x, dim)
    if aa == 1.0:
        return _centered_fft(*x, FORWARD, dim)
    if aa == 3.0:
        return _centered_fft(*x, INVERSE, dim)
    if aa > 2.0:
        aa -= 2.0
        x = _parity(*x, dim)
    if aa > 1.5:
        aa -= 1.0
        x = _centered_fft(*x, FORWARD, dim)
    if aa < 0.5:
        aa += 1.0
        x = _centered_fft(*x, INVERSE, dim)
    return _core(x[0], x[1], re.shape[dim], aa, dim)


def _along_axis(shape, axis: int, device) -> bool:
    """Whether the transform along ``axis`` runs in place along it: the
    last axis, or a CUDA tensor whose n, L1 and L2 all lie in the axis
    kernels' envelope (``cuda_fft._ax0_supported``), so that the plan runs
    the axis(-2) kernel, or the axis(-3) entry on a free view, with no
    transpose; otherwise the axis moves to the back once."""
    ax = axis % len(shape)
    if ax == len(shape) - 1:
        return True
    n = shape[ax]
    return device.type == "cuda" and all(
        cuda_fft._ax0_supported(m) for m in (n, *_conv_lengths(n)))


def frft(x, a: float, *, axis: int = -1):
    """Fractional Fourier transform of order `a` along `axis`.

    Returns complex64.  Additive (frft(frft(x, a), b) == frft(x, a + b))
    and unitary to roundoff on time-frequency-concentrated signals (see
    the module docstring); a=1 is the centered unitary DFT on the grid
    x_n = (n - N/2)/sqrt(N) exactly.
    """
    re, im = promote_to_split(x)
    a4 = float(np.mod(a, 4.0))
    if _along_axis(re.shape, axis, re.device):
        dim = axis % re.ndim - re.ndim
        return merge(*_frft_split(re, im, a4, dim))
    rr, ii = _frft_split(re.movedim(axis, -1), im.movedim(axis, -1), a4, -1)
    return merge(rr.movedim(-1, axis), ii.movedim(-1, axis))


def frft2(x, a, *, axes=(-2, -1)):
    """Separable 2-D fractional Fourier transform (the standard optical
    FrFT): order `a` — a scalar or an (a0, a1) pair — applied along both
    `axes`.  frft2(x, 1) is the centered unitary 2-D DFT."""
    if np.ndim(a) == 0:
        a0 = a1 = float(a)
    else:
        a0, a1 = map(float, a)
    ax0, ax1 = axes
    return frft(frft(x, a0, axis=ax0), a1, axis=ax1)


# ---------------------------------------------------------------------------
# Exactly-unitary DISCRETE FrFT (eigenvector method)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _dfrft_basis(n: int):
    """Hermite-like DFT eigenbasis (Candan-Kutay-Ozaktas): the
    eigenvectors of the Dickinson-Steiglitz tridiagonal-plus-corners S
    matrix that commutes with the DFT, split into even/odd symmetry
    subspaces (avoids degenerate-eigenvalue mixing) and ordered by
    Hermite index h (for even n the last even vector carries index n —
    the standard convention skips n-1).

    Returns (V [n, n] f32 orthonormal columns, h [n] int).  Host f64
    eigendecomposition, O(n^3) once per n (cached).
    """
    k = np.arange(n)
    S = np.zeros((n, n))
    S[k, k] = 2.0 * np.cos(2 * np.pi * k / n) - 4.0
    S[k, (k + 1) % n] = 1.0
    S[k, (k - 1) % n] = 1.0
    half = n // 2
    E = []
    for j in range(half + 1):
        v = np.zeros(n)
        if j == 0 or (n % 2 == 0 and j == half):
            v[j] = 1.0
        else:
            v[j] = v[n - j] = 1.0 / np.sqrt(2.0)
        E.append(v)
    O = []
    for j in range(1, (n - 1) // 2 + 1):
        v = np.zeros(n)
        v[j] = 1.0 / np.sqrt(2.0)
        v[n - j] = -1.0 / np.sqrt(2.0)
        O.append(v)
    E = np.array(E).T
    O = np.array(O).T if O else np.zeros((n, 0))
    we, Ve = np.linalg.eigh(E.T @ S @ E)
    even_vecs = E @ Ve[:, np.argsort(-we)]
    if O.shape[1]:
        wo, Vo = np.linalg.eigh(O.T @ S @ O)
        odd_vecs = O @ Vo[:, np.argsort(-wo)]
    else:
        odd_vecs = O
    V = np.zeros((n, n))
    h = np.zeros(n, np.int64)
    ie = io = idx = 0
    for m in range(n):
        if m % 2 == 0:
            V[:, idx] = even_vecs[:, ie]
            h[idx] = m
            ie += 1
            idx += 1
        elif io < odd_vecs.shape[1]:
            V[:, idx] = odd_vecs[:, io]
            h[idx] = m
            io += 1
            idx += 1
    if idx < n:  # even n: the leftover even vector has Hermite index n
        V[:, idx] = even_vecs[:, ie]
        h[idx] = n
    return V.astype(np.float32), h


@functools.lru_cache(maxsize=16)
def _dfrft_table(n: int, device):
    """The basis V on ``device``: one upload per n and device."""
    return host_table(_dfrft_basis(n)[0], device)


def dfrft(x, a: float, *, axis: int = -1):
    """EXACTLY unitary discrete fractional Fourier transform of order
    `a` (Candan-Kutay-Ozaktas eigenvector method).

    F^a = V diag(e^{-i pi a h / 2}) V^T over the Hermite-ordered DFT
    eigenbasis: additive, unitary, and invertible to roundoff for EVERY
    input, with a=1 exactly the unitary DFT and a=2 exactly circular
    parity.  Cost: one O(n^3) host eigendecomposition per n (cached), then
    two [n, n] matmuls per call in full float32 — prefer `frft`
    (O(n log n)) for long admissible signals.
    """
    re, im = promote_to_split(x)
    n = re.shape[axis]
    V = _dfrft_table(n, re.device)
    ph = -0.5 * np.pi * float(a) * _dfrft_basis(n)[1]
    pr = host_table(np.cos(ph), re.device)
    pi_ = host_table(np.sin(ph), re.device)
    re, im = re.movedim(axis, -1), im.movedim(axis, -1)
    with full_float32(re):
        vr, vi = _cmul(re @ V, im @ V, pr, pi_)
        yr, yi = vr @ V.T, vi @ V.T
    return merge(yr.movedim(-1, axis), yi.movedim(-1, axis))
