"""FFT-based structured linear algebra: circulant, Toeplitz and BCCB
operators and exact stationary Gaussian random fields (torch port of
``fft_wgpu_tpu.ops.structured``).

Circulant matrices diagonalize in the Fourier basis, so matvec and solve
are O(n log n) spectral multiplies; Toeplitz matvecs ride a circulant
embedding of twice the length; symmetric positive-definite Toeplitz
solves use conjugate gradients with the Strang circulant preconditioner;
circulant embedding also gives exact stationary Gaussian random fields
(Dietrich & Newsam 1997).

    circulant_matvec(c, x)       y = C(c) @ x            O(n log n)
    circulant_solve(c, b)        x = C(c)^{-1} b         spectral division
    toeplitz_matvec(c, r, x)     y = T(c, r) @ x         circulant embedding
    toeplitz_solve(c, b)         SPD T(c, c) solve       PCG + Strang
    bccb_matvec / bccb_solve     2-D circular (de)convolution
    grf_sample(acf, generator)   exact stationary GRF    Dietrich-Newsam

Every transform is the plan's C2C along the last axis (the row kernel on
the card for pow2 n up to 16384, the four-step above it) or over the last
two axes (``nd.fftn_split``: the fused-plane kernel inside its envelope,
else the axis(-2) and row kernels).  ``toeplitz_solve`` iterates in
Python with the JAX package's stopping rule, so each iteration reads one
scalar back to the host.  Inputs and outputs are real float32 tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.complex_utils import default_device
from ..core.twiddle import FORWARD, INVERSE
from .helpers import _tensor
from .nd import fftn_split

__all__ = ["circulant_matvec", "circulant_solve", "toeplitz_matvec",
           "bccb_matvec", "bccb_solve", "toeplitz_solve", "grf_sample"]


def _f32(*xs):
    """The operands as float32 tensors on one device (non-tensors join the
    device of a tensor among them, else the current CUDA device)."""
    dev = next((t.device for t in xs if isinstance(t, torch.Tensor)), None)
    return tuple(_tensor(v, dev).to(torch.float32) for v in xs)


def _fft(re, im, sign, scale, dims=1):
    """The C2C over the last ``dims`` axes (1 or 2)."""
    return fftn_split(re, im, tuple(range(re.ndim - dims, re.ndim)), sign, scale)


def _spectrum(c, dims=1):
    return _fft(c, torch.zeros_like(c), FORWARD, None, dims)


def _mul_inverse(C, x, dims=1):
    """Re(IFFT(FFT(x) * C)) for the spectrum C of a real operator."""
    Cr, Ci = C
    Xr, Xi = _spectrum(x, dims)
    yr, _ = _fft(Xr * Cr - Xi * Ci, Xr * Ci + Xi * Cr, INVERSE,
                 1.0 / math.prod(x.shape[-dims:]), dims)
    return yr


def _div_inverse(C, b, reg=None, dims=1):
    """Re(IFFT(conj(C) * FFT(b) / (|C|^2 + reg)))."""
    Cr, Ci = C
    Br, Bi = _spectrum(b, dims)
    d = Cr * Cr + Ci * Ci
    if reg is not None:
        d = d + reg
    xr, _ = _fft((Br * Cr + Bi * Ci) / d, (Bi * Cr - Br * Ci) / d, INVERSE,
                 1.0 / math.prod(b.shape[-dims:]), dims)
    return xr


def circulant_matvec(c, x):
    """y = C @ x where C = scipy.linalg.circulant(c): C[i, j] = c[(i-j) % n].
    `x` may carry leading batch dims [..., n]."""
    c, x = _f32(c, x)
    if c.ndim != 1 or x.shape[-1] != c.shape[0]:
        raise ValueError(f"c must be 1-D with x.shape[-1] == len(c); "
                         f"got {tuple(c.shape)} vs {tuple(x.shape)}")
    return _mul_inverse(_spectrum(c), x)


def circulant_solve(c, b):
    """x with C(c) @ x = b by spectral division (batched over leading dims
    of `b`).  C must be invertible: a vanishing Fourier eigenvalue of `c`
    makes the system singular (no pseudo-inverse fallback is applied)."""
    c, b = _f32(c, b)
    if c.ndim != 1 or b.shape[-1] != c.shape[0]:
        raise ValueError(f"c must be 1-D with b.shape[-1] == len(c); "
                         f"got {tuple(c.shape)} vs {tuple(b.shape)}")
    return _div_inverse(_spectrum(c), b)


def _toeplitz_embedding(c, r):
    """First column of the length-2n circulant that embeds T(c, r)."""
    return torch.cat([c, c.new_zeros(1), r[1:].flip(0)])  # length 2n


def _toep_matvec(E, x):
    """T @ x through the spectrum E of the 2n circulant embedding."""
    n = x.shape[-1]
    return _mul_inverse(E, torch.nn.functional.pad(x, (0, n)))[..., :n]


def toeplitz_matvec(c, r, x):
    """y = T @ x where T = scipy.linalg.toeplitz(c, r) (square: first
    column `c`, first row `r`, r[0] is taken from c[0]).  Batched over
    leading dims of `x`.  Uses a 2n circulant embedding."""
    c, r, x = _f32(c, r, x)
    if c.ndim != 1 or r.ndim != 1 or c.shape != r.shape:
        raise ValueError("c and r must be 1-D of equal length")
    if x.shape[-1] != c.shape[0]:
        raise ValueError(f"x.shape[-1] must equal len(c) == {c.shape[0]}")
    return _toep_matvec(_spectrum(_toeplitz_embedding(c, r)), x)


def toeplitz_solve(c, b, *, tol: float = 1e-6, max_iter: int | None = None):
    """Solve T x = b for a symmetric positive-definite Toeplitz T whose
    first column is `c` (scipy.linalg.solve_toeplitz(c, b) parity for the
    SPD case), via conjugate gradients with the Strang circulant
    preconditioner — every iteration is two FFT matvecs, O(n log n).
    Batched over leading dims of `b`; iterates until the preconditioned
    residual norm falls below tol * ||b|| (or max_iter, default 4n).
    Each iteration reads the stopping test back to the host."""
    c, b = _f32(c, b)
    if c.ndim != 1 or b.shape[-1] != c.shape[0]:
        raise ValueError(f"c must be 1-D with b.shape[-1] == len(c); "
                         f"got {tuple(c.shape)} vs {tuple(b.shape)}")
    n = int(c.shape[0])
    if max_iter is None:
        max_iter = 4 * n
    # Strang preconditioner: the circulant nearest to T — copy the central
    # diagonals, wrap them periodically (f64 host table, cast once)
    ch = c.detach().cpu().numpy().astype(np.float64)
    s = ch.copy()
    half = n // 2
    if half >= 1:
        s[n - half:] = ch[1:half + 1][::-1]
    E = _spectrum(_toeplitz_embedding(c, c))
    S = _spectrum(torch.from_numpy(s.astype(np.float32)).to(c.device))

    def dot(u, v):
        return (u * v).sum(-1, keepdim=True)

    x, r = torch.zeros_like(b), b
    z = _div_inverse(S, r)
    p = z
    target = float(np.float32(tol)) * dot(b, b).sqrt()
    stop = target.min()
    i = 0
    while i < max_iter and bool(dot(r, r).max().sqrt() > stop):
        Ap = _toep_matvec(E, p)
        rz = dot(r, z)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z2 = _div_inverse(S, r)
        beta = dot(r, z2) / rz
        z, p = z2, z2 + beta * p
        i += 1
    return x


def _grf_embedding(acf):
    """(sqrt(lambda / m) of the minimal 2(n-1) circulant embedding of
    ``acf``, float64 on the host; n); raises if the embedding is
    indefinite."""
    if isinstance(acf, torch.Tensor):
        acf = acf.detach().cpu().numpy()
    acf = np.asarray(acf, np.float64)
    if acf.ndim != 1 or acf.size < 2:
        raise ValueError("acf must be 1-D with at least 2 lags")
    emb = np.concatenate([acf, acf[1:-1][::-1]])     # length m = 2(n-1)
    lam = np.fft.fft(emb).real
    if lam.min() < -1e-8 * lam.max():
        raise ValueError(
            "circulant embedding is not nonnegative definite; taper the "
            f"acf or pad it further (min eigenvalue {lam.min():.3e})")
    return np.sqrt(np.maximum(lam, 0.0) / emb.size), acf.size


def grf_sample(acf, generator: torch.Generator, num: int = 1):
    """Exact stationary Gaussian random field samples on a regular 1-D
    grid by circulant embedding (Dietrich & Newsam 1997).

    `acf[k]` is the autocovariance at lag k (length n).  Returns
    [num, n] real samples whose exact covariance is toeplitz(acf),
    provided the minimal 2(n-1) embedding is nonnegative-definite (true
    for e.g. exponential and Gaussian covariances); raises otherwise.
    The samples are computed on ``acf``'s device if it is a tensor, else
    on the current CUDA device; the two normal planes are drawn from
    ``generator`` on its own device and moved there.
    """
    dev = acf.device if isinstance(acf, torch.Tensor) else None
    sqrt_lam, n = _grf_embedding(acf)
    dev = dev or default_device()
    m = sqrt_lam.size
    pairs = (num + 1) // 2
    er = torch.randn((pairs, m), generator=generator, device=generator.device)
    ei = torch.randn((pairs, m), generator=generator, device=generator.device)
    return _grf_from_noise(torch.from_numpy(sqrt_lam.astype(np.float32)).to(dev),
                           er.to(dev), ei.to(dev), num, n)


def _grf_from_noise(sqrt_lam, er, ei, num: int, n: int):
    """The fields of the complex normal noise (er, ei) [pairs, m]: the real
    and imaginary parts of FFT(noise * sqrt_lam), each two independent
    exact samples, interleaved across the batch and cut to n lags."""
    fr, fi = _fft(er * sqrt_lam, ei * sqrt_lam, FORWARD, None)
    return torch.cat([fr[:, :n], fi[:, :n]], dim=0)[:num]


def bccb_matvec(k, x):
    """y = B @ vec(x) where B is the block-circulant-with-circulant-
    blocks (BCCB) matrix generated by the 2-D kernel `k` — i.e. the 2-D
    CIRCULAR convolution of x [.., m, n] with k [m, n] (the structure of
    periodic-boundary image blurring).  Diagonalized by the 2-D DFT:
    y = ifft2(fft2(k) * fft2(x))."""
    k, x = _f32(k, x)
    if k.ndim != 2 or x.shape[-2:] != k.shape:
        raise ValueError(f"k must be 2-D with x.shape[-2:] == k.shape; "
                         f"got {tuple(k.shape)} vs {tuple(x.shape)}")
    return _mul_inverse(_spectrum(k, 2), x, 2)


def bccb_solve(k, b, *, reg: float = 0.0):
    """x with B(k) @ vec(x) = vec(b) by 2-D spectral division — periodic
    deconvolution.  `reg` adds Tikhonov regularization
    (B^T B + reg I)^{-1} B^T b, the standard Wiener-style deblur for
    kernels with vanishing frequency response (reg=0 is the exact
    inverse and requires all eigenvalues nonzero)."""
    k, b = _f32(k, b)
    if k.ndim != 2 or b.shape[-2:] != k.shape:
        raise ValueError(f"k must be 2-D with b.shape[-2:] == k.shape; "
                         f"got {tuple(k.shape)} vs {tuple(b.shape)}")
    return _div_inverse(_spectrum(k, 2), b, float(np.float32(reg)), 2)
