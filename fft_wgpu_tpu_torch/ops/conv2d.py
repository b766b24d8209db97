"""2-D convolution/correlation with boundary handling, polynomial
deconvolution, Wiener filtering and Savitzky-Golay smoothing (torch port
of ``fft_wgpu_tpu.ops.conv2d``; scipy.signal convolve2d / correlate2d /
deconvolve / wiener / savgol_coeffs / savgol_filter / morlet parity).

The device work composes the port's transforms.  ``convolve2d`` and
``correlate2d`` of real planes ride the R2C route over the last axis and
the C2C route over the first at scipy's 5-smooth even lengths
(``next_fast_len(., real=True)``), then the C2R route: on a CUDA tensor the
R2C / C2R kernels at pow2 lengths, the composite R2C kernel and the
composite row and axis(-2) kernels at composite ones; complex planes run
the C2C route both ways.  ``wiener`` takes its two box means through the
same R2C and C2R routes, and ``savgol_filter`` its FIR pass through
``helpers.fftconvolve`` (the taps' spectrum once, broadcast over the rows;
the product C2R kernel on the card at pow2 lengths).  The design math
(``savgol_coeffs``, the 'interp' edge fit, ``morlet``) and ``deconvolve``
are host float64 numpy, as in the JAX package.  A tensor is computed on
its own device; other input goes to the current CUDA device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.complex_utils import merge, split
from .cuda_fft import _cmul
from .helpers import (_as_host_or_device, _iscomplex, _pad_axis, _pair, _tensor, fftconvolve,
                      next_fast_len)
from .nd import fftn, ifftn
from .rfft import _rfftn_split, irfftn
from .stockham import full_float32

__all__ = [
    "convolve2d",
    "correlate2d",
    "deconvolve",
    "wiener",
    "savgol_coeffs",
    "savgol_filter",
    "morlet",
]


def _pad2d_planes(ar, ai, p1: int, p2: int, boundary: str, fr, fi):
    """Pad float planes (re, im; im may be None) by (p1, p2) per side with
    scipy convolve2d's boundary semantics ('fill' | 'wrap' | 'symm')."""
    if boundary == "fill":
        def fill(v, c):
            return _pad_axis(_pad_axis(v, p1, p1, 0, "constant", c), p2, p2, 1, "constant", c)

        im = None if ai is None and fi == 0 else fill(
            torch.zeros_like(ar) if ai is None else ai, fi)
        return fill(ar, fr), im
    mode = {"wrap": "wrap", "symm": "symmetric"}.get(boundary)
    if mode is None:
        raise ValueError(f"unknown boundary {boundary!r}")

    def pad(v):
        return None if v is None else _pad_axis(_pad_axis(v, p1, p1, 0, mode), p2, p2, 1, mode)

    return pad(ar), pad(ai)


def _spectral_conv2d_full(ar, ai, br, bi):
    """Full 2-D linear convolution of planes (im None for a real plane).
    Real x real rides the R2C route; anything complex runs the C2C."""
    lfull = [ar.shape[0] + br.shape[0] - 1, ar.shape[1] + br.shape[1] - 1]
    shape = [next_fast_len(v, real=True) for v in lfull]
    if ai is None and bi is None:
        spectra = _cmul(*_rfftn_split(ar, shape, (0, 1), None),
                        *_rfftn_split(br, shape, (0, 1), None))
        return irfftn(spectra, s=shape, axes=(0, 1))[: lfull[0], : lfull[1]], None
    za = merge(ar, torch.zeros_like(ar) if ai is None else ai)
    zb = merge(br, torch.zeros_like(br) if bi is None else bi)
    out = ifftn(fftn(za, s=shape, axes=(-2, -1)) * fftn(zb, s=shape, axes=(-2, -1)),
                axes=(-2, -1))[: lfull[0], : lfull[1]]
    return out.real, out.imag


def _conv2d_impl(in1, in2, mode: str, boundary: str, fillvalue, corr: bool = False):
    """Shared convolve2d/correlate2d engine: pad, spectral convolution,
    crop."""
    in1 = _as_host_or_device(in1)
    in2 = _as_host_or_device(in2)
    if np.ndim(in1) != 2 or np.ndim(in2) != 2:
        raise ValueError("convolve2d inputs must both be 2-D")
    n1, n2 = in1.shape
    k1, k2 = in2.shape
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "valid" and not (
            (n1 >= k1 and n2 >= k2) or (k1 >= n1 and k2 >= n2)):
        raise ValueError(
            "valid mode needs one input at least as large as the other "
            "in every dimension")

    fr = float(np.real(fillvalue))
    fi = float(np.imag(fillvalue))
    cplx = _iscomplex(in1) or _iscomplex(in2) or fi != 0.0
    a, b = _pair(in1, in2)
    if cplx:
        ar, ai = split(a)
        br, bi = split(b)
    else:
        ar, ai = a.to(torch.float32), None
        br, bi = b.to(torch.float32), None

    # correlation's 'same' window sits one sample later than
    # convolution's when a kernel dim is even (scipy convention:
    # offset k//2 vs convolve's (k-1)//2)
    s1 = k1 // 2 if corr else (k1 - 1) // 2
    s2 = k2 // 2 if corr else (k2 - 1) // 2
    if corr:
        # correlate(a, b) == convolve(a, conj(b reversed))
        br = br.flip((0, 1))
        bi = None if bi is None else -bi.flip((0, 1))
    if boundary == "fill" and fr == 0 and fi == 0:
        fullr, fulli = _spectral_conv2d_full(ar, ai, br, bi)
        r0, c0 = 0, 0
    else:
        # Non-trivial boundary: pad by (k-1) per side (the kernel's full
        # reach), run a zero-boundary convolution, and crop the window of
        # the padded 'full' result corresponding to the requested mode on
        # the ORIGINAL signal (full output sample t appears at t + (k-1)
        # in the padded full output).
        ar, ai = _pad2d_planes(ar, ai, k1 - 1, k2 - 1, boundary, fr, fi)
        fullr, fulli = _spectral_conv2d_full(ar, ai, br, bi)
        r0, c0 = k1 - 1, k2 - 1
    h, w = n1 + k1 - 1, n2 + k2 - 1
    if mode == "same":
        r0, c0 = r0 + s1, c0 + s2
        h, w = n1, n2
    elif mode == "valid":
        h, w = abs(n1 - k1) + 1, abs(n2 - k2) + 1
        r0, c0 = r0 + min(n1, k1) - 1, c0 + min(n2, k2) - 1
    outr = fullr[r0:r0 + h, c0:c0 + w]
    if fulli is None:
        return outr
    return merge(outr, fulli[r0:r0 + h, c0:c0 + w])


def convolve2d(in1, in2, mode: str = "full", boundary: str = "fill",
               fillvalue=0):
    """2-D linear convolution (scipy.signal.convolve2d parity) via the
    port's FFT routes, with 'fill'/'wrap'/'symm' boundaries."""
    return _conv2d_impl(in1, in2, mode, boundary, fillvalue)


def correlate2d(in1, in2, mode: str = "full", boundary: str = "fill",
                fillvalue=0):
    """2-D cross-correlation (scipy.signal.correlate2d parity):
    convolution against the conjugated, axis-reversed template."""
    return _conv2d_impl(in1, in2, mode, boundary, fillvalue, corr=True)


def deconvolve(signal, divisor):
    """Polynomial long division: signal = convolve(divisor, quotient)
    + remainder (scipy.signal.deconvolve parity).

    Inherently sequential recurrence on tiny 1-D inputs — runs host-side
    in f64 like all design-time math in this framework.
    """
    num = np.atleast_1d(np.asarray(signal))
    den = np.atleast_1d(np.asarray(divisor))
    if num.ndim != 1 or den.ndim != 1:
        raise ValueError("deconvolve inputs must be 1-D")
    if den.size == 0 or den[0] == 0:
        raise ValueError("divisor must have a nonzero leading coefficient")
    L = num.size - den.size + 1
    dt = np.result_type(num.dtype, den.dtype, np.float64)
    if L < 1:
        return np.zeros(0, dtype=dt), num.astype(dt)
    rem = num.astype(dt).copy()
    quot = np.zeros(L, dtype=dt)
    d0 = den.astype(dt)
    for k in range(L):
        q = rem[k] / d0[0]
        quot[k] = q
        rem[k:k + den.size] -= q * d0
    return quot, rem


def wiener(im, mysize=None, noise=None):
    """Adaptive local-statistics Wiener filter (scipy.signal.wiener
    parity): the local mean and mean square are box windows in the
    spectrum domain (the box's R2C spectrum multiplies the image's and its
    square's, each back through the C2R route).

    scipy computes the windows with `correlate(im, ones, 'same')`, which
    for the symmetric box is `convolve`'s full output cropped at offset
    (k-1)//2 per axis."""
    im = _as_host_or_device(im)
    if _iscomplex(im):
        # scipy's own lVar < noise comparison is undefined on complex
        raise ValueError("wiener expects real input")
    nd = np.ndim(im)
    if mysize is None:
        mysize = (3,) * nd
    elif np.isscalar(mysize):
        mysize = (int(mysize),) * nd
    mysize = tuple(int(m) for m in mysize)
    if len(mysize) != nd:
        raise ValueError("mysize must match the input rank")
    size = math.prod(mysize)
    dims = tuple(im.shape)
    x = _tensor(im).to(torch.float32)

    lfull = [dims[a] + mysize[a] - 1 for a in range(nd)]
    shape = [next_fast_len(v, real=True) for v in lfull]
    axes = tuple(range(nd))
    fbr, fbi = _rfftn_split(x.new_ones(mysize), shape, axes, None)
    crop = tuple(slice((m - 1) // 2, (m - 1) // 2 + d) for m, d in zip(mysize, dims))

    def box_mean(v):
        fr, fi = _rfftn_split(v, shape, axes, None)
        full = irfftn(_cmul(fr, fi, fbr, fbi), s=shape, axes=axes)
        return full[crop] / size

    l_mean = box_mean(x)
    l_var = box_mean(x * x) - l_mean * l_mean  # unclamped, like scipy
    nz = l_var.mean() if noise is None else torch.tensor(float(noise), dtype=torch.float32,
                                                         device=x.device)
    res = l_mean + (x - l_mean) * (1.0 - nz / torch.maximum(l_var, nz))
    return torch.where(l_var < nz, l_mean, res)


def savgol_coeffs(window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, pos=None, use: str = "conv"):
    """Savitzky-Golay FIR coefficients (scipy.signal.savgol_coeffs
    parity), designed host-side in f64 via the Vandermonde pseudo-inverse
    (the framework's design-time-math rule)."""
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    if use not in ("conv", "dot"):
        raise ValueError("use must be 'conv' or 'dot'")
    halflen, rem = divmod(window_length, 2)
    if pos is None:
        if rem == 0:
            pos = halflen - 0.5
        else:
            pos = halflen
    if not (0 <= pos < window_length):
        raise ValueError("pos must be nonnegative and less than "
                         "window_length")
    if deriv > polyorder:
        return np.zeros(window_length)
    # rows of A are powers of (x - pos); solve A^T a = y for the impulse
    x = np.arange(-pos, window_length - pos, dtype=np.float64)
    if use == "conv":
        x = x[::-1]
    order = np.arange(polyorder + 1).reshape(-1, 1)
    A = x ** order
    y = np.zeros(polyorder + 1)
    y[deriv] = math.factorial(deriv) / (delta ** deriv)
    coeffs, _, _, _ = np.linalg.lstsq(A, y, rcond=None)
    return coeffs


def _savgol_edge_fit(window_length: int, polyorder: int, deriv: int,
                     delta: float):
    """[window_length, window_length] f64 matrix E with row i = the
    deriv-th derivative at sample i of the least-squares degree-polyorder
    polynomial fit to a window (scipy's 'interp' edge handling, as one
    host-designed matmul)."""
    t = np.arange(window_length, dtype=np.float64)
    A = t.reshape(-1, 1) ** np.arange(polyorder + 1)
    pinv = np.linalg.pinv(A)  # [polyorder+1, wl]
    # derivative operator on the coefficient vector
    rows = []
    for i in range(window_length):
        basis = np.zeros(polyorder + 1)
        for j in range(deriv, polyorder + 1):
            basis[j] = (math.factorial(j) / math.factorial(j - deriv)
                        * t[i] ** (j - deriv)) / delta ** deriv
        rows.append(basis @ pinv)
    return np.stack(rows)


_SAVGOL_PADS = {"mirror": "reflect", "constant": "constant", "nearest": "edge",
                "wrap": "wrap"}


def savgol_filter(x, window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, axis: int = -1, mode: str = "interp",
                  cval: float = 0.0):
    """Savitzky-Golay smoothing (scipy.signal.savgol_filter parity).

    The FIR pass is an FFT convolution on the tensor's device; 'interp'
    edges are the scipy polynomial edge fit, applied as one host-designed
    matrix per geometry (edge windows are tiny), in full float32.
    """
    x = _as_host_or_device(x)
    if _iscomplex(x):
        raise ValueError("savgol_filter expects real input")
    if mode not in ("mirror", "constant", "nearest", "interp", "wrap"):
        raise ValueError(f"unknown mode {mode!r}")
    coeffs = savgol_coeffs(window_length, polyorder, deriv=deriv,
                           delta=delta)
    nd = np.ndim(x)
    axis = axis % nd
    n = x.shape[axis]
    halflen = window_length // 2
    if mode == "interp" and window_length > n:
        raise ValueError("If mode is 'interp', window_length must be "
                         "less than or equal to the size of x.")

    xm = _tensor(x).to(torch.float32).movedim(axis, -1)
    if mode == "interp":
        ext = _pad_axis(xm, halflen, halflen, -1, "constant")  # edges replaced below
    else:
        ext = _pad_axis(xm, halflen, halflen, -1, _SAVGOL_PADS[mode], float(cval))
    y = _fir_same(ext, coeffs)[..., halflen:halflen + n]
    if mode == "interp":
        E = torch.from_numpy(_savgol_edge_fit(window_length, polyorder, deriv, delta)
                             .astype(np.float32)).to(xm.device)
        with full_float32(xm):
            head = xm[..., :window_length] @ E[:halflen].T
            tail = xm[..., n - window_length:] @ E[window_length - halflen:].T
        y = torch.cat([head, y[..., halflen:n - halflen], tail], -1)
    return y.movedim(-1, axis)


def _fir_same(x, taps):
    """'same' FIR pass along the last axis through ``fftconvolve``.  The
    taps are one row with size-1 leading dims, so their spectrum is
    computed once and broadcast over the rows."""
    k = torch.from_numpy(np.asarray(taps, np.float32)).to(x.device)
    full = fftconvolve(x, k.reshape((1,) * (x.ndim - 1) + (-1,)), axes=(-1,))
    lo = (k.shape[-1] - 1) // 2
    return full[..., lo:lo + x.shape[-1]]


def morlet(M: int, w: float = 5.0, s: float = 1.0, complete: bool = True):
    """Classic Morlet wavelet (scipy.signal.morlet parity), host-side f64
    (a design-time window, like every trig table in this framework)."""
    x = np.linspace(-s * 2 * np.pi, s * 2 * np.pi, M)
    out = np.exp(1j * w * x)
    if complete:
        out = out - np.exp(-0.5 * w ** 2)
    return out * np.exp(-0.5 * x ** 2) * np.pi ** -0.25
