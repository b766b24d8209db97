"""numpy.fft / scipy-compatible helpers: shifts, frequency grids, FFT
convolution and correlation, the analytic signal, the Hartley transform
and FFT-domain resampling (torch port of ``fft_wgpu_tpu.ops.helpers``).

The kernel users on a CUDA tensor:

* ``fftconvolve`` of real input over one axis: the R2C kernel on both
  operands in the padded serving form, then the product C2R kernel
  (``rfft.irfft_prod_last_split``); over several axes the C2C axes go
  through ``nd.fftn_split``;
* ``oaconvolve`` of real input: the R2C kernel on every segment and on the
  kernel, the product C2R kernel with the kernel spectrum broadcast over
  the segments, then an overlap-add of K contiguous slabs
  (``stft._ola_slabs``, no scatter);
* ``hilbert``: the row kernel, then the filtered row kernel with the
  one-sided weights at load (``cuda_fft.fft_filtered_split``);
* ``resample`` has no kernel of its own: real input takes the plan's R2C
  and C2R (the R2C and C2R kernels for pow2 lengths), complex input and
  ``domain="freq"`` its C2C, and composite lengths whatever the plan
  routes them to.

The transform lengths of the convolutions are powers of two on a CUDA
tensor (up to 2^21, the kernels' routes) and scipy's 5-smooth even length
on the CPU, as the JAX package picks them on and off the TPU.  A tensor
stays on its device; other input goes to the current CUDA device (or to
the device of the tensor it is paired with).  Complex results are
complex64 tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.complex_utils import default_device, merge, split
from ..core.twiddle import FORWARD, INVERSE
from ..plan.plan import get_plan
from . import cuda_fft
from .nd import fftn, fftn_split, ifftn
from .rfft import (_hermitian_extend, irfft, irfft_last_split, irfft_prod_last_split, rfft,
                   rfft_last_split)
from .spectral_est import get_window
from .stft import _ola_slabs, _on_card
from .transforms import _resize_axis, fft, ifft

__all__ = [
    "next_fast_len",
    "prev_fast_len",
    "get_workers",
    "set_workers",
    "fftconvolve",
    "convolve",
    "correlate",
    "choose_conv_method",
    "fftcorrelate",
    "hilbert",
    "hilbert2",
    "resample",
    "fftshift",
    "ifftshift",
    "fftfreq",
    "rfftfreq",
    "fft_convolve",
    "correlation_lags",
    "detrend",
    "oaconvolve",
    "dht",
    "idht",
]


def _tensor(x, device=None):
    """``x`` as a tensor: a tensor stays as it is; anything else goes to
    ``device`` or the current CUDA device, float64 as float32 and
    complex128 as complex64 (the JAX package's default precision)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.complex128:
        a = a.astype(np.complex64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device or default_device())


def _pair(a, b):
    """Both operands as tensors; a non-tensor joins the device of a tensor
    it is paired with."""
    dev = next((t.device for t in (a, b) if isinstance(t, torch.Tensor)), None)
    return _tensor(a, dev), _tensor(b, dev)


def _as_host_or_device(x):
    """Input with a ``.shape``: a tensor or an array passes as it is, a
    python sequence or scalar becomes host numpy."""
    if not hasattr(x, "shape"):
        return np.asarray(x)
    return x


def _iscomplex(x) -> bool:
    return x.is_complex() if isinstance(x, torch.Tensor) else np.iscomplexobj(x)


def _pad_axis(x, before: int, after: int, dim: int, mode: str, cval=0.0, odd=False):
    """``x`` padded along ``dim`` as ``jnp.pad`` / ``numpy.pad`` pad it in
    ``mode`` ('constant' with ``cval``, 'edge', 'wrap', 'symmetric',
    'reflect'; ``odd`` for reflect_type='odd'), any pad width."""
    if mode == "constant":
        shape = list(x.shape)
        parts = []
        for width in (before, after):
            shape[dim] = width
            parts.append(x.new_full(shape, cval))
        return torch.cat([parts[0], x, parts[1]], dim)
    n = x.shape[dim]
    if mode in ("edge", "wrap"):  # index maps
        idx = np.pad(np.arange(n), (before, after), mode=mode)
        return x.index_select(dim, torch.from_numpy(idx).to(x.device))
    if mode not in ("symmetric", "reflect"):
        raise ValueError(f"unknown pad mode {mode!r}")
    # jnp.pad's loop: reflect the padded array's edge until the width is met
    arr = x.movedim(dim, -1)
    offset = 1 if (mode == "reflect" and n > 1) else 0

    def build(arr, width, first):
        edge = arr[..., :1] if first else arr[..., -1:]
        while width > 0:
            cur = min(width, n - offset)
            width -= cur
            if first:
                piece = arr[..., offset:offset + cur]
            else:
                stop = arr.shape[-1] - (0 if (mode == "symmetric" or n == 1) else 1)
                piece = arr[..., stop - cur:stop]
            piece = piece.flip(-1)
            if odd:
                piece = 2 * edge - piece
                if n > 1:
                    edge = piece[..., :1] if first else piece[..., -1:]
            arr = torch.cat([piece, arr] if first else [arr, piece], -1)
        return arr

    return build(build(arr, before, True), after, False).movedim(-1, dim)


def _f32(x):
    return x.to(torch.float32)


def fftshift(x, axes=None):
    """Shift zero-frequency to center (numpy.fft.fftshift)."""
    x = _tensor(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    return torch.roll(x, [x.shape[a] // 2 for a in axes], tuple(axes))


def ifftshift(x, axes=None):
    """Inverse of fftshift."""
    x = _tensor(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    return torch.roll(x, [-(x.shape[a] // 2) for a in axes], tuple(axes))


def fftfreq(n: int, d: float = 1.0, *, dtype=torch.float32, device=None):
    """Sample frequencies for fft output bins (numpy.fft.fftfreq), on
    ``device`` (the current CUDA device by default)."""
    k = np.fft.fftfreq(n, d).astype(np.float32)  # host-side, exact semantics
    return torch.from_numpy(k).to(device or default_device(), dtype)


def rfftfreq(n: int, d: float = 1.0, *, dtype=torch.float32, device=None):
    """Sample frequencies for rfft output bins (numpy.fft.rfftfreq), on
    ``device`` (the current CUDA device by default)."""
    k = np.fft.rfftfreq(n, d).astype(np.float32)
    return torch.from_numpy(k).to(device or default_device(), dtype)


def _crop(full, cuts):
    """``full`` narrowed to (axis, start, length) of each cut."""
    for ax, start, length in cuts:
        full = full.narrow(ax, start, length)
    return full


def _mode_cut(mode, la, lb, lfull):
    """(start, length) of the ``mode`` slice of a full convolution of
    lengths la and lb (the first operand's 'same')."""
    if mode == "full":
        return 0, lfull
    if mode == "same":
        return (lb - 1) // 2, la
    if mode == "valid":
        return min(la, lb) - 1, max(la, lb) - min(la, lb) + 1
    raise ValueError(f"invalid mode {mode!r}")


def fft_convolve(a, b, mode: str = "full", axis: int = -1):
    """1-D linear convolution via the FFT (scipy.signal.fftconvolve-style),
    at a power-of-two transform length.  Real inputs use the R2C pipeline."""
    a, b = _pair(a, b)
    la, lb = a.shape[axis], b.shape[axis]
    lfull = la + lb - 1
    nfft = 1 << max(1, math.ceil(math.log2(lfull)))
    if _iscomplex(a) or _iscomplex(b):
        full = ifft(fft(a, n=nfft, axis=axis) * fft(b, n=nfft, axis=axis), axis=axis)
    else:
        fa = rfft(_f32(a), n=nfft, axis=axis)
        full = irfft(fa * rfft(_f32(b), n=nfft, axis=axis), n=nfft, axis=axis)
    return _crop(full, [(axis % full.ndim, *_mode_cut(mode, la, lb, lfull))])


def oaconvolve(a, b, mode: str = "full", axes=None, axis: int = None):
    """Overlap-add convolution of a long signal with a short kernel
    (scipy.signal.oaconvolve semantics).

    The overlap-add runs along ONE axis (scipy's axes= with a single
    entry, or axis=): the signal is cut into segments, all segments are
    transformed in one batched R2C call, multiplied by the kernel
    spectrum and inverse-transformed in one product C2R call (on a CUDA
    tensor the kernel spectrum is broadcast over the segment rows inside
    the kernel), then overlap-added as K contiguous slab adds.  scipy's
    default (axes=None: every axis) and multi-axis requests on N-D input
    delegate to :func:`fftconvolve`."""
    a, b = _pair(a, b)
    if axis is None:
        if axes is None:
            if max(a.ndim, b.ndim) > 1:
                return fftconvolve(a, b, mode=mode)
            axis = -1
        else:
            ax_list = [axes] if np.isscalar(axes) else list(axes)
            if len(ax_list) != 1:
                return fftconvolve(a, b, mode=mode, axes=ax_list)
            axis = int(ax_list[0])
    la0, lb0 = a.shape[axis], b.shape[axis]
    # swap only for the segmentation (convolution is commutative); 'same'
    # below follows the first operand as the caller passed it
    if la0 < lb0:
        a, b = b, a
    la, lb = max(la0, lb0), min(la0, lb0)
    lfull = la + lb - 1

    # segment size: a few kernel lengths, power-of-two FFT
    nfft = 1 << max(3, math.ceil(math.log2(8 * lb)))
    step = nfft - (lb - 1)
    nseg = -(-la // step)
    cplx = _iscomplex(a) or _iscomplex(b)
    if not cplx:
        a, b = _f32(a), _f32(b)
    x = a.movedim(axis, -1)
    lead = x.shape[:-1]
    xp = torch.nn.functional.pad(x, (0, nseg * step - la)).reshape(*lead, nseg, step)
    segs = torch.nn.functional.pad(xp, (0, nfft - step))
    bv = b.movedim(axis, -1)
    if not cplx:
        # the padded half-spectrum serving form end to end: the spectra are
        # internal, so they stay padded from the R2C through the product C2R
        Br, Bi = rfft_last_split(torch.nn.functional.pad(bv, (0, nfft - lb)), None,
                                 pad_out=True)
        if Br.ndim > 1:  # a batched-lead kernel: the composed product
            Br, Bi = Br[..., None, :], Bi[..., None, :]
        Sr, Si = rfft_last_split(segs, None, pad_out=True)
        Y = irfft_prod_last_split(Sr, Si, Br, Bi, nfft, 1.0 / nfft, padded_in=True)
    else:
        B = fft(bv, n=nfft, axis=-1)
        if B.ndim > 1:
            B = B[..., None, :]  # broadcast over the segment axis
        Y = ifft(fft(segs, axis=-1) * B, axis=-1)  # [.., nseg, nfft]
    # overlap-add into [.., nseg*step + nfft - step] (no flat-index scatter)
    full = _ola_slabs(Y, step, nseg * step + (nfft - step))[..., :lfull].movedim(-1, axis)
    if mode == "full":
        return full
    ax = axis % full.ndim
    if mode == "same":
        return full.narrow(ax, (lb0 - 1) // 2, la0)
    if mode == "valid":
        return full.narrow(ax, lb - 1, la - lb + 1)
    raise ValueError(f"invalid mode {mode!r}")


def next_fast_len(target: int, real: bool = False) -> int:
    """Smallest 5-smooth n >= target (scipy.fft.next_fast_len semantics).
    With `real=True` the result is also EVEN, so R2C/C2R callers land on
    the packed even-n paths."""
    if target <= 1:
        return 2 if real else 1
    best = 1 << (target - 1).bit_length()  # pow2 upper bound (even)
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            # smallest power of two lifting p35 over target (even if real)
            q = p35
            while q < target or (real and q % 2):
                q *= 2
            if q < best:
                best = q
            p35 *= 3
        p5 *= 5
    return best


def prev_fast_len(target: int, real: bool = False) -> int:
    """Largest 5-smooth n <= target (scipy.fft.prev_fast_len semantics);
    with `real=True` also even, except target=1, where no even value
    <= target exists and 1 is returned (scipy behavior).  target >= 1."""
    if target < 1:
        raise ValueError("target must be a positive integer")
    best = 1
    p5 = 1
    while p5 <= target:
        p35 = p5
        while p35 <= target:
            q = p35  # largest 2^a * p35 <= target
            while q * 2 <= target:
                q *= 2
            if q > best and not (real and q % 2):
                best = q
            p35 *= 3
        p5 *= 5
    return best


# scipy.fft worker-count shims: a transform is a few kernel launches on one
# card (parallelism comes from its grid, not host threads), so the worker
# count is recorded for API parity and changes nothing.
_workers = 1


def get_workers() -> int:
    """scipy.fft.get_workers parity (advisory; see set_workers)."""
    return _workers


class set_workers:
    """scipy.fft.set_workers parity: a context manager recording the
    requested worker count; no effect on execution."""

    def __init__(self, workers: int):
        self.workers = int(workers)
        self._prev = None

    def __enter__(self):
        global _workers
        self._prev, _workers = _workers, self.workers
        return self

    def __exit__(self, *exc):
        global _workers
        _workers = self._prev
        return False


def _conv_fast_len(l: int, device) -> int:
    """Transform length for spectral convolution: on a CUDA tensor the
    power of two (up to 2^21, where the pow2 kernels and the four-step
    serve it), elsewhere scipy's 5-smooth even choice."""
    p2 = 1 << max(l - 1, 1).bit_length()
    if device.type == "cuda" and p2 <= (1 << 21):
        return p2
    return next_fast_len(l, real=True)


def fftconvolve(a, b, mode: str = "full", axes=None):
    """N-D linear convolution via FFTs (scipy.signal.fftconvolve).

    `axes=None` convolves over all axes (the others must match or be 1);
    real inputs ride the R2C pipeline on the last convolved axis in the
    padded serving form, then, over one axis, the product C2R
    (``rfft.irfft_prod_last_split``), over several the C2C passes of the
    other axes and the C2R."""
    a, b = _pair(a, b)
    if a.ndim != b.ndim:
        raise ValueError("fftconvolve inputs must have equal rank")
    nd = a.ndim
    if axes is None:
        axes = tuple(range(nd))
    elif np.isscalar(axes):
        axes = (int(axes),)
    axes = tuple(ax % nd for ax in axes)
    for ax in range(nd):
        if (ax not in axes and a.shape[ax] != b.shape[ax]
                and 1 not in (a.shape[ax], b.shape[ax])):
            raise ValueError(  # scipy broadcasts size-1 non-convolved axes
                f"non-convolved axis {ax} must match or be broadcastable: "
                f"{tuple(a.shape)} vs {tuple(b.shape)}")
    if mode == "valid" and not (
        all(a.shape[ax] >= b.shape[ax] for ax in axes)
        or all(b.shape[ax] >= a.shape[ax] for ax in axes)
    ):
        raise ValueError(
            "for mode='valid' one input must be at least as large as the "
            "other in every convolved dimension")  # scipy parity
    lfull = [a.shape[ax] + b.shape[ax] - 1 for ax in axes]
    shape = [_conv_fast_len(lf, a.device) for lf in lfull]
    cuts = [(ax, *_mode_cut(mode, a.shape[ax], b.shape[ax], lf))
            for ax, lf in zip(axes, lfull)]

    if _iscomplex(a) or _iscomplex(b):
        fa = fftn(a, s=shape, axes=axes)
        return _crop(ifftn(fa * fftn(b, s=shape, axes=axes), axes=axes), cuts)

    last, rest = axes[-1], axes[:-1]
    n_last = shape[-1]

    def spectrum(v):
        for ax, L in zip(axes, shape):
            v = _resize_axis(v, L, ax)
        Xr, Xi = rfft_last_split(_f32(v).movedim(last, -1), None, pad_out=True)
        Xr, Xi = Xr.movedim(-1, last), Xi.movedim(-1, last)
        if rest:
            Xr, Xi = fftn_split(Xr, Xi, rest, FORWARD, None)
        return Xr, Xi

    far, fai = spectrum(a)
    fbr, fbi = spectrum(b)
    if not rest:
        # 1-D spectrum product: the product C2R forms it at load
        out = irfft_prod_last_split(*(v.movedim(last, -1) for v in (far, fai, fbr, fbi)),
                                    n_last, 1.0 / n_last, padded_in=True)
        return _crop(out.movedim(-1, last), cuts)
    pr, pi = far * fbr - fai * fbi, far * fbi + fai * fbr
    inv_scale = 1.0
    for ax in rest:
        inv_scale /= shape[axes.index(ax)]
    pr, pi = fftn_split(pr, pi, rest, INVERSE, inv_scale)
    out = irfft_last_split(pr.movedim(last, -1), pi.movedim(last, -1), n_last,
                           1.0 / n_last, padded_in=True)
    return _crop(out.movedim(-1, last), cuts)


def fftcorrelate(a, b, mode: str = "full", axes=None):
    """N-D cross-correlation via FFTs (scipy.signal.correlate with
    method='fft'): correlate(a, b) == fftconvolve(a, conj(b reversed))."""
    a, b = _pair(a, b)
    if axes is not None and np.isscalar(axes):
        axes = (int(axes),)
    dims = tuple(range(b.ndim)) if axes is None else tuple(
        sorted({ax % b.ndim for ax in axes}))
    br = torch.flip(b, dims)
    if br.is_complex():
        br = torch.conj_physical(br)
    return fftconvolve(a, br, mode=mode, axes=axes)


_HILBERT: dict = {}


def _hilbert_weights(length: int, device):
    """scipy's one-sided spectrum weights h = [1, 2, .., 2, (1), 0, ..] of
    ``length`` bins on ``device``, as float32 and as complex64 (the filtered
    kernel's complex64 row), both cached."""
    key = (length, str(device))
    h = _HILBERT.get(key)
    if h is None:
        w = np.zeros(length, np.float32)
        if length % 2 == 0:
            w[0] = w[length // 2] = 1.0
            w[1: length // 2] = 2.0
        else:
            w[0] = 1.0
            w[1: (length + 1) // 2] = 2.0
        h = _HILBERT[key] = (torch.from_numpy(w).to(device),
                             torch.from_numpy(w.astype(np.complex64)).to(device))
    return h


def hilbert(x, n: int = None, axis: int = -1, *, N: int = None):
    """Analytic signal via the FFT (scipy.signal.hilbert): real input ->
    complex x + i*H(x).  On a CUDA tensor of pow2 length in the row
    kernel's envelope: the R2C kernel into complex64 (its half spectrum of
    n/2 + 1 bins), then the filtered row kernel's complex64 entry reading
    those bins as they lie, zero past them, with the one-sided weights
    applied at load and 1/n at store: two launches, no zero plane, no split
    and no merge.  Elsewhere the plan's forward transform, the weights and
    the plan's inverse.  scipy spells the length argument N=; both are
    accepted."""
    if N is not None:
        if n is not None and n != N:
            raise ValueError("pass only one of n= and N=")
        n = N
    if _iscomplex(x):  # checked before any device transfer
        raise ValueError("hilbert requires a real input")
    v = _f32(_tensor(x)).movedim(axis, -1)
    length = n if n is not None else v.shape[-1]
    if v.shape[-1] != length:
        v = _resize_axis(v, length, -1)
    h, hc = _hilbert_weights(length, v.device)
    if _on_card(v) and cuda_fft._supported(length):
        X = cuda_fft.rfft_rows_c64(v)
        return cuda_fft.fft_filtered_c64(X, hc, INVERSE, 1.0 / length).movedim(-1, axis)
    p = get_plan(length)
    re, im = p._execute_split(v, torch.zeros_like(v), FORWARD, None)
    re, im = p._execute_split(re * h, im * h, INVERSE, 1.0 / length)
    return merge(re.movedim(-1, axis), im.movedim(-1, axis))


def _resample_window(window, n):
    """Host-side spectral window for `resample` (scipy semantics):
    callable -> window(fftfreq(n)); array -> used as-is (fft bin order);
    name/tuple -> fftshift(get_window(window, n)).  float64 numpy out."""
    if callable(window):
        W = np.asarray(window(np.fft.fftfreq(n)))
    elif hasattr(window, "shape") or isinstance(window, list):
        W = np.asarray(window.detach().cpu() if isinstance(window, torch.Tensor) else window)
        if W.shape != (n,):
            raise ValueError(f"window length {W.shape} != number of "
                             f"frequency bins ({n},)")
    else:
        W = np.fft.fftshift(get_window(window, n, device="cpu").numpy().astype(np.float64))
    if np.iscomplexobj(W):
        raise ValueError("complex spectral windows are not supported")
    return W.astype(np.float64)


def _scale_bin(v, k: int, s: float):
    """``v`` with bin ``k`` of its last axis multiplied by ``s`` (a copy)."""
    v = v.clone()
    v[..., k] *= s
    return v


def resample(x, num: int, t=None, axis: int = 0, window=None,
             domain: str = "time"):
    """FFT-domain resampling (scipy.signal.resample parity): transform,
    truncate or zero-pad the spectrum to `num` bins, inverse transform,
    rescale by num/n.  Real input rides the half-spectrum path; complex
    input and `domain='freq'` run the two-sided form.  `window` is applied
    in the frequency domain (folded onto the half spectrum for real input,
    scipy eq.); with `t` the resampled sample positions are returned as a
    second value (numpy)."""
    if domain not in ("time", "freq"):
        raise ValueError(f"domain must be 'time' or 'freq', got {domain!r}")
    num = int(num)
    if num < 1:
        raise ValueError("num must be >= 1")
    x0 = _tensor(x)
    n = x0.shape[axis]
    m = min(num, n)
    m2 = m // 2 + 1
    s_fac = n / num
    W = None if window is None else _resample_window(window, n)

    if domain == "time" and not _iscomplex(x0):
        old_bins = n // 2 + 1
        v = _f32(x0).movedim(axis, -1)
        if n % 2 == 0:
            Xr, Xi = rfft_last_split(v, None)
        else:  # odd input length: zero-imag C2C, half spectrum kept
            re_, im_ = fftn_split(v, torch.zeros_like(v), (v.ndim - 1,), FORWARD, None)
            Xr, Xi = re_[..., :old_bins], im_[..., :old_bins]
        if W is not None:
            # fold the two-sided window onto the half spectrum:
            # W1[l] = (W[l] + W[n-l]) / 2 for 0 < l < old_bins
            Wf = W[:old_bins].copy()
            Wf[1:] = (W[1:old_bins] + W[:-old_bins:-1]) / 2.0
            wj = torch.from_numpy(Wf.astype(np.float32)).to(v.device)
            Xr, Xi = Xr * wj, Xi * wj
        if m2 <= old_bins:
            Xr, Xi = Xr[..., :m2], Xi[..., :m2]
            if num % 2 == 0 and num < n:
                # the kept +num/2 and -num/2 bins fold into the new (real)
                # Nyquist: X[num/2] + conj(.) = 2*Re(X[num/2])
                Xr, Xi = _scale_bin(Xr, -1, 2.0), _scale_bin(Xi, -1, 0.0)
        if m2 > old_bins or num > n:
            if n % 2 == 0:
                # the old Nyquist splits across +/- frequencies: halve it
                Xr = _scale_bin(Xr, old_bins - 1, 0.5)
                Xi = _scale_bin(Xi, old_bins - 1, 0.5)
            new_bins = num // 2 + 1
            if new_bins > Xr.shape[-1]:
                pad = (0, new_bins - Xr.shape[-1])
                Xr = torch.nn.functional.pad(Xr, pad)
                Xi = torch.nn.functional.pad(Xi, pad)
        # total scale num/n with the inverse's 1/num folded in => 1/n
        if num % 2 == 0:
            y = irfft_last_split(Xr, Xi, num, 1.0 / n)
        else:  # odd target length: hermitian-extend + C2C inverse
            fr, fi = _hermitian_extend(Xr, Xi, num)
            y, _ = fftn_split(fr, fi, (fr.ndim - 1,), INVERSE, 1.0 / n)
        out = y.movedim(-1, axis)
    else:  # complex input or spectrum input: two-sided form
        vr, vi = split(x0)
        vr, vi = vr.movedim(axis, -1), vi.movedim(axis, -1)
        if domain == "time":
            Xr, Xi = fftn_split(vr, vi, (vr.ndim - 1,), FORWARD, None)
        else:
            Xr, Xi = vr, vi
        if W is not None:
            wj = torch.from_numpy(W.astype(np.float32)).to(vr.device)
            Xr, Xi = Xr * wj, Xi * wj
        Yr = Xr.new_zeros((*Xr.shape[:-1], num))
        Yi = Xi.new_zeros((*Xi.shape[:-1], num))
        Yr[..., :m2], Yi[..., :m2] = Xr[..., :m2], Xi[..., :m2]
        if m2 < m:  # negative-frequency half
            Yr[..., m2 - m:], Yi[..., m2 - m:] = Xr[..., m2 - m:], Xi[..., m2 - m:]
        if m % 2 == 0:
            if num < n:  # down: unite the bin pair at -m/2
                Yr[..., -m // 2] += Xr[..., -m // 2]
                Yi[..., -m // 2] += Xi[..., -m // 2]
            elif n < num:  # up: split the unpaired bin at m/2
                Yr[..., m // 2] *= 0.5
                Yi[..., m // 2] *= 0.5
                Yr[..., num - m // 2] = Yr[..., m // 2]
                Yi[..., num - m // 2] = Yi[..., m // 2]
        # ifft(Y / s_fac): 1/num inverse scale * num/n => 1/n
        yr, yi = fftn_split(Yr, Yi, (Yr.ndim - 1,), INVERSE, 1.0 / n)
        out = merge(yr.movedim(-1, axis), yi.movedim(-1, axis))
    if t is not None:
        t = np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)
        return out, t[0] + (t[1] - t[0]) * s_fac * np.arange(num)
    return out


def hilbert2(x, N=None):
    """2-D analytic signal (scipy.signal.hilbert2): real [.., n1, n2] ->
    complex with the first-quadrant spectrum kept x4 (h1 (x) h2 outer
    weighting over the last two axes).  `N` resizes the transform lengths
    (scalar or per-axis pair), scipy-named."""
    if _iscomplex(x):
        raise ValueError("hilbert2 requires a real input")
    v = _f32(_tensor(x))
    if v.ndim < 2:
        raise ValueError("hilbert2 requires at least 2 dimensions")
    if N is not None:
        n1, n2 = (N, N) if np.isscalar(N) else N
        if n1 <= 0 or n2 <= 0:
            raise ValueError("N must be positive")
    else:
        n1, n2 = v.shape[-2], v.shape[-1]

    def h(length):
        # scipy's 2-D mask differs from 1-D hilbert: the Nyquist row/col
        # is ZEROED for even lengths (Xf[k0:] = 0 with k0 = (N+1)//2)
        w = np.zeros(length, np.float32)
        w[0] = 1.0
        w[1: (length + 1) // 2] = 2.0
        return w

    if v.shape[-2] != n1:
        v = _resize_axis(v, n1, -2)
    if v.shape[-1] != n2:
        v = _resize_axis(v, n2, -1)
    axes = (v.ndim - 2, v.ndim - 1)
    re, im = fftn_split(v, torch.zeros_like(v), axes, FORWARD, None)
    w = torch.from_numpy(np.outer(h(n1), h(n2))).to(v.device)
    return merge(*fftn_split(re * w, im * w, axes, INVERSE, 1.0 / (n1 * n2)))


def _dht(v, axis, inverse):
    v = v.movedim(axis, -1)
    n = v.shape[-1]
    if n % 2 == 0:
        Xr, Xi = rfft_last_split(v, None)
        # Hermitian extension: H[k] = Re X[k] - Im X[k] with
        # X[n-k] = conj(X[k]) -> Re mirror, -Im mirror
        tail = (Xr[..., 1:-1] + Xi[..., 1:-1]).flip(-1)
        H = torch.cat([Xr - Xi, tail], dim=-1)
    else:
        Xr, Xi = fftn_split(v, torch.zeros_like(v), (v.ndim - 1,), FORWARD, None)
        H = Xr - Xi
    if inverse:
        H = H * (1.0 / n)
    return H.movedim(-1, axis)


def _check_real_f32(x, what):
    if _iscomplex(x):
        raise ValueError(f"{what} requires real input")
    return _f32(_tensor(x))


def dht(x, axis: int = -1):
    """Discrete Hartley transform along `axis`:
    H[k] = sum_j x[j] (cos(2 pi j k / n) + sin(2 pi j k / n)), evaluated
    as Re(FFT) - Im(FFT) on the R2C path.  Self-inverse up to 1/n (idht)."""
    return _dht(_check_real_f32(x, "dht"), axis, False)


def idht(x, axis: int = -1):
    """Inverse discrete Hartley transform: idht(dht(x)) == x."""
    return _dht(_check_real_f32(x, "idht"), axis, True)


def correlation_lags(in1_len: int, in2_len: int, mode: str = "full"):
    """Lag indices for :func:`fftcorrelate` output (scipy.signal
    .correlation_lags parity; host index math, a numpy array)."""
    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.size // 2
        lag_bound = in1_len // 2
        return lags[mid - lag_bound:mid + lag_bound + (in1_len % 2)]
    if mode == "valid":
        lag_bound = in1_len - in2_len
        if lag_bound >= 0:
            return np.arange(lag_bound + 1)
        return np.arange(lag_bound, 1)
    raise ValueError(f"invalid mode {mode!r}")


def _detrend_linear(v, bp):
    """v: [N, rest]; remove a least-squares line from each segment between
    breakpoints (normal equations in closed 2x2 form)."""
    out = v.clone()
    for lo, hi in zip(bp[:-1], bp[1:]):
        npts = hi - lo
        t = torch.arange(1, npts + 1, dtype=v.dtype, device=v.device) / npts
        seg = out[lo:hi]
        st, stt = t.sum(), (t * t).sum()
        sy, sty = seg.sum(0), (t[:, None] * seg).sum(0)
        det = npts * stt - st * st
        a = (npts * sty - st * sy) / det  # slope coefficient
        b = (stt * sy - st * sty) / det  # intercept
        out[lo:hi] = seg - (t[:, None] * a + b)
    return out


def detrend(data, axis: int = -1, type: str = "linear", bp=0):
    """Remove a constant or piecewise-linear trend (scipy.signal.detrend
    parity).  `bp` gives breakpoints along `axis` for piecewise fits.
    Complex input detrends re and im independently."""
    data = _tensor(data)
    if data.is_complex():
        re, im = split(data)
        return merge(detrend(re, axis, type, bp), detrend(im, axis, type, bp))
    x = _f32(data)
    if type in ("constant", "c"):
        return x - x.mean(dim=axis, keepdim=True)
    if type not in ("linear", "l"):
        raise ValueError("trend type must be 'linear' or 'constant'")
    N = x.shape[axis]
    bps = np.sort(np.unique(np.concatenate([[0], np.atleast_1d(bp), [N]])))
    if np.any(bps > N) or np.any(bps < 0):
        raise ValueError("breakpoints must lie within the axis length")
    v = x.movedim(axis, 0)
    out = _detrend_linear(v.reshape(N, -1), [int(b) for b in bps])
    return out.reshape(v.shape).movedim(0, axis)


def choose_conv_method(in1, in2, mode: str = "full", measure: bool = False):
    """scipy.signal.choose_conv_method parity shim: the FFT path IS the
    implementation, so the answer is always 'fft'; with measure=True
    ('fft', {}) like scipy's two-tuple form."""
    return ("fft", {}) if measure else "fft"


def convolve(in1, in2, mode: str = "full", method: str = "auto"):
    """N-D convolution (scipy.signal.convolve drop-in).  `method` accepts
    'auto'/'fft'/'direct'; all run :func:`fftconvolve`."""
    if method not in ("auto", "fft", "direct"):
        raise ValueError(f"invalid method {method!r}")
    return fftconvolve(in1, in2, mode=mode)


def correlate(in1, in2, mode: str = "full", method: str = "auto"):
    """N-D correlation (scipy.signal.correlate drop-in) on the FFT path
    (:func:`fftcorrelate`)."""
    if method not in ("auto", "fft", "direct"):
        raise ValueError(f"invalid method {method!r}")
    return fftcorrelate(in1, in2, mode=mode)
