"""Real transforms: R2C / C2R (torch port of ``fft_wgpu_tpu.ops.rfft``).

Even lengths use the half-size packing trick: one complex FFT of length
n/2 plus an O(n) recombination, about half the flops and bytes of a full
C2C.  On a CUDA tensor, pow2 n in 128..16384 runs that in one pass per row
through the R2C / C2R kernels (``cuda_fft.rfft_rows_split`` and
``cuda_fft.irfft_rows_split``; ``rfft`` itself takes the R2C kernel's
complex64 sink, ``cuda_fft.rfft_rows_c64``, and returns its output with no
merge, and ``irfft`` of a complex64 tensor the C2R kernel's complex64
source, ``cuda_fft.irfft_rows_c64``, with no split; ``irfftn`` and
``irfft2`` of complex64 run their leading axes through ``nd.fftn_c64``
first, where its route takes them); an R2C of composite non-pow2 n in the
composite-row envelope, odd or even, runs the composite R2C kernel
(``cuda_fft.rfft_rows_general_split``); other even n take the packed
path through the plan, other odd n a zero-imaginary C2C.  The C2R of a
spectrum product (``irfft_prod_last_split``, the convolutions' epilogue)
runs the product C2R kernel (``cuda_fft.irfft_prod_rows_split``) there.
A CPU tensor takes the packed path, as the JAX package does off the TPU.

All recombination twiddles are f64-generated (core/twiddle.py).  Chained
stages (the C2C axes of ``rfftn`` / ``irfftn``, the Hermitian family)
pass planar (re, im) pairs and merge to complex64 once, at the end.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.complex_utils import as_args, from_args, merge, promote_to_split, real_part
from ..core.twiddle import FORWARD, INVERSE
from ..utils.jit_cache import cached_call, shape_key
from . import cuda_fft, nd
from .cuda_fft import pad_bins
from .nd import _norm_axes, _run_nd_split, _sizes, fftn_split
from .transforms import _checked_length, _pad_or_trim, _positive, _resize_axis

__all__ = ["rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn", "hfft",
           "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn", "irfft_prod_last_split"]


def _r2c_general(xr) -> bool:
    """Whether the R2C of ``xr``'s last axis runs the composite R2C kernel."""
    return xr.device.type == "cuda" and cuda_fft._gen_supported(xr.shape[-1])


def _c2r_length(bins: int, n) -> int:
    """A C2R's output length: ``n``, or 2 * (bins - 1) from a half spectrum
    of ``bins`` bins, checked by ``transforms._positive`` (a 1-bin spectrum
    has no default length)."""
    return _positive(2 * (bins - 1) if n is None else n)


def _scales(n, norm, inverse):
    if norm in (None, "backward"):
        return None if not inverse else 1.0 / n
    if norm == "ortho":
        return n**-0.5
    if norm == "forward":
        return 1.0 / n if not inverse else None
    raise ValueError(f"invalid norm {norm!r}")


def rfft_last_split(xr, sign_scale, *, pad_out=False):
    """R2C over the last axis, split output, any length.

    On a CUDA tensor, pow2 n in the kernel's envelope runs the one-pass
    R2C kernel, composite n in its envelope the composite R2C kernel;
    other even n use the packed half-size path, other odd n a
    zero-imaginary C2C with the half spectrum kept.
    pad_out=True returns the padded serving form [..., pad_bins(n)]
    (exact zeros past bin n//2).
    """
    n = xr.shape[-1]
    if xr.device.type == "cuda" and cuda_fft._supported(n):  # the R2C envelope
        return cuda_fft.rfft_rows_split(xr, sign_scale, pad_out=pad_out)
    if _r2c_general(xr):
        return cuda_fft.rfft_rows_general_split(xr, sign_scale, pad_out=pad_out)
    if n % 2 == 0 and n >= 2:
        Xr, Xi = _rfft_even_split(xr, sign_scale)
    else:
        re, im = fftn_split(xr, torch.zeros_like(xr), (xr.ndim - 1,), FORWARD, sign_scale)
        Xr, Xi = re[..., : n // 2 + 1], im[..., : n // 2 + 1]
    if pad_out:
        pad = (0, pad_bins(n) - Xr.shape[-1])
        Xr = torch.nn.functional.pad(Xr, pad)
        Xi = torch.nn.functional.pad(Xi, pad)
    return Xr, Xi


def _rfft_even_split(xr, sign_scale):
    """R2C over the last axis (even n) via half-size packing.

    x real [..., n] -> X split pair [..., n//2 + 1].
    """
    from ..plan.plan import get_plan

    n = xr.shape[-1]
    m = n // 2
    z = xr.reshape(*xr.shape[:-1], m, 2)
    Zr, Zi = get_plan(m, "auto")._execute_split(z[..., 0], z[..., 1], FORWARD, None)
    return cuda_fft._r2c_unpack(Zr, Zi, n, sign_scale)


def irfft_last_split(Xr, Xi, n, total_scale, *, padded_in=False):
    """C2R over the last axis with explicit TOTAL output scale
    (numpy backward norm == 1/n), any length.

    On a CUDA tensor, pow2 n in the kernel's envelope runs the one-pass C2R
    kernel; otherwise even n take the packed half-size path, odd n the
    Hermitian extension and a C2C.  padded_in=True consumes the padded
    serving form [..., pad_bins(n)]; its pad columns are never read."""
    T = 1.0 if total_scale is None else float(total_scale)
    if Xr.device.type == "cuda" and cuda_fft._supported(n):  # the C2R envelope
        return cuda_fft.irfft_rows_split(Xr, Xi, n, T, padded_in=padded_in)
    if padded_in:
        Xr = Xr[..., : n // 2 + 1]
        Xi = Xi[..., : n // 2 + 1]
    if n % 2 or n < 2:
        fr, fi = _hermitian_extend(Xr, Xi, n)
        return fftn_split(fr, fi, (fr.ndim - 1,), INVERSE, total_scale)[0]
    # the packed path applies 1/n itself; pass the remainder on top
    net = T * n
    return _irfft_even_split(Xr, Xi, n, None if abs(net - 1.0) < 1e-12 else net)


def _one_row(Ar, Br) -> bool:
    """Whether B is one row broadcast over A: 1-D, or of A's rank or less
    with every leading dim 1 (a taps row ``[1, ..., 1, bins]``)."""
    return Br.ndim == 1 or (Br.ndim <= Ar.ndim and all(d == 1 for d in Br.shape[:-1]))


def _prod_on_kernel(Ar, Br, n) -> bool:
    """Whether real(IRFFT(A * B)) runs the product C2R kernel: a CUDA
    tensor, pow2 n in its envelope, and B of A's shape or one row
    (:func:`_one_row`)."""
    return (Ar.device.type == "cuda" and cuda_fft._supported(n)
            and (_one_row(Ar, Br) or Br.shape == Ar.shape))


def irfft_prod_last_split(Ar, Ai, Br, Bi, n, total_scale, *, padded_in=False):
    """real(IRFFT(A * B)) over the last axis with explicit TOTAL output
    scale: the spectrum-domain convolution epilogue.

    In the product C2R kernel's envelope (:func:`_prod_on_kernel`) the
    product is formed at load (a row ``[1, ..., 1, bins]`` as one 1-D row);
    any other shape (a batched-lead B such as ``[5, 1, bins]``, other n, a
    CPU tensor) takes the composed product
    and :func:`irfft_last_split`, chosen before any launch.  Both are
    differentiable in A and B.  padded_in=True consumes the padded serving
    form [..., pad_bins(n)] of both operands."""
    if _prod_on_kernel(Ar, Br, n):
        if Br.shape != Ar.shape:  # one row, as the kernel broadcasts it
            Br, Bi = Br.reshape(-1), Bi.reshape(-1)
        return cuda_fft.irfft_prod_rows_split(Ar, Ai, Br, Bi, n, total_scale,
                                              padded_in=padded_in)
    return irfft_last_split(Ar * Br - Ai * Bi, Ar * Bi + Ai * Br, n, total_scale,
                            padded_in=padded_in)


def _irfft_even_split(Xr, Xi, n, scale):
    """C2R over the last axis (even n): X [..., n//2+1] -> real [..., n].

    `scale` multiplies the result; numpy's irfft backward norm (1/n) is the
    1/m of the packed inverse FFT plus the factor absorbed in recombination.
    """
    from ..plan.plan import get_plan

    m = n // 2
    Zr, Zi = cuda_fft._c2r_pack(Xr, Xi, n)
    zr, zi = get_plan(m, "auto")._execute_split(Zr, Zi, INVERSE, 1.0 / m)
    x = torch.stack([zr, zi], dim=-1).reshape(*zr.shape[:-1], n)
    if scale is not None:
        x = x * float(np.float32(scale))
    return x


def _real_tensor(x):
    is_complex = x.is_complex() if isinstance(x, torch.Tensor) else np.iscomplexobj(x)
    if is_complex:
        raise TypeError("rfft requires real input; use fft for complex")
    return real_part(x)


def _rfft_c64(device, n: int) -> bool:
    """Whether ``rfft`` of length ``n`` on ``device`` runs the R2C kernel's
    complex64 sink (one launch, no merge): a CUDA device, pow2 n in the
    kernel's envelope."""
    return device.type == "cuda" and cuda_fft._supported(n)


def rfft(x, n=None, axis: int = -1, norm=None):
    """1-D R2C FFT: real input -> n//2+1 complex bins (numpy.fft.rfft).  On
    a CUDA tensor a repeated call replays a captured graph
    (``utils.jit_cache``), but for the R2C kernel's complex64 sink
    (:func:`_rfft_c64`, one launch), which runs eagerly, uncached."""
    xr = _real_tensor(x)
    length = _checked_length(xr, n, axis)
    scale = _scales(length, norm, inverse=False)

    def impl(v):
        if v.shape[axis] != length:
            v = _resize_axis(v, length, axis)
        if _rfft_c64(v.device, length):
            return cuda_fft.rfft_rows_c64(v.movedim(axis, -1), scale).movedim(-1, axis)
        Xr, Xi = rfft_last_split(v.movedim(axis, -1), scale)
        return merge(Xr.movedim(-1, axis), Xi.movedim(-1, axis))

    key = None if _rfft_c64(xr.device, length) else ("rfft", shape_key(xr), length, axis, scale)
    return cached_call(key, impl, xr)


def _rfft_split(x, n, axis, norm):
    xr = _real_tensor(x)
    _checked_length(xr, n, axis)
    if n is not None and xr.shape[axis] != n:
        xr = _resize_axis(xr, n, axis)
    length = xr.shape[axis]
    scale = _scales(length, norm, inverse=False)
    Xr, Xi = rfft_last_split(xr.movedim(axis, -1), scale)
    return Xr.movedim(-1, axis), Xi.movedim(-1, axis)


def _irfft_c64(device, n: int) -> bool:
    """Whether ``irfft`` of length ``n`` of a complex64 tensor of n//2 + 1
    bins on ``device`` runs the C2R kernel's complex64 source (one launch,
    no split): a CUDA device, pow2 n in the kernel's envelope."""
    return device.type == "cuda" and cuda_fft._supported(n)


def _irfftn_c64(shape, dtype, device, s, axes) -> bool:
    """Whether ``irfftn`` over ``axes`` (normalised, with the sizes ``s``) of
    a tensor of ``shape``, ``dtype`` and ``device`` runs the complex64 route
    (:func:`_irfftn_c64_run`): complex64, the last axis's bins as they lie
    (n//2 + 1 of them, n = s[-1] or 2 * (bins - 1)) on the C2R kernel's
    complex64 source (:func:`_irfft_c64`), and the leading axes, if any, on
    ``nd.fftn_c64``'s route (``nd._c64_route`` or ``nd._c64_plane``)."""
    if dtype != torch.complex64 or not axes:
        return False
    last, lead, s_lead = axes[-1], axes[:-1], s[:-1]
    n = s[-1] if s[-1] is not None else 2 * (shape[last] - 1)
    if shape[last] != n // 2 + 1 or not _irfft_c64(device, n):
        return False
    return (not lead or nd._c64_route(shape, dtype, device, s_lead, lead)
            or nd._c64_plane(shape, dtype, device, s_lead, lead))


def _irfftn_c64_run(x, s, axes, norm):
    """The complex64 route of :func:`_irfftn_c64`: the inverse C2C of the
    leading axes through the kernels' complex64 entries (``nd.fftn_c64``),
    then the C2R of the last axis from complex64 (``irfft_rows_c64``), the
    whole scale folded into the C2R's store."""
    last, lead = axes[-1], axes[:-1]
    n = s[-1] if s[-1] is not None else 2 * (x.shape[last] - 1)
    scale = _scales(n, norm, inverse=True)
    if lead:
        lead_scale = nd._nd_scale(math.prod(x.shape[a] for a in lead), INVERSE, norm)
        if lead_scale is not None:
            scale = lead_scale if scale is None else lead_scale * scale
        plane = nd._c64_plane(x.shape, x.dtype, x.device, s[:-1], lead)
        x = nd.fftn_c64(x, lead, INVERSE, None, plane)
    return cuda_fft.irfft_rows_c64(x.movedim(last, -1), n, scale).movedim(-1, last)


def irfft(x, n=None, axis: int = -1, norm=None):
    """1-D C2R inverse: n//2+1 bins -> real length-n signal (numpy.fft.irfft).
    A complex64 CUDA tensor of n//2 + 1 bins takes the C2R kernel's
    complex64 source (:func:`_irfft_c64`), eagerly, uncached (one launch).
    On a CUDA tensor any other route's repeated call replays a captured
    graph (``utils.jit_cache``)."""
    args = as_args(x)
    length = _c2r_length(args[0].shape[axis], n)
    norm_scale = _scales(length, norm, inverse=True)
    c64 = len(args) == 1 and _irfftn_c64(x.shape, x.dtype, x.device, [n], [axis])

    def impl(*a):
        if c64:
            return _irfftn_c64_run(a[0], [n], [axis], norm)
        Xr, Xi = from_args(a)
        bins = length // 2 + 1
        if Xr.shape[axis] != bins:
            Xr, Xi = _pad_or_trim(Xr, Xi, bins, axis)
        out = irfft_last_split(Xr.movedim(axis, -1), Xi.movedim(axis, -1), length, norm_scale)
        return out.movedim(-1, axis)

    key = None if c64 else ("irfft", shape_key(args[0]), length, axis, norm_scale)
    return cached_call(key, impl, *args)


def _hermitian_extend(Xr, Xi, n):
    """[..., n//2+1] half spectrum -> full [..., n] hermitian spectrum."""
    k = n // 2 + 1
    tail_r = Xr[..., 1: n - k + 1].flip(-1)
    tail_i = -Xi[..., 1: n - k + 1].flip(-1)
    return torch.cat([Xr, tail_r], dim=-1), torch.cat([Xi, tail_i], dim=-1)


def rfftn(x, s=None, axes=None, norm=None):
    """N-D R2C: rfft over the last transform axis, C2C over the rest."""
    xr = real_part(x)  # as in the JAX package, complex input keeps its real part
    return merge(*_rfftn_split(xr, s, axes, norm))


def _rfftn_split(xr, s, axes, norm):
    s_, axes_ = _norm_axes(xr.shape, s, axes)
    _sizes(xr.shape, s_, axes_)  # every axis before the first is transformed
    y = _rfft_split(xr, s_[-1], axes_[-1], norm)
    rest = axes_[:-1]
    if rest:
        y = _run_nd_split(y, list(s_[:-1]), rest, FORWARD, norm, "auto")
    return y


def irfftn(x, s=None, axes=None, norm=None):
    """N-D C2R: inverse C2C over the leading axes, irfft over the last.  A
    complex64 CUDA tensor takes the complex64 entries where
    :func:`_irfftn_c64` holds, with no split and no merge."""
    args = as_args(x)
    v = args[0]
    s_, axes_ = _norm_axes(v.shape, s, axes)
    rest = axes_[:-1]
    _sizes(v.shape, s_[:-1], rest)
    n_last = _c2r_length(v.shape[axes_[-1]], s_[-1])
    if len(args) == 1 and _irfftn_c64(v.shape, v.dtype, v.device, s_, axes_):
        return _irfftn_c64_run(v, s_, axes_, norm)
    Xr, Xi = from_args(args)
    if rest:
        Xr, Xi = _run_nd_split((Xr, Xi), list(s_[:-1]), rest, INVERSE, norm, "auto")
    return irfft((Xr, Xi), n=n_last, axis=axes_[-1], norm=norm)


def rfft2(x, s=None, axes=(-2, -1), norm=None):
    return rfftn(x, s=s, axes=list(axes), norm=norm)


def irfft2(x, s=None, axes=(-2, -1), norm=None):
    return irfftn(x, s=s, axes=list(axes), norm=norm)


def hfft(x, n=None, axis: int = -1, norm=None):
    """FFT of a signal with Hermitian symmetry -> real output
    (numpy.fft.hfft semantics): hfft(x, n) == irfft(conj(x), n) * n."""
    Xr, Xi = promote_to_split(x)
    length = _c2r_length(Xr.shape[axis], n)
    y = irfft((Xr, -Xi), n=length, axis=axis, norm=None)
    if norm in (None, "backward"):
        return y * float(np.float32(length))
    if norm == "ortho":
        return y * float(np.float32(length**0.5))
    if norm == "forward":
        return y
    raise ValueError(f"invalid norm {norm!r}")


def ihfft(x, n=None, axis: int = -1, norm=None):
    """Inverse of hfft: real input -> half-spectrum with conjugate flip."""
    Xr, Xi = _rfft_split(x, n, axis, None)
    length = n if n is not None else np.shape(x)[axis]
    if norm in (None, "backward"):
        s = 1.0 / length
    elif norm == "ortho":
        s = length**-0.5
    elif norm == "forward":
        s = 1.0
    else:
        raise ValueError(f"invalid norm {norm!r}")
    s = float(np.float32(s))
    return merge(Xr * s, -Xi * s)


# Hermitian N-D transforms (scipy.fft.hfftn/ihfftn): symmetry lives on the
# LAST transform axis only; the rest are ordinary C2C passes.  The whole
# family reduces to the real transforms through the conjugation identity
# hfftn(x, norm) == irfftn(conj(x), norm'), ihfftn(x, norm) ==
# conj(rfftn(x, norm')) with backward <-> forward swapped (the Hermitian
# transforms are normalized as FORWARD transforms while c2r/r2c inverses
# are normalized as inverses).
_NORM_SWAP = {None: "forward", "backward": "forward",
              "forward": "backward", "ortho": "ortho"}


def hfftn(x, s=None, axes=None, norm=None):
    """N-D FFT of a signal Hermitian-symmetric in its last transform axis
    (real spectrum), real output — scipy.fft.hfftn semantics."""
    if norm not in _NORM_SWAP:
        raise ValueError(f"invalid norm {norm!r}")
    Xr, Xi = promote_to_split(x)
    return irfftn((Xr, -Xi), s=s, axes=axes, norm=_NORM_SWAP[norm])


def ihfftn(x, s=None, axes=None, norm=None):
    """Inverse of hfftn: real input -> half-spectrum, conjugate-flipped
    (scipy.fft.ihfftn semantics)."""
    if norm not in _NORM_SWAP:
        raise ValueError(f"invalid norm {norm!r}")
    Xr, Xi = _rfftn_split(real_part(x), s, axes, _NORM_SWAP[norm])
    return merge(Xr, -Xi)


def hfft2(x, s=None, axes=(-2, -1), norm=None):
    return hfftn(x, s=s, axes=None if axes is None else list(axes), norm=norm)


def ihfft2(x, s=None, axes=(-2, -1), norm=None):
    return ihfftn(x, s=s, axes=None if axes is None else list(axes), norm=norm)
