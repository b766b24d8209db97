"""FFT kernels on Hopper: the port's counterpart of ``ops/pallas_fft.py``
for seven of its entry points.

* ``fft_batched_split`` — rows along the last axis, ``csrc/rows_fft.cu``
  (one thread block per row, the whole row in shared memory);
* ``fft_axis0_split`` — along axis -2 of ``[..., n, m]``, ``csrc/ax0_fft.cu``
  (a tile of neighbouring columns per block);
* ``fft_axis3_split`` — along axis -3 of ``[..., n, Y, Z]``: the same
  ``ax0_fft`` kernel on the free view ``[..., n, Y*Z]``;
* ``fft_rows_transposed_split`` — rows with the four-step outer twiddle at
  load and a transposed store, ``csrc/rows_t_fft.cu``; ``fft2_split`` is
  that kernel twice;
* ``fft2_fused_split`` — both trailing axes of ``[..., A, B]`` planes in one
  pass over device memory, ``csrc/fft2f_fft.cu``;
* ``rfft_rows_split`` / ``irfft_rows_split`` — R2C and C2R rows through a
  half-length complex FFT, ``csrc/r2c_fft.cu`` and ``csrc/c2r_fft.cu``.

A CUDA tensor goes through the hand-written kernel, a CPU tensor through
its plain version (``*_reference``).  There is no fallback between the two:
an in-envelope call on a CUDA tensor launches the kernel or raises.  Each
entry point is a ``torch.autograd.Function`` whose backward is a kernel
too, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import twiddle as _tw
from ..core.twiddle import FORWARD, INVERSE
from ..utils import build
from . import stockham

__all__ = ["Unsupported", "FUSED_MIN_N", "FUSED_MAX_N", "FFT2F_MAX_ELEMS",
           "fft_batched_split", "fft_batched_split_reference",
           "fft_axis0_split", "fft_axis0_split_reference", "fft_axis3_split",
           "fft_axis3_split_reference", "fft_rows_transposed_split",
           "fft_rows_transposed_split_reference", "fft2_fused_split",
           "fft2_fused_split_reference", "fft2_split", "pad_bins",
           "rfft_rows_split", "rfft_rows_split_reference", "irfft_rows_split",
           "irfft_rows_split_reference"]

FUSED_MIN_N = 128
FUSED_MAX_N = 16384
FFT2F_MAX_ELEMS = 1 << 16  # points of one fused 2-D plane (the JAX envelope)

# Launches of each entry point's kernel (rows_fft, ax0_fft, ax0_fft on the
# axis(-3) view, rows_t_fft, fft2f_fft, r2c_fft, c2r_fft); callers may
# reset them to 0.
launches = 0
ax0_launches = 0
ax3_launches = 0
rows_t_launches = 0
fft2f_launches = 0
r2c_launches = 0
c2r_launches = 0

# Device copies of the f64-generated (n, sign) tables, [rows, 2] float32.
_TWIDDLES: dict = {}


class Unsupported(Exception):
    """Shape outside a kernel's envelope."""


def _supported(n: int) -> bool:
    if n < FUSED_MIN_N or n > FUSED_MAX_N:
        return False
    if n & (n - 1):
        return False
    return n % 128 == 0 and n // 128 <= 128


def _check_envelope(n: int) -> None:
    if not _supported(n):
        raise Unsupported(f"n={n} outside the row kernel envelope "
                          f"(pow2 {FUSED_MIN_N}..{FUSED_MAX_N})")


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _check_planes(re, im):
    if re.shape != im.shape or re.dtype != torch.float32 \
            or im.dtype != torch.float32 or re.device != im.device:
        raise ValueError("re and im must be float32 tensors of one shape on "
                         "one device")


def _check_sign(sign):
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign!r}")


def _scale_arg(scale) -> float:
    return 1.0 if scale is None else float(scale)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _twiddle_table(n: int, sign: int, device, table=_tw.roots_np) -> torch.Tensor:
    """``table(n, sign)`` (default: the n-th roots of unity) as interleaved
    (cos, sin) float32 pairs on ``device``, cached."""
    key = (table.__name__, n, sign, str(device))
    tab = _TWIDDLES.get(key)
    if tab is None:
        pair = np.stack(table(n, sign), axis=-1)
        tab = _TWIDDLES[key] = torch.from_numpy(pair).to(device)
    return tab


def _launch(re, im, sign, scale, out=None):
    """Run the rows_fft kernel on CUDA tensors; ``out`` may alias the input."""
    global launches
    n = re.shape[-1]
    re, im = re.contiguous(), im.contiguous()
    if out is None:
        out = (torch.empty_like(re), torch.empty_like(im))
    elif not all(o.is_contiguous() and o.dtype == torch.float32
                 and o.shape == re.shape and o.device == re.device for o in out):
        raise ValueError("out planes must be contiguous float32 tensors of the "
                         "input's shape and device")
    rows = re.numel() // n
    if rows == 0:
        return out
    fn = build.function("rows_fft", "rows_fft_f32",
                        [_P, _P, _P, _P, _P, _LL, _I, _I, _F, _I, _P])
    tw = _twiddle_table(n, sign, re.device)
    err = fn(re.data_ptr(), im.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
             tw.data_ptr(), rows, n.bit_length() - 1, sign, _scale_arg(scale),
             re.device.index, _stream(re))
    build.check("rows_fft", err, f"rows_fft launch failed (n={n}, rows={rows})")
    launches += 1
    return out


def _transform(re, im, sign, scale, out=None):
    if re.device.type == "cuda":
        return _launch(re, im, sign, scale, out)
    if re.device.type != "cpu":
        raise ValueError(f"no row FFT for device {re.device}")
    yr, yi = fft_batched_split_reference(re, im, sign, scale)
    if out is None:
        return yr, yi
    out[0].copy_(yr)
    out[1].copy_(yi)
    return out


class _SignFlipped(torch.autograd.Function):
    """``transform(re, im, sign, scale)``, a DFT along one axis, with its
    adjoint.  The transform is M = scale * W_sign with W symmetric and
    conj(W_s) = W_-s, so its adjoint is scale * W_-sign: the same transform
    (the same kernel, on the card) with the sign flipped and the same scale."""

    @staticmethod
    def forward(ctx, transform, re, im, sign, scale):
        ctx.transform, ctx.sign, ctx.scale = transform, sign, scale
        return transform(re, im, sign, scale)

    @staticmethod
    def backward(ctx, gr, gi):
        return (None, *ctx.transform(gr, gi, -ctx.sign, ctx.scale), None, None)


def fft_batched_split(re, im, sign, scale=None, *, out=None):
    """Batched FFT over the last axis of planar float32 ``[..., n]`` tensors.

    sign: -1 forward / +1 inverse; scale folded into the last pass.
    Differentiable (the backward is the sign-flipped transform).  With
    ``out=(out_re, out_im)`` the result is written into those planes, which
    may be the inputs themselves (in place); that form does not record
    autograd history.
    """
    _check_envelope(re.shape[-1])
    _check_sign(sign)
    _check_planes(re, im)
    if out is None:
        return _SignFlipped.apply(_transform, re, im, sign, scale)
    if torch.is_grad_enabled() and (re.requires_grad or im.requires_grad):
        raise ValueError("out= writes in place and records no gradient; "
                         "call without out= to differentiate")
    return _transform(re, im, sign, scale, out)


def fft_batched_split_reference(re, im, sign, scale=None):
    """Plain torch version of :func:`fft_batched_split`: the mixed-radix
    stockham path plus the output scale, on the same f64-generated tables.
    Raises :class:`Unsupported` for the same n as the kernel."""
    _check_envelope(re.shape[-1])
    re, im = stockham.fft_last_axis(re, im, sign)
    return stockham.apply_scale(re, im, scale)


# ---------------------------------------------------------------------- #
# axis -2 of [..., n, m] (pallas_fft.fft_axis0_split)
# ---------------------------------------------------------------------- #
def _ax0_supported(n: int) -> bool:
    """Axis(-2) kernel envelope: pow2 n in 128..16384.  The JAX package's
    kernel also takes composite n; that range comes with the composite row
    kernel (ROADMAP queue A, slice 6)."""
    return _supported(n)


def _check_ax0(re) -> None:
    if re.ndim < 2:
        raise ValueError(f"axis(-2) FFT needs [..., n, m], got shape {tuple(re.shape)}")
    n = re.shape[-2]
    if not _ax0_supported(n):
        raise Unsupported(f"n={n} outside the axis(-2) kernel envelope "
                          f"(pow2 {FUSED_MIN_N}..{FUSED_MAX_N})")


def _ax0_kernel(re, im, sign, scale):
    """Run the ax0_fft kernel on CUDA tensors; returns the output planes
    and whether it launched (an empty input launches nothing)."""
    n, m = re.shape[-2:]
    re, im = re.contiguous(), im.contiguous()
    out = (torch.empty_like(re), torch.empty_like(im))
    if re.numel() == 0:
        return out, False
    planes = re.numel() // (n * m)
    fn = build.function("ax0_fft", "ax0_fft_f32",
                        [_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _F, _I, _P])
    tw = _twiddle_table(n, sign, re.device)
    err = fn(re.data_ptr(), im.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
             tw.data_ptr(), planes, m, n.bit_length() - 1, sign, _scale_arg(scale),
             re.device.index, _stream(re))
    build.check("ax0_fft", err,
                f"ax0_fft launch failed (n={n}, m={m}, planes={planes})")
    return out, True


def _ax0_launch(re, im, sign, scale):
    """The ax0_fft kernel on axis -2 of CUDA tensors, counted."""
    global ax0_launches
    out, launched = _ax0_kernel(re, im, sign, scale)
    ax0_launches += launched
    return out


def _ax0(re, im, sign, scale):
    if re.device.type == "cuda":
        return _ax0_launch(re, im, sign, scale)
    if re.device.type != "cpu":
        raise ValueError(f"no axis(-2) FFT for device {re.device}")
    return fft_axis0_split_reference(re, im, sign, scale)


def fft_axis0_split(re, im, sign, scale=None):
    """Batched FFT along axis -2 of planar float32 ``[..., n, m]`` tensors
    (the m columns are the batch), with no transpose in memory.

    sign: -1 forward / +1 inverse; scale folded into the store.
    Differentiable (the backward is the sign-flipped transform)."""
    _check_ax0(re)
    _check_sign(sign)
    _check_planes(re, im)
    return _SignFlipped.apply(_ax0, re, im, sign, scale)


def fft_axis0_split_reference(re, im, sign, scale=None):
    """Plain torch version of :func:`fft_axis0_split`: the mixed-radix path
    on axis -2 moved to the back, plus the scale (the JAX package's route
    off the TPU).  Raises :class:`Unsupported` for the same n as the kernel."""
    _check_ax0(re)
    yr, yi = stockham.fft_last_axis(re.movedim(-2, -1), im.movedim(-2, -1), sign)
    yr, yi = stockham.apply_scale(yr, yi, scale)
    return yr.movedim(-1, -2), yi.movedim(-1, -2)


# ---------------------------------------------------------------------- #
# rows with the outer twiddle, stored transposed
# (pallas_fft.fft_rows_transposed_split)
# ---------------------------------------------------------------------- #
def _check_rows_t(re, outer) -> None:
    if re.ndim < 2:
        raise ValueError(f"transposed row FFT needs [..., R, n], got shape "
                         f"{tuple(re.shape)}")
    _check_envelope(re.shape[-1])
    if outer is not None and int(outer[1]) < 1:
        raise ValueError(f"outer=(n1, outer_n) needs outer_n >= 1, got {outer!r}")


def _outer_plane(rows: int, n: int, outer_n: int, sign: int, device):
    """The outer twiddle plane w[r, m] = exp(sign*2pi*i*((r*m) mod outer_n)
    / outer_n), r < rows, m < n, gathered from the f64-generated table of
    outer_n-th roots at the integer-reduced index: (re, im) ``[rows, n]``."""
    tab = _twiddle_table(outer_n, sign, device)
    r = torch.arange(rows, device=device, dtype=torch.int64)
    m = torch.arange(n, device=device, dtype=torch.int64)
    w = tab[(r[:, None] * m[None, :]) % outer_n]
    return w[..., 0], w[..., 1]


def _rows_t_launch(re, im, sign, scale, outer):
    """Run the rows_t_fft kernel on CUDA tensors: [..., R, n] -> [..., n, R]."""
    global rows_t_launches
    rows, n = re.shape[-2:]
    re, im = re.contiguous(), im.contiguous()
    shape = (*re.shape[:-2], n, rows)
    out = (re.new_empty(shape), im.new_empty(shape))
    if re.numel() == 0:
        return out
    planes = re.numel() // (rows * n)
    tw = _twiddle_table(n, sign, re.device)
    outer_n = 0 if outer is None else int(outer[1])
    otab = None if outer is None else _twiddle_table(outer_n, sign, re.device).data_ptr()
    fn = build.function("rows_t_fft", "rows_t_fft_f32",
                        [_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _F, _I, _P])
    err = fn(re.data_ptr(), im.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
             tw.data_ptr(), otab, outer_n, planes, rows, n.bit_length() - 1, sign,
             _scale_arg(scale), re.device.index, _stream(re))
    build.check("rows_t_fft", err, f"rows_t_fft launch failed (n={n}, "
                f"rows={rows}, planes={planes}, outer={outer})")
    rows_t_launches += 1
    return out


def _rows_t(re, im, sign, scale, outer):
    if re.device.type == "cuda":
        return _rows_t_launch(re, im, sign, scale, outer)
    if re.device.type != "cpu":
        raise ValueError(f"no transposed row FFT for device {re.device}")
    return fft_rows_transposed_split_reference(re, im, sign, scale, outer=outer)


class _RowsTFFT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, re, im, sign, scale, outer):
        ctx.sign, ctx.scale, ctx.outer = sign, scale, outer
        return _rows_t(re, im, sign, scale, outer)

    @staticmethod
    def backward(ctx, gr, gi):
        # The forward is x -> transpose(scale * W_sign (tw . x)).  Its adjoint
        # takes the cotangent back through the transpose, then scale * W_-sign
        # (the row kernel with the sign flipped), then the conjugate twiddle.
        gr, gi = _transform(gr.transpose(-1, -2), gi.transpose(-1, -2),
                            -ctx.sign, ctx.scale)
        if ctx.outer is not None:
            rows, n = gr.shape[-2:]
            twr, twi = _outer_plane(rows, n, int(ctx.outer[1]), -ctx.sign, gr.device)
            gr, gi = gr * twr - gi * twi, gr * twi + gi * twr
        return gr, gi, None, None, None


def fft_rows_transposed_split(re, im, sign, scale=None, *, outer=None):
    """FFT each length-n row of planar float32 ``[..., R, n]`` and return the
    transposed result ``[..., n, R]``.  With ``outer=(n1, outer_n)`` row r is
    first multiplied by exp(sign*2pi*i*r*m/outer_n) (the four-step outer
    twiddle; n1 is not read).  Differentiable: the backward runs the row
    kernel with the sign flipped and the conjugate twiddle."""
    _check_rows_t(re, outer)
    _check_sign(sign)
    _check_planes(re, im)
    return _RowsTFFT.apply(re, im, sign, scale, outer)


def fft_rows_transposed_split_reference(re, im, sign, scale=None, *, outer=None):
    """Plain torch version of :func:`fft_rows_transposed_split`: the twiddle
    plane, the mixed-radix rows, the scale, then the transpose.  Raises
    :class:`Unsupported` for the same n as the kernel."""
    _check_rows_t(re, outer)
    if outer is not None:
        twr, twi = _outer_plane(re.shape[-2], re.shape[-1], int(outer[1]), sign,
                                re.device)
        re, im = re * twr - im * twi, re * twi + im * twr
    yr, yi = stockham.fft_last_axis(re, im, sign)
    yr, yi = stockham.apply_scale(yr, yi, scale)
    return yr.transpose(-1, -2), yi.transpose(-1, -2)


# ---------------------------------------------------------------------- #
# axis -3 of [..., n, Y, Z] (pallas_fft.fft_axis3_split)
# ---------------------------------------------------------------------- #
def _check_ax3(re) -> None:
    if re.ndim < 3:
        raise ValueError(f"axis(-3) FFT needs [..., n, Y, Z], got shape "
                         f"{tuple(re.shape)}")
    n = re.shape[-3]
    # the axis(-2) kernel's envelope; the JAX kernel also needs Y % 8 == 0
    # and Z % 128 == 0 (its VMEM tiling), here Y and Z are free
    if not _ax0_supported(n):
        raise Unsupported(f"n={n} outside the axis(-3) kernel envelope "
                          f"(pow2 {FUSED_MIN_N}..{FUSED_MAX_N})")


def _ax3_launch(re, im, sign, scale):
    """Axis -3 of contiguous ``[..., n, Y, Z]`` is axis -2 of the free view
    ``[..., n, Y*Z]``: run the ax0_fft kernel there, counted as axis(-3)."""
    global ax3_launches
    shape = re.shape
    re, im = re.contiguous(), im.contiguous()
    view = (*shape[:-2], shape[-2] * shape[-1])
    (yr, yi), launched = _ax0_kernel(re.view(view), im.view(view), sign, scale)
    ax3_launches += launched
    return yr.view(shape), yi.view(shape)


def _ax3(re, im, sign, scale):
    if re.device.type == "cuda":
        return _ax3_launch(re, im, sign, scale)
    if re.device.type != "cpu":
        raise ValueError(f"no axis(-3) FFT for device {re.device}")
    return fft_axis3_split_reference(re, im, sign, scale)


def fft_axis3_split(re, im, sign, scale=None):
    """Batched FFT along axis -3 of planar float32 ``[..., n, Y, Z]``, with
    no transpose in memory: on the card the axis(-2) kernel walks the free
    view ``[..., n, Y*Z]``.  A non-contiguous input is made contiguous once.

    sign: -1 forward / +1 inverse; scale folded into the store.
    Differentiable (the backward is the sign-flipped transform)."""
    _check_ax3(re)
    _check_sign(sign)
    _check_planes(re, im)
    return _SignFlipped.apply(_ax3, re, im, sign, scale)


def fft_axis3_split_reference(re, im, sign, scale=None):
    """Plain torch version of :func:`fft_axis3_split`: the mixed-radix path
    on axis -3 moved to the back, plus the scale.  Raises
    :class:`Unsupported` for the same n as the kernel."""
    _check_ax3(re)
    yr, yi = stockham.fft_last_axis(re.movedim(-3, -1), im.movedim(-3, -1), sign)
    yr, yi = stockham.apply_scale(yr, yi, scale)
    return yr.movedim(-1, -3), yi.movedim(-1, -3)


# ---------------------------------------------------------------------- #
# 2-D planes: fused (pallas_fft.fft2_fused_split) and two transposed-rows
# passes (pallas_fft.fft2_split)
# ---------------------------------------------------------------------- #
def _fft2f_supported(A: int, B: int) -> bool:
    """Fused-plane envelope, the JAX kernel's: A and B pow2 >= 128 with
    A*B <= 2^16 points (a plane of up to 512 KB, held by a cluster of two
    to eight blocks on the card)."""
    return (all(v >= FUSED_MIN_N and not v & (v - 1) for v in (A, B))
            and A * B <= FFT2F_MAX_ELEMS)


def _check_fft2f(re) -> None:
    if re.ndim < 2:
        raise ValueError(f"2-D FFT needs [..., A, B], got shape {tuple(re.shape)}")
    A, B = re.shape[-2:]
    if not _fft2f_supported(A, B):
        raise Unsupported(f"plane ({A},{B}) outside the fused-plane envelope "
                          f"(pow2 >= {FUSED_MIN_N}, A*B <= {FFT2F_MAX_ELEMS})")


def _fft2f_launch(re, im, sign, scale):
    """Run the fft2f_fft kernel on CUDA tensors."""
    global fft2f_launches
    A, B = re.shape[-2:]
    re, im = re.contiguous(), im.contiguous()
    out = (torch.empty_like(re), torch.empty_like(im))
    if re.numel() == 0:
        return out
    planes = re.numel() // (A * B)
    fn = build.function("fft2f_fft", "fft2f_fft_f32",
                        [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _F, _I, _P])
    twa = _twiddle_table(A, sign, re.device)
    twb = _twiddle_table(B, sign, re.device)
    err = fn(re.data_ptr(), im.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
             twa.data_ptr(), twb.data_ptr(), planes, A.bit_length() - 1,
             B.bit_length() - 1, sign, _scale_arg(scale), re.device.index,
             _stream(re))
    build.check("fft2f_fft", err,
                f"fft2f_fft launch failed (plane {A}x{B}, planes={planes})")
    fft2f_launches += 1
    return out


def _fft2f(re, im, sign, scale):
    if re.device.type == "cuda":
        return _fft2f_launch(re, im, sign, scale)
    if re.device.type != "cpu":
        raise ValueError(f"no fused 2-D FFT for device {re.device}")
    return fft2_fused_split_reference(re, im, sign, scale)


def fft2_fused_split(re, im, sign, scale=None):
    """2-D FFT over the two trailing axes of planar float32 ``[..., A, B]``
    in one pass over device memory (both axes while the plane is on chip).

    sign: -1 forward / +1 inverse; scale folded into the store.
    Differentiable (the backward is the sign-flipped transform)."""
    _check_fft2f(re)
    _check_sign(sign)
    _check_planes(re, im)
    return _SignFlipped.apply(_fft2f, re, im, sign, scale)


def fft2_fused_split_reference(re, im, sign, scale=None):
    """Plain torch version of :func:`fft2_fused_split`: the mixed-radix path
    over B, then over A, plus the scale.  Raises :class:`Unsupported` for
    the same planes as the kernel."""
    _check_fft2f(re)
    yr, yi = stockham.fft_last_axis(re, im, sign)
    yr, yi = stockham.fft_last_axis(yr.transpose(-1, -2), yi.transpose(-1, -2), sign)
    yr, yi = stockham.apply_scale(yr, yi, scale)
    return yr.transpose(-1, -2), yi.transpose(-1, -2)


def fft2_split(re, im, sign, scale=None):
    """2-D FFT over the last two axes as two transposed-rows passes (the
    rows_t_fft kernel twice, no other transpose):

        pass 1: X[a, b]  -> Y[kb, a]   (FFT over b)
        pass 2: Y[kb, a] -> Z[ka, kb]  (FFT over a; the scale folded in)

    Both axes must be in the row kernel's envelope.  Differentiable."""
    if re.ndim < 2:
        raise ValueError(f"2-D FFT needs [..., A, B], got shape {tuple(re.shape)}")
    A, B = re.shape[-2:]
    if not (_supported(A) and _supported(B)):
        raise Unsupported(f"2-D axes ({A},{B}) outside the row kernel envelope")
    r1, i1 = fft_rows_transposed_split(re, im, sign, None)
    return fft_rows_transposed_split(r1, i1, sign, scale)


# ---------------------------------------------------------------------- #
# real transforms: R2C rows (pallas_fft.rfft_rows_split) and C2R rows
# (pallas_fft.irfft_rows_split) through a half-length complex FFT
# ---------------------------------------------------------------------- #
def pad_bins(n: int) -> int:
    """Bin count of the padded half-spectrum serving form,
    round_up(n//2 + 1, 128); pad columns are exact zeros.  An API contract
    shared with the JAX package, not a schedule."""
    return -(-(n // 2 + 1) // 128) * 128


def _check_real(n: int) -> None:
    # the row kernel's envelope, pow2 n in 128..16384 (a half-length complex
    # FFT of 64..8192 points in one block); the JAX C2R kernel starts at
    # n = 256, here both start at 128
    if not _supported(n):
        raise Unsupported(f"n={n} outside the real-transform kernel envelope "
                          f"(pow2 {FUSED_MIN_N}..{FUSED_MAX_N})")


def _halfcomplex_table(n: int, sign: int, device) -> torch.Tensor:
    """exp(sign*2pi*i*k/n), k = 0..n/2, as (cos, sin) pairs on ``device``."""
    return _twiddle_table(n, sign, device, _tw.halfcomplex_twiddle_np)


def _r2c_unpack(Zr, Zi, n, scale):
    """X[k], k = 0..n/2, of the real row x from Z = FFT_{n/2}(x[0::2] +
    i x[1::2]):  X[k] = (Z[k] + conj(Z[m-k]))/2 - (i/2) t[k] (Z[k] -
    conj(Z[m-k])), t[k] = exp(-2 pi i k/n), Z[m] = Z[0]; times ``scale``."""
    Zr_f = torch.cat([Zr, Zr[..., :1]], dim=-1)
    Zi_f = torch.cat([Zi, Zi[..., :1]], dim=-1)
    Zr_rev, Zi_rev = Zr_f.flip(-1), Zi_f.flip(-1)
    tab = _halfcomplex_table(n, FORWARD, Zr.device)
    tr, ti = tab[:, 0], tab[:, 1]
    er, ei = 0.5 * (Zr_f + Zr_rev), 0.5 * (Zi_f - Zi_rev)
    dr, di = 0.5 * (Zr_f - Zr_rev), 0.5 * (Zi_f + Zi_rev)
    Xr = er + (tr * di + ti * dr)
    Xi = ei - (tr * dr - ti * di)
    return stockham.apply_scale(Xr, Xi, scale)


def _c2r_pack(Xr, Xi, n):
    """Z[k], k < n/2, whose inverse FFT_{n/2} with 1/(n/2) is the real row
    (numpy's irfft) interleaved as z[j] = x[2j] + i x[2j+1]:
    Z = E + i O, E[k] = (X[k] + conj(X[m-k]))/2,
    O[k] = t[k] (X[k] - conj(X[m-k]))/2, t[k] = exp(+2 pi i k/n).  The
    imaginary parts of the DC and Nyquist bins are ignored, as numpy does."""
    m = n // 2
    keep = torch.ones(m + 1, dtype=Xi.dtype, device=Xi.device)
    keep[0] = keep[m] = 0.0
    Xi = Xi * keep
    Xr_rev, Xi_rev = Xr.flip(-1), Xi.flip(-1)
    tab = _halfcomplex_table(n, INVERSE, Xr.device)[:m]
    tr, ti = tab[:, 0], tab[:, 1]
    er, ei = 0.5 * (Xr + Xr_rev)[..., :m], 0.5 * (Xi - Xi_rev)[..., :m]
    dr, di = 0.5 * (Xr - Xr_rev)[..., :m], 0.5 * (Xi + Xi_rev)[..., :m]
    or_, oi = tr * dr - ti * di, tr * di + ti * dr
    return er - oi, ei + or_


def _r2c_launch(xr, scale, pad_out):
    """Run the r2c_fft kernel on a CUDA tensor."""
    global r2c_launches
    n = xr.shape[-1]
    bins = pad_bins(n) if pad_out else n // 2 + 1
    xr = xr.contiguous()
    shape = (*xr.shape[:-1], bins)
    out = (xr.new_empty(shape), xr.new_empty(shape))
    if xr.numel() == 0:
        return out
    rows = xr.numel() // n
    m = n // 2
    fn = build.function("r2c_fft", "r2c_fft_f32",
                        [_P, _P, _P, _P, _P, _LL, _I, _I, _F, _I, _P])
    err = fn(xr.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
             _twiddle_table(m, FORWARD, xr.device).data_ptr(),
             _halfcomplex_table(n, FORWARD, xr.device).data_ptr(), rows,
             m.bit_length() - 1, bins, _scale_arg(scale), xr.device.index,
             _stream(xr))
    build.check("r2c_fft", err, f"r2c_fft launch failed (n={n}, rows={rows})")
    r2c_launches += 1
    return out


def _r2c(xr, scale, pad_out):
    if xr.device.type == "cuda":
        return _r2c_launch(xr, scale, pad_out)
    if xr.device.type != "cpu":
        raise ValueError(f"no R2C FFT for device {xr.device}")
    return rfft_rows_split_reference(xr, scale, pad_out=pad_out)


def _c2r_launch(Xr, Xi, n, scale):
    """Run the c2r_fft kernel on CUDA tensors (rows of any bin count
    >= n/2 + 1; only bins 0..n/2 are read)."""
    global c2r_launches
    bins = Xr.shape[-1]
    Xr, Xi = Xr.contiguous(), Xi.contiguous()
    out = Xr.new_empty((*Xr.shape[:-1], n))
    if Xr.numel() == 0:
        return out
    rows = Xr.numel() // bins
    m = n // 2
    fn = build.function("c2r_fft", "c2r_fft_f32",
                        [_P, _P, _P, _P, _P, _LL, _I, _I, _F, _I, _P])
    err = fn(Xr.data_ptr(), Xi.data_ptr(), out.data_ptr(),
             _twiddle_table(m, INVERSE, Xr.device).data_ptr(),
             _halfcomplex_table(n, INVERSE, Xr.device).data_ptr(), rows,
             m.bit_length() - 1, bins, _scale_arg(scale), Xr.device.index,
             _stream(Xr))
    build.check("c2r_fft", err, f"c2r_fft launch failed (n={n}, rows={rows})")
    c2r_launches += 1
    return out


def _c2r(Xr, Xi, n, scale):
    if Xr.device.type == "cuda":
        return _c2r_launch(Xr, Xi, n, scale)
    if Xr.device.type != "cpu":
        raise ValueError(f"no C2R FFT for device {Xr.device}")
    return irfft_rows_split_reference(Xr, Xi, n, scale,
                                      padded_in=Xr.shape[-1] != n // 2 + 1)


class _R2C(torch.autograd.Function):
    """R2C with scale k: X[b] = k sum_m x[m] exp(-2 pi i b m/n), b <= n/2.
    Its adjoint is g[m] = k Re sum_b ct[b] exp(+2 pi i b m/n): the cotangent
    bins zero-padded to n through the +sign C2C (the row kernel on the
    card), real part.  Pad columns of the padded form are written as zeros,
    so their cotangents are discarded."""

    @staticmethod
    def forward(ctx, xr, scale, pad_out):
        ctx.n, ctx.scale = xr.shape[-1], scale
        return _r2c(xr, scale, pad_out)

    @staticmethod
    def backward(ctx, gr, gi):
        n, mp = ctx.n, ctx.n // 2 + 1
        pad = (0, n - mp)
        gr = torch.nn.functional.pad(gr[..., :mp], pad)
        gi = torch.nn.functional.pad(gi[..., :mp], pad)
        yr, _ = _transform(gr.contiguous(), gi.contiguous(), INVERSE, ctx.scale)
        return yr, None, None


class _C2R(torch.autograd.Function):
    """C2R with scale k: x = 2k Re sum_b eps_b X[b] exp(+2 pi i b j/n),
    eps = 1/2 at DC and Nyquist.  Its adjoint is 2k eps_b (R2C of ct)[b]
    (the R2C kernel on the card); the padded form's pad columns get zero."""

    @staticmethod
    def forward(ctx, Xr, Xi, n, scale, padded_in):
        ctx.n, ctx.scale, ctx.padded_in = n, scale, padded_in
        return _c2r(Xr, Xi, n, scale)

    @staticmethod
    def backward(ctx, g):
        n, m = ctx.n, ctx.n // 2
        gr, gi = _r2c(g.contiguous(), None, ctx.padded_in)
        eps = torch.zeros(gr.shape[-1], dtype=gr.dtype, device=gr.device)
        eps[:m + 1] = 1.0
        eps[0] = eps[m] = 0.5
        k = 2.0 * _scale_arg(ctx.scale)
        return k * eps * gr, k * eps * gi, None, None, None


def rfft_rows_split(xr, scale=None, *, pad_out=False):
    """Batched R2C FFT over the last axis: real float32 ``[..., n]`` ->
    planar ``[..., n//2 + 1]``, or the padded serving form
    ``[..., pad_bins(n)]`` with exact zeros past bin n//2 when
    ``pad_out=True``.  Forward sign; scale folded into the store.
    Differentiable (backward: the +sign row kernel on the zero-padded
    cotangent, real part)."""
    if xr.dtype != torch.float32:
        raise ValueError("rfft_rows_split takes a float32 tensor")
    _check_real(xr.shape[-1])
    return _R2C.apply(xr, scale, bool(pad_out))


def rfft_rows_split_reference(xr, scale=None, *, pad_out=False):
    """Plain torch version of :func:`rfft_rows_split`: the half-size
    packing through the mixed-radix path.  Raises :class:`Unsupported` for
    the same n as the kernel."""
    n = xr.shape[-1]
    _check_real(n)
    z = xr.reshape(*xr.shape[:-1], n // 2, 2)
    Zr, Zi = stockham.fft_last_axis(z[..., 0], z[..., 1], FORWARD)
    Xr, Xi = _r2c_unpack(Zr, Zi, n, scale)
    if pad_out:
        pad = (0, pad_bins(n) - Xr.shape[-1])
        Xr = torch.nn.functional.pad(Xr, pad)
        Xi = torch.nn.functional.pad(Xi, pad)
    return Xr, Xi


def _check_c2r(Xr, Xi, n, padded_in) -> None:
    _check_real(n)
    _check_planes(Xr, Xi)
    bins = pad_bins(n) if padded_in else n // 2 + 1
    if Xr.shape[-1] != bins:
        raise ValueError(f"C2R of n={n} expects {bins} bins"
                         f"{' (padded)' if padded_in else ''}, got {Xr.shape[-1]}")


def irfft_rows_split(Xr, Xi, n, scale=None, *, padded_in=False):
    """Batched C2R over the last axis: planar half spectrum
    ``[..., n//2 + 1]`` (or the padded form ``[..., pad_bins(n)]`` with
    ``padded_in=True``, whose pad columns are not read) -> real float32
    ``[..., n]``.  ``scale`` multiplies the result (numpy's irfft is
    scale = 1/n); the imaginary parts of the DC and Nyquist bins are
    ignored.  Differentiable (backward: the R2C kernel)."""
    _check_c2r(Xr, Xi, n, padded_in)
    return _C2R.apply(Xr, Xi, n, scale, bool(padded_in))


def irfft_rows_split_reference(Xr, Xi, n, scale=None, *, padded_in=False):
    """Plain torch version of :func:`irfft_rows_split`: the half-size
    packing through the mixed-radix path.  Raises :class:`Unsupported` for
    the same n as the kernel."""
    _check_c2r(Xr, Xi, n, padded_in)
    m = n // 2
    Zr, Zi = _c2r_pack(Xr[..., :m + 1], Xi[..., :m + 1], n)
    zr, zi = stockham.fft_last_axis(Zr, Zi, INVERSE)
    # the packed inverse with 1/m is numpy's irfft (scale 1/n): n/m = 2
    zr, zi = stockham.apply_scale(zr, zi, 2.0 * _scale_arg(scale))
    return torch.stack([zr, zi], dim=-1).reshape(*zr.shape[:-1], n)
