"""C2C FFT kernels on Hopper: the port's counterpart of ``ops/pallas_fft.py``
for three of its entry points.

* ``fft_batched_split`` — rows along the last axis, ``csrc/rows_fft.cu``
  (one thread block per row, the whole row in shared memory);
* ``fft_axis0_split`` — along axis -2 of ``[..., n, m]``, ``csrc/ax0_fft.cu``
  (a tile of neighbouring columns per block);
* ``fft_rows_transposed_split`` — rows with the four-step outer twiddle at
  load and a transposed store, ``csrc/rows_t_fft.cu``.

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
from ..utils import build
from . import stockham

__all__ = ["Unsupported", "FUSED_MIN_N", "FUSED_MAX_N", "fft_batched_split",
           "fft_batched_split_reference", "fft_axis0_split",
           "fft_axis0_split_reference", "fft_rows_transposed_split",
           "fft_rows_transposed_split_reference"]

FUSED_MIN_N = 128
FUSED_MAX_N = 16384

# Launches of each kernel (rows_fft, ax0_fft, rows_t_fft); callers may
# reset them to 0.
launches = 0
ax0_launches = 0
rows_t_launches = 0

# Device copies of the per-(n, sign) root-of-unity tables, [n, 2] float32.
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


def _twiddle_table(n: int, sign: int, device) -> torch.Tensor:
    key = (n, sign, str(device))
    tab = _TWIDDLES.get(key)
    if tab is None:
        pair = np.stack(_tw.roots_np(n, sign), axis=-1)
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


def _ax0_launch(re, im, sign, scale):
    """Run the ax0_fft kernel on CUDA tensors."""
    global ax0_launches
    n, m = re.shape[-2:]
    re, im = re.contiguous(), im.contiguous()
    out = (torch.empty_like(re), torch.empty_like(im))
    if re.numel() == 0:
        return out
    planes = re.numel() // (n * m)
    fn = build.function("ax0_fft", "ax0_fft_f32",
                        [_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _F, _I, _P])
    tw = _twiddle_table(n, sign, re.device)
    err = fn(re.data_ptr(), im.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
             tw.data_ptr(), planes, m, n.bit_length() - 1, sign, _scale_arg(scale),
             re.device.index, _stream(re))
    build.check("ax0_fft", err,
                f"ax0_fft launch failed (n={n}, m={m}, planes={planes})")
    ax0_launches += 1
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
