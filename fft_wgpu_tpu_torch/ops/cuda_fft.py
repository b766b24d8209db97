"""Batched row FFT on Hopper: the port's counterpart of ``ops/pallas_fft.py``
for its batched C2C entry point, ``fft_batched_split``.

A CUDA tensor goes through the hand-written kernel ``csrc/rows_fft.cu``
(one thread block per row, the whole row in shared memory).  A CPU tensor
goes through the plain version, :func:`fft_batched_split_reference`.  There
is no fallback between the two: an in-envelope call on a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import twiddle as _tw
from ..utils import build
from . import stockham

__all__ = ["Unsupported", "FUSED_MIN_N", "FUSED_MAX_N", "fft_batched_split",
           "fft_batched_split_reference"]

FUSED_MIN_N = 128
FUSED_MAX_N = 16384

# Launches of the rows_fft kernel; callers may reset it to 0.
launches = 0

# Device copies of the per-(n, sign) root-of-unity tables, [n, 2] float32.
_TWIDDLES: dict = {}


class Unsupported(Exception):
    """Shape outside the row kernel's envelope."""


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


def _lib():
    lib = build.load("rows_fft")
    if lib.rows_fft_f32.argtypes is None:
        p = ctypes.c_void_p
        lib.rows_fft_f32.argtypes = [p, p, p, p, p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_int, p]
        lib.rows_fft_f32.restype = ctypes.c_int
        lib.rows_fft_error_string.argtypes = [ctypes.c_int]
        lib.rows_fft_error_string.restype = ctypes.c_char_p
    return lib


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
    lib = _lib()
    tw = _twiddle_table(n, sign, re.device)
    err = lib.rows_fft_f32(
        re.data_ptr(), im.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        tw.data_ptr(), rows, n.bit_length() - 1, sign,
        1.0 if scale is None else float(scale), re.device.index,
        torch.cuda.current_stream(re.device).cuda_stream)
    if err:
        raise RuntimeError(f"rows_fft launch failed (n={n}, rows={rows}): "
                           f"{lib.rows_fft_error_string(err).decode()}")
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


class _RowsFFT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, re, im, sign, scale):
        ctx.sign, ctx.scale = sign, scale
        return _transform(re, im, sign, scale)

    @staticmethod
    def backward(ctx, gr, gi):
        # The transform is M = scale * W_sign with W symmetric and
        # conj(W_s) = W_-s, so its adjoint is scale * W_-sign: the same
        # kernel with the sign flipped and the same scale.
        return (*_transform(gr, gi, -ctx.sign, ctx.scale), None, None)


def fft_batched_split(re, im, sign, scale=None, *, out=None):
    """Batched FFT over the last axis of planar float32 ``[..., n]`` tensors.

    sign: -1 forward / +1 inverse; scale folded into the last pass.
    Differentiable (the backward is the sign-flipped transform).  With
    ``out=(out_re, out_im)`` the result is written into those planes, which
    may be the inputs themselves (in place); that form does not record
    autograd history.
    """
    _check_envelope(re.shape[-1])
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign!r}")
    if re.shape != im.shape or re.dtype != torch.float32 \
            or im.dtype != torch.float32 or re.device != im.device:
        raise ValueError("re and im must be float32 tensors of one shape on "
                         "one device")
    if out is None:
        return _RowsFFT.apply(re, im, sign, scale)
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
