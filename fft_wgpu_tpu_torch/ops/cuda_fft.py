"""FFT kernels on Hopper: the port's counterpart of ``ops/pallas_fft.py``
for fourteen of its entry points, and one fused pair of them.

* ``fft_batched_split`` / ``fft_batched_c64`` — rows along the last axis,
  planar or complex64 as it lies, ``csrc/rows_fft.cu`` (the compiled pow2
  passes of ``mixed_fft.cuh``, the whole row in shared memory);
* ``fft_axis0_split`` / ``fft_axis0_c64`` — along axis -2 of ``[..., n, m]``
  (a tile of neighbouring columns per block or cluster):
  ``csrc/ax0_fft.cu`` (the compiled pow2 passes of ``mixed_fft.cuh``,
  planar or complex64 as it lies) for pow2 n, ``csrc/ax0_gen_fft.cu`` (the
  mixed-radix passes on each column of the tile) for composite n;
* ``fft_axis3_split`` / ``fft_axis3_c64`` — along axis -3 of
  ``[..., n, Y, Z]``: the same kernels on the free view ``[..., n, Y*Z]``;
* ``fft_rows_transposed_split`` / ``fft_rows_transposed_c64`` — rows with
  the four-step outer twiddle at load (a product of two table roots,
  :func:`_outer_tables`) and a transposed store, planar or complex64 as it
  lies, ``csrc/rows_t_fft.cu`` (the compiled pow2 passes of
  ``mixed_fft.cuh``, a cluster's rows stored together); ``fft2_split`` is
  that kernel twice;
* ``fft2_fused_split`` / ``fft2_fused_c64`` — both trailing axes of
  ``[..., A, B]`` planes in one pass over device memory, planar or
  complex64 as it lies, ``csrc/fft2f_fft.cu`` (a cluster per plane on the
  compiled pow2 passes of ``mixed_fft.cuh``);
* ``rfft_rows_split`` / ``rfft_rows_c64`` / ``irfft_rows_split`` /
  ``irfft_rows_c64`` — R2C (into planes or complex64) and C2R rows (from
  planes or complex64) through a half-length complex FFT on the compiled
  pow2 passes of ``mixed_fft.cuh``, ``csrc/r2c_fft.cu`` and
  ``csrc/c2r_fft.cu`` (the half spectrum staged once in shared memory);
* ``fft_rows_general_split`` / ``rfft_rows_general_split`` — C2C and R2C
  rows of composite non-pow2 length n = n1*n2 (factors <= 256) as
  mixed-radix Stockham passes in one pass over device memory
  (``csrc/mixed_fft.cuh``), ``csrc/gen_fft.cu`` and ``csrc/r2c_gen_fft.cu``;
* ``fft_chirp_forward_split`` / ``fft_chirp_inverse_split`` — the two
  m-point passes of Bluestein and the chirp-z transform, with the chirp
  multiplies at load and store, and ``fft_chirp_full_split``, both passes
  in one kernel (the route of Bluestein and the chirp-z transforms),
  ``csrc/chirp_fft.cu`` on the mixed-radix passes of ``mixed_fft.cuh``;
* ``fft_filtered_split`` / ``fft_filtered_c64`` / ``fft_bank_split`` —
  rows with a filter multiply at load: every row times one filter (planar,
  or complex64 as it lies), or one signal times every row of a filter bank
  (the same kernel with the strides swapped), ``csrc/filt_fft.cu`` on the
  compiled pow2 passes of ``mixed_fft.cuh``;
* ``irfft_prod_rows_split`` — C2R of the product of two half spectra
  staged once in shared memory, ``csrc/c2r_fft.cu``'s second kernel (on
  the compiled pow2 passes of ``mixed_fft.cuh``).

A CUDA tensor goes through the hand-written kernel, a CPU tensor through
its plain version (``*_reference``).  There is no fallback between the two:
an in-envelope call on a CUDA tensor launches the kernel or raises.  Each
entry point is a ``torch.autograd.Function`` whose backward is a kernel
too, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..core import twiddle as _tw
from ..core.twiddle import FORWARD, INVERSE
from ..utils import build
from . import stockham

__all__ = ["Unsupported", "FUSED_MIN_N", "FUSED_MAX_N", "FFT2F_MAX_ELEMS",
           "GEN_MIN_N", "GEN_MAX_FACTOR",
           "fft_batched_split", "fft_batched_split_reference", "fft_batched_c64",
           "fft_batched_c64_reference",
           "fft_axis0_split", "fft_axis0_split_reference", "fft_axis0_c64",
           "fft_axis0_c64_reference", "fft_axis3_split", "fft_axis3_split_reference",
           "fft_axis3_c64", "fft_axis3_c64_reference", "fft_rows_transposed_split",
           "fft_rows_transposed_split_reference", "fft_rows_transposed_c64",
           "fft_rows_transposed_c64_reference", "fft2_fused_split",
           "fft2_fused_split_reference", "fft2_fused_c64", "fft2_fused_c64_reference",
           "fft2_split", "pad_bins",
           "rfft_rows_split", "rfft_rows_split_reference", "rfft_rows_c64",
           "rfft_rows_c64_reference", "irfft_rows_split",
           "irfft_rows_split_reference", "irfft_rows_c64", "irfft_rows_c64_reference", "fft_rows_general_split",
           "fft_rows_general_split_reference", "rfft_rows_general_split",
           "rfft_rows_general_split_reference", "fft_chirp_forward_split",
           "fft_chirp_forward_split_reference", "fft_chirp_inverse_split",
           "fft_chirp_inverse_split_reference", "fft_chirp_full_split",
           "fft_chirp_full_split_reference", "fft_filtered_split",
           "fft_filtered_split_reference", "fft_filtered_c64",
           "fft_filtered_c64_reference", "fft_bank_split",
           "fft_bank_split_reference", "irfft_prod_rows_split",
           "irfft_prod_rows_split_reference"]

FUSED_MIN_N = 128
FUSED_MAX_N = 16384
FFT2F_MAX_ELEMS = 1 << 16  # points of one fused 2-D plane (the JAX envelope)

# Launches of each entry point's kernel (rows_fft, ax0_fft, ax0_gen_fft,
# either of those on the axis(-3) view, rows_t_fft, fft2f_fft, r2c_fft,
# c2r_fft and its product form, gen_fft, r2c_gen_fft, chirp_fft's three
# kernels and filt_fft's two); callers may reset them to 0.  ``launches``
# counts every launch of rows_fft, ``c64_launches`` those of them through its
# complex64 entry (fft_batched_c64); so do ``ax0_launches`` and
# ``ax0_c64_launches`` for ax0_fft on axis -2, ``ax3_launches`` and
# ``ax3_c64_launches`` on the axis(-3) view, ``rows_t_launches`` and
# ``rows_t_c64_launches`` for rows_t_fft, ``fft2f_launches`` and
# ``fft2f_c64_launches`` for fft2f_fft, ``r2c_launches`` and
# ``r2c_c64_launches`` for r2c_fft, ``c2r_launches`` and
# ``c2r_c64_launches`` for c2r_fft's C2R (not its product form), and
# ``filt_launches`` and ``filt_c64_launches`` for filt_fft's filtered rows.
launches = 0
c64_launches = 0
ax0_launches = 0
ax0_c64_launches = 0
ax0_gen_launches = 0
ax3_launches = 0
ax3_c64_launches = 0
rows_t_launches = 0
rows_t_c64_launches = 0
fft2f_launches = 0
fft2f_c64_launches = 0
r2c_launches = 0
r2c_c64_launches = 0
c2r_launches = 0
c2r_c64_launches = 0
gen_launches = 0
r2c_gen_launches = 0
chirp_fwd_launches = 0
chirp_inv_launches = 0
chirp_full_launches = 0
filt_launches = 0
filt_c64_launches = 0
bank_launches = 0
c2r_prod_launches = 0

# Device copies of the f64-generated (n, sign) tables, [rows, 2] float32,
# and of the outer twiddle's (hi, lo, S) (_outer_tables).
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
    """Run the rows_fft kernel on CUDA planes; ``out`` may alias the input."""
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
    tw = _twiddle_table(n, sign, re.device, _pass_roots_np)
    build.launch("rows_fft", "rows_fft_f32", [_P, _P, _P, _P, _P, _LL, _I, _I, _F, _P],
                 re.device, re.data_ptr(), im.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), tw.data_ptr(), rows, n.bit_length() - 1, sign,
                 _scale_arg(scale), _stream(re),
                 what=f"rows_fft launch failed (n={n}, rows={rows})")
    launches += 1
    return out


def _launch_c64(x, sign, scale, out=None):
    """Run the rows_fft kernel on a CUDA complex64 tensor, its interleaved
    entry; ``out`` (contiguous, of x's shape) may be x itself, since a
    block reads its whole row before it stores any of it."""
    global launches, c64_launches
    n = x.shape[-1]
    x = x.resolve_conj().contiguous()
    if out is None:
        out = torch.empty_like(x)
    rows = x.numel() // n
    if rows == 0:
        return out
    tw = _twiddle_table(n, sign, x.device, _pass_roots_np)
    build.launch("rows_fft", "rows_fft_c64", [_P, _P, _P, _LL, _I, _I, _F, _P], x.device,
                 x.data_ptr(), out.data_ptr(), tw.data_ptr(), rows, n.bit_length() - 1,
                 sign, _scale_arg(scale), _stream(x),
                 what=f"rows_fft launch failed (n={n}, rows={rows})")
    launches += 1
    c64_launches += 1
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


def _transform_c64(x, sign, scale):
    if x.device.type == "cuda":
        return _launch_c64(x, sign, scale)
    if x.device.type != "cpu":
        raise ValueError(f"no row FFT for device {x.device}")
    return fft_batched_c64_reference(x, sign, scale)


class _SignFlipped(torch.autograd.Function):
    """``transform(*xs, sign, scale)``, a DFT along one axis of planes
    ``(re, im)`` or of one complex64 tensor, with its adjoint.  The transform
    is M = scale * W_sign with W symmetric and conj(W_s) = W_-s, so its
    adjoint is scale * W_-sign: the same transform (the same kernel, on the
    card) with the sign flipped and the same scale (torch's gradient of a
    complex input is the adjoint applied to the output's)."""

    @staticmethod
    def forward(ctx, transform, sign, scale, *xs):
        ctx.transform, ctx.sign, ctx.scale = transform, sign, scale
        return transform(*xs, sign, scale)

    @staticmethod
    def backward(ctx, *grads):
        g = ctx.transform(*grads, -ctx.sign, ctx.scale)
        return (None, None, None, *(g if isinstance(g, tuple) else (g,)))


def _check_c64(x):
    if not isinstance(x, torch.Tensor) or x.dtype != torch.complex64 or x.ndim < 1:
        raise ValueError("x must be a complex64 tensor of at least one axis")


def fft_batched_c64(x, sign, scale=None):
    """:func:`fft_batched_split` on a complex64 ``[..., n]`` tensor as it
    lies (interleaved (re, im) pairs; a non-contiguous one is copied
    first), with no split and no merge: on the card the kernel's
    interleaved entry, one launch.  Differentiable (the backward is the
    sign-flipped transform)."""
    _check_c64(x)
    _check_envelope(x.shape[-1])
    _check_sign(sign)
    return _SignFlipped.apply(_transform_c64, sign, scale, x)


def fft_batched_c64_reference(x, sign, scale=None):
    """Plain torch version of :func:`fft_batched_c64`: the plain version of
    the planar entry on the two planes."""
    _check_c64(x)
    return torch.complex(*fft_batched_split_reference(x.real, x.imag, sign, scale))


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
        return _SignFlipped.apply(_transform, sign, scale, re, im)
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


def _rows_passes(re, im, sign, scale=None):
    """Plain torch version of the rows_fft kernel's own passes: n's
    compiled plan (:func:`_fixed_passes` on :func:`_pass_roots_np`'s
    table), then the scale.  No CUDA path calls it."""
    n = re.shape[-1]
    tab = _twiddle_table(n, sign, re.device, _pass_roots_np)
    z = _fixed_passes(torch.complex(re, im), sign, torch.complex(tab[:, 0], tab[:, 1]),
                      _mixed_radix_plan(n))
    return stockham.apply_scale(z.real.contiguous(), z.imag.contiguous(), scale)


# ---------------------------------------------------------------------- #
# axis -2 of [..., n, m] (pallas_fft.fft_axis0_split)
# ---------------------------------------------------------------------- #
def _ax0_supported(n: int) -> bool:
    """Axis(-2) kernel envelope, the JAX kernel's: pow2 n in 128..16384
    (``ax0_fft``), or composite n in 512..16384 with a split of factors
    <= 256 (``ax0_gen_fft``)."""
    if _supported(n):
        return True
    return GEN_MIN_N <= n <= FUSED_MAX_N and _choose_general_split(n) is not None


# log2 of the blocks of the pow2 axis(-2) kernel's clusters for n = 2^7 ..
# 2^14, planar and complex64: ax0_log2c of csrc/ax0_fft.cu (tests hold the
# two equal).  A block transforms n / 2^log2c points of each of its columns,
# and the host builds that length's pass twiddles.
_AX0_LOG2C = {False: (0, 0, 0, 0, 0, 2, 3, 4), True: (0, 0, 0, 0, 0, 0, 2, 3)}


def _ax0_log2c(n: int, c64: bool) -> int:
    return _AX0_LOG2C[bool(c64)][n.bit_length() - 8]


def _check_ax0(re) -> None:
    if re.ndim < 2:
        raise ValueError(f"axis(-2) FFT needs [..., n, m], got shape {tuple(re.shape)}")
    n = re.shape[-2]
    if not _ax0_supported(n):
        raise Unsupported(f"n={n} outside the axis(-2) kernel envelope (pow2 "
                          f"{FUSED_MIN_N}..{FUSED_MAX_N}, or composite "
                          f"{GEN_MIN_N}..{FUSED_MAX_N} with factors <= {GEN_MAX_FACTOR})")


def _ax0_kernel(re, im, sign, scale, out=None):
    """Run the axis(-2) kernel of n on CUDA tensors (``ax0_fft`` for pow2
    n, ``ax0_gen_fft`` for composite n, on the passes of
    :func:`_mixed_radix_plan`); returns the output planes and whether it
    launched (an empty input launches nothing).  ``out`` (contiguous planes
    of the input's shape) may be the input planes themselves: both kernels
    read a tile whole before they store any of it."""
    n, m = re.shape[-2:]
    re, im = re.contiguous(), im.contiguous()
    if out is None:
        out = (torch.empty_like(re), torch.empty_like(im))
    if re.numel() == 0:
        return out, False
    planes = re.numel() // (n * m)
    what = f"launch failed (n={n}, m={m}, planes={planes})"
    if _supported(n):
        build.launch("ax0_fft", "ax0_fft_f32",
                     [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _F, _P], re.device,
                     re.data_ptr(), im.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                     *_ax0_tables(n, sign, False, re.device), planes, m,
                     n.bit_length() - 1, _ax0_log2c(n, False), sign, _scale_arg(scale),
                     _stream(re), what=f"ax0_fft {what}")
    else:
        plan = _mixed_radix_plan(n)
        build.launch("ax0_gen_fft", "ax0_gen_fft_f32",
                     [_P, _P, _P, _P, _P, _LL, _LL, _I, _P, _I, _I, _F, _P],
                     re.device, re.data_ptr(), im.data_ptr(), out[0].data_ptr(),
                     out[1].data_ptr(), _twiddle_table(n, sign, re.device).data_ptr(),
                     planes, m, n, ctypes.cast(_radix_arg(plan), _P), len(plan),
                     sign, _scale_arg(scale), _stream(re),
                     what=f"ax0_gen_fft {what}")
    return out, True


def _ax0_tables(n: int, sign: int, c64: bool, device):
    """The pow2 axis(-2) kernel's two twiddle tables, as pointers: the n-th
    roots (its clusters' butterfly) and the pass roots of the length each
    block transforms, n / 2^_ax0_log2c(n, c64)."""
    q = n >> _ax0_log2c(n, c64)
    return (_twiddle_table(n, sign, device).data_ptr(),
            _twiddle_table(q, sign, device, _pass_roots_np).data_ptr())


def _ax0_c64_kernel(x, sign, scale, out=None):
    """Run ax0_fft's complex64 entry on a CUDA ``[..., n, m]`` tensor, pow2
    n; ``out`` (contiguous, of x's shape) may be x itself.  Returns the
    output and whether it launched (an empty input launches nothing)."""
    n, m = x.shape[-2:]
    x = x.resolve_conj().contiguous()
    if out is None:
        out = torch.empty_like(x)
    if x.numel() == 0:
        return out, False
    planes = x.numel() // (n * m)
    build.launch("ax0_fft", "ax0_fft_c64", [_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _F, _P],
                 x.device, x.data_ptr(), out.data_ptr(), *_ax0_tables(n, sign, True, x.device),
                 planes, m, n.bit_length() - 1, _ax0_log2c(n, True), sign, _scale_arg(scale),
                 _stream(x), what=f"ax0_fft launch failed (n={n}, m={m}, planes={planes})")
    return out, True


def _ax0_launch_c64(x, sign, scale, out=None):
    """ax0_fft's complex64 entry on axis -2 of a CUDA tensor, counted as
    ``ax0_fft`` and ``ax0_fft`` complex64; ``out`` may be x."""
    global ax0_launches, ax0_c64_launches
    out, launched = _ax0_c64_kernel(x, sign, scale, out)
    ax0_launches += launched
    ax0_c64_launches += launched
    return out


def _ax0_launch(re, im, sign, scale, out=None):
    """The axis(-2) kernel on axis -2 of CUDA tensors, counted as
    ``ax0_fft`` (pow2 n) or ``ax0_gen_fft`` (composite n); ``out`` may be
    the input planes."""
    global ax0_launches, ax0_gen_launches
    out, launched = _ax0_kernel(re, im, sign, scale, out)
    if _supported(re.shape[-2]):
        ax0_launches += launched
    else:
        ax0_gen_launches += launched
    return out


def _ax0(re, im, sign, scale, out=None):
    if re.device.type == "cuda":
        return _ax0_launch(re, im, sign, scale, out)
    if re.device.type != "cpu":
        raise ValueError(f"no axis(-2) FFT for device {re.device}")
    yr, yi = fft_axis0_split_reference(re, im, sign, scale)
    if out is None:
        return yr, yi
    out[0].copy_(yr)
    out[1].copy_(yi)
    return out


def fft_axis0_split(re, im, sign, scale=None, *, out=None):
    """Batched FFT along axis -2 of planar float32 ``[..., n, m]`` tensors
    (the m columns are the batch), with no transpose in memory; n pow2 in
    128..16384, or composite in 512..16384 with factors <= 256.

    sign: -1 forward / +1 inverse; scale folded into the store.
    Differentiable (the backward is the sign-flipped transform).  With
    ``out=(out_re, out_im)`` (contiguous planes of the input's shape) the
    result is written there, which may be the inputs themselves (in place);
    that form records no autograd history."""
    _check_ax0(re)
    _check_sign(sign)
    _check_planes(re, im)
    if out is None:
        return _SignFlipped.apply(_ax0, sign, scale, re, im)
    if torch.is_grad_enabled() and (re.requires_grad or im.requires_grad):
        raise ValueError("out= writes in place and records no gradient; "
                         "call without out= to differentiate")
    if not all(o.is_contiguous() and o.dtype == torch.float32 and o.shape == re.shape
               and o.device == re.device for o in out):
        raise ValueError("out planes must be contiguous float32 tensors of the "
                         "input's shape and device")
    return _ax0(re, im, sign, scale, out)


def _axis_plain(re, im, sign, scale, axis):
    """The plain transform along ``axis``, moved to the back: the
    mixed-radix path for pow2 n, the JAX kernel's two-factor math
    (:func:`_two_factor`) for composite n; plus the scale."""
    n = re.shape[axis]
    r, i = re.movedim(axis, -1), im.movedim(axis, -1)
    if _supported(n):
        yr, yi = stockham.apply_scale(*stockham.fft_last_axis(r, i, sign), scale)
    else:
        yr, yi = _two_factor(r, i, sign, scale)
    return yr.movedim(-1, axis), yi.movedim(-1, axis)


def fft_axis0_split_reference(re, im, sign, scale=None):
    """Plain torch version of :func:`fft_axis0_split`: the plain transform
    on axis -2 moved to the back (:func:`_axis_plain`).  Raises
    :class:`Unsupported` for the same n as the kernel."""
    _check_ax0(re)
    return _axis_plain(re, im, sign, scale, -2)


def _check_pow2_axis(x, axis: int, what: str) -> None:
    _check_c64(x)
    if x.ndim < -axis:
        raise ValueError(f"{what} FFT needs at least {-axis} axes, got shape "
                         f"{tuple(x.shape)}")
    n = x.shape[axis]
    if not _supported(n):
        raise Unsupported(f"n={n} outside the complex64 {what} kernel envelope (pow2 "
                          f"{FUSED_MIN_N}..{FUSED_MAX_N})")


def _ax0_c64(x, sign, scale):
    if x.device.type == "cuda":
        return _ax0_launch_c64(x, sign, scale)
    if x.device.type != "cpu":
        raise ValueError(f"no axis(-2) FFT for device {x.device}")
    return fft_axis0_c64_reference(x, sign, scale)


def fft_axis0_c64(x, sign, scale=None):
    """:func:`fft_axis0_split` on a complex64 ``[..., n, m]`` tensor as it
    lies (interleaved (re, im) pairs; a non-contiguous one is copied first),
    pow2 n in 128..16384, with no split and no merge: on the card the
    kernel's interleaved entry, one launch.  Differentiable (the backward is
    the sign-flipped transform)."""
    _check_pow2_axis(x, -2, "axis(-2)")
    _check_sign(sign)
    return _SignFlipped.apply(_ax0_c64, sign, scale, x)


def fft_axis0_c64_reference(x, sign, scale=None):
    """Plain torch version of :func:`fft_axis0_c64`: the plain version of
    the planar entry on the two planes."""
    _check_pow2_axis(x, -2, "axis(-2)")
    return torch.complex(*fft_axis0_split_reference(x.real, x.imag, sign, scale))


def _mixed_radix_axis(re, im, sign, scale, axis=-2):
    """Plain torch version of the ax0_gen_fft kernel: the mixed-radix
    passes of composite n (:func:`_mixed_radix`) along ``axis`` moved to
    the back.  No CUDA path calls it."""
    yr, yi = _mixed_radix(re.movedim(axis, -1), im.movedim(axis, -1), sign, scale)
    return yr.movedim(-1, axis), yi.movedim(-1, axis)


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
    outer_n-th roots at the integer-reduced index: (re, im) ``[rows, n]``.
    The JAX package's contract; the kernel and its plain version form the
    same roots as products (:func:`_outer_plane_two_level`)."""
    tab = _twiddle_table(outer_n, sign, device)
    r = torch.arange(rows, device=device, dtype=torch.int64)
    m = torch.arange(n, device=device, dtype=torch.int64)
    w = tab[(r[:, None] * m[None, :]) % outer_n]
    return w[..., 0], w[..., 1]


_OUTER_MAX_LO_BITS = 12  # kMaxLoBits of csrc/rows_t_fft.cu


def _outer_lo_bits(outer_n: int) -> int:
    """S of the two-level outer twiddle: ceil(log2(outer_n) / 2), at most 12."""
    return min((max(outer_n - 1, 0).bit_length() + 1) // 2, _OUTER_MAX_LO_BITS)


def _outer_roots_np(outer_n: int, sign: int):
    """The two tables of w = exp(sign*2pi*i/outer_n), float32 of float64, as
    one ``(cos, sin)`` pair: hi[q] = w^(q*2^S) for q < ceil(outer_n / 2^S),
    then lo[t] = w^t for t < 2^S (S = :func:`_outer_lo_bits`), each angle
    reduced mod outer_n in integers."""
    S = _outer_lo_bits(outer_n)
    hi = np.arange(-(-outer_n >> S), dtype=np.int64) << S
    e = np.concatenate([hi % outer_n, np.arange(1 << S, dtype=np.int64) % outer_n])
    theta = (sign * 2.0 * np.pi / outer_n) * e.astype(np.float64)
    return np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32)


def _outer_tables(outer_n: int, sign: int, device):
    """(hi, lo, S): the two-level outer twiddle's tables on ``device`` as
    interleaved (cos, sin) float32 pairs ``[entries, 2]``, cached (the
    four-step calls this once a transform)."""
    key = ("outer", outer_n, sign, str(device))
    tables = _TWIDDLES.get(key)
    if tables is None:
        tab = _twiddle_table(outer_n, sign, device, table=_outer_roots_np)
        S = _outer_lo_bits(outer_n)
        nhi = -(-outer_n >> S)
        tables = _TWIDDLES[key] = (tab[:nhi], tab[nhi:], S)
    return tables


def _outer_plane_two_level(rows: int, n: int, outer_n: int, sign: int, device):
    """The outer twiddle plane as the rows_t_fft kernel forms it: w^e for
    e = (r*m) mod outer_n as the product hi[e >> S] * lo[e & (2^S - 1)] of
    two float32 roots (:func:`_outer_tables`), r < rows, m < n: (re, im)
    ``[rows, n]``.  Within about 1.2e-7 of :func:`_outer_plane`."""
    hi, lo, S = _outer_tables(outer_n, sign, device)
    r = torch.arange(rows, device=device, dtype=torch.int64)
    m = torch.arange(n, device=device, dtype=torch.int64)
    e = (r[:, None] * m[None, :]) % outer_n
    h, l_ = hi[e >> S], lo[e & ((1 << S) - 1)]
    wr = h[..., 0] * l_[..., 0] - h[..., 1] * l_[..., 1]
    wi = h[..., 0] * l_[..., 1] + h[..., 1] * l_[..., 0]
    return wr, wi


def _rows_t_tables(n: int, sign: int, outer, device):
    """The rows_t_fft kernel's tables as pointers and numbers: n's pass
    roots (:func:`_pass_roots_np`), then the outer twiddle's (hi, lo,
    outer_n, S), or nulls and zeros without one."""
    tw = _twiddle_table(n, sign, device, _pass_roots_np).data_ptr()
    if outer is None:
        return tw, None, None, 0, 0
    outer_n = int(outer[1])
    hi, lo, S = _outer_tables(outer_n, sign, device)
    return tw, hi.data_ptr(), lo.data_ptr(), outer_n, S


def _aligned16(t):
    """``t`` contiguous, copied where its data does not start on 16 bytes
    (the rows_t_fft kernel stages its rows 16 bytes a copy)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _rows_t_launch(re, im, sign, scale, outer):
    """Run the rows_t_fft kernel on CUDA tensors: [..., R, n] -> [..., n, R]."""
    global rows_t_launches
    rows, n = re.shape[-2:]
    re, im = _aligned16(re), _aligned16(im)
    shape = (*re.shape[:-2], n, rows)
    out = (re.new_empty(shape), im.new_empty(shape))
    if re.numel() == 0:
        return out
    planes = re.numel() // (rows * n)
    build.launch("rows_t_fft", "rows_t_fft_f32",
                 [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _LL, _LL, _I, _I, _F, _P],
                 re.device, re.data_ptr(), im.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), *_rows_t_tables(n, sign, outer, re.device), planes, rows,
                 n.bit_length() - 1, sign, _scale_arg(scale), _stream(re),
                 what=f"rows_t_fft launch failed (n={n}, rows={rows}, planes={planes}, "
                      f"outer={outer})")
    rows_t_launches += 1
    return out


def _rows_t_launch_c64(x, sign, scale, outer):
    """Run rows_t_fft's complex64 entry on a CUDA ``[..., R, n]`` tensor ->
    complex64 ``[..., n, R]``, counted as ``rows_t_fft`` and ``rows_t_fft``
    complex64."""
    global rows_t_launches, rows_t_c64_launches
    rows, n = x.shape[-2:]
    x = _aligned16(x.resolve_conj())
    out = x.new_empty((*x.shape[:-2], n, rows))
    if x.numel() == 0:
        return out
    planes = x.numel() // (rows * n)
    build.launch("rows_t_fft", "rows_t_fft_c64",
                 [_P, _P, _P, _P, _P, _LL, _I, _LL, _LL, _I, _I, _F, _P], x.device,
                 x.data_ptr(), out.data_ptr(), *_rows_t_tables(n, sign, outer, x.device),
                 planes, rows, n.bit_length() - 1, sign, _scale_arg(scale), _stream(x),
                 what=f"rows_t_fft launch failed (n={n}, rows={rows}, planes={planes}, "
                      f"outer={outer})")
    rows_t_launches += 1
    rows_t_c64_launches += 1
    return out


def _rows_t(re, im, sign, scale, outer):
    if re.device.type == "cuda":
        return _rows_t_launch(re, im, sign, scale, outer)
    if re.device.type != "cpu":
        raise ValueError(f"no transposed row FFT for device {re.device}")
    return fft_rows_transposed_split_reference(re, im, sign, scale, outer=outer)


def _rows_t_c64(x, sign, scale, outer):
    if x.device.type == "cuda":
        return _rows_t_launch_c64(x, sign, scale, outer)
    if x.device.type != "cpu":
        raise ValueError(f"no transposed row FFT for device {x.device}")
    return fft_rows_transposed_c64_reference(x, sign, scale, outer=outer)


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
            twr, twi = _outer_plane_two_level(rows, n, int(ctx.outer[1]), -ctx.sign,
                                              gr.device)
            gr, gi = gr * twr - gi * twi, gr * twi + gi * twr
        return gr, gi, None, None, None


class _RowsTFFTC64(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sign, scale, outer):
        ctx.sign, ctx.scale, ctx.outer = sign, scale, outer
        return _rows_t_c64(x, sign, scale, outer)

    @staticmethod
    def backward(ctx, g):
        # as _RowsTFFT's: back through the transpose, the row kernel's
        # complex64 entry with the sign flipped, then the conjugate twiddle
        g = _transform_c64(g.transpose(-1, -2).contiguous(), -ctx.sign, ctx.scale)
        if ctx.outer is not None:
            rows, n = g.shape[-2:]
            g = g * torch.complex(*_outer_plane_two_level(rows, n, int(ctx.outer[1]),
                                                          -ctx.sign, g.device))
        return g, None, None, None


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
    """Plain torch version of :func:`fft_rows_transposed_split`, the
    kernel's arithmetic: the twiddle plane as the kernel forms it
    (:func:`_outer_plane_two_level`), n's compiled plan on its pass roots
    (:func:`_rows_passes`), the scale, then the transpose.  Raises
    :class:`Unsupported` for the same n as the kernel."""
    _check_rows_t(re, outer)
    if outer is not None:
        twr, twi = _outer_plane_two_level(re.shape[-2], re.shape[-1], int(outer[1]),
                                          sign, re.device)
        re, im = re * twr - im * twi, re * twi + im * twr
    yr, yi = _rows_passes(re, im, sign, scale)
    return yr.transpose(-1, -2), yi.transpose(-1, -2)


def fft_rows_transposed_c64(x, sign, scale=None, *, outer=None):
    """:func:`fft_rows_transposed_split` on a complex64 ``[..., R, n]``
    tensor as it lies (interleaved (re, im) pairs; a non-contiguous one is
    copied first) -> complex64 ``[..., n, R]``, with no split and no merge:
    on the card the kernel's interleaved entry, one launch.  Differentiable:
    the backward runs the row kernel's complex64 entry with the sign flipped
    and the conjugate twiddle."""
    _check_c64(x)
    _check_rows_t(x, outer)
    _check_sign(sign)
    return _RowsTFFTC64.apply(x, sign, scale, outer)


def fft_rows_transposed_c64_reference(x, sign, scale=None, *, outer=None):
    """Plain torch version of :func:`fft_rows_transposed_c64`: the plain
    version of the planar entry on the two planes."""
    _check_c64(x)
    return torch.complex(*fft_rows_transposed_split_reference(x.real, x.imag, sign, scale,
                                                               outer=outer))


# ---------------------------------------------------------------------- #
# axis -3 of [..., n, Y, Z] (pallas_fft.fft_axis3_split)
# ---------------------------------------------------------------------- #
def _check_ax3(re) -> None:
    if re.ndim < 3:
        raise ValueError(f"axis(-3) FFT needs [..., n, Y, Z], got shape "
                         f"{tuple(re.shape)}")
    n = re.shape[-3]
    # the axis(-2) kernels' envelope, composite n too; the JAX kernel takes
    # pow2 n only and needs Y % 8 == 0 and Z % 128 == 0 (its VMEM tiling),
    # here Y and Z are free
    if not _ax0_supported(n):
        raise Unsupported(f"n={n} outside the axis(-3) kernel envelope (that "
                          f"of the axis(-2) kernels)")


def _ax3_launch(re, im, sign, scale):
    """Axis -3 of contiguous ``[..., n, Y, Z]`` is axis -2 of the free view
    ``[..., n, Y*Z]``: run the axis(-2) kernel of n there, counted as
    axis(-3)."""
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
    return _SignFlipped.apply(_ax3, sign, scale, re, im)


def fft_axis3_split_reference(re, im, sign, scale=None):
    """Plain torch version of :func:`fft_axis3_split`: the plain transform
    on axis -3 moved to the back (:func:`_axis_plain`).  Raises
    :class:`Unsupported` for the same n as the kernel."""
    _check_ax3(re)
    return _axis_plain(re, im, sign, scale, -3)


def _ax3_launch_c64(x, sign, scale):
    """ax0_fft's complex64 entry on the free view ``[..., n, Y*Z]`` of a
    contiguous CUDA ``[..., n, Y, Z]``, counted as axis(-3) and axis(-3)
    complex64."""
    global ax3_launches, ax3_c64_launches
    shape = x.shape
    x = x.resolve_conj().contiguous()
    y, launched = _ax0_c64_kernel(x.view(*shape[:-2], shape[-2] * shape[-1]), sign, scale)
    ax3_launches += launched
    ax3_c64_launches += launched
    return y.view(shape)


def _ax3_c64(x, sign, scale):
    if x.device.type == "cuda":
        return _ax3_launch_c64(x, sign, scale)
    if x.device.type != "cpu":
        raise ValueError(f"no axis(-3) FFT for device {x.device}")
    return fft_axis3_c64_reference(x, sign, scale)


def fft_axis3_c64(x, sign, scale=None):
    """:func:`fft_axis3_split` on a complex64 ``[..., n, Y, Z]`` tensor as it
    lies, pow2 n in 128..16384: on the card the axis(-2) kernel's
    interleaved entry on the free view ``[..., n, Y*Z]``, one launch, no
    split and no merge.  Differentiable (the backward is the sign-flipped
    transform)."""
    _check_pow2_axis(x, -3, "axis(-3)")
    _check_sign(sign)
    return _SignFlipped.apply(_ax3_c64, sign, scale, x)


def fft_axis3_c64_reference(x, sign, scale=None):
    """Plain torch version of :func:`fft_axis3_c64`: the plain version of
    the planar entry on the two planes."""
    _check_pow2_axis(x, -3, "axis(-3)")
    return torch.complex(*fft_axis3_split_reference(x.real, x.imag, sign, scale))


def fft_c64_along(x, axis: int, sign, scale=None):
    """The complex64 kernels' transform of ``x`` along ``axis`` (pow2 length
    in 128..16384): the row kernel's interleaved entry for the last axis,
    the axis(-2) kernel's for axis -2, and that kernel on the free view
    ``[..., n, mid, Z]`` for an axis before it (the axes between merged
    into mid).  Differentiable."""
    ax = axis % x.ndim
    if ax == x.ndim - 1:
        return fft_batched_c64(x, sign, scale)
    if ax == x.ndim - 2:
        return fft_axis0_c64(x, sign, scale)
    shape = x.shape
    view = (*shape[:ax + 1], math.prod(shape[ax + 1:-1]), shape[-1])
    return fft_axis3_c64(x.reshape(view), sign, scale).reshape(shape)


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


# log2 of the points a block of the fused-plane kernel holds: a plane is a
# cluster of A*B >> _FFT2F_LOG2P blocks (kFft2fLog2P of csrc/fft2f_fft.cu;
# tests hold the two equal).
_FFT2F_LOG2P = 12


def _fft2f_args(A: int, B: int, planes: int, sign: int, scale, device):
    """The fused-plane kernel's C arguments after the data pointers: the
    pass roots of A and of B, the planes, the shape and the cluster."""
    la, lb = A.bit_length() - 1, B.bit_length() - 1
    return (_twiddle_table(A, sign, device, _pass_roots_np).data_ptr(),
            _twiddle_table(B, sign, device, _pass_roots_np).data_ptr(), planes, la, lb,
            la + lb - _FFT2F_LOG2P, sign, _scale_arg(scale))


_FFT2F_TAIL = [_P, _P, _LL, _I, _I, _I, _I, _F, _P]


def _fft2f_launch(re, im, sign, scale):
    """Run the fft2f_fft kernel's planar entry on CUDA tensors."""
    global fft2f_launches
    A, B = re.shape[-2:]
    re, im = re.contiguous(), im.contiguous()
    out = (torch.empty_like(re), torch.empty_like(im))
    if re.numel() == 0:
        return out
    planes = re.numel() // (A * B)
    build.launch("fft2f_fft", "fft2f_fft_f32", [_P, _P, _P, _P] + _FFT2F_TAIL, re.device,
                 re.data_ptr(), im.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                 *_fft2f_args(A, B, planes, sign, scale, re.device), _stream(re),
                 what=f"fft2f_fft launch failed (plane {A}x{B}, planes={planes})")
    fft2f_launches += 1
    return out


def _fft2f_launch_c64(x, sign, scale, out=None):
    """Run the fft2f_fft kernel's complex64 entry on a CUDA tensor; ``out``
    (contiguous, of x's shape) may be x itself: a cluster reads its plane
    whole before it stores any of it."""
    global fft2f_launches, fft2f_c64_launches
    A, B = x.shape[-2:]
    x = x.resolve_conj().contiguous()
    if out is None:
        out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    planes = x.numel() // (A * B)
    build.launch("fft2f_fft", "fft2f_fft_c64", [_P, _P] + _FFT2F_TAIL, x.device,
                 x.data_ptr(), out.data_ptr(), *_fft2f_args(A, B, planes, sign, scale, x.device),
                 _stream(x), what=f"fft2f_fft launch failed (plane {A}x{B}, planes={planes})")
    fft2f_launches += 1
    fft2f_c64_launches += 1
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
    return _SignFlipped.apply(_fft2f, sign, scale, re, im)


def fft2_fused_split_reference(re, im, sign, scale=None):
    """Plain torch version of :func:`fft2_fused_split`: the mixed-radix path
    over B, then over A, plus the scale.  Raises :class:`Unsupported` for
    the same planes as the kernel."""
    _check_fft2f(re)
    yr, yi = stockham.fft_last_axis(re, im, sign)
    yr, yi = stockham.fft_last_axis(yr.transpose(-1, -2), yi.transpose(-1, -2), sign)
    yr, yi = stockham.apply_scale(yr, yi, scale)
    return yr.transpose(-1, -2), yi.transpose(-1, -2)


def _fft2f_c64(x, sign, scale):
    if x.device.type == "cuda":
        return _fft2f_launch_c64(x, sign, scale)
    if x.device.type != "cpu":
        raise ValueError(f"no fused 2-D FFT for device {x.device}")
    return fft2_fused_c64_reference(x, sign, scale)


def fft2_fused_c64(x, sign, scale=None):
    """:func:`fft2_fused_split` on a complex64 ``[..., A, B]`` tensor as it
    lies (interleaved (re, im) pairs; a non-contiguous one is copied
    first), with no split and no merge: on the card the kernel's
    interleaved entry, one launch.  Differentiable (the backward is the
    sign-flipped transform)."""
    _check_c64(x)
    _check_fft2f(x)
    _check_sign(sign)
    return _SignFlipped.apply(_fft2f_c64, sign, scale, x)


def fft2_fused_c64_reference(x, sign, scale=None):
    """Plain torch version of :func:`fft2_fused_c64`: the plain version of
    the planar entry on the two planes."""
    _check_c64(x)
    return torch.complex(*fft2_fused_split_reference(x.real, x.imag, sign, scale))


def _fft2f_passes(x, sign, scale=None):
    """Plain torch version of the fft2f_fft kernel's own passes on a complex
    ``[..., A, B]`` tensor: the fixed passes of :func:`_mixed_radix_plan`(B)
    on every row, then those of A on every column, on the kernel's pass
    roots, the scale last.  No CUDA path calls it."""
    def passes(z, n):
        tab = _twiddle_table(n, sign, z.device, _pass_roots_np)
        return _fixed_passes(z, sign, torch.complex(tab[:, 0], tab[:, 1]),
                             _mixed_radix_plan(n))

    y = passes(passes(x, x.shape[-1]).transpose(-1, -2), x.shape[-2]).transpose(-1, -2)
    return y if scale is None else y * scale


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


@functools.lru_cache(maxsize=None)
def _c2r_keep(m: int, dtype, device) -> torch.Tensor:
    """:func:`_c2r_pack`'s mask of m + 1 bins, 0 at DC and Nyquist and 1
    between, built once per (m, dtype, device): a captured CUDA graph
    (``utils/jit_cache``) reads it, so it is built outside any capture and
    never evicted."""
    keep = torch.ones(m + 1, dtype=dtype)
    keep[0] = keep[m] = 0.0
    return keep.to(device)


def _c2r_pack(Xr, Xi, n):
    """Z[k], k < n/2, whose inverse FFT_{n/2} with 1/(n/2) is the real row
    (numpy's irfft) interleaved as z[j] = x[2j] + i x[2j+1]:
    Z = E + i O, E[k] = (X[k] + conj(X[m-k]))/2,
    O[k] = t[k] (X[k] - conj(X[m-k]))/2, t[k] = exp(+2 pi i k/n).  The
    imaginary parts of the DC and Nyquist bins are ignored, as numpy does."""
    m = n // 2
    Xi = Xi * _c2r_keep(m, Xi.dtype, Xi.device)
    Xr_rev, Xi_rev = Xr.flip(-1), Xi.flip(-1)
    tab = _halfcomplex_table(n, INVERSE, Xr.device)[:m]
    tr, ti = tab[:, 0], tab[:, 1]
    er, ei = 0.5 * (Xr + Xr_rev)[..., :m], 0.5 * (Xi - Xi_rev)[..., :m]
    dr, di = 0.5 * (Xr - Xr_rev)[..., :m], 0.5 * (Xi + Xi_rev)[..., :m]
    or_, oi = tr * dr - ti * di, tr * di + ti * dr
    return er - oi, ei + or_


def _paired(xr):
    """xr contiguous and 8-byte aligned, as the R2C kernel reads each pair
    of real points (x[2j], x[2j+1]) as one 8-byte load."""
    xr = xr.contiguous()
    return xr.clone() if xr.data_ptr() % 8 else xr


def _r2c_tables(n: int, device):
    """The R2C kernel's two tables, as pointers: the pass roots of the
    half length m = n/2 (sign -1) and the recombination's exp(-2 pi i k/n),
    k = 0..m."""
    return (_twiddle_table(n // 2, FORWARD, device, _pass_roots_np).data_ptr(),
            _halfcomplex_table(n, FORWARD, device).data_ptr())


def _r2c_launch(xr, scale, pad_out):
    """Run the r2c_fft kernel's planar sink on a CUDA tensor."""
    global r2c_launches
    n = xr.shape[-1]
    bins = pad_bins(n) if pad_out else n // 2 + 1
    xr = _paired(xr)
    shape = (*xr.shape[:-1], bins)
    out = (xr.new_empty(shape), xr.new_empty(shape))
    if xr.numel() == 0:
        return out
    rows = xr.numel() // n
    build.launch("r2c_fft", "r2c_fft_f32", [_P, _P, _P, _P, _P, _LL, _I, _I, _F, _P],
                 xr.device, xr.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                 *_r2c_tables(n, xr.device), rows, n.bit_length() - 2, bins,
                 _scale_arg(scale), _stream(xr),
                 what=f"r2c_fft launch failed (n={n}, rows={rows})")
    r2c_launches += 1
    return out


def _r2c_launch_c64(xr, scale):
    """Run the r2c_fft kernel's complex64 sink on a CUDA tensor: ``[...,
    n/2 + 1]`` complex64, no merge."""
    global r2c_launches, r2c_c64_launches
    n = xr.shape[-1]
    xr = _paired(xr)
    out = torch.empty((*xr.shape[:-1], n // 2 + 1), dtype=torch.complex64, device=xr.device)
    if xr.numel() == 0:
        return out
    rows = xr.numel() // n
    build.launch("r2c_fft", "r2c_fft_c64", [_P, _P, _P, _P, _LL, _I, _F, _P], xr.device,
                 xr.data_ptr(), out.data_ptr(), *_r2c_tables(n, xr.device), rows,
                 n.bit_length() - 2, _scale_arg(scale), _stream(xr),
                 what=f"r2c_fft launch failed (n={n}, rows={rows})")
    r2c_launches += 1
    r2c_c64_launches += 1
    return out


def _r2c(xr, scale, pad_out):
    if xr.device.type == "cuda":
        return _r2c_launch(xr, scale, pad_out)
    if xr.device.type != "cpu":
        raise ValueError(f"no R2C FFT for device {xr.device}")
    return rfft_rows_split_reference(xr, scale, pad_out=pad_out)


def _c2r_tables(n: int, device):
    """The C2R kernels' two tables, as pointers: the pass roots of the half
    length m = n/2 (sign +1) and the packing's exp(+2 pi i k/n), k = 0..m."""
    return (_twiddle_table(n // 2, INVERSE, device, _pass_roots_np).data_ptr(),
            _halfcomplex_table(n, INVERSE, device).data_ptr())


def _c2r_launch(Xr, Xi, n, scale):
    """Run the c2r_fft kernel's planar source on CUDA tensors (rows of any
    bin count >= n/2 + 1; only bins 0..n/2 are read)."""
    global c2r_launches
    bins = Xr.shape[-1]
    Xr, Xi = Xr.contiguous(), Xi.contiguous()
    out = Xr.new_empty((*Xr.shape[:-1], n))
    if Xr.numel() == 0:
        return out
    rows = Xr.numel() // bins
    build.launch("c2r_fft", "c2r_fft_f32", [_P, _P, _P, _P, _P, _LL, _I, _I, _F, _P],
                 Xr.device, Xr.data_ptr(), Xi.data_ptr(), out.data_ptr(),
                 *_c2r_tables(n, Xr.device), rows, n.bit_length() - 2, bins,
                 _scale_arg(scale), _stream(Xr),
                 what=f"c2r_fft launch failed (n={n}, rows={rows})")
    c2r_launches += 1
    return out


def _c2r_launch_c64(X, n, scale):
    """Run the c2r_fft kernel's complex64 source on a CUDA complex64 tensor
    ``[..., bins]`` as it lies (bins >= n/2 + 1; only bins 0..n/2 are
    read): real float32 ``[..., n]``, no split."""
    global c2r_launches, c2r_c64_launches
    bins = X.shape[-1]
    X = X.resolve_conj().contiguous()
    out = torch.empty((*X.shape[:-1], n), dtype=torch.float32, device=X.device)
    if X.numel() == 0:
        return out
    rows = X.numel() // bins
    build.launch("c2r_fft", "c2r_fft_c64", [_P, _P, _P, _P, _LL, _I, _I, _F, _P], X.device,
                 X.data_ptr(), out.data_ptr(), *_c2r_tables(n, X.device), rows,
                 n.bit_length() - 2, bins, _scale_arg(scale), _stream(X),
                 what=f"c2r_fft launch failed (n={n}, rows={rows})")
    c2r_launches += 1
    c2r_c64_launches += 1
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


def _r2c_c64(xr, scale):
    if xr.device.type == "cuda":
        return _r2c_launch_c64(xr, scale)
    if xr.device.type != "cpu":
        raise ValueError(f"no R2C FFT for device {xr.device}")
    return rfft_rows_c64_reference(xr, scale)


class _R2CC64(torch.autograd.Function):
    """:class:`_R2C` into complex64: the same adjoint, on the complex64
    cotangent zero-padded to n through the +sign row kernel's complex64
    entry, real part (no split)."""

    @staticmethod
    def forward(ctx, xr, scale):
        ctx.n, ctx.scale = xr.shape[-1], scale
        return _r2c_c64(xr, scale)

    @staticmethod
    def backward(ctx, g):
        g = torch.nn.functional.pad(g.to(torch.complex64), (0, ctx.n - g.shape[-1]))
        return _transform_c64(g, INVERSE, ctx.scale).real, None


def _c2r_adjoint(g, n, scale, padded_in):
    """The adjoint of the C2R with scale k, x = 2k Re sum_b eps_b X[b]
    exp(+2 pi i b j/n), eps = 1/2 at DC and Nyquist: 2k eps_b (R2C of g)[b]
    (the R2C kernel on the card); the padded form's pad columns get zero."""
    m = n // 2
    gr, gi = _r2c(g.contiguous(), None, padded_in)
    eps = torch.zeros(gr.shape[-1], dtype=gr.dtype, device=gr.device)
    eps[:m + 1] = 1.0
    eps[0] = eps[m] = 0.5
    k = 2.0 * _scale_arg(scale)
    return k * eps * gr, k * eps * gi


class _C2R(torch.autograd.Function):
    """C2R with its adjoint (:func:`_c2r_adjoint`)."""

    @staticmethod
    def forward(ctx, Xr, Xi, n, scale, padded_in):
        ctx.n, ctx.scale, ctx.padded_in = n, scale, padded_in
        return _c2r(Xr, Xi, n, scale)

    @staticmethod
    def backward(ctx, g):
        return (*_c2r_adjoint(g, ctx.n, ctx.scale, ctx.padded_in), None, None, None)


def _c2r_c64(X, n, scale):
    if X.device.type == "cuda":
        return _c2r_launch_c64(X, n, scale)
    if X.device.type != "cpu":
        raise ValueError(f"no C2R FFT for device {X.device}")
    return irfft_rows_c64_reference(X, n, scale, padded_in=X.shape[-1] != n // 2 + 1)


class _C2RC64(torch.autograd.Function):
    """:class:`_C2R` from complex64: the same adjoint, 2k eps_b (R2C of
    g)[b], through the R2C kernel's complex64 sink (no merge); the padded
    form's pad columns get zero."""

    @staticmethod
    def forward(ctx, X, n, scale):
        ctx.n, ctx.scale, ctx.bins = n, scale, X.shape[-1]
        return _c2r_c64(X, n, scale)

    @staticmethod
    def backward(ctx, g):
        m = ctx.n // 2
        G = _r2c_c64(g.contiguous(), None)
        eps = torch.ones(m + 1, dtype=torch.float32, device=G.device)
        eps[0] = eps[m] = 0.5
        G = G * (2.0 * _scale_arg(ctx.scale) * eps)
        return torch.nn.functional.pad(G, (0, ctx.bins - (m + 1))), None, None


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


def rfft_rows_c64(xr, scale=None):
    """Batched R2C FFT over the last axis: real float32 ``[..., n]`` ->
    complex64 ``[..., n//2 + 1]``, pow2 n in 128..16384: on the card the
    kernel's complex64 sink, one launch and no merge.  Forward sign; scale
    folded into the store.  Differentiable (backward: the +sign row kernel
    on the zero-padded cotangent, real part)."""
    if not isinstance(xr, torch.Tensor) or xr.dtype != torch.float32 or xr.ndim < 1:
        raise ValueError("rfft_rows_c64 takes a float32 tensor of at least one axis")
    _check_real(xr.shape[-1])
    return _R2CC64.apply(xr, scale)


def rfft_rows_c64_reference(xr, scale=None):
    """Plain torch version of :func:`rfft_rows_c64`: the plain version of
    the planar entry, merged."""
    return torch.complex(*rfft_rows_split_reference(xr, scale))


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


def _check_c2r_c64(X, n, padded_in) -> None:
    if not isinstance(X, torch.Tensor) or X.dtype != torch.complex64 or X.ndim < 1:
        raise ValueError("irfft_rows_c64 takes a complex64 tensor of at least one axis")
    _check_real(n)
    bins = pad_bins(n) if padded_in else n // 2 + 1
    if X.shape[-1] != bins:
        raise ValueError(f"C2R of n={n} expects {bins} bins"
                         f"{' (padded)' if padded_in else ''}, got {X.shape[-1]}")


def irfft_rows_c64(X, n, scale=None, *, padded_in=False):
    """:func:`irfft_rows_split` from a complex64 ``[..., n//2 + 1]`` tensor
    (or ``[..., pad_bins(n)]`` with ``padded_in=True``, whose pad columns
    are not read) -> real float32 ``[..., n]``, pow2 n in 128..16384: on the
    card the C2R kernel's complex64 source, one launch and no split.
    Differentiable (backward: the R2C kernel's complex64 sink)."""
    _check_c2r_c64(X, n, padded_in)
    return _C2RC64.apply(X, n, scale)


def irfft_rows_c64_reference(X, n, scale=None, *, padded_in=False):
    """Plain torch version of :func:`irfft_rows_c64`: the plain version of
    the planar source on X's planes."""
    _check_c2r_c64(X, n, padded_in)
    return irfft_rows_split_reference(X.real, X.imag, n, scale, padded_in=padded_in)


def _c2r_passes(Xr, Xi, n, scale=None):
    """Plain torch version of the C2R kernels' own passes (B7; B8 after its
    product): Z packed from X[k] and X[m-k] of bins 0..n/2 (:func:`_c2r_pack`:
    the DC and Nyquist imaginary parts ignored), the fixed passes of
    :func:`_mixed_radix_plan`(m) on the kernel's pass roots (sign +1), then
    the scale (2/m of the packing's halves is numpy's 1/n) and z[j]
    interleaved as x[2j], x[2j+1]: real ``[..., n]``.  No CUDA path calls
    it."""
    m = n // 2
    Zr, Zi = _c2r_pack(Xr[..., :m + 1], Xi[..., :m + 1], n)
    tab = _twiddle_table(m, INVERSE, Xr.device, _pass_roots_np)
    z = _fixed_passes(torch.complex(Zr, Zi), INVERSE, torch.complex(tab[:, 0], tab[:, 1]),
                      _mixed_radix_plan(m)) * (2.0 * _scale_arg(scale))
    return torch.stack([z.real, z.imag], dim=-1).reshape(*z.shape[:-1], n)


# ---------------------------------------------------------------------- #
# C2R of a spectrum product (pallas_fft.irfft_prod_rows_split): A * B
# staged once in shared memory, then the compiled pow2 passes
# ---------------------------------------------------------------------- #
def _check_c2r_prod(Ar, Ai, Br, Bi, n, padded_in) -> None:
    _check_c2r(Ar, Ai, n, padded_in)
    _check_planes(Br, Bi)
    if Br.device != Ar.device:
        raise ValueError("A and B must lie on one device")
    if Br.shape[-1] != Ar.shape[-1] or not (Br.ndim == 1 or Br.shape == Ar.shape):
        raise Unsupported(f"spectrum operands must have equal shapes (or a 1-D "
                          f"broadcast B), got {tuple(Ar.shape)} and {tuple(Br.shape)}")


def _c2r_prod_launch(Ar, Ai, Br, Bi, n, scale):
    """Run the c2r_prod kernel (``c2r_fft.cu``'s second kernel, on the
    compiled pow2 passes) on CUDA tensors."""
    global c2r_prod_launches
    bins = Ar.shape[-1]
    Ar, Ai, Br, Bi = (t.contiguous() for t in (Ar, Ai, Br, Bi))
    out = Ar.new_empty((*Ar.shape[:-1], n))
    if Ar.numel() == 0:
        return out
    rows, b_rows = Ar.numel() // bins, Br.numel() // bins
    m = n // 2
    build.launch("c2r_fft", "c2r_prod_fft_f32",
                 [_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _F, _P], Ar.device,
                 Ar.data_ptr(), Ai.data_ptr(), Br.data_ptr(), Bi.data_ptr(), out.data_ptr(),
                 _twiddle_table(m, INVERSE, Ar.device, _pass_roots_np).data_ptr(),
                 _halfcomplex_table(n, INVERSE, Ar.device).data_ptr(), rows, b_rows,
                 m.bit_length() - 1, bins, _scale_arg(scale), _stream(Ar),
                 what=f"c2r_prod launch failed (n={n}, rows={rows}, b_rows={b_rows})")
    c2r_prod_launches += 1
    return out


def _c2r_prod(Ar, Ai, Br, Bi, n, scale, padded_in):
    if Ar.device.type == "cuda":
        return _c2r_prod_launch(Ar, Ai, Br, Bi, n, scale)
    if Ar.device.type != "cpu":
        raise ValueError(f"no C2R FFT for device {Ar.device}")
    return irfft_prod_rows_split_reference(Ar, Ai, Br, Bi, n, scale, padded_in=padded_in)


def _c2r_prod_passes(Ar, Ai, Br, Bi, n, scale=None):
    """Plain torch version of the c2r_prod kernel's own passes (B8): the
    product X = A * B of bins 0..n/2 (B of A's shape or one broadcast row),
    then :func:`_c2r_passes`.  No CUDA path calls it."""
    m = n // 2
    return _c2r_passes(*_cmul(*(v[..., :m + 1] for v in (Ar, Ai, Br, Bi))), n, scale)


class _C2RProd(torch.autograd.Function):
    """x = C2R(A * B).  Its adjoint, of the composed form as the JAX
    package's custom_vjp takes it: g_P = the C2R adjoint of the cotangent
    (:func:`_c2r_adjoint`, the R2C kernel on the card), then
    gA = g_P * conj(B) and gB = g_P * conj(A), summed over the rows for a
    broadcast B; pad columns get zero."""

    @staticmethod
    def forward(ctx, Ar, Ai, Br, Bi, n, scale, padded_in):
        ctx.save_for_backward(Ar, Ai, Br, Bi)
        ctx.n, ctx.scale, ctx.padded_in = n, scale, padded_in
        return _c2r_prod(Ar, Ai, Br, Bi, n, scale, padded_in)

    @staticmethod
    def backward(ctx, g):
        Ar, Ai, Br, Bi = ctx.saved_tensors
        pr, pi = _c2r_adjoint(g, ctx.n, ctx.scale, ctx.padded_in)
        gar = gai = gbr = gbi = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            gar, gai = pr * Br + pi * Bi, pi * Br - pr * Bi
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            gbr, gbi = pr * Ar + pi * Ai, pi * Ar - pr * Ai
            if Br.ndim == 1:
                gbr = gbr.reshape(-1, Br.shape[0]).sum(0)
                gbi = gbi.reshape(-1, Br.shape[0]).sum(0)
        return gar, gai, gbr, gbi, None, None, None


def irfft_prod_rows_split(Ar, Ai, Br, Bi, n, scale=None, *, padded_in=False):
    """Batched C2R of the spectrum product A * B over the last axis,
    real(IRFFT(A * B)) times ``scale``, with the product formed at load
    (never written to device memory): the fftconvolve / oaconvolve
    epilogue.  A is planar ``[..., n//2 + 1]`` (or ``[..., pad_bins(n)]``
    with ``padded_in=True``); B has A's shape, or is one 1-D row broadcast
    over every row of A.  The imaginary parts of the product's DC and
    Nyquist bins are ignored (numpy's irfft of A * B).  Pow2 n in
    128..16384.  Differentiable in A and B (backward: the R2C kernel and
    two products)."""
    _check_c2r_prod(Ar, Ai, Br, Bi, n, padded_in)
    return _C2RProd.apply(Ar, Ai, Br, Bi, n, scale, bool(padded_in))


def irfft_prod_rows_split_reference(Ar, Ai, Br, Bi, n, scale=None, *, padded_in=False):
    """Plain torch version of :func:`irfft_prod_rows_split`: the product,
    then :func:`irfft_rows_split_reference`.  Raises :class:`Unsupported`
    for the same shapes as the kernel."""
    _check_c2r_prod(Ar, Ai, Br, Bi, n, padded_in)
    return irfft_rows_split_reference(*_cmul(Ar, Ai, Br, Bi), n, scale,
                                      padded_in=padded_in)


# ---------------------------------------------------------------------- #
# composite non-pow2 rows: C2C (pallas_fft.fft_rows_general_split) and R2C
# (pallas_fft.rfft_rows_general_split), one pass of mixed-radix passes
# ---------------------------------------------------------------------- #
GEN_MIN_N = 512
GEN_MAX_FACTOR = 256


def _choose_general_split(n: int):
    """Least-MAC divisor pair (n1, n2), n1 <= n2 <= 256, n1*n2 = n; None if
    n has no such factorization (a copy of the JAX package's)."""
    best = None
    d = 2
    while d * d <= n:
        if n % d == 0:
            pair = (d, n // d)
            if pair[1] <= GEN_MAX_FACTOR and (best is None or sum(pair) < sum(best)):
                best = pair
        d += 1
    return best


def _gen_supported(n: int) -> bool:
    """Composite-row envelope, the JAX kernel's: non-pow2 n in
    512..16384 with a split of factors <= 256."""
    return (GEN_MIN_N <= n <= FUSED_MAX_N and n & (n - 1) != 0
            and _choose_general_split(n) is not None)


def _check_gen(n: int) -> None:
    if not _gen_supported(n):
        raise Unsupported(f"n={n} outside the composite-row kernel envelope "
                          f"(non-pow2 {GEN_MIN_N}..{FUSED_MAX_N} with factors "
                          f"<= {GEN_MAX_FACTOR})")


_GEN_SMALL = (2, 3, 4, 5, 7, 8, 9, 11, 13, 16)


def _factorize(n: int) -> list:
    """The prime factors of n in ascending order, with multiplicity."""
    out, d = [], 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


@functools.lru_cache(maxsize=None)
def _mixed_radix_plan(n: int) -> tuple:
    """The radices of the composite-row kernels' passes over n points
    (``csrc/mixed_fft.cuh``), in pass order; their product is n.

    Powers of 2 go into the fewest passes of 16, 8, 4 or 2 (as even as
    possible, largest first), powers of 3 into 9s and a 3, the primes 5, 7,
    11 and 13 stay as themselves, and each prime from 17 to 251 is one
    generic pass.  Order: the smaller generic prime first, then 9s and 3,
    5, 7, 11, 13, then the powers of 2, then the other generic prime last.
    A first pass writes shared memory at stride R, so an odd radix there
    touches 32 banks; a generic pass first or last reads or writes device
    memory and never holds its outputs across a barrier.  Raises
    :class:`Unsupported` for n with a prime factor above 256 or more than
    two from 17 on (none in the envelope: 17*17 > 256)."""
    f = _factorize(n)
    if n < 2 or f[-1] > GEN_MAX_FACTOR:
        raise Unsupported(f"n={n} has no mixed-radix plan (a prime factor > "
                          f"{GEN_MAX_FACTOR})")
    generic = [p for p in f if p >= 17]
    if len(generic) > 2:
        raise Unsupported(f"n={n} has more than two prime factors >= 17")
    a, b = f.count(2), f.count(3)
    twos = []
    if a:
        passes = -(-a // 4)
        base, extra = divmod(a, passes)
        twos = [1 << (base + 1)] * extra + [1 << base] * (passes - extra)
    odd = [9] * (b // 2) + [3] * (b % 2) + [p for p in f if 5 <= p <= 13]
    return tuple(generic[:1] + odd + twos + generic[1:])


def _unit_pair(c: float, s: float):
    """The float32 pair nearest the root (c, s) whose |w|^2 is nearest 1:
    of the pairs within two ulps of float32(c), float32(s) in each part
    (parts below 1e-12 taken as 0), those whose | |w|^2 - 1 | is within
    1e-10 of the least, and of them the nearest to (c, s).  A multiply by
    it keeps a row's power where the rounded pair (|w|^2 - 1 as low as
    -5.7e-8 at w_16) shrinks it; its angle is within 2.2e-7 of the
    root's."""
    def moved(x, d):
        for _ in range(abs(d)):
            x = np.nextafter(x, np.float32(np.inf if d > 0 else -np.inf), dtype=np.float32)
        return x
    c, s = (0.0 if abs(v) < 1e-12 else float(v) for v in (c, s))
    pairs = [(moved(np.float32(c), dc), moved(np.float32(s), ds))
             for dc in range(-2, 3) for ds in range(-2, 3)]
    err = [abs(float(a) ** 2 + float(b) ** 2 - 1.0) for a, b in pairs]
    near = [i for i, e in enumerate(err) if e <= min(err) + 1e-10]
    return pairs[min(near, key=lambda i: abs(complex(float(pairs[i][0]) - c,
                                                      float(pairs[i][1]) - s)))]


@functools.lru_cache(maxsize=None)
def butterfly_roots_np(r: int):
    """cos and sin of 2*pi*m/r, m < r, as the pairs of :func:`_unit_pair`:
    the butterfly constants of ``csrc/mixed_fft.cuh`` (``kRoot``, for r in
    :data:`_GEN_SMALL` but 2 and 4; tests hold the two equal)."""
    t = 2.0 * np.pi * np.arange(r) / r
    pairs = [_unit_pair(c, s) for c, s in zip(np.cos(t), np.sin(t))]
    return (np.array([a for a, _ in pairs], np.float32),
            np.array([b for _, b in pairs], np.float32))


def _butterfly_matrix(r: int, sign: int, device):
    """The r-point DFT matrix W[q, k] = w_r^(sign*q*k) on the butterfly
    constants (:func:`butterfly_roots_np`), planar float32 on ``device``,
    cached: the plain version of the kernels' small-radix butterflies."""
    key = ("butterfly", r, sign, str(device))
    pair = _TWIDDLES.get(key)
    if pair is None:
        c, s = butterfly_roots_np(r)
        m = np.outer(np.arange(r), np.arange(r)) % r
        pair = _TWIDDLES[key] = (torch.from_numpy(c[m]).to(device),
                                 torch.from_numpy(sign * s[m]).to(device))
    return pair


def _radix_arg(plan: tuple):
    return (ctypes.c_int * len(plan))(*plan)


def _mixed_passes(z, sign, tw, tws):
    """The kernel's passes in plain torch on a complex ``[..., N]`` tensor:
    for each radix R of :func:`_mixed_radix_plan`(N), with NS the product of
    the radices before it, butterfly j reads z[j + k*N/R], multiplies input
    k by w^k, w = tw[(j mod NS) * N/(NS*R) * tws] (a float32 root of the
    table; w^k as k - 1 products for a small radix, the table's root of
    exponent k*e for a generic prime), takes the R-point DFT
    (:func:`_autosort`) and writes output q to
    (j - j mod NS)*R + j mod NS + q*NS."""
    N = z.shape[-1]
    ns = 1
    for R in _mixed_radix_plan(N):
        M = N // R
        j = torch.arange(M, device=z.device)
        k = torch.arange(R, device=z.device)
        x = z.reshape(*z.shape[:-1], R, M)
        e = (j % ns) * (N // (ns * R)) * tws
        if R in _GEN_SMALL:
            wk = torch.cumprod(tw[e].expand(R - 1, M), dim=0)
            x = torch.cat([x[..., :1, :], x[..., 1:, :] * wk], dim=-2)
        else:
            x = x * tw[k[:, None] * e[None, :]]
        z = _autosort(x, sign, ns)
        ns *= R
    return z


def _autosort(x, sign, ns):
    """The rest of a pass after its twiddles: the R-point DFTs (the
    butterfly constants' matrix, :func:`_butterfly_matrix`, for a small
    radix; an f64-generated matrix for a generic prime) of the twiddled
    inputs ``x`` [..., R(k), M(j)] and the Stockham store of output q of
    butterfly j at (j - j mod NS)*R + j mod NS + q*NS, a complex
    [..., R*M] tensor."""
    R, M = x.shape[-2:]
    j = torch.arange(M, device=x.device)
    k = torch.arange(R, device=x.device)
    if R in _GEN_SMALL:
        wr, wi = _butterfly_matrix(R, sign, x.device)
    else:
        wr, wi = stockham._const("dft_matrix_np", (R, sign), x.device)
    # y[q, j] = sum_k W[q, k] x[k, j], W symmetric: y^T = x^T @ W
    yr, yi = stockham._cmatmul(x.real.transpose(-1, -2).contiguous(),
                               x.imag.transpose(-1, -2).contiguous(), wr, wi)
    jm = j % ns
    d = ((j - jm) * R + jm)[:, None] + (k * ns)[None, :]  # [M, R(q)]
    out = x.new_empty(*x.shape[:-2], R * M)
    out[..., d.reshape(-1)] = torch.complex(yr, yi).reshape(*x.shape[:-2], R * M)
    return out


def _table_c(n: int, sign: int, device):
    tab = _twiddle_table(n, sign, device)
    return torch.complex(tab[:, 0], tab[:, 1])


def _mixed_radix(re, im, sign, scale):
    """Plain torch version of the gen_fft kernel's mixed-radix passes
    (:func:`_mixed_passes` over ``[..., n]``), the scale folded in at the
    end as the kernel's store does.  No CUDA path calls it."""
    n = re.shape[-1]
    y = _mixed_passes(torch.complex(re, im), sign, _table_c(n, sign, re.device), 1)
    return stockham.apply_scale(y.real.contiguous(), y.imag.contiguous(), scale)


def _mixed_radix_real(xr, scale, pad_out):
    """Plain torch version of the r2c_gen_fft kernel: for even n the row as
    m = n/2 complex points z[j] = x[2j] + i x[2j+1], the m-point passes
    (the n-point table at stride 2) and the recombination X[k] = (Z[k] +
    conj(Z[m-k]))/2 - (i/2) t[k] (Z[k] - conj(Z[m-k])), t[k] = w_n^k; for
    odd n the n-point passes of the real row, bins 0..n//2.  Zeros past bin
    n//2 when ``pad_out``.  No CUDA path calls it."""
    n = xr.shape[-1]
    mp = n // 2 + 1
    tw = _table_c(n, FORWARD, xr.device)
    if n % 2:
        X = _mixed_passes(torch.complex(xr, torch.zeros_like(xr)), FORWARD, tw, 1)[..., :mp]
    else:
        m = n // 2
        Z = _mixed_passes(torch.complex(xr[..., 0::2], xr[..., 1::2]), FORWARD, tw, 2)
        k = torch.arange(mp, device=xr.device)
        a, b = Z[..., k % m], Z[..., (m - k) % m]
        E = 0.5 * (a + b.conj())
        D = 0.5 * (a - b.conj())
        X = E - 1j * tw[k] * D
    Xr, Xi = stockham.apply_scale(X.real.contiguous(), X.imag.contiguous(), scale)
    bins = pad_bins(n) if pad_out else mp
    pad = (0, bins - mp)
    return torch.nn.functional.pad(Xr, pad), torch.nn.functional.pad(Xi, pad)


def _gen_launch(re, im, sign, scale):
    """Run the gen_fft kernel on CUDA tensors."""
    global gen_launches
    n = re.shape[-1]
    plan = _mixed_radix_plan(n)
    re, im = re.contiguous(), im.contiguous()
    out = (torch.empty_like(re), torch.empty_like(im))
    if re.numel() == 0:
        return out
    rows = re.numel() // n
    build.launch("gen_fft", "gen_fft_f32",
                 [_P, _P, _P, _P, _P, _LL, _I, _P, _I, _I, _F, _P],
                 re.device, re.data_ptr(), im.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), _twiddle_table(n, sign, re.device).data_ptr(), rows, n,
                 ctypes.cast(_radix_arg(plan), _P), len(plan), sign, _scale_arg(scale),
                 _stream(re), what=f"gen_fft launch failed (n={n}, rows={rows})")
    gen_launches += 1
    return out


def _gen(re, im, sign, scale):
    if re.device.type == "cuda":
        return _gen_launch(re, im, sign, scale)
    if re.device.type != "cpu":
        raise ValueError(f"no composite-row FFT for device {re.device}")
    return fft_rows_general_split_reference(re, im, sign, scale)


def fft_rows_general_split(re, im, sign, scale=None):
    """Batched FFT over the last axis of planar float32 ``[..., n]`` for
    composite non-pow2 n in 512..16384 (factors <= 256), one pass over
    device memory.  sign: -1 forward / +1 inverse; scale folded into the
    store.  Differentiable (the backward is the sign-flipped kernel)."""
    _check_gen(re.shape[-1])
    _check_sign(sign)
    _check_planes(re, im)
    return _SignFlipped.apply(_gen, sign, scale, re, im)


def _two_factor(re, im, sign, scale):
    """The JAX kernel's two-factor transform in plain torch: an n1-point
    DFT matrix product down the columns of [..., n1, n2], the twiddle
    w_n^(k1*j2), an n2-point DFT matrix product along the rows, out at
    k1 + n1*k2, then the scale; all tables f64-generated."""
    n = re.shape[-1]
    n1, n2 = _choose_general_split(n)
    lead = re.shape[:-1]
    # stage 1 on the transposed view [..., j2, j1]: B^T = A^T @ W1
    ar = re.reshape(*lead, n1, n2).transpose(-1, -2)
    ai = im.reshape(*lead, n1, n2).transpose(-1, -2)
    w1r, w1i = stockham._const("dft_matrix_np", (n1, sign), re.device)
    br, bi = stockham._cmatmul(ar, ai, w1r, w1i)
    twr, twi = stockham._const("twiddle_np", (n1, n2, sign, True), re.device)
    cr, ci = br * twr - bi * twi, br * twi + bi * twr
    # stage 2: D[k1, k2] = C[k1, :] @ W2, stored at k1 + n1*k2
    w2r, w2i = stockham._const("dft_matrix_np", (n2, sign), re.device)
    dr, di = stockham._cmatmul(cr.transpose(-1, -2), ci.transpose(-1, -2), w2r, w2i)
    yr = dr.transpose(-1, -2).reshape(*lead, n)
    yi = di.transpose(-1, -2).reshape(*lead, n)
    return stockham.apply_scale(yr, yi, scale)


def fft_rows_general_split_reference(re, im, sign, scale=None):
    """Plain torch version of :func:`fft_rows_general_split`: the JAX
    kernel's two-factor math (:func:`_two_factor`; the Hopper kernel's own
    passes are :func:`_mixed_radix`).  Raises :class:`Unsupported` for the
    same n as the kernel."""
    _check_gen(re.shape[-1])
    return _two_factor(re, im, sign, scale)


def _r2c_gen_launch(xr, scale, pad_out):
    """Run the r2c_gen_fft kernel on a CUDA tensor."""
    global r2c_gen_launches
    n = xr.shape[-1]
    plan = _mixed_radix_plan(n // 2 if n % 2 == 0 else n)
    bins = pad_bins(n) if pad_out else n // 2 + 1
    xr = xr.contiguous()
    shape = (*xr.shape[:-1], bins)
    out = (xr.new_empty(shape), xr.new_empty(shape))
    if xr.numel() == 0:
        return out
    rows = xr.numel() // n
    build.launch("r2c_gen_fft", "r2c_gen_fft_f32",
                 [_P, _P, _P, _P, _LL, _I, _P, _I, _I, _F, _P], xr.device, xr.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(),
                 _twiddle_table(n, FORWARD, xr.device).data_ptr(), rows, n,
                 ctypes.cast(_radix_arg(plan), _P), len(plan), bins, _scale_arg(scale),
                 _stream(xr), what=f"r2c_gen_fft launch failed (n={n}, rows={rows})")
    r2c_gen_launches += 1
    return out


def _r2c_gen(xr, scale, pad_out):
    if xr.device.type == "cuda":
        return _r2c_gen_launch(xr, scale, pad_out)
    if xr.device.type != "cpu":
        raise ValueError(f"no composite R2C FFT for device {xr.device}")
    return rfft_rows_general_split_reference(xr, scale, pad_out=pad_out)


class _R2CGen(torch.autograd.Function):
    """Composite R2C with scale k, X[b] = k sum_m x[m] exp(-2 pi i b m/n),
    b <= n/2.  Its adjoint is the cotangent bins zero-padded to n through
    the +sign composite C2C (the gen_fft kernel on the card), real part;
    the padded form's pad columns are written as zeros, so their
    cotangents are discarded."""

    @staticmethod
    def forward(ctx, xr, scale, pad_out):
        ctx.n, ctx.scale = xr.shape[-1], scale
        return _r2c_gen(xr, scale, pad_out)

    @staticmethod
    def backward(ctx, gr, gi):
        n, mp = ctx.n, ctx.n // 2 + 1
        pad = (0, n - mp)
        gr = torch.nn.functional.pad(gr[..., :mp], pad)
        gi = torch.nn.functional.pad(gi[..., :mp], pad)
        yr, _ = _gen(gr, gi, INVERSE, ctx.scale)
        return yr, None, None


def rfft_rows_general_split(xr, scale=None, *, pad_out=False):
    """Batched R2C over the last axis for composite non-pow2 n (odd or
    even) in the envelope of :func:`fft_rows_general_split`: real float32
    ``[..., n]`` -> planar ``[..., n//2 + 1]``, or ``[..., pad_bins(n)]``
    with exact zeros past bin n//2 when ``pad_out=True``.  Forward sign;
    scale folded into the store.  Differentiable (backward: the +sign
    composite C2C on the zero-padded cotangent, real part)."""
    if xr.dtype != torch.float32:
        raise ValueError("rfft_rows_general_split takes a float32 tensor")
    _check_gen(xr.shape[-1])
    return _R2CGen.apply(xr, scale, bool(pad_out))


def rfft_rows_general_split_reference(xr, scale=None, *, pad_out=False):
    """Plain torch version of :func:`rfft_rows_general_split`: the JAX
    kernel's two-factor math on the real row, bins 0..n//2 (the Hopper
    kernel's own passes are :func:`_mixed_radix_real`).  Raises
    :class:`Unsupported` for the same n as the kernel."""
    n = xr.shape[-1]
    _check_gen(n)
    Xr, Xi = _two_factor(xr, torch.zeros_like(xr), FORWARD, scale)
    mp = n // 2 + 1
    bins = pad_bins(n) if pad_out else mp
    pad = (0, bins - mp)
    return (torch.nn.functional.pad(Xr[..., :mp], pad),
            torch.nn.functional.pad(Xi[..., :mp], pad))


# ---------------------------------------------------------------------- #
# the Bluestein / chirp-z passes (pallas_fft.fft_chirp_forward_split and
# fft_chirp_inverse_split), m-point row FFTs with the chirp multiplies at
# load and store
# ---------------------------------------------------------------------- #
def _chirp_supported(m: int, n: int) -> bool:
    """Chirp-pass envelope: m pow2 in 128..16384 (the row kernel's) and a
    signal or output length 1 <= n <= m, any n (the TPU kernels needed
    multiples of 128)."""
    return _supported(m) and 1 <= n <= m


def _check_chirp(m: int, n: int, what: str) -> None:
    if not _chirp_supported(m, n):
        raise Unsupported(f"m={m}, {what}={n} outside the chirp-pass envelope "
                          f"(pow2 m in {FUSED_MIN_N}..{FUSED_MAX_N}, {what} <= m)")


def _table(t, shape, device, what: str) -> torch.Tensor:
    """A constant table (numpy array or tensor) of ``shape`` (an int for
    one row) float32 values on ``device``."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    t = torch.as_tensor(t, dtype=torch.float32, device=device).contiguous()
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} must have shape {shape}, got {tuple(t.shape)}")
    return t


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _plan_roots(m: int, sign: int, plan: tuple):
    """Each pass's twiddles for the fixed-plan passes of
    ``mixed_fft.cuh::fixed_passes``: for each pass of ``plan`` after the
    first, with NS the product of the radices before it and R its radix,
    the powers w_(NS*R)^(k*e) = exp(sign*2pi*i*k*e/(NS*R)) as [k - 1][e],
    0 < k < R, e < NS, pass after pass; taken from the m-point table of
    :func:`_tw.roots_np`, so every value is one of that table's."""
    idx, ns = [], 1
    for r in plan:
        if ns > 1:
            idx.append((np.arange(1, r)[:, None] * np.arange(ns) * (m // (ns * r))).ravel())
        ns *= r
    idx = np.concatenate(idx)
    c, s = _tw.roots_np(m, sign)
    return c[idx], s[idx]


def _pass_roots_np(m: int, sign: int):
    """The chirp kernels' twiddle table: :func:`_plan_roots` of
    :func:`_mixed_radix_plan`(m), the plan compiled into
    ``csrc/chirp_fft.cu`` (its ``plans`` table)."""
    return _plan_roots(m, sign, _mixed_radix_plan(m))


def _pass_roots_reversed_np(m: int, sign: int):
    """chirp_full's second transform's table: :func:`_plan_roots` of the
    plan in reverse order (the kernel's turn pass runs the first
    transform's last radix as the second's first)."""
    return _plan_roots(m, sign, _mixed_radix_plan(m)[::-1])


def _chirp_fwd_launch(re, im, hr, hi, m, sign):
    """Run the chirp_fwd kernel on CUDA tensors: [..., n_in] -> [..., m]."""
    global chirp_fwd_launches
    n_in = re.shape[-1]
    re, im = re.contiguous(), im.contiguous()
    shape = (*re.shape[:-1], m)
    out = (re.new_empty(shape), re.new_empty(shape))
    if re.numel() == 0:
        return out
    rows = re.numel() // n_in
    build.launch("chirp_fft", "chirp_fwd_f32",
                 [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P], re.device,
                 re.data_ptr(), im.data_ptr(), hr.data_ptr(), hi.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(),
                 _twiddle_table(m, sign, re.device, _pass_roots_np).data_ptr(), rows, n_in,
                 m, sign, _stream(re),
                 what=f"chirp_fwd launch failed (n_in={n_in}, m={m}, rows={rows})")
    chirp_fwd_launches += 1
    return out


def _chirp_fwd(re, im, hr, hi, m, sign):
    if re.device.type == "cuda":
        return _chirp_fwd_launch(re, im, hr, hi, m, sign)
    if re.device.type != "cpu":
        raise ValueError(f"no chirp pass for device {re.device}")
    return fft_chirp_forward_split_reference(re, im, hr, hi, m, sign)


class _ChirpFwd(torch.autograd.Function):
    """y = FFT_m(zero_pad(h * x)), linear in x with h constant.  Adjoint:
    conj(h) * FFT_{-sign}(ct)[..., :n_in], with the row kernel as its FFT
    on the card (the JAX package's transpose rule)."""

    @staticmethod
    def forward(ctx, re, im, hr, hi, m, sign):
        ctx.save_for_backward(hr, hi)
        ctx.sign = sign
        return _chirp_fwd(re, im, hr, hi, m, sign)

    @staticmethod
    def backward(ctx, gr, gi):
        hr, hi = ctx.saved_tensors
        n_in = hr.shape[0]
        ar, ai = _transform(gr.contiguous(), gi.contiguous(), -ctx.sign, None)
        ar, ai = ar[..., :n_in], ai[..., :n_in]
        return ar * hr + ai * hi, ai * hr - ar * hi, None, None, None, None


def fft_chirp_forward_split(re, im, hr, hi, m, sign):
    """The Bluestein / chirp-z forward pass over the last axis:
    ``FFT_m(zero_pad_m(h * x))``, planar float32 ``[..., n_in]`` ->
    ``[..., m]``, with h ``[n_in]`` (a numpy array or tensor) multiplied in
    and the zero-pad made at load.  m pow2 in 128..16384, any n_in <= m.
    Differentiable in (re, im); h is a constant."""
    _check_chirp(m, re.shape[-1], "n_in")
    _check_sign(sign)
    _check_planes(re, im)
    hr = _table(hr, re.shape[-1], re.device, "hr")
    hi = _table(hi, re.shape[-1], re.device, "hi")
    return _ChirpFwd.apply(re, im, hr, hi, m, sign)


def fft_chirp_forward_split_reference(re, im, hr, hi, m, sign):
    """Plain torch version of :func:`fft_chirp_forward_split`: the chirp
    multiply, the zero-pad and the mixed-radix m-point FFT."""
    n_in = re.shape[-1]
    _check_chirp(m, n_in, "n_in")
    hr = _table(hr, n_in, re.device, "hr")
    hi = _table(hi, n_in, re.device, "hi")
    ar, ai = _cmul(re, im, hr, hi)
    pad = (0, m - n_in)
    return stockham.fft_last_axis(torch.nn.functional.pad(ar, pad),
                                  torch.nn.functional.pad(ai, pad), sign)


def _chirp_inv_launch(re, im, hr, hi, gr, gi, n_out, sign, scale):
    """Run the chirp_inv kernel on CUDA tensors: [..., m] -> [..., n_out]."""
    global chirp_inv_launches
    m = re.shape[-1]
    re, im = re.contiguous(), im.contiguous()
    shape = (*re.shape[:-1], n_out)
    out = (re.new_empty(shape), re.new_empty(shape))
    if re.numel() == 0:
        return out
    rows = re.numel() // m
    build.launch("chirp_fft", "chirp_inv_f32",
                 [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _F, _P],
                 re.device, re.data_ptr(), im.data_ptr(), hr.data_ptr(), hi.data_ptr(),
                 gr.data_ptr(), gi.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                 _twiddle_table(m, sign, re.device, _pass_roots_np).data_ptr(), rows,
                 n_out, m, sign, _scale_arg(scale), _stream(re),
                 what=f"chirp_inv launch failed (m={m}, n_out={n_out}, rows={rows})")
    chirp_inv_launches += 1
    return out


def _chirp_inv(re, im, hr, hi, gr, gi, n_out, sign, scale):
    if re.device.type == "cuda":
        return _chirp_inv_launch(re, im, hr, hi, gr, gi, n_out, sign, scale)
    if re.device.type != "cpu":
        raise ValueError(f"no chirp pass for device {re.device}")
    return fft_chirp_inverse_split_reference(re, im, hr, hi, gr, gi, n_out, sign,
                                             scale)


class _ChirpInv(torch.autograd.Function):
    """y = g * (scale * FFT_sign(h * x))[..., :n_out], linear in x with h
    and g constant.  Adjoint: conj(h) * (scale * FFT_{-sign}(zero_pad_m(
    conj(g) * ct))), with the row kernel as its FFT on the card (the JAX
    package's transpose rule)."""

    @staticmethod
    def forward(ctx, re, im, hr, hi, gr, gi, n_out, sign, scale):
        ctx.save_for_backward(hr, hi, gr, gi)
        ctx.sign, ctx.scale = sign, scale
        return _chirp_inv(re, im, hr, hi, gr, gi, n_out, sign, scale)

    @staticmethod
    def backward(ctx, ctr, cti):
        hr, hi, gr, gi = ctx.saved_tensors
        cr, ci = ctr * gr + cti * gi, cti * gr - ctr * gi
        pad = (0, hr.shape[0] - gr.shape[0])
        ar, ai = _transform(torch.nn.functional.pad(cr, pad).contiguous(),
                            torch.nn.functional.pad(ci, pad).contiguous(),
                            -ctx.sign, ctx.scale)
        return (ar * hr + ai * hi, ai * hr - ar * hi,
                None, None, None, None, None, None, None)


def fft_chirp_inverse_split(re, im, hr, hi, gr, gi, n_out, sign, scale=None):
    """The Bluestein / chirp-z inverse pass over the last axis:
    ``g * (scale * FFT_sign(h * x))[..., :n_out]``, planar float32
    ``[..., m]`` -> ``[..., n_out]``, with h ``[m]`` multiplied in at load
    and g ``[n_out]`` at the store.  m pow2 in 128..16384, any n_out <= m.
    Differentiable in (re, im); h and g are constants."""
    m = re.shape[-1]
    _check_chirp(m, n_out, "n_out")
    _check_sign(sign)
    _check_planes(re, im)
    hr, hi = (_table(t, m, re.device, w) for t, w in ((hr, "hr"), (hi, "hi")))
    gr, gi = (_table(t, n_out, re.device, w) for t, w in ((gr, "gr"), (gi, "gi")))
    return _ChirpInv.apply(re, im, hr, hi, gr, gi, n_out, sign, scale)


def fft_chirp_inverse_split_reference(re, im, hr, hi, gr, gi, n_out, sign,
                                      scale=None):
    """Plain torch version of :func:`fft_chirp_inverse_split`: the filter
    multiply, the mixed-radix m-point FFT, the slice, the scale and the
    post-chirp multiply."""
    m = re.shape[-1]
    _check_chirp(m, n_out, "n_out")
    hr, hi = (_table(t, m, re.device, w) for t, w in ((hr, "hr"), (hi, "hi")))
    gr, gi = (_table(t, n_out, re.device, w) for t, w in ((gr, "gr"), (gi, "gi")))
    yr, yi = stockham.fft_last_axis(*_cmul(re, im, hr, hi), sign)
    yr, yi = stockham.apply_scale(yr[..., :n_out], yi[..., :n_out], scale)
    return _cmul(yr, yi, gr, gi)


def _chirp_full_launch(re, im, hr, hi, Hr, Hi, gr, gi, m, n_out, scale):
    """Run the chirp_full kernel on CUDA tensors: [..., n_in] -> [..., n_out]."""
    global chirp_full_launches
    n_in = re.shape[-1]
    re, im = re.contiguous(), im.contiguous()
    shape = (*re.shape[:-1], n_out)
    out = (re.new_empty(shape), re.new_empty(shape))
    if re.numel() == 0:
        return out
    rows = re.numel() // n_in
    build.launch("chirp_fft", "chirp_full_f32",
                 [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _F, _P],
                 re.device, re.data_ptr(), im.data_ptr(), hr.data_ptr(), hi.data_ptr(),
                 Hr.data_ptr(), Hi.data_ptr(), gr.data_ptr(), gi.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(),
                 _twiddle_table(m, -1, re.device, _pass_roots_np).data_ptr(),
                 _twiddle_table(m, 1, re.device, _pass_roots_reversed_np).data_ptr(),
                 rows, n_in, n_out, m, _scale_arg(scale), _stream(re),
                 what=f"chirp_full launch failed (n_in={n_in}, m={m}, n_out={n_out}, "
                      f"rows={rows})")
    chirp_full_launches += 1
    return out


def _chirp_full(re, im, hr, hi, Hr, Hi, gr, gi, m, n_out, scale):
    if re.device.type == "cuda":
        return _chirp_full_launch(re, im, hr, hi, Hr, Hi, gr, gi, m, n_out, scale)
    if re.device.type != "cpu":
        raise ValueError(f"no chirp pass for device {re.device}")
    return fft_chirp_full_split_reference(re, im, hr, hi, Hr, Hi, gr, gi, m, n_out, scale)


class _ChirpFull(torch.autograd.Function):
    """y = g * (scale * FFT_+(H * FFT_-(zero_pad_m(h * x))))[..., :n_out],
    linear in x with h, H and g constant.  Its adjoint, conj(h) * (scale *
    FFT_+(conj(H) * FFT_-(zero_pad_m(conj(g) * ct))))[..., :n_in], is the
    same map with the tables conjugated, h and g swapped and n_in and n_out
    exchanged (the adjoint of FFT_s is FFT_-s, and the pass order turns
    round): the same kernel on the card."""

    @staticmethod
    def forward(ctx, re, im, hr, hi, Hr, Hi, gr, gi, m, n_out, scale):
        ctx.save_for_backward(hr, hi, Hr, Hi, gr, gi)
        ctx.m, ctx.scale = m, scale
        return _chirp_full(re, im, hr, hi, Hr, Hi, gr, gi, m, n_out, scale)

    @staticmethod
    def backward(ctx, ctr, cti):
        hr, hi, Hr, Hi, gr, gi = ctx.saved_tensors
        ar, ai = _chirp_full(ctr.contiguous(), cti.contiguous(), gr, -gi, Hr, -Hi, hr, -hi,
                             ctx.m, hr.shape[0], ctx.scale)
        return (ar, ai) + (None,) * 9


def fft_chirp_full_split(re, im, hr, hi, Hr, Hi, gr, gi, m, n_out, scale=None):
    """Bluestein's algorithm and the chirp-z transform in one pass over the
    last axis: ``g * (scale * FFT_+(H * FFT_-(zero_pad_m(h * x))))[...,
    :n_out]``, planar float32 ``[..., n_in]`` -> ``[..., n_out]``, with h
    ``[n_in]``, H ``[m]`` and g ``[n_out]`` (numpy arrays or tensors)
    multiplied in.  It is :func:`fft_chirp_forward_split` (sign -1)
    followed by :func:`fft_chirp_inverse_split` (sign +1), and on the card
    one kernel that holds each m-point row in shared memory from the chirp
    to the post-chirp; the tables carry the transform's direction (an
    inverse DFT is the conjugate chirps).  m pow2 in 128..16384, any n_in,
    n_out <= m.  Differentiable in (re, im) (the backward is the same
    kernel); the tables are constants."""
    n_in = re.shape[-1]
    _check_chirp(m, max(n_in, n_out), "max(n_in, n_out)")
    _check_planes(re, im)
    tabs = (_table(t, n, re.device, w) for t, n, w in (
        (hr, n_in, "hr"), (hi, n_in, "hi"), (Hr, m, "Hr"), (Hi, m, "Hi"),
        (gr, n_out, "gr"), (gi, n_out, "gi")))
    return _ChirpFull.apply(re, im, *tabs, m, n_out, scale)


def _fixed_passes(z, sign, roots, plan):
    """The fixed-plan passes of ``mixed_fft.cuh::fixed_passes`` in plain
    torch on a complex ``[..., N]`` tensor, as :func:`_mixed_passes` but
    with each pass's twiddle w^k = roots[off + (k - 1)*NS + j mod NS] read
    from the pass-after-pass table of :func:`_plan_roots` (complex
    ``roots``)."""
    N = z.shape[-1]
    ns, off = 1, 0
    for R in plan:
        M = N // R
        x = z.reshape(*z.shape[:-1], R, M)
        if ns > 1:
            j = torch.arange(M, device=z.device)
            k = torch.arange(R - 1, device=z.device)
            wk = roots[off + (k * ns)[:, None] + (j % ns)[None, :]]
            x = torch.cat([x[..., :1, :], x[..., 1:, :] * wk], dim=-2)
            off += ns * (R - 1)
        z = _autosort(x, sign, ns)
        ns *= R
    return z


def _chirp_full_passes(re, im, hr, hi, Hr, Hi, gr, gi, m, n_out, scale=None):
    """Plain torch version of the chirp_full kernel's own passes: pad(h*x),
    the fixed passes of :func:`_mixed_radix_plan`(m) (sign -1), the product
    with H, the passes of the plan in reverse order (+1; the kernel's
    turn pass fuses the first's last pass with the second's first, the
    same arithmetic), then the slice, the scale and g, all on the tables
    the kernel reads.  No CUDA path calls it."""
    plan = _mixed_radix_plan(m)

    def roots(sgn, table):
        tab = _twiddle_table(m, sgn, re.device, table)
        return torch.complex(tab[:, 0], tab[:, 1])

    x = torch.complex(*_cmul(re, im, hr, hi))
    y = _fixed_passes(torch.nn.functional.pad(x, (0, m - re.shape[-1])), -1,
                      roots(-1, _pass_roots_np), plan)
    y = _fixed_passes(y * torch.complex(Hr, Hi), 1, roots(1, _pass_roots_reversed_np),
                      plan[::-1])
    yr, yi = stockham.apply_scale(y.real[..., :n_out], y.imag[..., :n_out], scale)
    return _cmul(yr, yi, gr, gi)


def fft_chirp_full_split_reference(re, im, hr, hi, Hr, Hi, gr, gi, m, n_out, scale=None):
    """Plain torch version of :func:`fft_chirp_full_split`: the plain
    versions of the two passes, one after the other."""
    Yr, Yi = fft_chirp_forward_split_reference(re, im, hr, hi, m, -1)
    return fft_chirp_inverse_split_reference(Yr, Yi, Hr, Hi, gr, gi, n_out, 1, scale)


# ---------------------------------------------------------------------- #
# rows with a filter multiply at load: the spectral filter
# (pallas_fft.fft_filtered_split) and the filter bank
# (pallas_fft.fft_bank_split)
# ---------------------------------------------------------------------- #
def _bank_kernel(re, im, hr, hi, sign, scale):
    """Run the bank entry (the filtered rows' kernel, x shared and h moving)
    on CUDA tensors into output planes of h's shape; returns them and
    whether it launched (an empty bank launches nothing)."""
    n = hr.shape[-1]
    re, im = re.contiguous(), im.contiguous()
    out = (re.new_empty(hr.shape), re.new_empty(hr.shape))
    rows = out[0].numel() // n
    if rows == 0:
        return out, False
    build.launch("filt_fft", "bank_fft_f32", [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _F, _P],
                 re.device, re.data_ptr(), im.data_ptr(), hr.data_ptr(), hi.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(),
                 _twiddle_table(n, sign, re.device, _pass_roots_np).data_ptr(), rows,
                 n.bit_length() - 1, sign, _scale_arg(scale), _stream(re),
                 what=f"bank_fft_f32 launch failed (n={n}, rows={rows})")
    return out, True


def _filt_launch(re, im, hr, hi, sign, scale):
    """Run the filt kernel's planar entry on CUDA planes ``[..., n]``."""
    global filt_launches
    n = re.shape[-1]
    re, im = re.contiguous(), im.contiguous()
    out = (torch.empty_like(re), torch.empty_like(im))
    rows = re.numel() // n
    if rows == 0:
        return out
    build.launch("filt_fft", "filt_fft_f32", [_P] * 7 + [_LL, _I, _I, _F, _P], re.device,
                 re.data_ptr(), im.data_ptr(), hr.data_ptr(), hi.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(),
                 _twiddle_table(n, sign, re.device, _pass_roots_np).data_ptr(), rows,
                 n.bit_length() - 1, sign, _scale_arg(scale), _stream(re),
                 what=f"filt_fft_f32 launch failed (n={n}, rows={rows})")
    filt_launches += 1
    return out


def _filt_launch_c64(x, h, sign, scale, out=None):
    """Run the filt kernel's complex64 entry on a CUDA complex64 ``[...,
    n_in]`` tensor and the complex64 filter row h ``[n]``, n >= n_in (points
    past n_in are zero): complex64 ``[..., n]``.  ``out`` (contiguous, of
    the output's shape) may be x itself when n_in = n: a block reads its
    whole row before it stores any of it."""
    global filt_launches, filt_c64_launches
    n, n_in = h.shape[-1], x.shape[-1]
    x = x.resolve_conj().contiguous()
    h = h.resolve_conj().contiguous()
    if out is None:
        out = x.new_empty((*x.shape[:-1], n))
    rows = x.numel() // n_in
    if rows == 0:
        return out
    build.launch("filt_fft", "filt_fft_c64", [_P] * 4 + [_LL, _I, _I, _I, _F, _P], x.device,
                 x.data_ptr(), h.data_ptr(), out.data_ptr(),
                 _twiddle_table(n, sign, x.device, _pass_roots_np).data_ptr(), rows,
                 n.bit_length() - 1, n_in, sign, _scale_arg(scale), _stream(x),
                 what=f"filt_fft_c64 launch failed (n={n}, n_in={n_in}, rows={rows})")
    filt_launches += 1
    filt_c64_launches += 1
    return out


def _filt(re, im, hr, hi, sign, scale):
    if re.device.type == "cuda":
        return _filt_launch(re, im, hr, hi, sign, scale)
    if re.device.type != "cpu":
        raise ValueError(f"no filtered FFT for device {re.device}")
    return fft_filtered_split_reference(re, im, hr, hi, sign, scale)


def _filt_c64(x, h, sign, scale):
    if x.device.type == "cuda":
        return _filt_launch_c64(x, h, sign, scale)
    if x.device.type != "cpu":
        raise ValueError(f"no filtered FFT for device {x.device}")
    return fft_filtered_c64_reference(x, h, sign, scale)


class _Filtered(torch.autograd.Function):
    """y = scale * FFT_sign(h * x), linear in x with h constant.  Adjoint:
    conj(h) * (scale * FFT_{-sign}(ct)), the row kernel with the sign
    flipped and a multiply (the JAX package's transpose rule)."""

    @staticmethod
    def forward(ctx, re, im, hr, hi, sign, scale):
        ctx.save_for_backward(hr, hi)
        ctx.sign, ctx.scale = sign, scale
        return _filt(re, im, hr, hi, sign, scale)

    @staticmethod
    def backward(ctx, gr, gi):
        hr, hi = ctx.saved_tensors
        ar, ai = _transform(gr.contiguous(), gi.contiguous(), -ctx.sign, ctx.scale)
        return ar * hr + ai * hi, ai * hr - ar * hi, None, None, None, None


class _FilteredC64(torch.autograd.Function):
    """The complex64 form of :class:`_Filtered`, x zero past its n_in
    points: the adjoint conj(h) * (scale * FFT_{-sign}(ct)) through the row
    kernel's complex64 entry, cut to the first n_in points."""

    @staticmethod
    def forward(ctx, x, h, sign, scale):
        ctx.save_for_backward(h)
        ctx.sign, ctx.scale, ctx.n_in = sign, scale, x.shape[-1]
        return _filt_c64(x, h, sign, scale)

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        a = _transform_c64(g, -ctx.sign, ctx.scale)[..., :ctx.n_in]
        return a * h[:ctx.n_in].conj(), None, None, None


def fft_filtered_split(re, im, hr, hi, sign, scale=None):
    """Batched FFT over the last axis with the filter multiply fused into
    the loads: ``scale * FFT_sign(h * x)``, planar float32 ``[..., n]``
    with h ``[n]`` (a numpy array or tensor) broadcast over the rows; pow2
    n in 128..16384.  Differentiable in (re, im); h is a constant."""
    n = re.shape[-1]
    _check_envelope(n)
    _check_sign(sign)
    _check_planes(re, im)
    hr, hi = (_table(t, n, re.device, w) for t, w in ((hr, "hr"), (hi, "hi")))
    return _Filtered.apply(re, im, hr, hi, sign, scale)


def fft_filtered_split_reference(re, im, hr, hi, sign, scale=None):
    """Plain torch version of :func:`fft_filtered_split`: the multiply,
    then :func:`fft_batched_split_reference`."""
    n = re.shape[-1]
    _check_envelope(n)
    hr, hi = (_table(t, n, re.device, w) for t, w in ((hr, "hr"), (hi, "hi")))
    return fft_batched_split_reference(*_cmul(re, im, hr, hi), sign, scale)


def _filter_row(x, h, n_in):
    """Check a complex64 ``[..., n_in]`` x and the filter row h of length n
    (pow2 in 128..16384, n >= n_in); h as one complex64 tensor on x's
    device (a complex64 tensor there as it is, anything else converted)."""
    _check_c64(x)
    h = torch.as_tensor(h, dtype=torch.complex64, device=x.device)
    n = h.shape[-1] if h.ndim == 1 else 0
    _check_envelope(n)
    if n_in is not None and n_in != x.shape[-1]:
        raise ValueError(f"n_in={n_in} != the input's last axis {x.shape[-1]}")
    if not 1 <= x.shape[-1] <= n:
        raise Unsupported(f"input rows of {x.shape[-1]} points for a filter of n={n}: "
                          f"the kernel takes 1 <= n_in <= n")
    return h


def fft_filtered_c64(x, h, sign, scale=None, *, n_in=None):
    """:func:`fft_filtered_split` on a complex64 ``[..., n_in]`` tensor as
    it lies, zero past its n_in points: ``scale * FFT_sign(h * pad(x, n))``,
    complex64 ``[..., n]``, with h ``[n]`` one complex row (a complex64
    tensor, read as it lies, or an array), 1 <= n_in <= n (n_in =
    x.shape[-1]; when given it must be that).  On the card the filtered row kernel's complex64 entry, one
    launch, no split and no merge (hilbert's inverse reads the R2C half
    spectrum of n/2 + 1 bins as it lies).  Differentiable in x; h is a
    constant."""
    h = _filter_row(x, h, n_in)
    _check_sign(sign)
    return _FilteredC64.apply(x, h, sign, scale)


def fft_filtered_c64_reference(x, h, sign, scale=None, *, n_in=None):
    """Plain torch version of :func:`fft_filtered_c64`: the zero pad and the
    multiply, then :func:`fft_batched_c64_reference`."""
    h = _filter_row(x, h, n_in)
    xp = torch.nn.functional.pad(x, (0, h.shape[-1] - x.shape[-1]))
    return fft_batched_c64_reference(xp * h, sign, scale)


def _filt_passes(x, h, sign, scale=None):
    """Plain torch version of the filt kernel's own passes on a complex
    ``[..., n_in]`` x and a complex filter row h: the zero pad to n = h's
    length and the multiply, the fixed passes of :func:`_mixed_radix_plan`(n)
    on the kernel's pass roots (``_pass_roots_np``), then the scale.  No
    CUDA path calls it."""
    n = h.shape[-1]
    z = torch.nn.functional.pad(x, (0, n - x.shape[-1])) * h
    tab = _twiddle_table(n, sign, x.device, _pass_roots_np)
    y = _fixed_passes(z, sign, torch.complex(tab[:, 0], tab[:, 1]), _mixed_radix_plan(n))
    return y * _scale_arg(scale)


def _bank_passes(re, im, hr, hi, sign, scale=None):
    """Plain torch version of the bank entry's own passes: x ``[n]`` times
    every row of the bank h ``[S, n]``, then :func:`_filt_passes`' passes
    (complex ``[S, n]``).  No CUDA path calls it."""
    return _filt_passes(torch.complex(re, im), torch.complex(hr, hi), sign, scale)


def _check_bank(re, hr) -> None:
    n = re.shape[-1]
    _check_envelope(n)
    if re.ndim != 1 or np.ndim(hr) != 2 or np.shape(hr)[-1] != n:
        raise Unsupported(f"the bank kernel takes x [n] and h [S, n], got "
                          f"{tuple(re.shape)} and {tuple(np.shape(hr))}")


def _bank(re, im, hr, hi, sign, scale):
    global bank_launches
    if re.device.type == "cuda":
        out, launched = _bank_kernel(re, im, hr, hi, sign, scale)
        bank_launches += launched
        return out
    if re.device.type != "cpu":
        raise ValueError(f"no filter-bank FFT for device {re.device}")
    return fft_bank_split_reference(re, im, hr, hi, sign, scale)


class _Bank(torch.autograd.Function):
    """y[s] = scale * FFT_sign(x * h[s]), linear in x with the bank h
    constant.  Adjoint: sum_s conj(h[s]) * (scale * FFT_{-sign}(ct[s])),
    the row kernel with the sign flipped, a multiply and a sum over the
    bank (the JAX package's transpose rule)."""

    @staticmethod
    def forward(ctx, re, im, hr, hi, sign, scale):
        ctx.save_for_backward(hr, hi)
        ctx.sign, ctx.scale = sign, scale
        return _bank(re, im, hr, hi, sign, scale)

    @staticmethod
    def backward(ctx, gr, gi):
        hr, hi = ctx.saved_tensors
        ar, ai = _transform(gr.contiguous(), gi.contiguous(), -ctx.sign, ctx.scale)
        return ((ar * hr + ai * hi).sum(0), (ai * hr - ar * hi).sum(0),
                None, None, None, None)


def fft_bank_split(re, im, hr, hi, sign, scale=None):
    """Filter-bank transform ``y[s] = scale * FFT_sign(x * h[s])``: one
    planar float32 signal ``[n]`` against a bank h ``[S, n]`` (numpy arrays
    or tensors), out ``[S, n]``, the multiply fused into the loads, so the
    signal is never materialised at ``[S, n]``; pow2 n in 128..16384.
    Differentiable in (re, im); the bank is a constant."""
    _check_bank(re, hr)
    _check_sign(sign)
    _check_planes(re, im)
    shape = np.shape(hr)
    hr, hi = (_table(t, shape, re.device, w) for t, w in ((hr, "hr"), (hi, "hi")))
    return _Bank.apply(re, im, hr, hi, sign, scale)


def fft_bank_split_reference(re, im, hr, hi, sign, scale=None):
    """Plain torch version of :func:`fft_bank_split`: the broadcast
    multiply, then :func:`fft_batched_split_reference` over the bank."""
    _check_bank(re, hr)
    shape = np.shape(hr)
    hr, hi = (_table(t, shape, re.device, w) for t, w in ((hr, "hr"), (hi, "hi")))
    return fft_batched_split_reference(*_cmul(re, im, hr, hi), sign, scale)
