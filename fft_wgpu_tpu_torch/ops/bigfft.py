"""Single-pass whole-row FFT: the port's counterpart of ``ops/bigfft.py``.

A row of 2^15 .. 2^18 points is held on chip for the whole transform, so
device memory sees one read and one write per point and no
``[.., n] <-> [.., n1, n2]`` relayout.  On the TPU the row stays in VMEM; on
Hopper a row of 2^15 points (256 KB) is more than one block's 227 KB of
shared memory, so a thread-block cluster of 8 blocks (16 at 2^18) holds it
and exchanges through distributed shared memory (``csrc/big_fft.cu``).

The envelope is Hopper's, not the v5e one: ``BIG_MAX_N`` is set by
16384 points (128 KB) per block times the cluster size, and the row count
plays no part in it, since every row is its own cluster.  A CUDA tensor in
the envelope launches the kernel, a CPU tensor runs the plain version
(:func:`fft_big_split_reference`), and a shape outside it raises
:class:`Unsupported` on either device.
"""

from __future__ import annotations

import torch

from ..utils import build
from . import cuda_fft, stockham
from .cuda_fft import Unsupported, _P, _I, _LL, _F

__all__ = ["fft_big_split", "fft_big_split_reference", "BIG_MIN_N",
           "BIG_MAX_N", "Unsupported"]

BIG_MIN_N = 1 << 15  # below: the row kernel holds the row in one block
BIG_MAX_N = 1 << 18  # 16 blocks of 16384 points, the largest cluster

# Launches of the big_fft kernel; callers may reset it to 0.
launches = 0


def _cluster(n: int) -> int:
    """Blocks per row: 8 (the portable cluster size) up to 2^17, 16 above."""
    return 8 if n <= 1 << 17 else 16


def _supported(n: int, rows: int = 1) -> bool:
    if n < BIG_MIN_N or n > BIG_MAX_N or n & (n - 1):
        return False
    return rows * _cluster(n) < 2 ** 31  # the grid's x extent


def _check_envelope(n: int, rows: int) -> None:
    if not _supported(n, rows):
        raise Unsupported(f"n={n} x {rows} rows outside the whole-row kernel "
                          f"envelope (pow2 {BIG_MIN_N}..{BIG_MAX_N})")


def _rows(re) -> int:
    n = re.shape[-1]
    return re.numel() // n if n else 0


def _launch(re, im, sign, scale):
    """Run the big_fft kernel on CUDA tensors."""
    global launches
    n = re.shape[-1]
    re, im = re.contiguous(), im.contiguous()
    out = (torch.empty_like(re), torch.empty_like(im))
    rows = _rows(re)
    if rows == 0:
        return out
    tw = cuda_fft._twiddle_table(n, sign, re.device)
    build.launch("big_fft", "big_fft_f32", [_P, _P, _P, _P, _P, _LL, _I, _I, _F, _P],
                 re.device, re.data_ptr(), im.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), tw.data_ptr(), rows, n.bit_length() - 1, sign,
                 cuda_fft._scale_arg(scale), cuda_fft._stream(re),
                 what=f"big_fft launch failed (n={n}, rows={rows})")
    launches += 1
    return out


def _transform(re, im, sign, scale):
    if re.device.type == "cuda":
        return _launch(re, im, sign, scale)
    if re.device.type != "cpu":
        raise ValueError(f"no whole-row FFT for device {re.device}")
    return fft_big_split_reference(re, im, sign, scale)


def fft_big_split(re, im, sign, scale=None):
    """Whole-row FFT over the last axis of planar float32 ``[..., n]``,
    pow2 n in ``BIG_MIN_N..BIG_MAX_N``, natural order, flat in and out.

    sign: -1 forward / +1 inverse; scale folded into the store.
    Differentiable (the backward is the sign-flipped transform)."""
    _check_envelope(re.shape[-1], _rows(re))
    cuda_fft._check_sign(sign)
    cuda_fft._check_planes(re, im)
    return cuda_fft._SignFlipped.apply(_transform, re, im, sign, scale)


def fft_big_split_reference(re, im, sign, scale=None):
    """Plain torch version of :func:`fft_big_split`: the mixed-radix path
    plus the scale.  Raises :class:`Unsupported` for the same shapes as the
    kernel."""
    _check_envelope(re.shape[-1], _rows(re))
    re, im = stockham.fft_last_axis(re, im, sign)
    return stockham.apply_scale(re, im, scale)
