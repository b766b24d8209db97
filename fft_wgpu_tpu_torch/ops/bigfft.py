"""Single-pass whole-row FFT: the port's counterpart of ``ops/bigfft.py``.

A row of 2^15 .. 2^18 points is held on chip for the whole transform, so
device memory sees one read and one write per point and no
``[.., n] <-> [.., n1, n2]`` relayout.  On the TPU the row stays in VMEM; on
Hopper a row of 2^15 points (256 KB) is more than one block's 227 KB of
shared memory, so a thread-block cluster of 4, 8 or 16 blocks holds it
and exchanges through distributed shared memory (``csrc/big_fft.cu``): a
C-point butterfly over the blocks, each block's Q = n/C-point transform on
the compiled passes of ``csrc/mixed_fft.cuh``, and a store in natural order.
Two entry points: planar (re, im) float32 planes (:func:`fft_big_split`)
and complex64 as it lies (:func:`fft_big_c64`, the plan's route for a
complex64 tensor, with no split and no merge).

The envelope is Hopper's, not the v5e one: ``BIG_MAX_N`` is set by
16384 points (128 KB) per block times the cluster size, and the row count
plays no part in it, since every row is its own cluster.  A CUDA tensor in
the envelope launches the kernel, a CPU tensor runs the plain version
(:func:`fft_big_split_reference`), and a shape outside it raises
:class:`Unsupported` on either device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import twiddle as _tw
from ..utils import build
from . import cuda_fft, stockham
from .cuda_fft import Unsupported, _P, _I, _LL, _F

__all__ = ["fft_big_split", "fft_big_split_reference", "fft_big_c64",
           "fft_big_c64_reference", "BIG_MIN_N", "BIG_MAX_N", "Unsupported"]

BIG_MIN_N = 1 << 15  # below: the row kernel holds the row in one block
BIG_MAX_N = 1 << 18  # 16 blocks of 16384 points, the largest cluster

# Launches of the big_fft kernel, and of them those through its complex64
# entry (fft_big_c64); callers may reset them to 0.
launches = 0
c64_launches = 0


def _cluster(n: int) -> int:
    """Blocks per row: 4 at 2^15 and 8 (the portable cluster size) at 2^16
    and 2^17, so a block holds 8192 or 16384 points (at 2^15, 4 blocks of
    8192 ran 11% faster than 8 of 4096 on an H100,
    ``scripts/time_pow2_variants.py``); 16 at 2^18."""
    if n <= 1 << 15:
        return 4
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


def _big_roots_np(n: int, sign: int):
    """The big_fft kernel's twiddle table for n = C*Q points
    (C = :func:`_cluster`), pairs of float32 values of the f64 roots
    w_n^e = exp(sign*2pi*i*e/n): the lane roots w_n^(l*k1) as [C][32]
    (l < 32, k1 < C), the warp roots w_n^(32*m) (m < n/32), then each
    pass's roots of Q's compiled plan (:func:`cuda_fft._pass_roots_np`).
    Step 3's twiddle w_n^(q*k1) is the warp root of m = (q // 32) * k1
    times the lane root of (q mod 32, k1)."""
    c = _cluster(n)
    cos, sin = _tw.roots_np(n, sign)
    idx = np.concatenate([(np.arange(c)[:, None] * np.arange(32)).ravel(),
                          32 * np.arange(n // 32)])
    pc, ps = cuda_fft._pass_roots_np(n // c, sign)
    return np.concatenate([cos[idx], pc]), np.concatenate([sin[idx], ps])


def _launch_args(n: int, sign: int, device):
    tw = cuda_fft._twiddle_table(n, sign, device, _big_roots_np)
    return tw.data_ptr(), n.bit_length() - 1, _cluster(n).bit_length() - 1


def _launch(re, im, sign, scale):
    """Run the big_fft kernel on CUDA planes."""
    global launches
    n = re.shape[-1]
    re, im = re.contiguous(), im.contiguous()
    out = (torch.empty_like(re), torch.empty_like(im))  # 16-byte aligned
    rows = _rows(re)
    if rows == 0:
        return out
    tw, log2n, log2c = _launch_args(n, sign, re.device)
    build.launch("big_fft", "big_fft_f32", [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _F, _P],
                 re.device, re.data_ptr(), im.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), tw, rows, log2n, log2c, sign,
                 cuda_fft._scale_arg(scale), cuda_fft._stream(re),
                 what=f"big_fft launch failed (n={n}, rows={rows})")
    launches += 1
    return out


def _launch_c64(x, sign, scale):
    """Run the big_fft kernel on a CUDA complex64 tensor."""
    global launches, c64_launches
    n = x.shape[-1]
    x = x.resolve_conj().contiguous()
    out = torch.empty_like(x)  # 16-byte aligned
    rows = _rows(x)
    if rows == 0:
        return out
    tw, log2n, log2c = _launch_args(n, sign, x.device)
    build.launch("big_fft", "big_fft_c64", [_P, _P, _P, _LL, _I, _I, _I, _F, _P], x.device,
                 x.data_ptr(), out.data_ptr(), tw, rows, log2n, log2c, sign,
                 cuda_fft._scale_arg(scale), cuda_fft._stream(x),
                 what=f"big_fft launch failed (n={n}, rows={rows})")
    launches += 1
    c64_launches += 1
    return out


def _transform(re, im, sign, scale):
    if re.device.type == "cuda":
        return _launch(re, im, sign, scale)
    if re.device.type != "cpu":
        raise ValueError(f"no whole-row FFT for device {re.device}")
    return fft_big_split_reference(re, im, sign, scale)


def _transform_c64(x, sign, scale):
    if x.device.type == "cuda":
        return _launch_c64(x, sign, scale)
    if x.device.type != "cpu":
        raise ValueError(f"no whole-row FFT for device {x.device}")
    return fft_big_c64_reference(x, sign, scale)


def fft_big_split(re, im, sign, scale=None):
    """Whole-row FFT over the last axis of planar float32 ``[..., n]``,
    pow2 n in ``BIG_MIN_N..BIG_MAX_N``, natural order, flat in and out.

    sign: -1 forward / +1 inverse; scale folded into the store.
    Differentiable (the backward is the sign-flipped transform)."""
    _check_envelope(re.shape[-1], _rows(re))
    cuda_fft._check_sign(sign)
    cuda_fft._check_planes(re, im)
    return cuda_fft._SignFlipped.apply(_transform, sign, scale, re, im)


def fft_big_split_reference(re, im, sign, scale=None):
    """Plain torch version of :func:`fft_big_split`: the mixed-radix path
    plus the scale.  Raises :class:`Unsupported` for the same shapes as the
    kernel."""
    _check_envelope(re.shape[-1], _rows(re))
    re, im = stockham.fft_last_axis(re, im, sign)
    return stockham.apply_scale(re, im, scale)


def fft_big_c64(x, sign, scale=None):
    """:func:`fft_big_split` on a complex64 ``[..., n]`` tensor as it lies
    (interleaved (re, im) pairs; a non-contiguous one is copied first),
    with no split and no merge: on the card the kernel's interleaved entry.
    Differentiable (the backward is the sign-flipped transform)."""
    cuda_fft._check_c64(x)
    _check_envelope(x.shape[-1], _rows(x))
    cuda_fft._check_sign(sign)
    return cuda_fft._SignFlipped.apply(_transform_c64, sign, scale, x)


def fft_big_c64_reference(x, sign, scale=None):
    """Plain torch version of :func:`fft_big_c64`: the plain version of the
    planar entry on the two planes."""
    cuda_fft._check_c64(x)
    return torch.complex(*fft_big_split_reference(x.real, x.imag, sign, scale))


def _big_passes(re, im, sign, scale=None):
    """Plain torch model of the big_fft kernel's own decomposition on the
    tables it reads: with C = :func:`_cluster`(n) blocks of Q = n/C points,
    step 3's C-point DFT over x[c*Q + q] (an f64-generated matrix) times
    the table twiddle w_n^(q*k1) (warp root times lane root of
    :func:`_big_roots_np`), step 5's Q-point passes of Q's compiled plan
    (:func:`cuda_fft._fixed_passes` on the table's pass roots), step 7's
    order X[C*pos + c] = Z[c, pos], and the scale.  No CUDA path calls it."""
    n = re.shape[-1]
    c, q = _cluster(n), n // _cluster(n)
    cos, sin = (torch.from_numpy(t).to(re.device) for t in _big_roots_np(n, sign))
    tab = torch.complex(cos, sin)
    x = torch.complex(re, im).reshape(*re.shape[:-1], c, q)
    wr, wi = cuda_fft._butterfly_matrix(c, sign, re.device)
    y = torch.complex(wr, wi) @ x  # [k1, q]: the C-point DFT over c
    k1 = torch.arange(c, device=re.device)[:, None]
    pos = torch.arange(q, device=re.device)[None, :]
    y = y * (tab[c * 32 + (pos // 32) * k1] * tab[k1 * 32 + pos % 32])
    z = cuda_fft._fixed_passes(y, sign, tab[c * 32 + n // 32:],
                               cuda_fft._mixed_radix_plan(q))
    x = z.transpose(-1, -2).reshape(*re.shape[:-1], n)
    return stockham.apply_scale(x.real.contiguous(), x.imag.contiguous(), scale)
