"""Single-pass whole-row FFT: the port's counterpart of ``ops/bigfft.py``.

A row of 2^15 .. 2^18 points is held on chip for the whole transform, so
device memory sees one read and one write per point and no
``[.., n] <-> [.., n1, n2]`` relayout.  On the TPU the row stays in VMEM; on
Hopper a row of 2^15 points (256 KB) is more than one block's 227 KB of
shared memory, so a thread-block cluster of 4, 8 or 16 blocks holds it
(``csrc/big_fft.cu``): each block the Q = n/C-point transform of its
decimated row x[q*C + b] on the compiled passes of ``csrc/mixed_fft.cuh``,
read from device memory at stride C, then a C-point butterfly across the
blocks through distributed shared memory and a store in natural order.
Two entry points: planar (re, im) float32 planes (:func:`fft_big_split`)
and complex64 as it lies (:func:`fft_big_c64`, the plan's route for a
complex64 tensor, with no split and no merge).

The envelope is Hopper's, not the v5e one: ``BIG_MAX_N`` is set by
16384 points (128 KB) per block times the cluster size, and the row count
plays no part in it, since every row is its own cluster.  A CUDA tensor in
the envelope launches the kernel, a CPU tensor runs the plain version
(:func:`fft_big_split_reference`), and a shape outside it raises
:class:`Unsupported` on either device.  Which row counts the static route
sends here is a rule of its own (:func:`takes`, the crossover to the
four-step's two passes measured on the card, as the JAX package's
``BATCHED_MAX_N`` was on a v5e).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import twiddle as _tw
from ..utils import build
from . import cuda_fft, stockham
from .cuda_fft import Unsupported, _P, _I, _LL, _F

__all__ = ["fft_big_split", "fft_big_split_reference", "fft_big_c64",
           "fft_big_c64_reference", "takes", "BIG_MIN_N", "BIG_MAX_N", "TWO_PASS_FROM",
           "Unsupported"]

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


# The static route's crossover (``"auto"`` and ``"fourstep"``), the
# counterpart of the JAX package's BATCHED_MAX_N: from this many rows of n
# points on, the four-step's two passes (the axis(-2) kernel then the
# transposed-rows kernel) are taken instead, through the planar entries
# (key (n, False)) or the complex64 ones ((n, True)); below it, and at any
# n and layout not listed, this kernel.  Each is the fewest rows measured
# at which the two passes' slowest round beat this kernel's fastest, by
# scripts/tune_large_rows.py (the tuner's timer, rows 1 .. 1024, two
# rounds) on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6):
# complex64 2^17 at 128 rows 0.2194 ms against 0.2309; 2^18 at 64 rows
# 0.2370-0.2383 against 0.3482-0.3503 planar, complex64 at 32 rows
# 0.1236-0.1304 against 0.1767-0.1768.  Planar 2^17 never crossed (256
# rows: 0.4283-0.4513 against 0.4482-0.4503), nor did 2^15 or 2^16.
TWO_PASS_FROM: dict[tuple[int, bool], int] = {
    (1 << 17, True): 128, (1 << 18, False): 64, (1 << 18, True): 32}


def takes(n: int, rows: int, c64: bool = False) -> bool:
    """Whether the static route sends ``rows`` rows of length n (complex64
    with ``c64``, else planar) to this kernel: inside its envelope and below
    :data:`TWO_PASS_FROM`'s crossover.  A route rule, not the envelope:
    ``executor="bigfft"``, the tuner and the kernel's own entry points take
    every row count that :func:`_supported` takes."""
    return _supported(n, rows) and rows < TWO_PASS_FROM.get((n, bool(c64)), 2 ** 31)


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
    w_n^e = exp(sign*2pi*i*e/n): the lane roots w_n^(l*c) as [C][32]
    (l < 32, c < C), the warp roots w_n^(32*m) (m < n/32), then each
    pass's roots of Q's compiled plan (:func:`cuda_fft._pass_roots_np`).
    The butterfly step's twiddle w_n^(c*k2) is the warp root of
    m = (k2 // 32) * c times the lane root of (k2 mod 32, c)."""
    c = _cluster(n)
    cos, sin = _tw.roots_np(n, sign)
    idx = np.concatenate([(np.arange(c)[:, None] * np.arange(32)).ravel(),
                          32 * np.arange(n // 32)])
    pc, ps = cuda_fft._pass_roots_np(n // c, sign)
    return np.concatenate([cos[idx], pc]), np.concatenate([sin[idx], ps])


def _launch_args(n: int, sign: int, device):
    tw = cuda_fft._twiddle_table(n, sign, device, _big_roots_np)
    return tw.data_ptr(), n.bit_length() - 1, _cluster(n).bit_length() - 1


def _max_clusters(n: int, c64: bool, device) -> int:
    """How many of the kernel's clusters for rows of n points (its planar
    entry's, or with ``c64`` its complex64 entry's) fit on the CUDA
    ``device`` at once (``cudaOccupancyMaxActiveClusters``)."""
    import ctypes

    _check_envelope(n, 1)
    count = ctypes.c_int()
    build.launch("big_fft", "big_fft_max_clusters", [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
                 device, n.bit_length() - 1, _cluster(n).bit_length() - 1, int(c64),
                 ctypes.byref(count), what=f"big_fft cluster occupancy (n={n})")
    return count.value


def _launch(re, im, sign, scale):
    """Run the big_fft kernel on CUDA planes."""
    global launches
    n = re.shape[-1]
    re, im = re.contiguous(), im.contiguous()
    out = (torch.empty_like(re), torch.empty_like(im))
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
    out = torch.empty_like(x)
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
    tables it reads, with C = :func:`_cluster`(n) blocks of Q = n/C points:
    each block's Q-point passes of Q's compiled plan
    (:func:`cuda_fft._fixed_passes` on the table's pass roots) over the
    decimated row x[q*C + b], the table twiddle w_n^(b*k2) (warp root times
    lane root of :func:`_big_roots_np`), the C-point DFT over the blocks
    (an f64-generated matrix), the order X[k2 + Q*k1], and the scale.  No
    CUDA path calls it."""
    n = re.shape[-1]
    c, q = _cluster(n), n // _cluster(n)
    cos, sin = (torch.from_numpy(t).to(re.device) for t in _big_roots_np(n, sign))
    tab = torch.complex(cos, sin)
    x = torch.complex(re, im).reshape(*re.shape[:-1], q, c).transpose(-1, -2)  # [b, q]
    y = cuda_fft._fixed_passes(x, sign, tab[c * 32 + n // 32:], cuda_fft._mixed_radix_plan(q))
    b = torch.arange(c, device=re.device)[:, None]
    k2 = torch.arange(q, device=re.device)[None, :]
    y = y * (tab[c * 32 + (k2 // 32) * b] * tab[b * 32 + k2 % 32])
    wr, wi = cuda_fft._butterfly_matrix(c, sign, re.device)
    z = torch.complex(wr, wi) @ y  # [k1, k2]: the C-point DFT over b
    x = z.reshape(*re.shape[:-1], n)
    return stockham.apply_scale(x.real.contiguous(), x.imag.contiguous(), scale)
