"""Fused segment-spectrum kernels on Hopper: the port's counterpart of
``ops/pallas_welch.py``, all seven of its entry points.

* ``welch_accum_split`` (B16) — sum over segments of |RFFT(w * frame)|^2;
* ``spec_psd_split`` (B19) — the per-segment powers;
* ``csd_accum_split`` (B17) — sum over segments of conj(X) * Y;
* ``coherence_accum_split`` (B18) — conj(X) * Y, |X|^2 and |Y|^2 summed in
  one sweep;
* ``welch_accum_c2c_split`` / ``welch_accum_c2c_c64`` (B21) — sum over
  segments of |FFT(w * frame)|^2 of a complex signal, all nfft bins, from
  planes or from the complex64 signal as it lies;
* ``spec_rfft_split`` / ``spec_rfft_c64`` (B20) — the per-segment half
  spectra of a real signal, as planes (ragged or in the padded serving
  form) or as one complex64 tensor, each padded frame optionally rolled
  left (ShortTimeFFT's phase shift);
* ``spec_c2c_split`` / ``spec_c2c_c64`` (B22) — the per-segment two-sided
  spectra of a complex signal (or of a real one taken two-sided), as
  planes or as one complex64 tensor, from planes or from the complex64
  signal as it lies.

A frame is ``nperseg`` points of a ``[..., t]`` signal at hop ``hop``,
less its mean when ``detrend == "constant"`` (each plane of a complex
signal on its own), times the window, zero-padded to ``nfft``.  B16, B17,
B18 and B21 run in ``csrc/welch_acc_fft.cu`` on ``mixed_fft.cuh``'s
compiled pow2 passes: two real frames transformed as one complex frame
(B16: frames 2p and 2p + 1 of a row, or at nfft 8192 and 16384 B20's
half-length transform of each frame; B17 and B18: segment s of x and of
y), the two spectra separated per bin, or (B21) one complex frame a
segment, and their sums kept per thread; each block writes one row of its
sums, which ``torch.sum`` adds in a fixed order (the library's
``welch_acc_shape`` sizes the grid; ``_acc_passes`` is the plain version
of its passes and epilogue).  No kernel uses float atomics.  B20 runs in
``csrc/spec_fft.cu`` and B22 in ``csrc/spec_c2c_fft.cu``, both on
``mixed_fft.cuh``'s compiled pow2 passes, several segments a block, each
into a planar or a complex64 sink; B19 runs in ``spec_fft.cu`` too, two
segments as one complex frame (B16's design) on nfft's compiled plan, each
segment's powers stored (``_psd_passes`` is the plain version of its
passes and epilogue).

A CUDA tensor goes through the kernel, a CPU tensor through its plain
version (``*_reference``: ``_frame``, ``_detrend_seg``, the window, the
zero pad and roll, then ``rfft_rows_split_reference`` or, for complex
input, ``fft_batched_split_reference`` (``fft_batched_c64_reference``),
and the power or cross product, summed over segments).  There is no fallback between the two.  The JAX
kernels have no gradient; each entry point here is a
``torch.autograd.Function`` whose backward differentiates the composed
form, rebuilding the frames and running the R2C kernel (B6) or the row
kernel (B1; its complex64 entry for ``spec_c2c_c64`` and
``welch_accum_c2c_c64``), whose own backward
is the row kernel.

The envelope (:func:`fused_welch_ok`) is wider than the TPU's: the frame
is read with a stride, so any hop <= nperseg runs (the TPU's chunk view
needed hop | nperseg and nperseg/hop <= 8), and nfft starts at 128, B6's
floor, not 512.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core.twiddle import FORWARD
from ..utils import build
from . import cuda_fft
from .cuda_fft import FUSED_MAX_N, FUSED_MIN_N, Unsupported
from .stft import _frame, _reflect_pad

__all__ = ["Unsupported", "fused_welch_ok", "welch_accum_split",
           "welch_accum_split_reference", "spec_psd_split", "spec_psd_split_reference",
           "csd_accum_split", "csd_accum_split_reference", "coherence_accum_split",
           "coherence_accum_split_reference", "welch_accum_c2c_split",
           "welch_accum_c2c_split_reference", "welch_accum_c2c_c64",
           "welch_accum_c2c_c64_reference", "spec_rfft_split",
           "spec_rfft_split_reference", "spec_rfft_c64", "spec_rfft_c64_reference",
           "spec_c2c_split", "spec_c2c_split_reference", "spec_c2c_c64",
           "spec_c2c_c64_reference"]

# Launches of each kernel (B16, B19, B17, B18, B21, B20, B22); callers may
# reset them to 0.  ``psd_launches`` counts B19's launches (spec_fft's
# psd_pairs kernel, not counted in ``spec_launches``); ``c2c_launches``
# counts every launch of B21, ``c2c_c64_launches`` those of them through
# its complex64 entry point (``welch_accum_c2c_c64``); ``spec_launches``
# counts every launch of B20,
# ``spec_c64_launches`` those of them into its complex64 sink; so do
# ``spec_c2c_launches`` and ``spec_c2c_c64_launches`` for B22.
welch_launches = 0
psd_launches = 0
csd_launches = 0
coh_launches = 0
c2c_launches = 0
c2c_c64_launches = 0
spec_launches = 0
spec_c64_launches = 0
spec_c2c_launches = 0
spec_c2c_c64_launches = 0

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# welch_acc_fft.cu's kinds (B16, B18, B17, B21; B21's complex64 entry point
# "c2c_c64"): kind -> (its number in welch_acc_f32 and welch_acc_shape,
# output planes, and whether they hold all nfft bins or nfft/2 + 1)
_ACC = {"welch": (0, 1, False), "coh": (1, 4, False), "csd": (2, 2, False),
        "c2c": (3, 1, True), "c2c_c64": (3, 1, True)}
_ACC_ARGTYPES = [_I] + [_P] * 10 + [_LL, _LL] + [_I] * 7 + [_P]
_ACC_C64_ARGTYPES = [_P] * 4 + [_LL, _LL] + [_I] * 7 + [_P]
_ACC_SHAPE_ARGTYPES = [_I, _LL, _I, _I] + [ctypes.POINTER(_I)] * 2
# kinds whose x and y are the planes of one complex signal (nfft bins; the
# complex64 entries "c2c_c64" and "spec_c2c_c64" take x complex64 too, or a
# real x with y its imaginary plane or None); B20 (spec_fft.cu) writes planes
# ("spec") or complex64 ("spec_c64"), B22 (spec_c2c_fft.cu) planes
# ("spec_c2c") or complex64 ("spec_c2c_c64")
_COMPLEX = ("c2c", "spec_c2c")
_C64_IN = ("c2c_c64", "spec_c2c_c64")
_SPEC = ("spec", "spec_c64")
_SPEC_C2C = ("spec_c2c", "spec_c2c_c64")


def fused_welch_ok(t: int, nperseg: int, hop: int, nfft: int, detrend) -> bool:
    """Envelope of the seven kernels (B1's and B6's range, for real and
    complex input alike): nfft a power of two in 128..16384,
    1 <= nperseg <= nfft, 0 < hop <= nperseg, t >= nperseg, detrend False,
    None or "constant" (checked by identity, as the JAX package checks it,
    so that ``detrend=0`` stays outside)."""
    return (FUSED_MIN_N <= nfft <= FUSED_MAX_N and nfft & (nfft - 1) == 0
            and 1 <= nperseg <= nfft
            and 0 < hop <= nperseg
            and t >= nperseg
            and (detrend is False or detrend is None
                 or (isinstance(detrend, str) and detrend == "constant")))


def _check(x, y, win, nperseg, hop, nfft, detrend, roll_s=0, pad=0, c64_ok=False) -> int:
    """Validate the operands (x complex64 too where ``c64_ok``, then with no
    y); the segment count."""
    if not isinstance(x, torch.Tensor) or x.dtype not in (
            (torch.float32, torch.complex64) if c64_ok else (torch.float32,)):
        raise ValueError("x must be a real float32 tensor"
                         + (" or a complex64 one" if c64_ok else ""))
    if y is not None and (not isinstance(y, torch.Tensor) or y.dtype != torch.float32
                          or y.device != x.device or x.is_complex()):
        raise ValueError("y must be a real float32 tensor on x's device, beside a real x")
    if y is not None and y.shape != x.shape:
        raise Unsupported(f"the fused kernels take two signals (or planes) of one "
                          f"shape, got {tuple(x.shape)} and {tuple(y.shape)}")
    if (win.dtype != torch.float32 or win.shape != (nperseg,)
            or win.device != x.device):
        raise ValueError(f"win must be a float32 [{nperseg}] tensor on x's device")
    if not 0 <= pad < max(x.shape[-1], 1):
        raise ValueError(f"pad={pad} must lie in [0, t={x.shape[-1]})")
    t = x.shape[-1] + 2 * pad
    if not fused_welch_ok(t, nperseg, hop, nfft, detrend):
        raise Unsupported(f"outside the fused welch envelope (t={t}, nperseg={nperseg}, "
                          f"hop={hop}, nfft={nfft}, detrend={detrend!r})")
    if not 0 <= roll_s < nfft:
        raise ValueError(f"roll_s={roll_s} must lie in [0, nfft={nfft})")
    return 1 + (t - nperseg) // hop


# ---------------------------------------------------------------------- #
# the composed form: the plain versions and the backward
# ---------------------------------------------------------------------- #
def _frames(x, win, nperseg, hop, nfft, detrend, roll_s=0, pad=0):
    """Framed, detrended, windowed segments of x reflect-padded by ``pad``
    at both ends, zero-padded to nfft and rolled left by roll_s, ``[...,
    num, nfft]``."""
    # imported here: spectral_est imports this module
    from .spectral_est import _detrend_seg

    fr = _detrend_seg(_frame(_reflect_pad(x, pad) if pad else x, nperseg, hop), detrend) * win
    fr = torch.nn.functional.pad(fr, (0, nfft - nperseg))
    return torch.roll(fr, -roll_s, -1) if roll_s else fr


def _reduce(kind, X, Y):
    """The kernel's outputs from the per-segment spectra ``[..., num, bins]``."""
    if kind in ("spec", "spec_c2c"):
        return X
    if kind in ("spec_c64", "spec_c2c_c64"):
        return (X,)
    if kind == "c2c_c64":
        return ((X.real * X.real + X.imag * X.imag).sum(-2),)
    (xr, xi), p = X, lambda a, b: a * a + b * b
    if kind == "psd":
        return (p(xr, xi),)
    if kind in ("welch", "c2c"):
        return (p(xr, xi).sum(-2),)
    yr, yi = Y
    cross = ((xr * yr + xi * yi).sum(-2), (xr * yi - xi * yr).sum(-2))
    if kind == "csd":
        return cross
    return (*cross, p(xr, xi).sum(-2), p(yr, yi).sum(-2))


def _composed(kind, x, y, win, nperseg, hop, nfft, detrend, kernels: bool, roll_s=0,
              pad_out=False, scale=None, pad=0):
    """The kernel's function composed of framing and a transform per
    segment: through the R2C (or, for complex input, the row) kernel when
    ``kernels``, else through its plain version."""
    def frames(v):
        return _frames(v, win, nperseg, hop, nfft, detrend, roll_s, pad)

    if kind in _C64_IN:  # x complex64, or real with y its imaginary plane or None
        fft = cuda_fft.fft_batched_c64 if kernels else cuda_fft.fft_batched_c64_reference
        return _reduce(kind, fft(_complex_frames(x, y, frames), FORWARD, scale), None)
    if kind in _COMPLEX:  # x, y: the planes of one complex signal
        fft = cuda_fft.fft_batched_split if kernels else cuda_fft.fft_batched_split_reference
        return _reduce(kind, fft(frames(x), frames(y), FORWARD), None)
    if kind == "spec_c64":
        rfft = cuda_fft.rfft_rows_c64 if kernels else cuda_fft.rfft_rows_c64_reference
        return _reduce(kind, rfft(frames(x), scale), None)
    rfft = cuda_fft.rfft_rows_split if kernels else cuda_fft.rfft_rows_split_reference
    return _reduce(kind, rfft(frames(x), scale, pad_out=pad_out),
                   None if y is None else rfft(frames(y)))


def _complex_frames(x, y, frames):
    """The frames of a complex signal, complex64: of x complex64, or of the
    planes x and y (None: a zero plane), each plane framed and detrended on
    its own."""
    if x.is_complex():
        return torch.complex(frames(x.real), frames(x.imag))
    fr = frames(x)
    return torch.complex(fr, frames(y) if y is not None else torch.zeros_like(fr))


def _spec_c2c_passes(x, y, win, nperseg, hop, nfft, detrend, scale=None):
    """Plain torch version of the spec_c2c_fft kernel's own passes (B22):
    the complex frames (:func:`_complex_frames`), the fixed passes of
    ``cuda_fft._mixed_radix_plan``(nfft) on the kernel's pass roots, then
    the scale: complex ``[..., num, nfft]``.  No CUDA path calls it."""
    z = _complex_frames(x, y, lambda v: _frames(v, win, nperseg, hop, nfft, detrend))
    tab = cuda_fft._twiddle_table(nfft, FORWARD, x.device, cuda_fft._pass_roots_np)
    Z = cuda_fft._fixed_passes(z, FORWARD, torch.complex(tab[:, 0], tab[:, 1]),
                               cuda_fft._mixed_radix_plan(nfft))
    return Z * cuda_fft._scale_arg(scale)


def _spec_passes(x, win, nperseg, hop, nfft, detrend, roll_s=0, scale=None, pad=0):
    """Plain torch version of the spec_fft kernel's own passes (B20): the
    frames as m = nfft/2 complex points z[k] = f[2k] + i f[2k+1], the fixed
    passes of ``cuda_fft._mixed_radix_plan``(m) on the kernel's pass roots,
    then the recombination of bins 0..m from Z[k] and Z[m-k] and the scale:
    complex ``[..., num, m + 1]``.  No CUDA path calls it."""
    m = nfft // 2
    fr = _frames(x, win, nperseg, hop, nfft, detrend, roll_s, pad)
    z = torch.complex(fr[..., 0::2], fr[..., 1::2])
    tab = cuda_fft._twiddle_table(m, FORWARD, x.device, cuda_fft._pass_roots_np)
    Z = cuda_fft._fixed_passes(z, FORWARD, torch.complex(tab[:, 0], tab[:, 1]),
                               cuda_fft._mixed_radix_plan(m))
    return torch.complex(*cuda_fft._r2c_unpack(Z.real, Z.imag, nfft, scale))


def _psd_passes(x, win, nperseg, hop, nfft, detrend):
    """Plain torch version of spec_fft's B19 kernel's passes and epilogue:
    segments 2p and 2p + 1 as one complex frame z = a + i b (an odd count's
    last with a zero plane), the fixed passes of
    ``cuda_fft._mixed_radix_plan``(nfft) on the kernel's pass roots, and per
    bin k = 0..nfft/2, A = Z[k] and C = Z[(nfft - k) mod nfft],
    |FFT(a)|^2 = |A + conj C|^2/4 and |FFT(b)|^2 = |A - conj C|^2/4 to rows
    2p and 2p + 1: ``[..., num, nfft/2 + 1]``.  No CUDA path calls it."""
    fx = _frames(x, win, nperseg, hop, nfft, detrend)
    num = fx.shape[-2]
    if num % 2:
        fx = torch.cat([fx, torch.zeros_like(fx[..., :1, :])], -2)
    z = torch.complex(fx[..., 0::2, :], fx[..., 1::2, :])
    tab = cuda_fft._twiddle_table(nfft, FORWARD, x.device, cuda_fft._pass_roots_np)
    Z = cuda_fft._fixed_passes(z, FORWARD, torch.complex(tab[:, 0], tab[:, 1]),
                               cuda_fft._mixed_radix_plan(nfft))
    k = torch.arange(nfft // 2 + 1, device=x.device)
    A, C = Z[..., k], Z[..., (nfft - k) % nfft]
    pa = 0.25 * ((A.real + C.real) ** 2 + (A.imag - C.imag) ** 2)
    pb = 0.25 * ((A.imag + C.imag) ** 2 + (C.real - A.real) ** 2)
    P = torch.stack([pa, pb], -2).reshape(*Z.shape[:-2], -1, nfft // 2 + 1)
    return P[..., :num, :]


def _acc_passes(kind, x, y, win, nperseg, hop, nfft, detrend, half=False):
    """Plain torch version of the welch_acc_fft kernel's passes and
    epilogue (B16 ``"welch"``, B18 ``"coh"``, B17 ``"csd"``, B21 ``"c2c"``):
    the frames as the kernel makes them, two real frames a complex one z =
    a + i b (B16: frames 2p and 2p + 1 of a row, an odd count's last with a
    zero plane; B17, B18: segment s of x and of y, of y and of x for odd s),
    the fixed passes of ``cuda_fft._mixed_radix_plan``(nfft) on the
    kernel's pass roots, then per bin k = 0..nfft/2, A = Z[k] and B = conj
    Z[(nfft - k) mod nfft]: B16 sums (|A|^2 + |B|^2)/2 over the pairs; B17
    and B18 separate FFT(a) = (A + B)/2 and FFT(b) = (A - B)/(2i), X and Y
    or (odd s) Y and X, and sum Re and Im of conj(X) Y (B18: and |X|^2 and
    |Y|^2).  B21: one complex frame a segment (x complex64, or the planes x
    and y, None a zero plane: :func:`_spec_c2c_passes`), |Z|^2 summed over
    the segments at every bin.  With ``half``, B16's other design:
    :func:`_spec_passes`, B20's half-length transform of each frame, and
    |X|^2 summed over the segments (the source's kWelchHalf says at which
    nfft the kernel runs it; both designs compute one function).  The
    kernel's outputs; no CUDA path calls it."""
    def frames(v):
        return _frames(v, win, nperseg, hop, nfft, detrend)

    if kind == "welch" and half:
        X = _spec_passes(x, win, nperseg, hop, nfft, detrend)
        return ((X.real ** 2 + X.imag ** 2).sum(-2),)
    if kind == "c2c":
        Z = _spec_c2c_passes(x, y, win, nperseg, hop, nfft, detrend)
        return ((Z.real ** 2 + Z.imag ** 2).sum(-2),)
    fx = frames(x)
    if kind in ("coh", "csd"):  # odd segments swap the planes
        fy = frames(y)
        swap = (torch.arange(fx.shape[-2], device=x.device) % 2 == 1)[:, None]
        z = torch.complex(torch.where(swap, fy, fx), torch.where(swap, fx, fy))
    else:
        if fx.shape[-2] % 2:
            fx = torch.cat([fx, torch.zeros_like(fx[..., :1, :])], -2)
        z = torch.complex(fx[..., 0::2, :], fx[..., 1::2, :])
    tab = cuda_fft._twiddle_table(nfft, FORWARD, x.device, cuda_fft._pass_roots_np)
    Z = cuda_fft._fixed_passes(z, FORWARD, torch.complex(tab[:, 0], tab[:, 1]),
                               cuda_fft._mixed_radix_plan(nfft))
    k = torch.arange(nfft // 2 + 1, device=x.device)
    A, C = Z[..., k], Z[..., (nfft - k) % nfft]
    if kind == "welch":
        return ((0.5 * (A.real ** 2 + A.imag ** 2 + C.real ** 2 + C.imag ** 2)).sum(-2),)
    # FFT(a) = (A + conj C)/2, FFT(b) = (A - conj C)/(2i)
    fr, fi = 0.5 * (A.real + C.real), 0.5 * (A.imag - C.imag)
    hr, hi = 0.5 * (A.imag + C.imag), 0.5 * (C.real - A.real)
    im = fr * hi - fi * hr
    cross = ((fr * hr + fi * hi).sum(-2), torch.where(swap, -im, im).sum(-2))
    if kind == "csd":
        return cross
    pf, ph = fr * fr + fi * fi, hr * hr + hi * hi
    return (*cross, torch.where(swap, ph, pf).sum(-2), torch.where(swap, pf, ph).sum(-2))


# ---------------------------------------------------------------------- #
# the kernels
# ---------------------------------------------------------------------- #
@functools.lru_cache(maxsize=256)
def _acc_shape(number: int, batch: int, num: int, nfft: int, device) -> tuple[int, int]:
    """(rounds a block, blocks a row) of welch_acc_fft's kind ``number``,
    from the library (``welch_acc_shape``: one wave of the device's SMs at
    the kernel's occupancy); asked once per shape and device."""
    iters, tiles = _I(), _I()
    build.launch("welch_acc_fft", "welch_acc_shape", _ACC_SHAPE_ARGTYPES, device,
                 number, batch, num, nfft.bit_length() - 1, ctypes.byref(iters),
                 ctypes.byref(tiles), what=f"welch_acc_shape failed ({number}, nfft={nfft})")
    return iters.value, tiles.value


def _acc_launch(kind, x, y, win, nperseg, hop, nfft, detrend):
    """Run welch_acc_fft's kernel (B16 ``"welch"``, B18 ``"coh"``, B17
    ``"csd"``, B21 ``"c2c"`` and ``"c2c_c64"``: x complex64 read as it
    lies, or the planes x and y, None a zero plane) on CUDA tensors; the
    outputs ``[..., bins]`` (nfft/2 + 1, B21 nfft): one row a block, summed
    over a signal row's blocks by ``torch.sum`` where there are several."""
    global c2c_launches
    number, nout, full = _ACC[kind]
    lead, t = x.shape[:-1], x.shape[-1]
    batch = math.prod(lead)
    num = 1 + (t - nperseg) // hop
    bins = nfft if full else nfft // 2 + 1
    if batch == 0:
        return tuple(x.new_zeros((*lead, bins), dtype=torch.float32) for _ in range(nout))
    x = x.resolve_conj().contiguous()
    y = None if y is None else y.contiguous()
    iters, tiles = _acc_shape(number, batch, num, nfft, x.device)
    outs = list(torch.empty((nout, batch, tiles, bins), dtype=torch.float32,
                            device=x.device).unbind(0))
    tw = cuda_fft._twiddle_table(nfft, FORWARD, x.device, cuda_fft._pass_roots_np)
    args = (batch, t, nperseg, hop, num, nfft.bit_length() - 1, int(detrend == "constant"),
            iters, tiles, cuda_fft._stream(x))
    what = (f"welch_acc_fft launch failed ({kind}, batch={batch}, t={t}, nperseg={nperseg}, "
            f"hop={hop}, nfft={nfft})")
    if x.is_complex():
        build.launch("welch_acc_fft", "welch_acc_c64", _ACC_C64_ARGTYPES, x.device,
                     x.data_ptr(), win.contiguous().data_ptr(), outs[0].data_ptr(),
                     tw.data_ptr(), *args, what=what)
    else:
        ptrs = [o.data_ptr() for o in outs] + [None] * (4 - nout)
        build.launch("welch_acc_fft", "welch_acc_f32", _ACC_ARGTYPES, x.device, number,
                     x.data_ptr(), None if y is None else y.data_ptr(),
                     win.contiguous().data_ptr(), *ptrs, tw.data_ptr(),
                     *cuda_fft._r2c_tables(nfft, x.device), *args, what=what)
    globals()[f"{kind}_launches"] += 1
    if kind == "c2c_c64":
        c2c_launches += 1
    # the blocks' rows, summed in a fixed order
    return tuple((o.sum(1) if tiles > 1 else o[:, 0]).reshape(*lead, bins) for o in outs)


def _launch(kind, x, y, win, nperseg, hop, nfft, detrend):
    """Run the kernel of ``kind`` (welch, coh, csd, c2c, c2c_c64:
    welch_acc_fft's; psd: spec_fft's B19) on CUDA tensors; the outputs."""
    if kind == "psd":
        return (_psd_launch(x, win, nperseg, hop, nfft, detrend),)
    return _acc_launch(kind, x, y, win, nperseg, hop, nfft, detrend)


def _psd_launch(x, win, nperseg, hop, nfft, detrend):
    """Run spec_fft's B19 kernel on a CUDA tensor: the powers ``[..., num,
    nfft/2 + 1]``."""
    global psd_launches
    lead, t = x.shape[:-1], x.shape[-1]
    batch = math.prod(lead)
    num = 1 + (t - nperseg) // hop
    out = x.new_empty((*lead, num, nfft // 2 + 1))
    if batch == 0:
        return out
    x = x.contiguous()
    tw = cuda_fft._twiddle_table(nfft, FORWARD, x.device, cuda_fft._pass_roots_np)
    build.launch("spec_fft", "spec_psd_f32", [_P] * 4 + [_LL, _LL] + [_I] * 5 + [_P],
                 x.device, x.data_ptr(), win.contiguous().data_ptr(), out.data_ptr(),
                 tw.data_ptr(), batch, t, nperseg, hop, num, nfft.bit_length() - 1,
                 int(detrend == "constant"), cuda_fft._stream(x),
                 what=f"spec_psd_f32 launch failed (batch={batch}, t={t}, "
                      f"nperseg={nperseg}, hop={hop}, nfft={nfft})")
    psd_launches += 1
    return out


def _spec_launch(x, win, nperseg, hop, nfft, detrend, roll_s=0, pad_out=False, c64=False,
                 scale=None, pad=0):
    """Run the spec_fft kernel (B20) on CUDA tensors, x reflect-padded by
    ``pad`` at both ends: planes (Xr, Xi) ``[..., num, bins]`` (bins =
    nfft/2 + 1, or pad_bins(nfft) with ``pad_out``), or with ``c64`` one
    complex64 tensor ``[..., num, nfft/2 + 1]``."""
    global spec_launches, spec_c64_launches
    lead, t = x.shape[:-1], x.shape[-1]
    batch = math.prod(lead)
    num = 1 + (t + 2 * pad - nperseg) // hop
    bins = cuda_fft.pad_bins(nfft) if pad_out and not c64 else nfft // 2 + 1
    shape = (*lead, num, bins)
    if c64:
        outs = (torch.empty(shape, dtype=torch.complex64, device=x.device),)
    else:
        outs = (x.new_empty(shape), x.new_empty(shape))
    if batch == 0:
        return tuple(o.zero_() for o in outs)
    x = x.contiguous()
    w = cuda_fft._paired(win)  # 8-byte aligned, for the kernel's pair loads
    tabs = cuda_fft._r2c_tables(nfft, x.device)
    args = (batch, t, nperseg, hop, num, nfft.bit_length() - 1, int(detrend == "constant"),
            int(roll_s), int(pad))
    what = (f"spec_fft launch failed (batch={batch}, t={t}, nperseg={nperseg}, hop={hop}, "
            f"nfft={nfft})")
    if c64:
        build.launch("spec_fft", "spec_fft_c64", [_P] * 5 + [_LL, _LL] + [_I] * 7 + [_F, _P],
                     x.device, x.data_ptr(), w.data_ptr(), outs[0].data_ptr(), *tabs, *args,
                     cuda_fft._scale_arg(scale), cuda_fft._stream(x), what=what)
        spec_c64_launches += 1
    else:
        build.launch("spec_fft", "spec_fft_f32",
                     [_P] * 6 + [_LL, _LL] + [_I] * 8 + [_F, _P], x.device,
                     x.data_ptr(), w.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
                     *tabs, *args, bins, cuda_fft._scale_arg(scale), cuda_fft._stream(x),
                     what=what)
    spec_launches += 1
    return outs


def _spec_c2c_launch(x, y, win, nperseg, hop, nfft, detrend, c64=False, scale=None):
    """Run the spec_c2c_fft kernel (B22) on CUDA tensors: from x complex64
    as it lies, or from the planes x and y (None: a zero plane, none read);
    planes (Xr, Xi) ``[..., num, nfft]``, or with ``c64`` one complex64
    tensor of that shape."""
    global spec_c2c_launches, spec_c2c_c64_launches
    lead, t = x.shape[:-1], x.shape[-1]
    batch = math.prod(lead)
    num = 1 + (t - nperseg) // hop
    shape = (*lead, num, nfft)
    if c64:
        outs = (torch.empty(shape, dtype=torch.complex64, device=x.device),)
    else:
        outs = (torch.empty(shape, device=x.device), torch.empty(shape, device=x.device))
    if batch == 0:
        return tuple(o.zero_() for o in outs)
    x = x.resolve_conj().contiguous()
    y = None if y is None else y.contiguous()
    src = ((x.data_ptr(), None, None) if x.is_complex()
           else (None, x.data_ptr(), None if y is None else y.data_ptr()))
    tw = cuda_fft._twiddle_table(nfft, FORWARD, x.device, cuda_fft._pass_roots_np)
    args = (batch, t, nperseg, hop, num, nfft.bit_length() - 1, int(detrend == "constant"),
            cuda_fft._scale_arg(scale), cuda_fft._stream(x))
    what = (f"spec_c2c_fft launch failed (batch={batch}, t={t}, nperseg={nperseg}, "
            f"hop={hop}, nfft={nfft})")
    w = win.contiguous()
    if c64:
        build.launch("spec_c2c_fft", "spec_c2c_fft_c64", [_P] * 6 + [_LL, _LL] + [_I] * 5
                     + [_F, _P], x.device, *src, w.data_ptr(), outs[0].data_ptr(),
                     tw.data_ptr(), *args, what=what)
        spec_c2c_c64_launches += 1
    else:
        build.launch("spec_c2c_fft", "spec_c2c_fft_f32", [_P] * 7 + [_LL, _LL] + [_I] * 5
                     + [_F, _P], x.device, *src, w.data_ptr(), outs[0].data_ptr(),
                     outs[1].data_ptr(), tw.data_ptr(), *args, what=what)
    spec_c2c_launches += 1
    return outs


def _run(kind, x, y, win, nperseg, hop, nfft, detrend, roll_s, pad_out, scale, pad):
    if x.device.type == "cuda":
        if kind in _SPEC:
            return _spec_launch(x, win, nperseg, hop, nfft, detrend, roll_s, pad_out,
                                kind == "spec_c64", scale, pad)
        if kind in _SPEC_C2C:
            return _spec_c2c_launch(x, y, win, nperseg, hop, nfft, detrend,
                                    kind == "spec_c2c_c64", scale)
        return _launch(kind, x, y, win, nperseg, hop, nfft, detrend)
    if x.device.type != "cpu":
        raise ValueError(f"no segment-spectrum kernel for device {x.device}")
    return _composed(kind, x, y, win, nperseg, hop, nfft, detrend, False, roll_s, pad_out,
                     scale, pad)


class _Segments(torch.autograd.Function):
    """One of the seven kernels with the gradient of its composed form:
    the backward rebuilds the frames of x (and y) and runs them through
    the R2C kernel (B6; complex input: the row kernel, B1) under autograd,
    then differentiates the power or cross products and the framing back
    to the signals."""

    @staticmethod
    def forward(ctx, kind, x, y, win, nperseg, hop, nfft, detrend, roll_s, pad_out, scale,
                pad):
        ctx.save_for_backward(x, y, win)
        ctx.args = (kind, nperseg, hop, nfft, detrend, roll_s, pad_out, scale, pad)
        return _run(kind, x, y, win, nperseg, hop, nfft, detrend, roll_s, pad_out, scale, pad)

    @staticmethod
    def backward(ctx, *grads):
        x, y, win = ctx.saved_tensors
        kind, nperseg, hop, nfft, detrend, roll_s, pad_out, scale, pad = ctx.args
        with torch.enable_grad():
            ins = [v.detach().requires_grad_() for v in (x, y) if v is not None]
            outs = _composed(kind, ins[0], ins[1] if y is not None else None, win,
                             nperseg, hop, nfft, detrend, True, roll_s, pad_out, scale, pad)
            gs = torch.autograd.grad(outs, ins, grads)
        return (None, gs[0], gs[1] if y is not None else None) + (None,) * 10


def _apply(kind, x, y, win, nperseg, hop, nfft, detrend, roll_s=0, pad_out=False,
           scale=None, pad=0):
    num = _check(x, y, win, nperseg, hop, nfft, detrend, roll_s, pad, kind in _C64_IN)
    return _Segments.apply(kind, x, y, win, nperseg, hop, nfft, detrend, roll_s,
                           bool(pad_out), scale, pad), num


def _reference(kind, x, y, win, nperseg, hop, nfft, detrend, roll_s=0, pad_out=False,
               scale=None, pad=0):
    num = _check(x, y, win, nperseg, hop, nfft, detrend, roll_s, pad, kind in _C64_IN)
    return _composed(kind, x, y, win, nperseg, hop, nfft, detrend, False, roll_s,
                     bool(pad_out), scale, pad), num


def welch_accum_split(x, win, nperseg, hop, nfft, detrend):
    """Fused welch core: real float32 ``[..., t]`` x -> (power_sum
    ``[..., nfft//2 + 1]``, num), power_sum[b] = sum over the ``num``
    segments of |RFFT(win * detrend(frame_s), nfft)[b]|^2.  The caller
    applies the mean, the normalisation and the one-sided doubling.
    Differentiable in x."""
    (psum,), num = _apply("welch", x, None, win, nperseg, hop, nfft, detrend)
    return psum, num


def welch_accum_split_reference(x, win, nperseg, hop, nfft, detrend):
    """Plain torch version of :func:`welch_accum_split`; raises
    :class:`Unsupported` where the kernel would."""
    (psum,), num = _reference("welch", x, None, win, nperseg, hop, nfft, detrend)
    return psum, num


def spec_psd_split(x, win, nperseg, hop, nfft, detrend):
    """Fused per-segment power spectra: real float32 ``[..., t]`` x ->
    ``[..., num, nfft//2 + 1]`` (the spectrogram psd core and welch's
    median; the caller scales).  Differentiable in x."""
    (P,), _ = _apply("psd", x, None, win, nperseg, hop, nfft, detrend)
    return P


def spec_psd_split_reference(x, win, nperseg, hop, nfft, detrend):
    """Plain torch version of :func:`spec_psd_split`."""
    (P,), _ = _reference("psd", x, None, win, nperseg, hop, nfft, detrend)
    return P


def csd_accum_split(x, y, win, nperseg, hop, nfft, detrend):
    """Fused csd core: real float32 ``[..., t]`` x, y of one shape ->
    (Pr, Pi ``[..., nfft//2 + 1]``, num), P = sum_s conj(X_s) * Y_s (scipy's
    csd convention).  Differentiable in x and y."""
    (pr, pi), num = _apply("csd", x, y, win, nperseg, hop, nfft, detrend)
    return pr, pi, num


def csd_accum_split_reference(x, y, win, nperseg, hop, nfft, detrend):
    """Plain torch version of :func:`csd_accum_split`."""
    (pr, pi), num = _reference("csd", x, y, win, nperseg, hop, nfft, detrend)
    return pr, pi, num


def coherence_accum_split(x, y, win, nperseg, hop, nfft, detrend):
    """Fused coherence core: real float32 ``[..., t]`` x, y of one shape ->
    (Pr, Pi, Sxx, Syy ``[..., nfft//2 + 1]``, num) from one sweep;
    coherence = |P|^2 / (Sxx Syy), whose normalisations cancel.
    Differentiable in x and y."""
    outs, num = _apply("coh", x, y, win, nperseg, hop, nfft, detrend)
    return (*outs, num)


def coherence_accum_split_reference(x, y, win, nperseg, hop, nfft, detrend):
    """Plain torch version of :func:`coherence_accum_split`."""
    outs, num = _reference("coh", x, y, win, nperseg, hop, nfft, detrend)
    return (*outs, num)


def welch_accum_c2c_split(re, im, win, nperseg, hop, nfft, detrend):
    """Fused two-sided welch core (B21): a complex signal as float32
    planes (re, im) ``[..., t]`` of one shape -> (power_sum ``[..., nfft]``,
    num), power_sum[b] = sum over the ``num`` segments of |FFT(win *
    detrend(frame_s), nfft)[b]|^2, every bin in natural (unshifted) order;
    each plane is detrended on its own.  The caller applies the mean and
    the normalisation.  Differentiable in re and im."""
    (psum,), num = _apply("c2c", re, im, win, nperseg, hop, nfft, detrend)
    return psum, num


def welch_accum_c2c_split_reference(re, im, win, nperseg, hop, nfft, detrend):
    """Plain torch version of :func:`welch_accum_c2c_split`."""
    (psum,), num = _reference("c2c", re, im, win, nperseg, hop, nfft, detrend)
    return psum, num


def welch_accum_c2c_c64(x, win, nperseg, hop, nfft, detrend, *, im=None):
    """:func:`welch_accum_c2c_split` of a complex64 signal as it lies: x
    is the complex64 signal ``[..., t]`` (each plane detrended on its own),
    or a real float32 one (with ``im``, a float32 tensor of x's shape: the
    planes of a complex signal; without, the real signal taken two-sided,
    no imaginary plane read) -> (power_sum ``[..., nfft]``, num).  On the
    card one launch of B21's complex64 entry point (or, for real x, its
    planar one) with no split and no copy of a contiguous x.
    Differentiable in x and im (the composed form's gradient, through the
    row kernel's complex64 entry)."""
    (psum,), num = _apply("c2c_c64", x, im, win, nperseg, hop, nfft, detrend)
    return psum, num


def welch_accum_c2c_c64_reference(x, win, nperseg, hop, nfft, detrend, *, im=None):
    """Plain torch version of :func:`welch_accum_c2c_c64`."""
    (psum,), num = _reference("c2c_c64", x, im, win, nperseg, hop, nfft, detrend)
    return psum, num


def spec_rfft_split(x, win, nperseg, hop, nfft, detrend, *, pad_out=False, roll_s=0,
                    scale=None):
    """Fused framed R2C (B20): real float32 ``[..., t]`` x -> split spectra
    (Xr, Xi) ``[..., num, bins]``, bins = nfft//2 + 1, or ``pad_bins(nfft)``
    with exact zeros past bin nfft//2 when ``pad_out``.  ``roll_s`` (0 <=
    roll_s < nfft) rolls each zero-padded frame left before the transform
    (ShortTimeFFT's phase shift); the mean is taken before the roll; the
    scale is folded into the store.  Differentiable in x."""
    (Xr, Xi), _ = _apply("spec", x, None, win, nperseg, hop, nfft, detrend, roll_s, pad_out,
                         scale)
    return Xr, Xi


def spec_rfft_split_reference(x, win, nperseg, hop, nfft, detrend, *, pad_out=False,
                              roll_s=0, scale=None):
    """Plain torch version of :func:`spec_rfft_split`."""
    (Xr, Xi), _ = _reference("spec", x, None, win, nperseg, hop, nfft, detrend, roll_s,
                             pad_out, scale)
    return Xr, Xi


def spec_rfft_c64(x, win, nperseg, hop, nfft, detrend, *, roll_s=0, scale=None, pad=0):
    """:func:`spec_rfft_split` into one complex64 tensor ``[..., num,
    nfft//2 + 1]``: on the card the kernel's complex64 sink, one launch and
    no merge.  ``pad`` (0 <= pad < t) frames x with numpy's reflect pad of
    ``pad`` points at both ends (stft's centering), read in place by the
    kernel.  Differentiable in x (the composed form's gradient, through the
    R2C kernel's complex64 sink)."""
    (X,), _ = _apply("spec_c64", x, None, win, nperseg, hop, nfft, detrend, roll_s, False,
                     scale, pad)
    return X


def spec_rfft_c64_reference(x, win, nperseg, hop, nfft, detrend, *, roll_s=0, scale=None,
                            pad=0):
    """Plain torch version of :func:`spec_rfft_c64`."""
    (X,), _ = _reference("spec_c64", x, None, win, nperseg, hop, nfft, detrend, roll_s,
                         False, scale, pad)
    return X


def spec_c2c_split(re, im, win, nperseg, hop, nfft, detrend):
    """Fused two-sided framed C2C (B22): a complex signal as float32 planes
    (re, im) ``[..., t]`` of one shape -> split spectra (Xr, Xi) ``[...,
    num, nfft]``, every bin in natural (unshifted) order; each plane is
    detrended on its own.  Differentiable in re and im."""
    (Xr, Xi), _ = _apply("spec_c2c", re, im, win, nperseg, hop, nfft, detrend)
    return Xr, Xi


def spec_c2c_split_reference(re, im, win, nperseg, hop, nfft, detrend):
    """Plain torch version of :func:`spec_c2c_split`."""
    (Xr, Xi), _ = _reference("spec_c2c", re, im, win, nperseg, hop, nfft, detrend)
    return Xr, Xi


def spec_c2c_c64(x, win, nperseg, hop, nfft, detrend, *, scale=None, im=None):
    """Fused two-sided framed C2C (B22) into one complex64 tensor ``[...,
    num, nfft]``, every bin in natural order, the scale folded into the
    store.  x is the complex64 signal ``[..., t]`` (read as it lies, each
    plane detrended on its own), or a real float32 one (with ``im``, a
    float32 tensor of x's shape: the planes of a complex signal; without,
    the real signal taken two-sided, no imaginary plane read).  On the card
    the kernel's complex64 sink, one launch and no merge.  Differentiable in
    x and im (the composed form's gradient, through the row kernel's
    complex64 entry)."""
    (X,), _ = _apply("spec_c2c_c64", x, im, win, nperseg, hop, nfft, detrend, scale=scale)
    return X


def spec_c2c_c64_reference(x, win, nperseg, hop, nfft, detrend, *, scale=None, im=None):
    """Plain torch version of :func:`spec_c2c_c64`."""
    (X,), _ = _reference("spec_c2c_c64", x, im, win, nperseg, hop, nfft, detrend, scale=scale)
    return X
