"""Plan-based FFT scheduler (torch port of ``fft_wgpu_tpu.plan.plan``).

A :class:`Plan` is constructed once per transform length and replayed by
calling its methods.  PyTorch runs eagerly, so there is nothing to compile:
the kernel library and the constant tables are built once per process and
cached by the modules that use them.

Executors keep the JAX package's names:
  * ``"pallas"`` and its schedules ``"pallas:classic"``, ``"pallas:dit"``,
    ``"pallas:balanced"`` — the Hopper row kernel (``ops/cuda_fft.py``);
    the TPU schedules collapse into that one kernel
  * ``"xla"``    — the plain-torch mixed-radix path (``ops/stockham.py``)
  * ``"direct"`` — one direct DFT matmul
  * ``"fourstep"`` — the four-step decomposition (``ops/fourstep.py``):
    on a CUDA tensor the whole-row kernel where ``bigfft.takes`` the shape
    (its envelope, below the rows from which the two passes measured
    faster), else the axis(-2) kernel then the transposed-rows kernel
  * ``"bigfft"`` — the whole-row kernel (``ops/bigfft.py``); a shape
    outside its envelope raises :class:`~..ops.bigfft.Unsupported`.  On a
    CPU tensor it runs the kernel's plain version (the JAX package's
    ``"bigfft"`` cannot run on the CPU at all outside interpret mode).

Routes of ``"auto"`` that have no executor name of their own, and that a
tuned plan (``autotune=True``, ``plan/autotune.py``) or an AOT artifact
(``plan/aot.py``) may pick: ``"general"`` (the composite-row kernel),
``"bluestein"`` (Bluestein's fused chirp kernel) and
``"fourstep:two-pass"`` (the axis(-2) kernel then the transposed-rows
kernel, where ``"fourstep"`` would take the whole-row kernel); and
``"axis"``, an axis before the last on the axis(-2) kernels.

With ``executor="auto"`` a CUDA tensor of pow2 length 128..16384 always
goes through the row kernel, whatever its row count (a complex64 tensor
transformed along its last axis through the kernel's interleaved entry, with
no split and no merge, as on the whole-row kernel's route and the four-step's
two passes); pow2 lengths above
16384 go through ``"fourstep"``; composite lengths in the composite-row
kernel's envelope (non-pow2 512..16384, factors <= 256) through that
kernel (``cuda_fft.fft_rows_general_split``); any other length runs the
mixed-radix path on the same device, which sends a length with a prime
factor above 128 from 512 on to Bluestein (``bluestein.fft_bluestein_split``:
the two chirp passes while its m is at most 16384, the ifft scale folded
into the second).  Axis -2 of a CUDA tensor,
for pow2 n in 128..16384 or composite n in the composite-row envelope,
goes through the axis(-2) kernel of n with no transpose, and any axis
before it through the axis(-3) entry point on ``[..., n, mid, Z]`` (the
same kernels on a free view), again with no transpose; other lengths move
to the back around the row route.  A CPU tensor always takes the mixed-radix
path, as the JAX package does off the TPU.

With ``autotune=True`` and ``executor="auto"``, a CUDA tensor's route is
the one ``autotune.measure_executor`` measured fastest for its (card, n,
rows bucket, axis); a CPU tensor is not tuned, as in the JAX package off
the TPU.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.complex_utils import default_device, merge, promote_to_split
from ..core.twiddle import FORWARD, INVERSE
from ..ops import bigfft, bluestein, cuda_fft, fourstep, stockham
from ..ops.cuda_fft import FUSED_MAX_N, FUSED_MIN_N

__all__ = ["Plan", "plan", "get_plan"]

_KERNEL = ("pallas", "pallas:classic", "pallas:dit", "pallas:balanced")
_EXECUTORS = ("auto", "xla", "direct", "fourstep", "bigfft") + _KERNEL


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _is_complex64(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.complex64
    try:
        return np.dtype(dtype) == np.complex64
    except TypeError:
        return False


def _into(out, yr, yi):
    if out is None:
        return yr, yi
    out[0].copy_(yr)
    out[1].copy_(yi)
    return out


class Plan:
    """FFT plan for 1-D transforms of length ``n``.

    API parity with the reference plan objects:
      forward                -> Forward::proc
      inverse                -> Inverse::proc        (fused 1/N)
      inverse_unnormalized   -> Onlyinverse::proc
      normalize              -> Normalize::proc

    ``donate=True`` makes the ``*_split`` forms write their result into the
    input planes, in place: on the row kernel and the axis(-2) kernels
    directly (each block holds its whole row, or each cluster its whole
    tile, on chip before it stores), elsewhere by a copy.
    ``autotune=True`` (with ``executor="auto"``) measures the routes that
    can serve each CUDA shape once per (card, n, rows bucket, axis) and
    keeps the fastest (``plan/autotune.py``); on a CPU tensor it does
    nothing, as in the JAX package off the TPU.
    """

    def __init__(self, n: int, *, executor: str = "auto",
                 dtype=torch.complex64, donate: bool = False,
                 autotune: bool = False):
        if n < 1:
            raise ValueError(f"fft length must be >= 1, got {n}")
        self.n = int(n)
        if not _is_complex64(dtype):
            raise ValueError(
                f"unsupported dtype {dtype!r}: plans compute in split-f32 and "
                "return complex64 (use dtype=torch.complex64)")
        self.dtype = torch.complex64
        if executor not in _EXECUTORS:
            raise ValueError(f"unknown executor {executor!r}")
        self.executor = executor
        self.autotune = bool(autotune)
        self.donate = bool(donate)
        self._tuned: dict = {}  # (device, rows bucket, axis) -> measured route

    def _route(self, device, shape, axis: int) -> str:
        """The route a call on a tensor of ``shape`` along ``axis`` takes on
        ``device``, the one rule :meth:`_execute_split_axis` follows and
        ``plan/aot.py`` records: ``"axis"`` where an axis before the last
        runs the axis(-2) kernels (the axis(-3) entry on the free view
        before axis -2); with ``autotune=True`` and ``executor="auto"`` on
        a CUDA device the measured route, kept on the plan per (device,
        rows bucket, axis) so that a repeated call is one lookup; else
        :meth:`_resolve_executor`'s."""
        ax = axis % len(shape)
        on_card = device.type == "cuda"
        if (ax != len(shape) - 1 and on_card and self.executor in ("auto",) + _KERNEL
                and cuda_fft._ax0_supported(self.n)):
            return "axis"
        if not (self.autotune and self.executor == "auto" and on_card):
            return self._resolve_executor(device)
        from . import autotune

        key = (device, autotune.rows_bucket(shape, self.n), ax - len(shape))
        route = self._tuned.get(key)
        if route is None:
            route = autotune.measure_executor(self, tuple(shape), axis, device)
            self._tuned[key] = route
        return route

    def _resolve_executor(self, device) -> str:
        """The executor, or for ``"auto"`` the static route on ``device``."""
        if self.executor != "auto":
            return self.executor
        n = self.n
        if device.type != "cuda":
            return "xla"
        if _is_pow2(n):
            if FUSED_MIN_N <= n <= FUSED_MAX_N:
                return "pallas"
            if n > FUSED_MAX_N:
                return "fourstep"
        if cuda_fft._gen_supported(n):
            return "general"  # an internal route of "auto", not an executor name
        return "xla"

    # ------------------------------------------------------------------ #
    # split-domain executors (re/im pairs)
    # ------------------------------------------------------------------ #
    def _execute_split(self, re, im, sign: int, scale, out=None, ex=None):
        """Transform along the last axis on route ``ex`` (default: the
        resolved one); ``out`` receives the result."""
        if re.shape[-1] != self.n:
            raise ValueError(
                f"plan built for n={self.n}, input last axis is {re.shape[-1]}")
        ex = ex or self._route(re.device, re.shape, -1)
        if ex in _KERNEL:
            if out is not None and re.is_contiguous() and im.is_contiguous():
                return cuda_fft.fft_batched_split(re, im, sign, scale, out=out)
            return _into(out, *cuda_fft.fft_batched_split(re, im, sign, scale))
        if ex == "bigfft":
            return _into(out, *bigfft.fft_big_split(re, im, sign, scale))
        if ex == "general":
            return _into(out, *cuda_fft.fft_rows_general_split(re, im, sign, scale))
        if ex == "bluestein":
            return _into(out, *bluestein.fft_bluestein_split(re, im, sign, scale))
        if ex in ("fourstep", "fourstep:two-pass"):
            return _into(out, *fourstep.fft_last_axis(
                re, im, sign, scale, whole_row=ex == "fourstep"))
        if ex == "direct":
            yr, yi = stockham.apply_scale(*stockham._dft_direct(re, im, sign), scale)
            return _into(out, yr, yi)
        return _into(out, *stockham.fft_last_axis(re, im, sign, scale))

    def _execute_split_axis(self, re, im, sign: int, scale, axis: int,
                            out=None, ex=None):
        """Transform along ``axis`` on route ``ex`` (default:
        :meth:`_route`'s).  On route ``"axis"`` (a CUDA tensor with n in
        the axis(-2) kernels' envelope: pow2 128..16384, or composite
        512..16384 with factors <= 256), axis -2 runs the axis(-2) kernel
        and any axis before it the axis(-3) entry point on the free view
        ``[..., n, mid, Z]`` (the axes between it and the last merged into
        mid), both with no transpose; otherwise the axis moves to the back
        around the row path."""
        ax = axis % re.ndim
        ex = ex or self._route(re.device, re.shape, ax)
        if ax == re.ndim - 1:
            return self._execute_split(re, im, sign, scale, out, ex)
        if ex == "axis":
            shape = re.shape
            if shape[ax] != self.n:
                raise ValueError(f"plan built for n={self.n}, input axis "
                                 f"{axis} has length {shape[ax]}")
            if ax == re.ndim - 2:
                if out is not None and re.is_contiguous() and im.is_contiguous():
                    # in place: the kernel reads each tile whole before it stores
                    return cuda_fft.fft_axis0_split(re, im, sign, scale, out=out)
                return _into(out, *cuda_fft.fft_axis0_split(re, im, sign, scale))
            view = (*shape[:ax + 1], math.prod(shape[ax + 1:-1]), shape[-1])
            yr, yi = cuda_fft.fft_axis3_split(re.reshape(view), im.reshape(view),
                                              sign, scale)
            return _into(out, yr.view(shape), yi.view(shape))
        yr, yi = self._execute_split(re.movedim(ax, -1), im.movedim(ax, -1),
                                     sign, scale, ex=ex)
        return _into(out, yr.movedim(-1, ax), yi.movedim(-1, ax))

    def _split(self, re, im, axis: int, sign: int, scale):
        re, im = promote_to_split((re, im))
        if not self.donate:
            return self._execute_split_axis(re, im, sign, scale, axis)
        if torch.is_grad_enabled() and (re.requires_grad or im.requires_grad):
            raise ValueError("donate=True writes the result into the input "
                             "planes and cannot record a gradient")
        return self._execute_split_axis(re, im, sign, scale, axis, out=(re, im))

    def forward_split(self, re, im, axis: int = -1):
        """Forward FFT on a split (re, im) float32 pair -> split pair.
        With donate=True the result is written into (re, im) in place."""
        return self._split(re, im, axis, FORWARD, None)

    def inverse_split(self, re, im, axis: int = -1):
        """Inverse FFT with fused 1/N on a split pair -> split pair."""
        return self._split(re, im, axis, INVERSE, 1.0 / self.n)

    def inverse_unnormalized_split(self, re, im, axis: int = -1):
        """Unnormalized inverse on a split pair -> split pair."""
        return self._split(re, im, axis, INVERSE, None)

    # ------------------------------------------------------------------ #
    # public complex-facade methods
    # ------------------------------------------------------------------ #
    def _execute_c64(self, x, axis: int, sign: int, scale):
        """The transform of a complex64 CUDA tensor on the row kernel's
        route (any axis: the row kernel's, the axis(-2) kernel's or, on the
        free view, the axis(-3) entry), or along its last axis on the
        whole-row kernel's (``"bigfft"``, or ``"fourstep"`` where
        ``bigfft.takes`` the shape), through the kernel's interleaved entry:
        one launch, no split and no merge; or along its last axis on the
        four-step's two passes (``"fourstep"`` where the whole-row kernel
        does not take the shape, ``"fourstep:two-pass"``; both factors pow2
        128..16384), through the interleaved entries of the axis(-2) and
        transposed-rows kernels: two launches, no split and no merge.  None
        for any other input, which takes the planar path."""
        if not (isinstance(x, torch.Tensor) and x.dtype == torch.complex64
                and x.is_cuda and x.ndim >= 1 and -x.ndim <= axis < x.ndim
                and x.shape[axis] == self.n):
            return None
        ex = self._route(x.device, x.shape, axis % x.ndim)
        if ex in _KERNEL or (ex == "axis" and cuda_fft._supported(self.n)):
            return cuda_fft.fft_c64_along(x, axis, sign, scale)
        last = axis % x.ndim == x.ndim - 1
        rows = x.numel() // self.n
        if last and ((ex == "bigfft" and bigfft._supported(self.n, rows))
                     or (ex == "fourstep" and bigfft.takes(self.n, rows, c64=True))):
            return bigfft.fft_big_c64(x, sign, scale)
        if ex in ("fourstep", "fourstep:two-pass") and last and fourstep.c64_supported(self.n):
            return fourstep.fft_last_axis_c64(x, sign, scale)
        return None

    def _run(self, x, axis: int, sign: int, scale):
        y = self._execute_c64(x, axis, sign, scale)
        if y is not None:
            return y
        re, im = promote_to_split(x)
        if re.shape[axis] != self.n:
            raise ValueError(
                f"plan built for n={self.n}, input axis {axis} has length "
                f"{re.shape[axis]}")
        return merge(*self._execute_split_axis(re, im, sign, scale, axis))

    def forward(self, x, axis: int = -1):
        """Forward FFT, unscaled (reference Forward)."""
        return self._run(x, axis, FORWARD, None)

    def inverse(self, x, axis: int = -1):
        """Inverse FFT with the 1/N scale folded into the last pass
        (reference Inverse)."""
        return self._run(x, axis, INVERSE, 1.0 / self.n)

    def inverse_unnormalized(self, x, axis: int = -1):
        """Inverse FFT without the 1/N scale (reference Onlyinverse)."""
        return self._run(x, axis, INVERSE, None)

    def normalize(self, x, axis: int = -1):
        """Standalone 1/N scaling pass (reference Normalize)."""
        del axis  # elementwise — axis kept for API symmetry
        re, im = promote_to_split(x)
        s = float(np.float32(1.0 / self.n))
        return merge(re * s, im * s)

    def warmup(self, batch_shape=(), axis: int = -1, device=None):
        """Run every mode once on zeros of ``batch_shape + (n,)`` on
        ``device`` (the current CUDA device by default, which raises if
        there is none; pass ``"cpu"`` for the CPU): on a CUDA device this
        builds the kernels of its route and uploads their tables before the
        first real call.
        Returns self for chaining."""
        shape = tuple(batch_shape) + (self.n,)
        device = device if device is not None else default_device()
        for sign, scale in ((FORWARD, None), (INVERSE, 1.0 / self.n),
                            (INVERSE, None)):
            re = torch.zeros(shape, device=device)
            self._execute_split_axis(re, torch.zeros_like(re), sign, scale, axis)
        return self

    def __repr__(self):
        return f"Plan(n={self.n}, executor={self.executor!r})"


def plan(n: int, **kw) -> Plan:
    """Construct an FFT plan (``Forward::new`` analogue)."""
    return Plan(n, **kw)


@functools.lru_cache(maxsize=512)
def get_plan(n: int, executor: str = "auto") -> Plan:
    """Module-level plan cache used by the functional API (fft/ifft/...)."""
    return Plan(n, executor=executor)
