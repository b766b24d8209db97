"""Multi-dimensional C2C transforms (torch port of ``fft_wgpu_tpu.ops.nd``).

N-D is the separable application of the 1-D executor along each axis; the
per-axis route (row, axis(-2) or axis(-3) kernel, or the mixed-radix path)
is the plan's.  Composite axes take the composite kernels with no
transpose: ``fft2`` of ``[16, 1080, 1920]`` frames is the composite-row
kernel over 1920 and the composite axis(-2) kernel over 1080.  On a CUDA
tensor a transform over the two trailing axes of planes in the fused-plane
envelope (A, B pow2 >= 128, A*B <= 2^16) first runs the fused-plane kernel
(both axes in one pass over device memory, one launch: faster than the row
kernel then the axis(-2) kernel from one plane on, by CUDA events on an
NVIDIA H100 80GB HBM3 at its 700 W power limit, PERF.md); the remaining
axes then take their own routes.

The JAX package sends other trailing planes in the row kernel's envelope
to two transposed-rows passes (``fft2_split``, kept as an entry point
here).  On the H100 the per-axis loop, the row kernel then the axis(-2)
kernel, measured faster at 4096 x 4096 (0.60 against 0.67 ms, PERF.md), so
those planes take the per-axis loop.

A complex64 CUDA tensor whose transformed axes are all pow2 in 128..16384
runs the kernels' complex64 entries, with no split and no merge
(:func:`fftn_c64`): the fused plane's (``cuda_fft.fft2_fused_c64``) over a
trailing plane in its envelope (:func:`_c64_plane`), then, for every
other axis, the row kernel's entry for the last axis, the axis(-2)
kernel's for axis -2 and its entry on the free view for the axes before it
(:func:`_c64_route` when no plane goes first).  ``fftn`` of 256^3 is the
fused plane, then the axis(-3) kernel, and ``fft2`` of a 4096 x 4096 plane
the row kernel, then the axis(-2) kernel: two launches and nothing else.
Other tensors (planar pairs, other dtypes, pads or trims) take the split
route, the fused plane's planar entry first where it applies.

Routes are picked by envelope predicates (:func:`_fused_plane`,
:func:`_c64_plane`, :func:`_c64_route`), never by catching an error.  A
CPU tensor takes the per-axis loop, as the JAX package does off the TPU.
"""

from __future__ import annotations

import math

import torch

from ..core.complex_utils import as_args, from_args, merge, promote_to_split
from ..core.twiddle import FORWARD, INVERSE
from ..utils.jit_cache import cached_call, shape_key
from . import cuda_fft
from .transforms import _pad_or_trim, _positive

__all__ = ["fft2", "ifft2", "fftn", "ifftn", "fftn_split"]


def _norm_axes(shape, s, axes):
    """(s, axes) for a tensor of ``shape``: the axes normalised (numpy's
    default: the last len(s) axes, or all), and a size per axis, None for
    the axis's default; a size of -1 is the axis's length as it lies, as
    numpy.fft and scipy.fft read it."""
    ndim = len(shape)
    if axes is None:
        if s is not None and len(s) > ndim:
            # numpy maps s to the LAST len(s) axes; more entries than
            # dims is an out-of-range axis there, not a silent wrap
            raise ValueError(
                f"shape requires {len(s)} axes but input has {ndim} "
                f"dimensions")
        axes = list(range(ndim)) if s is None else list(range(ndim - len(s), ndim))
    for a in axes:
        if not -ndim <= a < ndim:
            raise ValueError(
                f"axis {a} is out of bounds for array of dimension {ndim}")
    axes = [a % ndim for a in axes]
    if s is None:
        s = [None] * len(axes)
    if len(s) != len(axes):
        raise ValueError("s and axes must have the same length")
    return [shape[a] if size == -1 else size for size, a in zip(s, axes)], axes


def _sizes(shape, s, axes) -> list:
    """The transform's length along each of ``axes`` (normalised, with the
    sizes ``s``), each checked by ``transforms._positive``."""
    return [_positive(shape[a] if size is None else size) for size, a in zip(s, axes)]


def _fused_plane(shape, axes, device, executor="auto") -> bool:
    """Whether a transform over ``axes`` of ``shape`` starts with the
    fused-plane kernel over the trailing plane (else: the per-axis loop): a
    CUDA tensor whose two trailing axes are transformed and lie in the
    fused envelope, at any plane count (one launch measured faster than the
    row kernel then the axis(-2) kernel from one plane on, PERF.md)."""
    nd = len(shape)
    ax_sorted = sorted(a % nd for a in axes)
    return (executor in ("auto", "pallas") and device.type == "cuda" and len(axes) >= 2
            and ax_sorted[-2:] == [nd - 2, nd - 1]
            and cuda_fft._fft2f_supported(*shape[-2:]))


def _c64_ok(shape, dtype, device, s, axes, executor) -> bool:
    """complex64 on a CUDA device, no pad or trim, every axis of ``axes``
    pow2 in 128..16384: the complex64 entries take the whole transform."""
    return (dtype == torch.complex64 and device.type == "cuda"
            and executor in ("auto", "pallas") and len(axes) > 0
            and all(size is None or size == shape[a] for size, a in zip(s, axes))
            and all(cuda_fft._supported(shape[a]) for a in axes))


def _c64_plane(shape, dtype, device, s, axes, executor="auto") -> bool:
    """Whether the transform over ``axes`` (normalised, with the sizes
    ``s``) runs the complex64 entries with the trailing plane first through
    the fused-plane kernel's (:func:`fftn_c64` with ``plane``)."""
    return (_c64_ok(shape, dtype, device, s, axes, executor)
            and _fused_plane(shape, axes, device, executor))


def _c64_route(shape, dtype, device, s, axes, executor="auto") -> bool:
    """Whether the transform over ``axes`` (normalised, with the sizes
    ``s``) of a tensor of ``shape``, ``dtype`` and ``device`` runs the
    complex64 entries axis by axis (:func:`fftn_c64`): complex64 on a CUDA
    device, no pad or trim, every axis pow2 in 128..16384, and not the
    complex64 fused plane's route (:func:`_c64_plane`)."""
    return (_c64_ok(shape, dtype, device, s, axes, executor)
            and not _fused_plane(shape, axes, device, executor))


def fftn_c64(x, axes, sign, scale, plane=False):
    """The complex64 route: with ``plane`` the trailing plane first through
    the fused-plane kernel's complex64 entry (``cuda_fft.fft2_fused_c64``),
    then each remaining axis of ``axes`` in turn through the kernels'
    complex64 entries (``cuda_fft.fft_c64_along``), the scale folded into
    the last pass.  Differentiable."""
    if plane:
        axes = sorted(a % x.ndim for a in axes)[:-2]
        x = cuda_fft.fft2_fused_c64(x, sign, None if axes else scale)
    for i, ax in enumerate(axes):
        x = cuda_fft.fft_c64_along(x, ax, sign, scale if i == len(axes) - 1 else None)
    return x


def _nd_scale(total, sign, norm):
    if norm in (None, "backward"):
        return None if sign == FORWARD else 1.0 / total
    if norm == "ortho":
        return total**-0.5
    if norm == "forward":
        return 1.0 / total if sign == FORWARD else None
    raise ValueError(f"invalid norm {norm!r}")


def fftn_split(re, im, axes, sign, scale, executor="auto"):
    """Apply the 1-D executor along each axis; the scale is folded into the
    last axis's pass (the JAX package multiplies once at the end).

    On a CUDA tensor the trailing plane may first go through the
    fused-plane kernel (:func:`_fused_plane`); the remaining axes then take
    the per-axis loop."""
    from ..plan.plan import get_plan

    if _fused_plane(re.shape, axes, re.device, executor):
        rest = sorted(a % re.ndim for a in axes)[:-2]
        re, im = cuda_fft.fft2_fused_split(re, im, sign, None if rest else scale)
        if not rest:
            return re, im
        axes = rest

    for i, ax in enumerate(axes):
        # the plan layer picks the route per axis: the row kernel for the
        # last axis, the axis(-2) / axis(-3) kernels with no transpose
        p = get_plan(re.shape[ax], executor)
        re, im = p._execute_split_axis(re, im, sign,
                                       scale if i == len(axes) - 1 else None, ax)
    return re, im


def _run_nd_split(x, s, axes, sign, norm, executor):
    """The N-D transform of ``x`` (tensor, array or (re, im) pair) as a
    planar pair, so that chained stages pass planes without a merge and a
    split in between."""
    re, im = promote_to_split(x)
    s, axes = _norm_axes(re.shape, s, axes)
    _sizes(re.shape, s, axes)
    # numpy semantics: s trims/pads each axis
    for size, ax in zip(s, axes):
        if size is not None and re.shape[ax] != size:
            re, im = _pad_or_trim(re, im, size, ax)

    scale = _nd_scale(math.prod(re.shape[a] for a in axes), sign, norm)
    return fftn_split(re, im, tuple(axes), sign, scale, executor)


def _run_nd(x, s, axes, sign, norm, executor):
    """The N-D transform through one cached call (``utils.jit_cache``: on a
    CUDA tensor a repeated call replays a captured graph), keyed as the JAX
    package's, plus the fused plane's envelope (``cuda_fft.FFT2F_MAX_ELEMS``,
    which ``plan.autotune.tune_fused_plane`` may move).  The complex64 route
    (one launch an axis, no other device work) runs eagerly, uncached: a
    replay's copy in and clone out would cost it more than the host work
    it saves."""
    args = as_args(x)
    v = args[0]
    sn, axn = _norm_axes(v.shape, s, axes)
    scale = _nd_scale(math.prod(_sizes(v.shape, sn, axn)), sign, norm)
    plane = route = False
    if len(args) == 1:
        plane = _c64_plane(v.shape, v.dtype, v.device, sn, axn, executor)
        route = plane or _c64_route(v.shape, v.dtype, v.device, sn, axn, executor)

    def impl(*a):
        if route:
            return fftn_c64(a[0], axn, sign, scale, plane)
        re, im = from_args(a)
        for size, ax in zip(sn, axn):
            if size is not None and re.shape[ax] != size:
                re, im = _pad_or_trim(re, im, size, ax)
        return merge(*fftn_split(re, im, tuple(axn), sign, scale, executor))

    key = None if route else ("nd", shape_key(v), tuple(sn), tuple(axn), sign, scale, executor,
                              cuda_fft.FFT2F_MAX_ELEMS)
    return cached_call(key, impl, *args)


def fftn(x, s=None, axes=None, norm=None, *, executor: str = "auto"):
    """N-D forward C2C FFT (numpy.fft.fftn semantics)."""
    return _run_nd(x, s, axes, FORWARD, norm, executor)


def ifftn(x, s=None, axes=None, norm=None, *, executor: str = "auto"):
    """N-D inverse C2C FFT (numpy.fft.ifftn semantics)."""
    return _run_nd(x, s, axes, INVERSE, norm, executor)


def fft2(x, s=None, axes=(-2, -1), norm=None, *, executor: str = "auto"):
    """2-D forward FFT over `axes` (default last two)."""
    return _run_nd(x, s, list(axes), FORWARD, norm, executor)


def ifft2(x, s=None, axes=(-2, -1), norm=None, *, executor: str = "auto"):
    """2-D inverse FFT over `axes` (default last two)."""
    return _run_nd(x, s, list(axes), INVERSE, norm, executor)
