"""Non-uniform FFT (NUFFT), types 1, 2 and 3 in 1-D, 2-D and 3-D (torch
port of ``fft_wgpu_tpu.ops.nufft``; finufft semantics).

    type 1 ("adjoint"): nonuniform samples  -> uniform Fourier modes
        f_k = sum_j c_j exp(isign * i k x_j),   k = -n//2 .. n-n//2-1
    type 2 ("forward"): uniform Fourier modes -> nonuniform samples
        c_j = sum_k f_k exp(isign * i k x_j)
    type 3: arbitrary points x_j and frequencies s_k
        f_k = sum_j c_j exp(isign * i s_k x_j)

Mode ordering follows finufft: k ascending (fftshifted); the default signs
are isign=+1 for types 1 and 3, isign=-1 for type 2.

Algorithm, as in the JAX package: an oversampled fine grid of
nf = next_fast_len(2n) points an axis, a truncated Gaussian window of 14
points an axis (phi(x) = exp(-x^2 / 4 tau), error ~2e-7), the uniform
transform of the fine grid through the plan (unnormalized, in the
direction of isign), and a deconvolution by the window's Fourier
transform, a host float64 table cast once to float32 and uploaded once per
(n, nf) and device.  Type 3 reduces to type 2 on a free-space grid whose
geometry comes from the points' and frequencies' extents, read on the host
(one device-to-host copy of 2 * dims values a call).

Each point's position in fine-grid units (and type 3's centering and
phases) is computed in float64 on the device, from the float32 points, and
the window weights in float32 from its fractional part.  The JAX package
computes the position in float32, whose rounding alone costs about
n * 2^-24 of relative error (3e-3 at 2^16 modes against the direct sum,
on the CPU); here the error stays at float32's transform level (3e-7
there).

Spreading (type 1, and type 3's grid) is ``Tensor.index_add_`` of the
window-weighted values over the flattened fine grid, batch dimensions
kept; interpolation (type 2) is a gather (``index_select``) and a weighted
sum.  On the card ``index_add_`` adds with atomics, so the order of the
sums, and the low bits, may change from run to run.  The points go through
in chunks whose stencil (indices, weights and weighted values) holds at
most about 2 GiB (``_STENCIL_BYTES``): 39,000 points a chunk in 3-D for one
signal, the whole set in 1-D and 2-D at the sizes users send; the sum is
the same.  On a CUDA tensor the fine grid's transform runs the plan's
kernels: the row kernel for pow2 nf <= 16384, the whole-row kernel or the
four-step above it, the composite-row kernel for composite nf in its
envelope, and in 2-D and 3-D the axis(-2) kernel and the axis(-3) entry
along the leading axes.  Other fine-grid lengths (composite above 16384,
or below 512) run the plain mixed-radix path on the card.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.complex_utils import default_device, host_table, merge, promote_to_split, to_device
from ..core.twiddle import FORWARD, INVERSE
from ..plan.plan import get_plan
from .helpers import next_fast_len
from .nd import fftn_split

__all__ = ["nufft1d1", "nufft1d2", "nufft1d3", "nufft2d1", "nufft2d3", "nufft3d3",
           "nufft2d2", "nufft3d1", "nufft3d2"]

_SIGMA = 2.0  # oversampling factor
_WIDTH = 14   # spreading width in fine-grid points (M_sp = 7 per side)
# A chunk's stencil (int64 indices, float32 weights, the weighted float32
# values of both planes of every signal) holds at most this many bytes.
_STENCIL_BYTES = 2 << 30


def _fine_n(n: int) -> int:
    return next_fast_len(int(_SIGMA * n))


def _tau(nf: int) -> float:
    m_sp = _WIDTH // 2
    return math.pi * m_sp / (nf * nf * math.sqrt(1.0 - 1.0 / _SIGMA))


def _sign(isign) -> int:
    """The fine-grid transform's direction: e^{+iku} (INVERSE,
    unnormalized) for isign >= 0, e^{-iku} (FORWARD) otherwise."""
    return INVERSE if isign >= 0 else FORWARD


def _device(*args):
    """The device of the first tensor among ``args`` (or in an (re, im)
    pair), else the current CUDA device."""
    flat = [v for a in args for v in (a if isinstance(a, tuple) else (a,))]
    dev = next((v.device for v in flat if isinstance(v, torch.Tensor)), None)
    return dev if dev is not None else default_device()


def _stencil_weights(xi, h, tau):
    """From positions xi [M] in grid units (float64): (i0 [M] int64, the
    first of each point's w grid points, and wts [M, w] float32, the
    Gaussian window at them).  The position and its fraction are float64;
    the window is float32 from the fraction on."""
    i0 = torch.floor(xi).to(torch.int64) - (_WIDTH // 2 - 1)
    frac = (xi - i0).to(torch.float32)  # in [w/2 - 1, w/2)
    l = torch.arange(_WIDTH, dtype=torch.float32, device=xi.device)
    d = (frac[:, None] - l) * h
    return i0, torch.exp(-(d * d) * (1.0 / (4.0 * tau)))


def _window_weights(x, nf):
    """For points x [M] (radians, any real values, wrapped to [0, 2 pi)),
    return (i0 [M] int64 base fine-grid index, wts [M, w] Gaussian window
    weights).  The wrap and the position in grid units are float64: in
    float32 their rounding alone costs about n * 2^-24 of relative error
    (3e-3 at 2^16 modes), as in finufft's single precision."""
    xi = torch.remainder(x.to(torch.float64), 2.0 * math.pi) * (nf / (2.0 * math.pi))
    return _stencil_weights(xi, 2.0 * math.pi / nf, _tau(nf))


@functools.lru_cache(maxsize=64)
def _deconv(n: int, nf: int, device, ascending: bool = False):
    """h / phi_hat(k) for the kept modes on ``device``, in FFT bin order or,
    with ``ascending``, k ascending (host float64, cast once)."""
    tau = _tau(nf)
    k = np.fft.fftfreq(n, 1.0 / n)  # bin order: 0..ceil-1, -floor..-1
    ph = 2.0 * math.sqrt(math.pi * tau) * np.exp(-(k * k) * tau)
    d = (2.0 * math.pi / nf) / ph
    return host_table(np.roll(d, n // 2) if ascending else d, device)


def _gather_idx(i0, nf):
    return torch.remainder(i0[:, None] + torch.arange(_WIDTH, device=i0.device), nf)


def _chunks(m: int, dims: int, signals: int):
    """Point ranges [lo, hi) whose stencil fits in ``_STENCIL_BYTES``."""
    per_point = _WIDTH ** dims * (12 + 8 * signals)
    step = max(1, _STENCIL_BYTES // per_point)
    return [(lo, min(lo + step, m)) for lo in range(0, max(m, 1), step)]


def _stencil(idxs, ws, sizes, lo, hi):
    """Flat fine-grid indices [m, w**D] and product weights [m, w**D] of
    points lo:hi, from each axis's indices and weights [M, w]."""
    flat, wt = idxs[0][lo:hi], ws[0][lo:hi]
    m = hi - lo
    for d in range(1, len(idxs)):
        shape = (m,) + (1,) * d + (_WIDTH,)
        flat = flat[..., None] * sizes[d] + idxs[d][lo:hi].reshape(shape)
        wt = wt[..., None] * ws[d][lo:hi].reshape(shape)
    return flat.reshape(m, -1), wt.reshape(m, -1)


def _spread(cr, ci, idxs, ws, sizes):
    """Type-1 spreading: the values [*lead, M] times each point's window
    weights, added into the flattened fine grid [*lead, prod(sizes)]."""
    lead, m = cr.shape[:-1], cr.shape[-1]
    vals = torch.stack([cr, ci])
    g = vals.new_zeros(2, *lead, math.prod(sizes))
    for lo, hi in _chunks(m, len(sizes), math.prod(lead)):
        flat, wt = _stencil(idxs, ws, sizes, lo, hi)
        src = vals[..., lo:hi, None] * wt
        g.index_add_(-1, flat.reshape(-1), src.reshape(2, *lead, -1))
    return g[0], g[1]


def _interp(Gr, Gi, idxs, ws, sizes):
    """Type-2 interpolation: the flattened fine grid [*lead, prod(sizes)]
    gathered at each point's stencil and summed with its weights."""
    G = torch.stack([Gr, Gi])
    out = []
    for lo, hi in _chunks(idxs[0].shape[0], len(sizes), math.prod(Gr.shape[:-1])):
        flat, wt = _stencil(idxs, ws, sizes, lo, hi)
        v = G.index_select(-1, flat.reshape(-1)).reshape(*G.shape[:-1], hi - lo, -1)
        out.append((v * wt).sum(-1))
    c = torch.cat(out, -1)
    return c[0], c[1]


def _central(a, n, nf, axis):
    """The n kept modes of an nf-point spectrum along ``axis``, k ascending."""
    pos, neg = n - n // 2, n // 2
    kept = torch.cat([a.narrow(axis, 0, pos), a.narrow(axis, nf - neg, neg)], axis)
    return torch.roll(kept, neg, axis)


def _expand(a, n, nf, axis):
    """k-ascending modes along ``axis`` placed in bin order on nf points."""
    pos, neg = n - n // 2, n // 2
    a = torch.roll(a, -neg, axis)
    shape = list(a.shape)
    shape[axis] = nf - n
    return torch.cat([a.narrow(axis, 0, pos), a.new_zeros(shape), a.narrow(axis, pos, neg)],
                     axis)


def _grid_axes(ndim: int, dims: int):
    return tuple(range(ndim - dims, ndim))


def _uniform_weights(pts, nfs):
    """Each axis's wrapped stencil indices and weights on its fine grid."""
    idxs, ws = [], []
    for p, nf in zip(pts, nfs):
        i0, w = _window_weights(p, nf)
        idxs.append(_gather_idx(i0, nf))
        ws.append(w)
    return idxs, ws


def _impl_type1(pts, cr, ci, ns, isign):
    """Type 1 in len(ns) dimensions: spread, transform the fine grid,
    keep the central modes, deconvolve."""
    nfs = [_fine_n(n) for n in ns]
    idxs, ws = _uniform_weights(pts, nfs)
    gr, gi = _spread(cr, ci, idxs, ws, nfs)
    lead = cr.shape[:-1]
    gr, gi = gr.reshape(*lead, *nfs), gi.reshape(*lead, *nfs)
    axes = _grid_axes(gr.ndim, len(ns))
    if len(ns) == 1:
        Fr, Fi = get_plan(nfs[0], "auto")._execute_split(gr, gi, _sign(isign), None)
    else:
        Fr, Fi = fftn_split(gr, gi, axes, _sign(isign), None)
    for ax, n, nf in zip(axes, ns, nfs):
        Fr, Fi = _central(Fr, n, nf, ax), _central(Fi, n, nf, ax)
    dec = _deconv_planes(ns, nfs, Fr.device)
    return Fr * dec, Fi * dec


def _deconv_planes(ns, nfs, device):
    """The product deconvolution over len(ns) trailing axes, k ascending."""
    out = None
    for d, (n, nf) in enumerate(zip(ns, nfs)):
        t = _deconv(n, nf, device, True).reshape((-1,) + (1,) * (len(ns) - 1 - d))
        out = t if out is None else out * t
    return out


def _impl_type2(pts, fr, fi, isign):
    """Type 2 in len(pts) dimensions: deconvolve, place on the fine grid,
    transform it, interpolate at the points."""
    dims = len(pts)
    ns = fr.shape[-dims:]
    nfs = [_fine_n(n) for n in ns]
    dec = _deconv_planes(ns, nfs, fr.device)
    gr, gi = fr * dec, fi * dec
    axes = _grid_axes(gr.ndim, dims)
    for ax, n, nf in zip(axes, ns, nfs):
        gr, gi = _expand(gr, n, nf, ax), _expand(gi, n, nf, ax)
    if dims == 1:
        Gr, Gi = get_plan(nfs[0], "auto")._execute_split(gr, gi, _sign(isign), None)
    else:
        Gr, Gi = fftn_split(gr, gi, axes, _sign(isign), None)
    lead = Gr.shape[:-dims]
    idxs, ws = _uniform_weights(pts, nfs)
    return _interp(Gr.reshape(*lead, -1), Gi.reshape(*lead, -1), idxs, ws, nfs)


def _type1(pts, c, ns, isign):
    dev = _device(*pts, c)
    pts = [to_device(p, dev) for p in pts]
    cr, ci = promote_to_split(c, dev)
    return merge(*_impl_type1(pts, cr, ci, ns, isign))


def _type2(pts, f, isign):
    dev = _device(*pts, f)
    pts = [to_device(p, dev) for p in pts]
    fr, fi = promote_to_split(f, dev)
    return merge(*_impl_type2(pts, fr, fi, isign))


def nufft1d1(x, c, n: int, *, isign: int = +1):
    """Type-1 NUFFT: f_k = sum_j c_j e^{isign i k x_j}, k ascending
    (finufft ordering).  x: [M] radians; c: [..., M] -> [..., n]."""
    return _type1([x], c, (int(n),), isign)


def nufft1d2(x, f, *, isign: int = -1):
    """Type-2 NUFFT: c_j = sum_k f_k e^{isign i k x_j}; f: [..., n] with
    k ascending (finufft ordering) -> [..., M]."""
    return _type2([x], f, isign)


def nufft2d1(x, y, c, ns, *, isign: int = +1):
    """2-D type 1: f_{k1,k2} = sum_j c_j e^{isign i (k1 x_j + k2 y_j)};
    ns = (n1, n2); c: [..., M] -> [..., n1, n2], both k axes ascending."""
    return _type1([x, y], c, tuple(int(v) for v in ns), isign)


def nufft2d2(x, y, f, *, isign: int = -1):
    """2-D type 2: c_j = sum_{k1,k2} f_{k1,k2} e^{isign i (k1 x_j +
    k2 y_j)}; f: [..., n1, n2] with both k axes ascending -> [..., M]."""
    return _type2([x, y], f, isign)


def nufft3d1(x, y, z, c, ns, *, isign: int = +1):
    """3-D type 1: f_{k1,k2,k3} = sum_j c_j e^{isign i (k1 x + k2 y +
    k3 z)_j}; ns = (n1, n2, n3); c: [..., M] -> [..., n1, n2, n3]."""
    return _type1([x, y, z], c, tuple(int(v) for v in ns), isign)


def nufft3d2(x, y, z, f, *, isign: int = -1):
    """3-D type 2: c_j = sum_k f_k e^{isign i k.(x,y,z)_j};
    f: [..., n1, n2, n3] (all k axes ascending) -> [..., M]."""
    return _type2([x, y, z], f, isign)


# ---------------------------------------------------------------------------
# Type 3
# ---------------------------------------------------------------------------

def _extents(tensors):
    """(min, max) of each tensor as host float64, in one device-to-host
    copy; None for an empty tensor."""
    live = [t for t in tensors if t.numel()]
    vals = (torch.stack([v for t in live for v in (t.min(), t.max())]).cpu().double().numpy()
            if live else [])
    out, i = [], 0
    for t in tensors:
        if t.numel():
            out.append((float(vals[i]), float(vals[i + 1])))
            i += 2
        else:
            out.append(None)
    return out


def _t3_geom(xe, se):
    """Per-dimension type-3 geometry (xc, sc, h, tau, n) from the points'
    and the frequencies' (min, max) extents (None when empty)."""
    xc = (xe[1] + xe[0]) / 2.0 if xe else 0.0
    sc = (se[1] + se[0]) / 2.0 if se else 0.0
    X = max(max(xe[1] - xc, xc - xe[0]) if xe else 0.0, 1e-30)
    S = max(max(se[1] - sc, sc - se[0]) if se else 0.0, 1e-30)
    h = math.pi / (_SIGMA * S)
    tau = _WIDTH * h / (8.0 * math.sqrt(2.0) * S)
    n = next_fast_len(2 * (int(math.ceil(X / h)) + _WIDTH + 2))
    return xc, sc, h, tau, n


def _t3_spread_weights(xp, h, tau, n):
    """Free-space Gaussian spreading stencil for centered points xp
    (float64) on the grid u_i = (i - n/2) h: returns (idx [M, W],
    wts [M, W])."""
    i0, wts = _stencil_weights(xp * (1.0 / h) + (n // 2), h, tau)
    idx = torch.clamp(i0[:, None] + torch.arange(_WIDTH, device=xp.device), 0, n - 1)
    return idx, wts


def _type3(pts, c, freqs, isign):
    """Type 3 in len(pts) dimensions: center both sets, spread c e^{isign
    i sc x'} on the free-space grid, one type 2 at theta = s' h, then the
    product deconvolution and the x-center phase.  The points' and the
    frequencies' geometry (centering, phases, grid positions) is float64
    on the device, the values float32."""
    dev = _device(*pts, c, *freqs)
    pts = [to_device(p, dev) for p in pts]
    freqs = [to_device(s, dev) for s in freqs]
    cr, ci = promote_to_split(c, dev)
    ext = _extents(pts + freqs)
    dims = len(pts)
    geoms = [_t3_geom(ext[d], ext[dims + d]) for d in range(dims)]
    sgn = 1.0 if isign >= 0 else -1.0
    xp = [p.to(torch.float64) - g[0] for p, g in zip(pts, geoms)]
    sp = [s.to(torch.float64) - g[1] for s, g in zip(freqs, geoms)]
    # c'_j = c_j e^{isign i sc . x'_j} (center phase on the source side)
    ph = sgn * sum(g[1] * v for g, v in zip(geoms, xp))
    cph, sph = torch.cos(ph).to(torch.float32), torch.sin(ph).to(torch.float32)
    c2r, c2i = cr * cph - ci * sph, cr * sph + ci * cph
    stencils = [_t3_spread_weights(v, g[2], g[3], g[4]) for v, g in zip(xp, geoms)]
    ns = [g[4] for g in geoms]
    gr, gi = _spread(c2r, c2i, [s[0] for s in stencils], [s[1] for s in stencils], ns)
    lead = cr.shape[:-1]
    gr, gi = gr.reshape(*lead, *ns), gi.reshape(*lead, *ns)
    # the semi-discrete transform h * sum_i g_i e^{isign i s' u_i} is a
    # type 2 with mode index m = i - n/2 and theta_k = s' h
    vr, vi = _impl_type2([v * g[2] for v, g in zip(sp, geoms)], gr, gi, isign)
    # deconvolve by the product of phi_hat(s') = 2 sqrt(pi tau) e^{-s'^2 tau},
    # restore the x-center phase e^{isign i s . xc} (at the uncentered s),
    # fold h
    scale = math.prod(g[2] / (2.0 * math.sqrt(math.pi * g[3])) for g in geoms)
    amp = scale * torch.exp(sum(v * v * g[3] for v, g in zip(sp, geoms)))
    ph2 = sgn * sum(s.to(torch.float64) * g[0] for s, g in zip(freqs, geoms))
    c2 = (torch.cos(ph2) * amp).to(torch.float32)
    s2 = (torch.sin(ph2) * amp).to(torch.float32)
    return merge(vr * c2 - vi * s2, vr * s2 + vi * c2)


def nufft1d3(x, c, s, *, isign: int = +1):
    """Type-3 NUFFT: f_k = sum_j c_j e^{isign i s_k x_j} for arbitrary
    real points x_j and frequencies s_k (finufft nufft1d3 semantics).

    Reduction to type 2 (Lee-Greengard): center both sets, spread c_j
    with a Gaussian phi onto a free-space grid u_i = i*h (h = pi/(2S) so
    every target maps to theta_k = s_k*h inside (-pi/2, pi/2]), and
    evaluate the semi-discrete transform as a type 2 with mode index i and
    points theta_k, then deconvolve by phi_hat(s_k).
    """
    return _type3([x], c, [s], isign)


def nufft2d3(x, y, c, s, t, *, isign: int = +1):
    """2-D type-3 NUFFT: f_k = sum_j c_j e^{isign i (s_k x_j + t_k y_j)}
    for arbitrary points (x, y)_j and frequencies (s, t)_k (finufft
    nufft2d3 semantics): per-dimension geometry, product Gaussian
    spreading, one 2-D type 2, product deconvolution."""
    return _type3([x, y], c, [s, t], isign)


def nufft3d3(x, y, z, c, s, t, u, *, isign: int = +1):
    """3-D type-3 NUFFT: f_k = sum_j c_j e^{isign i (s x + t y + u z)}
    (finufft nufft3d3 semantics); see nufft2d3."""
    return _type3([x, y, z], c, [s, t, u], isign)
