"""Discrete cosine / sine transforms, scipy.fft types I-IV and their N-D
forms (torch port of ``fft_wgpu_tpu.ops.dct``).

The JAX package's compositions, on the port's transforms:

    DCT-I:   Re(R2C(even extension, length 2(n-1)))[:n]
    DCT-II:  v[j] = x[2j], v[n-1-j] = x[2j+1];  V = C2C(v + 0i)
             X[k] = 2 * Re( exp(-i*pi*k/(2n)) * V[k] )
    DCT-III: the inverse of II (its norms matched)
    DCT-IV:  the modulated C2C of the signed even-odd permutation
    DST-I:   -Im(R2C(odd extension, length 2(n+1)))[1:n+1]
    DST-II/III: the DCT of the sign-flipped, reversed sequence
    DST-IV:  (-1)^k * DCT-IV(reversed input)

Each C2C runs along the transform's own axis through
``Plan._execute_split_axis``: on a CUDA tensor the row kernel for the last
axis, the axis(-2) kernel for axis -2 and its axis(-3) entry for the axes
before it, with no transpose, so ``dctn`` of a 4096 x 4096 plane is one
axis(-2) launch and one row launch.  DCT-I and DST-I ride the R2C route of
the last axis (``rfft.rfft_last_split``: the R2C kernel for pow2 extensions
on the card).  The permutations are ``index_select`` along the axis; the
twiddle and modulation tables are built in float64 on the host, cast once
to float32 and uploaded once per length and device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.complex_utils import host_table, real_part
from ..core.twiddle import FORWARD, INVERSE
from ..plan.plan import get_plan
from .nd import _norm_axes, _sizes
from .rfft import rfft_last_split
from .transforms import _checked_length, _resize_axis
from ..utils.jit_cache import cached_call, shape_key

__all__ = ["dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn"]


def _even_odd_perm(n: int) -> np.ndarray:
    """v = x[perm]: the evens ascending, then the odds descending."""
    evens = np.arange(0, n, 2)
    odds = np.arange(1, n, 2)[::-1]
    return np.concatenate([evens, odds]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _perms(n: int, device):
    """The even-odd permutation and its inverse, as index tensors."""
    perm = _even_odd_perm(n)
    return (torch.from_numpy(perm).to(device),
            torch.from_numpy(np.argsort(perm)).to(device))


@functools.lru_cache(maxsize=None)
def _halfshift(n: int, sign: int, device):
    """cos and sin of sign * pi * k / (2n), k = 0..n-1."""
    theta = sign * np.pi * np.arange(n, dtype=np.float64) / (2.0 * n)
    return host_table(np.cos(theta), device), host_table(np.sin(theta), device)


@functools.lru_cache(maxsize=None)
def _dct4_tables(n: int, device):
    """DCT-IV's signed pre-modulation and post-modulation (re, im each)."""
    signs = np.ones(n)
    signs[(n + 1) // 2:] = -1.0  # the mirrored (odd-origin) half of the perm
    m = np.arange(n, dtype=np.float64)
    pre = np.exp(-1j * np.pi * m / n)
    post = np.exp(-1j * np.pi * (2 * m + 1) / (4.0 * n))
    return tuple(host_table(t, device) for t in (signs * pre.real, signs * pre.imag,
                                                 post.real, post.imag))


@functools.lru_cache(maxsize=None)
def _scales(kind: str, n: int, device):
    """The ortho scale vectors and the DST signs (-1)^k, as float32."""
    if kind == "dct1_in":
        s = np.ones(n, np.float32)
        s[0] = s[-1] = np.sqrt(2.0, dtype=np.float64).astype(np.float32)
    elif kind == "dct1_out":
        s = np.full(n, 1.0 / np.sqrt(2.0 * (n - 1)), np.float32)
        s[0] = s[-1] = s[0] / np.sqrt(2.0)
    elif kind == "dct2_out":
        s = np.full(n, 1.0 / np.sqrt(2.0 * n), np.float32)
        s[0] = 1.0 / np.sqrt(4.0 * n)
    elif kind == "dct3_in":
        s = np.full(n, 1.0 / np.sqrt(2.0 * n), np.float32)
        s[0] = 1.0 / np.sqrt(float(n))
    else:  # "signs"
        s = ((-1.0) ** np.arange(n)).astype(np.float32)
    return host_table(s, device)


def _on_axis(t, axis: int, ndim: int):
    """A 1-D table of the length of ``axis`` shaped to broadcast along it."""
    return t.reshape((-1,) + (1,) * (ndim - 1 - axis % ndim))


def _norm_opt(norm):
    """scipy norm strings: None == 'backward'; 'ortho' and 'forward'
    pass through; anything else is rejected."""
    if norm in (None, "backward"):
        return None
    if norm in ("ortho", "forward"):
        return norm
    raise ValueError(f"invalid norm {norm!r} "
                     "(expected 'backward', 'ortho', or 'forward')")


def _roundtrip_factor(type, n):
    """The unnormalized DCT/DST round-trip scale: 2(n-1) for DCT-I,
    2(n+1) for DST-I, 2n otherwise."""
    return 2 * (n - 1) if type == 1 else 2 * n


def _c2c(re, im, axis, sign, scale):
    """The plan's C2C of (re, im) along ``axis``, with no transpose on the
    kernels' routes."""
    n = re.shape[axis]
    return get_plan(n, "auto")._execute_split_axis(re, im, sign, scale, axis)


def dct(x, type: int = 2, axis: int = -1, norm=None):
    """DCT along `axis` (types 1-4, scipy.fft semantics)."""
    norm = _norm_opt(norm)
    n = _checked_length(x, None, axis)
    if norm == "forward":
        # scipy puts the whole round-trip scale on the forward transform
        return dct(x, type, axis, None) / _roundtrip_factor(type, n)
    if type == 1:
        return _dct1(x, axis, norm)
    if type == 2:
        return _dct2(x, axis, norm)
    if type == 3:
        return _dct3(x, axis, norm)
    if type == 4:
        return _dct4(x, axis, norm)
    raise NotImplementedError(f"DCT type {type} (supported: 1-4)")


def idct(x, type: int = 2, axis: int = -1, norm=None):
    """Inverse DCT (scipy semantics: the inverse of `dct(type=...)`)."""
    norm = _norm_opt(norm)
    n = _checked_length(x, None, axis)
    if norm == "forward":
        # the forward carried the whole scale, so the inverse is the raw
        # transpose-pair transform (DCT-II <-> DCT-III; I/IV self-paired)
        pair = {1: 1, 2: 3, 3: 2, 4: 4}[type]
        return dct(x, pair, axis, None)
    if type == 1:
        # DCT-I is self-inverse up to 2(n-1) (ortho: exactly self-inverse)
        if norm == "ortho":
            return _dct1(x, axis, "ortho")
        return _dct1(x, axis, None) / (2 * (n - 1))
    if type == 2:
        if norm == "ortho":
            return _dct3(x, axis, "ortho")
        return _idct2_core(real_part(x), axis)  # backward: exact inverse incl. 1/(2n)
    if type == 3:
        if norm == "ortho":
            return _dct2(x, axis, "ortho")
        return _dct2(x, axis, None) / (2 * n)
    if type == 4:
        # DCT-IV is self-inverse up to 2n (ortho: exactly self-inverse)
        if norm == "ortho":
            return _dct4(x, axis, "ortho")
        return _dct4(x, axis, None) / (2 * n)
    raise NotImplementedError(f"IDCT type {type} (supported: 1-4)")


def _dct1(x, axis, norm):
    """DCT-I via the even-symmetric extension of length 2(n-1): bins 0..n-1
    of its R2C half spectrum (n of them) are the transform."""
    v = real_part(x)
    if v.shape[axis] < 2:
        raise ValueError("DCT-I requires n >= 2")
    return cached_call(("dct1", shape_key(v), axis, norm), lambda u: _dct1_impl(u, axis, norm),
                       v)


def _dct1_impl(v, axis, norm):
    n = v.shape[axis]
    v = v.movedim(axis, -1)
    if norm == "ortho":
        # scipy's orthogonal DCT-I: endpoints scaled sqrt(2) on input,
        # 1/sqrt(2) on output, overall 1/sqrt(2(n-1)).
        v = v * _scales("dct1_in", n, v.device)
    ext = torch.cat([v, v[..., 1:-1].flip(-1)], dim=-1)
    Vr, _ = rfft_last_split(ext, None)  # m//2+1 == n bins
    X = Vr[..., :n]
    if norm == "ortho":
        X = X * _scales("dct1_out", n, X.device)
    return X.movedim(-1, axis)


def _dct4(x, axis, norm):
    """DCT-IV via one modulated C2C FFT of the even-odd permuted input:
    with u[m] = s_m * x[perm][m] (s=-1 on the mirrored half) the identity
    X4[k] = 2*Re( e^{-i pi (2k+1)/(4n)} * FFT(u * e^{-i pi m / n})[k] )."""
    v = real_part(x)
    return cached_call(("dct4", shape_key(v), axis, norm), lambda u: _dct4_impl(u, axis, norm),
                       v)


def _dct4_impl(v, axis, norm):
    n, nd = v.shape[axis], v.ndim
    perm, _ = _perms(n, v.device)
    prer, prei, postr, posti = (_on_axis(t, axis, nd) for t in _dct4_tables(n, v.device))
    u = v.index_select(axis, perm)
    Vr, Vi = _c2c(u * prer, u * prei, axis, FORWARD, None)
    X = 2.0 * (Vr * postr - Vi * posti)
    if norm == "ortho":
        X = X * float(np.float32(1.0 / np.sqrt(2.0 * n)))
    return X


def _dct2(x, axis, norm):
    v = real_part(x)
    return cached_call(("dct2", shape_key(v), axis, norm), lambda u: _dct2_impl(u, axis, norm),
                       v)


def _dct2_impl(v, axis, norm):
    n, nd = v.shape[axis], v.ndim
    perm, _ = _perms(n, v.device)
    cr, ci = (_on_axis(t, axis, nd) for t in _halfshift(n, -1, v.device))
    w = v.index_select(axis, perm)
    Vr, Vi = _c2c(w, torch.zeros_like(w), axis, FORWARD, None)
    X = 2.0 * (Vr * cr - Vi * ci)  # 2*Re(e^{-i pi k/2n} V[k])
    if norm == "ortho":
        X = X * _on_axis(_scales("dct2_out", n, X.device), axis, nd)
    return X


def _idct2_core(Y, axis):
    """Backward-norm inverse of DCT-II:
    invperm(Re(IFFT( 0.5 * e^{+i pi k/2n} * (Y - i*Yrev) )))."""
    return cached_call(("idct2", shape_key(Y), axis), lambda u: _idct2_impl(u, axis), Y)


def _idct2_impl(Y, axis):
    n, nd = Y.shape[axis], Y.ndim
    _, inv_perm = _perms(n, Y.device)
    cr, ci = (_on_axis(t, axis, nd) for t in _halfshift(n, +1, Y.device))
    Yt = torch.cat([torch.zeros_like(Y.narrow(axis, 0, 1)),
                    Y.narrow(axis, 1, n - 1).flip(axis)], dim=axis)
    # 0.5*(Y - i*Yt)*(cr + i*ci)
    Vr = 0.5 * (Y * cr + Yt * ci)
    Vi = 0.5 * (Y * ci - Yt * cr)
    vr, _ = _c2c(Vr, Vi, axis, INVERSE, 1.0 / n)
    return vr.index_select(axis, inv_perm)


def _dct3(x, axis, norm):
    """DCT-III: backward = 2n * idct2_core; ortho = backward with the input
    pre-scaled by [1/sqrt(n), 1/sqrt(2n), ...]."""
    v = real_part(x)
    n = v.shape[axis]
    if norm == "ortho":
        v = v * _on_axis(_scales("dct3_in", n, v.device), axis, v.ndim)
    return _idct2_core(v, axis) * (2 * n)


def dst(x, type: int = 2, axis: int = -1, norm=None):
    """DST-II/III via the DCT identity
    DST2(x) = reverse( DCT2( (-1)^j * x ) )  and its transpose for type 3.
    (Sign-flip and reversal are orthogonal maps, so norms carry over.)"""
    norm = _norm_opt(norm)
    xr = real_part(x)
    n = _checked_length(xr, None, axis)
    signs = _on_axis(_scales("signs", n, xr.device), axis, xr.ndim)

    if type == 1:
        if norm == "forward":
            return _dst1(xr, axis, None) / (2 * (n + 1))
        return _dst1(xr, axis, norm)
    if type == 2:
        y = dct(xr * signs, type=2, axis=axis, norm=norm)
        return y.flip(axis)
    if type in (3, 4):
        # DST-IV(x)[k] = (-1)^k * DCT-IV(reverse(x))[k]; both maps are
        # orthogonal so the norm carries over unchanged.
        y = dct(xr.flip(axis), type=type, axis=axis, norm=norm)
        return y * signs
    raise NotImplementedError(f"DST type {type} (supported: 1-4)")


def _dst1(xr, axis, norm):
    """DST-I via the odd-symmetric extension of length 2(n+1): bins 1..n of
    its R2C half spectrum (m//2+1 == n+2 bins), negated imaginary parts."""
    return cached_call(("dst1", shape_key(xr), axis, norm), lambda u: _dst1_impl(u, axis, norm),
                       xr)


def _dst1_impl(xr, axis, norm):
    n = xr.shape[axis]
    v = xr.movedim(axis, -1)
    z = torch.zeros_like(v[..., :1])
    ext = torch.cat([z, v, z, -v.flip(-1)], dim=-1)
    _, Vi = rfft_last_split(ext, None)
    X = -Vi[..., 1: n + 1]
    if norm == "ortho":
        X = X * float(np.float32(1.0 / np.sqrt(2.0 * (n + 1))))
    return X.movedim(-1, axis)


def idst(x, type: int = 2, axis: int = -1, norm=None):
    """Inverse DST (scipy semantics)."""
    norm = _norm_opt(norm)
    n = _checked_length(x, None, axis)
    if norm == "forward":
        pair = {1: 1, 2: 3, 3: 2, 4: 4}[type]
        return dst(x, pair, axis, None)
    if type not in (1, 2, 3, 4):
        raise NotImplementedError(f"IDST type {type} (supported: 1-4)")
    pair = {1: 1, 2: 3, 3: 2, 4: 4}[type]
    if norm == "ortho":
        return dst(x, type=pair, axis=axis, norm="ortho")
    return dst(x, type=pair, axis=axis) / (2 * (n + 1) if type == 1 else 2 * n)


def _apply_nd(fn1d, x, type, s, axes, norm):
    """Separable N-D transform: the 1-D transform applied per axis
    (scipy.fft.dctn semantics: `s` trims/zero-pads each axis first, and
    with axes=None it selects the LAST len(s) axes)."""
    v = real_part(x)
    s, axes = _norm_axes(v.shape, None if s is None else list(s),
                         None if axes is None else list(axes))
    # every length is checked before the first axis is transformed
    sizes = _sizes(v.shape, s, axes)
    if type == 1 and fn1d in (dct, idct) and min(sizes, default=2) < 2:
        raise ValueError("DCT-I requires n >= 2")

    def impl(v):
        for sz, ax in zip(s, axes):
            if sz is not None and v.shape[ax] != sz:
                v = _resize_axis(v, sz, ax)
        for ax in axes:
            v = fn1d(v, type=type, axis=ax, norm=norm)
        return v

    key = ("ndsep", fn1d.__name__, shape_key(v), type, tuple(s), tuple(axes), norm)
    return cached_call(key, impl, v)


def dctn(x, type: int = 2, s=None, axes=None, norm=None):
    """N-D DCT as separable 1-D DCTs over `axes` (scipy.fft.dctn)."""
    return _apply_nd(dct, x, type, s, axes, norm)


def idctn(x, type: int = 2, s=None, axes=None, norm=None):
    """N-D inverse DCT (scipy.fft.idctn)."""
    return _apply_nd(idct, x, type, s, axes, norm)


def dstn(x, type: int = 2, s=None, axes=None, norm=None):
    """N-D DST as separable 1-D DSTs over `axes` (scipy.fft.dstn)."""
    return _apply_nd(dst, x, type, s, axes, norm)


def idstn(x, type: int = 2, s=None, axes=None, norm=None):
    """N-D inverse DST (scipy.fft.idstn)."""
    return _apply_nd(idst, x, type, s, axes, norm)
