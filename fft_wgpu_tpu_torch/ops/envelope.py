"""Signal envelope via frequency-domain band splitting, scipy.signal.envelope
parity with scipy >= 1.16 semantics (torch port of
``fft_wgpu_tpu.ops.envelope``).

All band arithmetic (bin index windows, analytic doubling, residual
masks, the unpaired-Nyquist corrections) is static host numpy, uploaded
once per configuration and device; a call is transform -> gather/mask ->
inverse transform.  Real input rides the R2C route
(``rfft.rfft_last_split``: the R2C kernel for pow2 n on the card, the
composite R2C kernel for composite n in its envelope, else the packed
path for even n and a C2C for odd n) and its residual the C2R route
(``rfft.irfft_last_split``); complex input and the baseband inverse the
plan's C2C along the last axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.complex_utils import host_table, merge, promote_to_split
from ..core.twiddle import FORWARD, INVERSE
from ..plan.plan import get_plan
from .helpers import _iscomplex, _tensor
from .rfft import irfft_last_split, rfft_last_split

__all__ = ["envelope"]


def _band_bins(n: int, start: int, stop: int) -> np.ndarray:
    """Bin indices of the band [start, stop) on an n-point spectrum.

    Equivalent to scipy's two branches (direct slice vs fftshift+slice):
    both reduce to arange(start, stop) mod n."""
    return np.arange(start, stop, dtype=np.int64) % n


@functools.lru_cache(maxsize=32)
def _tables(n: int, nout: int, start: int, stop: int, residual, device):
    """(band, dbl, mask, maskb) on ``device``: the band's bin indices, the
    analytic doubling of the one-sided bins, the residual mask over the
    n-point spectrum and over the one-sided bins, the latter with the
    unpaired-Nyquist factor of the resampled residual folded in."""
    nb = n // 2 + 1                       # one-sided bin count (real input)
    band = _band_bins(n, start, stop)

    # Analytic-signal doubling for real inputs (negative bins are zero, so
    # the band's positive half carries the full amplitude).
    dbl = np.ones(nb, np.float64)
    if start > 0:
        dbl[start:stop] = 2.0
    elif stop > 0:
        dbl[1:stop] = 2.0

    # Residual mask over the n-point spectrum: band removed; lowpass
    # additionally removes everything at-or-above the band.
    mask = np.ones(n, np.float64)
    mask[band] = 0.0
    if residual == "lowpass":
        if stop > 0:
            mask[stop:(n + 1) // 2] = 0.0
        else:
            mask[n + start:] = 0.0
            mask[0:(n + 1) // 2] = 0.0
    maskb = mask[:nb].copy()
    m = min(n, nout)
    if nout != n and m % 2 == 0:
        maskb[m // 2] *= 2.0 if nout < n else 0.5
    return (torch.from_numpy(band).to(device), host_table(dbl, device),
            host_table(mask, device), host_table(maskb, device))


def envelope(z, bp_in: tuple = (1, None), *, n_out: int | None = None,
             squared: bool = False, residual: str | None = "lowpass",
             axis: int = -1):
    """Envelope (and band residual) of a real or complex signal.

    scipy.signal.envelope parity: returns ``z_env`` of the input shape
    (with `axis` resampled to `n_out`) when ``residual is None``, else
    the pair stacked along a new leading axis of length 2 (so
    ``z_env, z_res = envelope(...)`` unpacks).  ``bp_in`` selects the
    analysis band in DFT-bin units; ``residual='lowpass'`` keeps only the
    below-band part, ``'all'`` everything outside the band.
    """
    z0 = _tensor(z)
    is_cplx = _iscomplex(z0)
    if not (-z0.ndim <= axis < z0.ndim):
        raise ValueError(f"invalid axis={axis} for shape {tuple(z0.shape)}")
    n = z0.shape[axis]
    if n <= 0:
        raise ValueError("z.shape[axis] must be > 0")
    if len(bp_in) != 2 or not all(b is None or isinstance(b, (int, np.integer))
                                  for b in bp_in):
        raise ValueError(f"bp_in={bp_in!r} is not a 2-tuple of int|None")
    if n_out is not None and (not isinstance(n_out, (int, np.integer))
                              or n_out <= 0):
        raise ValueError(f"n_out={n_out!r} is not a positive int or None")
    if residual not in ("lowpass", "all", None):
        raise ValueError(f"residual={residual!r} not in ('lowpass','all',None)")

    nout = int(n_out) if n_out is not None else n
    start = int(bp_in[0]) if bp_in[0] is not None else -(n // 2)
    stop = int(bp_in[1]) if bp_in[1] is not None else (n + 1) // 2
    if not (-(n // 2) <= start < stop <= (n + 1) // 2):
        raise ValueError(f"need -n//2 <= bp_in[0] < bp_in[1] <= (n+1)//2 "
                         f"for n={n}, got {bp_in!r}")

    nb = n // 2 + 1
    lb = stop - start
    m = min(n, nout)                      # resampling: surviving bins
    m2 = m // 2 + 1
    band, dbl, mask, maskb = _tables(n, nout, start, stop, residual, z0.device)
    p_bb = get_plan(nout)                 # baseband inverse (length n_out)

    def baseband_env(Zr, Zi):
        """|ifft(Z[band] zero-padded/truncated to n_out)| * (n_out/n)."""
        br, bi = Zr.index_select(-1, band), Zi.index_select(-1, band)
        if lb >= nout:
            br, bi = br[..., :nout], bi[..., :nout]
        else:
            br = torch.nn.functional.pad(br, (0, nout - lb))
            bi = torch.nn.functional.pad(bi, (0, nout - lb))
        # fak * ifft  ==  (n_out/n) * (1/n_out) * sum  ==  (1/n) * sum
        er, ei = p_bb._execute_split(br, bi, INVERSE, 1.0 / n)
        sq = er * er + ei * ei
        return sq if squared else torch.sqrt(sq)

    def resample_c2c(Zr, Zi):
        """scipy.signal.resample(Z, n_out, domain='freq') on split data;
        total scale folded to 1/n (ifft's 1/n_out times 1/s_fac)."""
        if nout == n:
            return get_plan(n)._execute_split(Zr, Zi, INVERSE, 1.0 / n)
        Y = []
        for Z in (Zr, Zi):
            parts = [Z[..., :m2]]
            if m2 < m:
                parts.append(Z.new_zeros(*Z.shape[:-1], nout - m))
                parts.append(Z[..., m2 - m:])
            else:
                parts.append(Z.new_zeros(*Z.shape[:-1], nout - m2))
            y = torch.cat(parts, dim=-1)
            if m % 2 == 0:
                if nout < n:      # fold the bin pair into one unpaired bin
                    y[..., nout - m // 2] += Z[..., n - m // 2]
                else:             # split the unpaired bin into a pair
                    y[..., m // 2] *= 0.5
                    y[..., nout - m // 2] = y[..., m // 2]
            Y.append(y)
        return p_bb._execute_split(Y[0], Y[1], INVERSE, 1.0 / n)

    if not is_cplx:
        v = z0.to(torch.float32).movedim(axis, -1)
        Rr, Ri = rfft_last_split(v, None)            # nb bins
        Rr, Ri = Rr * dbl, Ri * dbl
        env = baseband_env(torch.nn.functional.pad(Rr, (0, n - nb)),
                           torch.nn.functional.pad(Ri, (0, n - nb))).movedim(-1, axis)
        if residual is None:
            return env
        Mr, Mi = Rr * maskb, Ri * maskb
        kb = nout // 2 + 1
        if kb <= nb:
            Mr, Mi = Mr[..., :kb], Mi[..., :kb]
        else:
            Mr = torch.nn.functional.pad(Mr, (0, kb - nb))
            Mi = torch.nn.functional.pad(Mi, (0, kb - nb))
        res = irfft_last_split(Mr, Mi, nout, 1.0 / n)   # fak * irfft == 1/n total
        return torch.stack([env, res.movedim(-1, axis)], dim=0)

    vr, vi = (t.movedim(axis, -1) for t in promote_to_split(z0))
    Zr, Zi = get_plan(n)._execute_split(vr, vi, FORWARD, None)
    env = baseband_env(Zr, Zi).movedim(-1, axis)
    if residual is None:
        return env
    rr, ri = resample_c2c(Zr * mask, Zi * mask)
    # scipy stacks env (real) with the complex residual -> complex result
    return torch.stack([merge(env, torch.zeros_like(env)),
                        merge(rr.movedim(-1, axis), ri.movedim(-1, axis))], dim=0)
