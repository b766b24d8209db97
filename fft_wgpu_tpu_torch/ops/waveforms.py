"""Waveform / test-signal generators, scipy.signal parity (torch port of
``fft_wgpu_tpu.ops.waveforms``).

Host generators, as in the JAX package: numpy, list or scalar input is
computed in float64 numpy and returned as a float64 (or complex128) numpy
array.  A torch tensor ``t`` for ``chirp``, ``sweep_poly``, ``gausspulse``,
``sawtooth`` and ``square`` is computed in float64 on ``t``'s own device
and returned as a tensor there, so a time grid on the card never makes a
host round trip (the JAX functions take a ``jax.Array`` through
``np.asarray``; this is the port's counterpart of that input).  No
function here runs a transform or launches a kernel.

Parity targets: scipy.signal.{chirp, sweep_poly, gausspulse, sawtooth,
square, unit_impulse, max_len_seq, vectorstrength}.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "chirp",
    "sweep_poly",
    "gausspulse",
    "sawtooth",
    "square",
    "unit_impulse",
    "max_len_seq",
    "vectorstrength",
]


def _time(t):
    """``t`` as float64: a tensor on its own device (and ``torch`` as the
    array namespace), anything else as host numpy (and ``np``)."""
    if isinstance(t, torch.Tensor):
        return t.to(torch.float64), torch
    return np.asarray(t, np.float64), np


def _param(v, like):
    """A broadcastable parameter in ``like``'s namespace and device."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.asarray(v, np.float64), device=like.device)
    return np.asarray(v, np.float64)


def _chirp_phase(t, f0, t1, f1, method, vertex_zero):
    """Integrated instantaneous frequency -> phase in radians (no phi)."""
    t, xp = _time(t)
    f0 = float(f0)
    f1 = float(f1)
    t1 = float(t1)
    if method in ("linear", "lin", "li"):
        beta = (f1 - f0) / t1
        return 2 * np.pi * (f0 * t + 0.5 * beta * t * t)
    if method in ("quadratic", "quad", "q"):
        beta = (f1 - f0) / (t1 * t1)
        if vertex_zero:
            return 2 * np.pi * (f0 * t + beta * t**3 / 3)
        return 2 * np.pi * (f1 * t + beta * ((t1 - t) ** 3 - t1**3) / 3)
    if method in ("logarithmic", "log", "lo"):
        if f0 * f1 <= 0.0:
            raise ValueError(
                "For a logarithmic chirp, f0 and f1 must be nonzero and "
                "have the same sign.")
        if f0 == f1:
            return 2 * np.pi * f0 * t
        beta = t1 / np.log(f1 / f0)
        return 2 * np.pi * beta * f0 * ((f1 / f0) ** (t / t1) - 1.0)
    if method in ("hyperbolic", "hyp"):
        if f0 == 0 or f1 == 0:
            raise ValueError(
                "For a hyperbolic chirp, f0 and f1 must be nonzero.")
        if f0 == f1:
            return 2 * np.pi * f0 * t
        sing = -f1 * t1 / (f0 - f1)
        return 2 * np.pi * (-sing * f0) * xp.log(xp.abs(1 - t / sing))
    raise ValueError(
        f"method must be 'linear', 'quadratic', 'logarithmic' or "
        f"'hyperbolic', got {method!r}")


def chirp(t, f0, t1, f1, method="linear", phi=0, vertex_zero=True,
          *, complex=False):  # noqa: A002 - scipy kwarg name
    """Frequency-swept cosine, scipy.signal.chirp parity (all four sweep
    laws; ``complex=True`` returns the analytic ``exp(1j*phase)`` form,
    scipy >= 1.15).  float64 numpy in and out, or a float64 (complex128)
    tensor on ``t``'s device for a tensor ``t``."""
    phase = _chirp_phase(t, f0, t1, f1, method, vertex_zero)
    xp = torch if isinstance(phase, torch.Tensor) else np
    phi_r = _param(np.deg2rad(phi), phase)
    if complex:
        return xp.exp(1j * (phase + phi_r))
    return xp.cos(phase + phi_r)


def _polyval(coeffs, t):
    """Horner's rule, highest power first (numpy.polyval's order)."""
    out = t * 0.0
    for c in coeffs:
        out = out * t + float(c)
    return out


def sweep_poly(t, poly, phi=0):
    """Cosine with instantaneous frequency given by a polynomial in t
    (scipy.signal.sweep_poly parity: accepts coefficient sequences or
    np.poly1d; phase is the exact polynomial integral)."""
    p = poly if isinstance(poly, np.poly1d) else np.poly1d(poly)
    t, xp = _time(t)
    integ = p.integ()
    if xp is np:
        phase = 2 * np.pi * np.polyval(integ, t)
    else:
        phase = 2 * np.pi * _polyval(integ.coeffs, t)
    return xp.cos(phase + _param(np.deg2rad(phi), t))


def gausspulse(t, fc=1000, bw=0.5, bwr=-6, tpr=-60, retquad=False,
               retenv=False):
    """Gaussian-modulated sinusoid (scipy.signal.gausspulse parity,
    including ``t='cutoff'``)."""
    fc = float(fc)
    bw = float(bw)
    if fc < 0:
        raise ValueError(f"Center frequency must be >= 0, got {fc}")
    if bw <= 0:
        raise ValueError(f"Fractional bandwidth must be > 0, got {bw}")
    if bwr >= 0:
        raise ValueError(f"Reference level bwr must be < 0 dB, got {bwr}")
    # envelope exp(-a t^2) whose spectrum is `bwr` dB down at fc*bw/2 off
    # center: a = -(pi*fc*bw)^2 / (4 ln(10^(bwr/20)))
    ref = np.power(10.0, bwr / 20.0)
    a = -((np.pi * fc * bw) ** 2) / (4.0 * np.log(ref))
    if isinstance(t, str):
        if t != "cutoff":
            raise ValueError(f"If t is a string, it must be 'cutoff', "
                             f"got {t!r}")
        if tpr >= 0:
            raise ValueError(f"Reference level tpr must be < 0 dB, "
                             f"got {tpr}")
        # time where the envelope has fallen to tpr dB
        return np.sqrt(-np.log(np.power(10.0, tpr / 20.0)) / a)
    t, xp = _time(t)
    a = float(a)
    yenv = xp.exp(-a * t * t)
    yI = yenv * xp.cos(2 * np.pi * fc * t)
    yQ = yenv * xp.sin(2 * np.pi * fc * t)
    if not retquad and not retenv:
        return yI
    out = (yI,)
    if retquad:
        out += (yQ,)
    if retenv:
        out += (yenv,)
    return out


def _frac_and(t, param):
    """The phase fraction mod(t, 2 pi) / (2 pi) and ``param``, broadcast."""
    t, xp = _time(t)
    frac = (t % (2 * np.pi)) / (2 * np.pi)
    p = _param(param, t)
    if xp is np:
        return np.broadcast_arrays(frac, p)
    return torch.broadcast_tensors(frac, p)


def sawtooth(t, width=1):
    """Periodic sawtooth/triangle in [-1, 1] with period 2*pi
    (scipy.signal.sawtooth parity; `width` is the rising-ramp fraction,
    broadcastable)."""
    fb, wb = _frac_and(t, width)
    if isinstance(fb, torch.Tensor):
        y = torch.empty(fb.shape, dtype=torch.float64, device=fb.device)
    else:
        y = np.empty(fb.shape, np.float64)
    bad = (wb < 0) | (wb > 1)
    rising = (fb < wb) & ~bad
    falling = ~rising & ~bad
    # rising ramp: -1 -> 1 over width; falling ramp: 1 -> -1 over the
    # rest.  width==1 never takes the falling branch and width==0 never
    # the rising one, so neither division sees a zero denominator.
    y[rising] = 2 * fb[rising] / wb[rising] - 1
    y[falling] = 2 * (1 - fb[falling]) / (1 - wb[falling]) - 1
    y[bad] = np.nan
    return y


def square(t, duty=0.5):
    """Periodic square wave in {-1, 1} with period 2*pi
    (scipy.signal.square parity; `duty` broadcastable)."""
    fb, db = _frac_and(t, duty)
    if isinstance(fb, torch.Tensor):
        one = torch.ones_like(fb)
        y = torch.where(fb < db, one, -one)
        return torch.where((db < 0) | (db > 1), torch.full_like(fb, np.nan), y)
    y = np.where(fb < db, 1.0, -1.0)
    return np.where((db < 0) | (db > 1), np.nan, y)


def unit_impulse(shape, idx=None, dtype=float):
    """Unit impulse delta[n - idx] (scipy.signal.unit_impulse parity,
    including idx='mid')."""
    out = np.zeros(shape, dtype)
    shape = out.shape
    if idx is None:
        idx = (0,) * len(shape)
    elif idx == "mid":
        idx = tuple(s // 2 for s in shape)
    elif not hasattr(idx, "__iter__"):
        idx = (idx,) * len(shape)
    out[tuple(idx)] = 1
    return out


# Primitive-polynomial feedback taps for maximal-length LFSRs, nbits
# 2..32 (standard tables, e.g. Xilinx XAPP052 / scipy's choice).  Values
# are the tapped bit positions below the register length.
_MLS_TAPS = {
    2: [1], 3: [2], 4: [3], 5: [3], 6: [5], 7: [6], 8: [7, 6, 1],
    9: [5], 10: [7], 11: [9], 12: [11, 10, 4], 13: [12, 11, 8],
    14: [13, 12, 2], 15: [14], 16: [15, 13, 4], 17: [14], 18: [11],
    19: [18, 17, 14], 20: [17], 21: [19], 22: [21], 23: [18],
    24: [23, 22, 17], 25: [22], 26: [25, 24, 20], 27: [26, 25, 22],
    28: [25], 29: [27], 30: [29, 28, 7], 31: [28], 32: [31, 30, 10],
}


def max_len_seq(nbits, state=None, length=None, taps=None):
    """Maximal-length sequence (MLS) via a Fibonacci LFSR
    (scipy.signal.max_len_seq parity: returns (seq, final_state), bits in
    {0, 1} as int8)."""
    nbits = int(nbits)
    if taps is None:
        if nbits not in _MLS_TAPS:
            raise ValueError(
                f"nbits must be between 2 and 32 when taps is None, "
                f"got {nbits}")
        taps = _MLS_TAPS[nbits]
    taps = np.unique(np.asarray(taps, np.intp))[::-1]
    if np.any(taps < 0) or np.any(taps > nbits) or taps.size < 1:
        raise ValueError("taps must be nonzero bit positions < nbits")
    if length is None:
        length = (1 << nbits) - 1
    length = int(length)
    if state is None:
        state = np.ones(nbits, np.int8)
    else:
        state = (np.asarray(state) != 0).astype(np.int8)
    if state.ndim != 1 or state.size != nbits:
        raise ValueError("state must be a 1-D array of size nbits")
    if not np.any(state):
        raise ValueError("state must not be all zeros")
    seq = np.empty(length, np.int8)
    st = state.copy()
    # Fibonacci LFSR over a circular buffer: the new bit is the XOR of
    # the degree-nbits term (st[idx]) with the tapped terms, written in
    # place; rolling back at the end restores canonical bit order.
    idx = 0
    for i in range(length):
        out = st[idx]
        seq[i] = out
        fb = out
        for t in taps:
            fb ^= st[(t + idx) % nbits]
        st[idx] = fb
        idx = (idx + 1) % nbits
    return seq, np.roll(st, -idx)


def vectorstrength(events, period):
    """Vector strength + mean phase of events vs a period
    (scipy.signal.vectorstrength parity: scalar or array periods)."""
    events = np.asarray(events, np.float64)
    period = np.asarray(period, np.float64)
    if events.ndim > 1:
        raise ValueError("events cannot have dimensions more than 1")
    events = np.atleast_1d(events)  # scalar event is valid (scipy parity)
    if period.ndim > 1:
        raise ValueError("periods cannot have dimensions more than 1")
    scalar = period.ndim == 0
    p = np.atleast_1d(period)
    if np.any(p <= 0):
        raise ValueError("periods must be positive")
    ang = 2 * np.pi * events[np.newaxis, :] / p[:, np.newaxis]
    vec = np.exp(1j * ang).mean(axis=1)
    strength = np.abs(vec)
    phase = np.angle(vec)
    if scalar:
        return strength[0], phase[0]
    return strength, phase
