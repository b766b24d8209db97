"""Split-step Fourier integrator for the nonlinear Schrodinger equation
(and the Gross-Pitaevskii equation with an external potential); torch
port of ``fft_wgpu_tpu.models.nlse``:

    i psi_t + (1/2) laplacian(psi) + g |psi|^2 psi - V(x) psi = 0

on a periodic box, 1-D or 2-D.  Strang splitting: the nonlinear/potential
phase rotation is EXACT (|psi| is invariant under it), the linear step is
exact in Fourier space (multiply by exp(-i |k|^2 dt / 2)) — the canonical
pseudo-spectral method for dispersive PDE, O(dt^2) in time and spectrally
accurate in space.

State is the SPLIT (re, im) complex field; the linear step is a forward
and an inverse C2C over the grid axes (``nd.fftn_split``: on a CUDA
tensor the row kernel in 1-D, the fused-plane kernel for a 2-D plane in
its envelope).  Phase tables exp(-i k^2 dt/2) are f64-generated on the
host and cast once.  The rollout is a Python loop over the steps.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.complex_utils import host_table, to_device
from ..core.twiddle import FORWARD, INVERSE
from ..ops.nd import fftn_split
from ._plan import StepperPlan, resolve_device

__all__ = ["NLSEPlan", "nlse_init", "nlse_step", "nlse_rollout",
           "bright_soliton", "free_gaussian"]


class NLSEPlan(StepperPlan):
    """Immutable split-step stepper config (see :class:`StepperPlan`)."""


def nlse_init(shape, lengths, dt: float, g: float = 1.0, potential=None, *,
              device=None) -> NLSEPlan:
    """Precompute the half/full linear phase tables for a periodic grid, on
    ``device`` (the current CUDA device by default).

    shape: (n,) or (ny, nx) grid points; lengths: matching box sizes;
    g: nonlinear coefficient (+1 focusing, -1 defocusing, 0 linear);
    potential: optional real array or tensor V broadcastable to `shape`
    (GPE trap), moved to ``device``.
    """
    shape = tuple(int(s) for s in shape)
    if np.ndim(lengths) == 0:
        lengths = (float(lengths),) * len(shape)
    lengths = tuple(float(L) for L in lengths)
    if len(lengths) != len(shape):
        raise ValueError("lengths must match shape rank")
    if len(shape) not in (1, 2):
        raise ValueError("1-D and 2-D grids supported")
    device = resolve_device(device)
    k2 = np.zeros(shape, np.float64)
    for ax, (n, L) in enumerate(zip(shape, lengths)):
        k = 2.0 * np.pi * np.fft.fftfreq(n, L / n).astype(np.float64)
        kshape = [1] * len(shape)
        kshape[ax] = n
        k2 = k2 + (k.reshape(kshape)) ** 2
    # linear propagator over a full step: exp(-i k^2 dt / 2)
    ph = -0.5 * k2 * float(dt)
    consts = {
        "shape": shape, "dt": float(dt), "g": float(g),
        "cos": host_table(np.cos(ph), device), "sin": host_table(np.sin(ph), device),
        "ndim": len(shape),
    }
    if potential is not None:
        consts["V"] = to_device(potential, device)
    return NLSEPlan(consts, device)


def _linear(c, ur, ui):
    """Full linear step: multiply the spectrum by exp(-i k^2 dt / 2)."""
    axes = tuple(range(ur.ndim - c["ndim"], ur.ndim))
    fr, fi = fftn_split(ur, ui, axes, FORWARD, None)
    cs, sn = c["cos"], c["sin"]
    gr, gi = fr * cs - fi * sn, fr * sn + fi * cs
    n_total = float(np.prod(c["shape"]))
    return fftn_split(gr, gi, axes, INVERSE, 1.0 / n_total)


def _phase(c, ur, ui, frac):
    """Nonlinear/potential rotation over frac*dt: exact phase
    exp(i (g |psi|^2 - V) frac dt)."""
    theta = c["g"] * (ur * ur + ui * ui)
    V = c._consts.get("V")
    if V is not None:
        theta = theta - V
    theta = theta * (frac * c["dt"])
    cs, sn = torch.cos(theta), torch.sin(theta)
    return ur * cs - ui * sn, ur * sn + ui * cs


def nlse_step(c, ur, ui):
    """One Strang split step: half nonlinear, full linear, half nonlinear."""
    ur, ui = c.split_field((ur, ui))
    ur, ui = _phase(c, ur, ui, 0.5)
    ur, ui = _linear(c, ur, ui)
    return _phase(c, ur, ui, 0.5)


def nlse_rollout(c, psi0, steps: int, keep_every: int = 0):
    """Integrate the field psi0 for `steps` Strang steps.  psi0: (re, im)
    pair or complex array or tensor [..., *shape].  keep_every=0 returns
    the final split field; keep_every=s additionally returns the
    trajectory sampled every s steps (split pair with a new leading time
    axis).

    Consecutive half-phases are NOT merged across step boundaries so the
    per-sample states are true Strang states.
    """
    ur, ui = c.split_field(psi0)
    if keep_every and steps % keep_every:
        raise ValueError("steps must be a multiple of keep_every")
    if not keep_every:
        for _ in range(steps):
            ur, ui = nlse_step(c, ur, ui)
        return ur, ui
    tr, ti = [], []
    for _ in range(steps // keep_every):
        for _ in range(keep_every):
            ur, ui = nlse_step(c, ur, ui)
        tr.append(ur)
        ti.append(ui)
    if not tr:
        return (ur, ui), (ur.new_empty((0, *ur.shape)), ui.new_empty((0, *ui.shape)))
    return (ur, ui), (torch.stack(tr), torch.stack(ti))


def bright_soliton(n: int, length: float, eta: float = 1.0, v: float = 0.0,
                   x0: float = 0.0, t: float = 0.0, *, device=None):
    """Analytic bright soliton of the focusing NLSE (g = +1):
    psi = eta sech(eta (x - x0 - v t)) exp(i (v x + (eta^2 - v^2) t / 2)).
    Returns a split (re, im) float32 pair on an n-point grid centred on 0,
    on ``device`` (the current CUDA device by default).
    """
    device = resolve_device(device)
    x = (np.arange(n, dtype=np.float64) - n / 2) * (length / n)
    env = eta / np.cosh(eta * (x - x0 - v * t))
    ph = v * x + 0.5 * (eta * eta - v * v) * t
    return host_table(env * np.cos(ph), device), host_table(env * np.sin(ph), device)


def free_gaussian(grids, sigma: float, t: float = 0.0, *, device=None):
    """Analytic free-Schrodinger (g = 0) evolution of a Gaussian
    psi(x,0) = exp(-|x|^2 / (2 sigma^2)) (any dimension; `grids` is a
    list of 1-D coordinate arrays, meshgrid'ed with ij indexing).
    Returns a split (re, im) float32 pair on ``device`` (the current CUDA
    device by default).
    """
    device = resolve_device(device)
    mesh = np.meshgrid(*[np.asarray(g, np.float64) for g in grids],
                       indexing="ij")
    r2 = sum(m * m for m in mesh)
    s2 = sigma * sigma
    a = s2 + 1j * t  # width parameter evolution
    psi = (s2 / a) ** (len(grids) / 2.0) * np.exp(-r2 / (2.0 * a))
    return host_table(np.real(psi), device), host_table(np.imag(psi), device)
