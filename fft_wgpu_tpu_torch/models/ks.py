"""Pseudo-spectral 1-D Kuramoto-Sivashinsky equation with an ETDRK4
exponential integrator (torch port of ``fft_wgpu_tpu.models.ks``).

    u_t = -u u_x - u_xx - u_xxxx   on [0, L), periodic

The canonical stiff chaotic PDE benchmark (Kassam & Trefethen 2005).
Linear part L(k) = k^2 - k^4 spans ~8 orders of magnitude at n=1024, so
explicit RK is hopeless; ETDRK4 integrates the linear term exactly and
the nonlinear term to 4th order.  The phi-function coefficients are
evaluated on the host in f64 by the Kassam-Trefethen unit-circle contour
mean (numerically stable near z = 0) and cast once to float32 device
tables.

State is the SPLIT (re, im) half spectrum riding the batched R2C/C2R
routes (on a CUDA tensor of pow2 n in 128..16384 the R2C and C2R kernels'
planar entries, four each a step); the rollout is a Python loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.complex_utils import host_table
from ..ops.rfft import irfft_last_split, rfft_last_split
from ._plan import StepperPlan, resolve_device

__all__ = ["KSPlan", "ks_init", "ks_step", "ks_rollout", "kt_initial_condition"]


class KSPlan(StepperPlan):
    """Immutable ETDRK4 stepper config (see :class:`StepperPlan`)."""


def _etdrk4_coeffs(lin: np.ndarray, h: float, m: int = 32):
    """Kassam-Trefethen contour coefficients for dt=h over the real linear
    symbol `lin` (f64): E, E2, Q, f1, f2, f3 — each shaped like lin."""
    z = h * lin[:, None].astype(np.float64)
    r = np.exp(1j * np.pi * (np.arange(1, m + 1) - 0.5) / m)[None, :]
    zr = z + r
    E = np.exp(h * lin)
    E2 = np.exp(0.5 * h * lin)
    Q = h * np.real(np.mean((np.expm1(zr / 2.0)) / zr, axis=1))
    f1 = h * np.real(np.mean(
        (-4.0 - zr + np.exp(zr) * (4.0 - 3.0 * zr + zr ** 2)) / zr ** 3, axis=1))
    f2 = h * np.real(np.mean(
        (2.0 + zr + np.exp(zr) * (-2.0 + zr)) / zr ** 3, axis=1))
    f3 = h * np.real(np.mean(
        (-4.0 - 3.0 * zr - zr ** 2 + np.exp(zr) * (4.0 - zr)) / zr ** 3, axis=1))
    return E, E2, Q, f1, f2, f3


def ks_init(n: int, length: float, dt: float, *, device=None) -> KSPlan:
    """Precompute wavenumbers, 2/3-rule dealias mask, and the six ETDRK4
    coefficient tables for an n-point grid on [0, length), on ``device``
    (the current CUDA device by default)."""
    device = resolve_device(device)
    k = (2.0 * np.pi / length) * np.fft.rfftfreq(n, 1.0 / n).astype(np.float64)
    lin = k * k - k ** 4
    E, E2, Q, f1, f2, f3 = _etdrk4_coeffs(lin, float(dt))
    mask = (np.fft.rfftfreq(n, 1.0 / n) <= n / 3.0).astype(np.float32)

    def f32(a):
        return host_table(a, device)

    return KSPlan({
        "n": n, "dt": float(dt), "k": f32(k), "mask": f32(mask),
        "E": f32(E), "E2": f32(E2), "Q": f32(Q),
        "f1": f32(f1), "f2": f32(f2), "f3": f32(f3),
    }, device)


def _nonlinear(c, vr, vi):
    """N(v)_hat = -(ik/2) (u^2)_hat from the split spectrum, dealiased."""
    n, k, m = c["n"], c["k"], c["mask"]
    u = irfft_last_split(vr, vi, n, 1.0 / n)
    ar, ai = rfft_last_split(u * u, None)
    return 0.5 * k * ai * m, -0.5 * k * ar * m


def ks_step(c, vr, vi):
    """One ETDRK4 step on the split half spectrum."""
    vr, vi = c.field(vr), c.field(vi)
    E, E2, Q, f1, f2, f3 = (c["E"], c["E2"], c["Q"],
                            c["f1"], c["f2"], c["f3"])
    nvr, nvi = _nonlinear(c, vr, vi)
    ar, ai = E2 * vr + Q * nvr, E2 * vi + Q * nvi
    nar, nai = _nonlinear(c, ar, ai)
    br, bi = E2 * vr + Q * nar, E2 * vi + Q * nai
    nbr, nbi = _nonlinear(c, br, bi)
    cr_, ci_ = E2 * ar + Q * (2.0 * nbr - nvr), E2 * ai + Q * (2.0 * nbi - nvi)
    ncr, nci = _nonlinear(c, cr_, ci_)
    vr2 = E * vr + f1 * nvr + 2.0 * f2 * (nar + nbr) + f3 * ncr
    vi2 = E * vi + f1 * nvi + 2.0 * f2 * (nai + nbi) + f3 * nci
    return vr2, vi2


def ks_rollout(c, u0, steps: int, keep_every: int = 0):
    """Integrate real u0 [..., n] for `steps` ETDRK4 steps.  keep_every=0
    returns only the final field [..., n]; keep_every=s additionally
    returns the trajectory sampled every s steps, stacked on a new
    leading-time axis [steps//s, ..., n]."""
    if keep_every and steps % keep_every:
        raise ValueError("steps must be a multiple of keep_every")
    vr, vi = rfft_last_split(c.field(u0), None)
    m = c["mask"]
    vr, vi = vr * m, vi * m
    n, inv = c["n"], 1.0 / c["n"]
    if not keep_every:
        for _ in range(steps):
            vr, vi = ks_step(c, vr, vi)
        return irfft_last_split(vr, vi, n, inv)
    traj = []
    for _ in range(steps // keep_every):
        for _ in range(keep_every):
            vr, vi = ks_step(c, vr, vi)
        traj.append(irfft_last_split(vr, vi, n, inv))
    final = irfft_last_split(vr, vi, n, inv)
    return final, torch.stack(traj) if traj else final.new_empty((0, *final.shape))


def kt_initial_condition(n: int, length: float, *, device=None):
    """The Kassam-Trefethen demo initial condition on [0, length):
    u0 = cos(2 pi x / length) (1 + sin(2 pi x / length)), float32 on
    ``device`` (the current CUDA device by default)."""
    x = np.arange(n, dtype=np.float64) * (length / n)
    th = 2.0 * np.pi * x / length
    return host_table(np.cos(th) * (1.0 + np.sin(th)), resolve_device(device))
