"""Pseudo-spectral 2-D Navier-Stokes (vorticity form) on the FFT stack
(torch port of ``fft_wgpu_tpu.models.navier_stokes``).

Method: vorticity w on a [n, n] periodic grid,

    dw/dt + u . grad(w) = nu * lap(w) + f

integrated in spectral space with the standard split: exact integrating
factor for the viscous term, RK2 (Heun) for the advection term evaluated
pseudo-spectrally with 2/3-rule dealiasing.  The velocity comes from the
streamfunction: u = (d psi/dy, -d psi/dx), psi_hat = w_hat / k^2.

State is carried as the SPLIT (re, im) half-spectrum pair.  Each 2-D
transform is the R2C (or C2R) along the rows and a C2C down axis -2
through the plan: on a CUDA tensor of pow2 n in 128..16384 the R2C, C2R
and axis(-2) kernels' planar entries (a step: axis(-2) 10, C2R 8, R2C 2).
The rollout is a Python loop over the steps.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.complex_utils import host_table
from ..ops.rfft import irfft_last_split, rfft_last_split
from ..plan.plan import get_plan
from ._plan import StepperPlan, resolve_device

__all__ = ["NS2DPlan", "ns2d_init", "ns2d_step", "ns2d_rollout", "taylor_green_vorticity"]


def _wavenumbers(n: int, device):
    """(kx[n,1], ky[1, n//2+1], ksq, dealias mask) for an rfft2 layout
    with axis 0 full-spectrum and axis 1 half-spectrum."""
    kx = np.fft.fftfreq(n, 1.0 / n).astype(np.float32)[:, None]
    ky = np.abs(np.fft.rfftfreq(n, 1.0 / n).astype(np.float32))[None, :]
    ksq = kx * kx + ky * ky
    cut = n / 3.0
    mask = ((np.abs(kx) <= cut) & (ky <= cut)).astype(np.float32)
    return tuple(host_table(a, device) for a in (kx, ky, ksq, mask))


def _rfft2_split(x):
    """Real [.., n, n] -> split half spectrum [.., n, n//2+1] (rows R2C
    then complex FFT down axis -2 through the plan layer)."""
    Xr, Xi = rfft_last_split(x, None)
    p = get_plan(Xr.shape[-2], "auto")
    return p._execute_split_axis(Xr, Xi, -1, None, -2)


def _irfft2_split(Xr, Xi, n):
    """Split half spectrum -> real [.., n, n] (inverse axis -2, then C2R
    rows with the full 1/n^2 folded across the two passes)."""
    p = get_plan(Xr.shape[-2], "auto")
    Xr, Xi = p._execute_split_axis(Xr, Xi, +1, 1.0 / n, -2)
    return irfft_last_split(Xr, Xi, n, 1.0 / n)


class NS2DPlan(StepperPlan):
    """Immutable 2-D Navier-Stokes stepper config (see
    :class:`StepperPlan`)."""


def ns2d_init(n: int, nu: float, dt: float, *, device=None) -> NS2DPlan:
    """Precompute the stepper's spectral constants (a plan-like object) on
    ``device`` (the current CUDA device by default)."""
    device = resolve_device(device)
    kx, ky, ksq, mask = _wavenumbers(n, device)
    ksq_safe = torch.where(ksq == 0.0, 1.0, ksq)
    visc = torch.exp(-nu * ksq * dt)  # exact viscous integrating factor
    return NS2DPlan({
        "n": n, "dt": dt, "kx": kx, "ky": ky, "ksq_safe": ksq_safe,
        "mask": mask, "visc": visc,
    }, device)


def _nonlinear(c, wr, wi):
    """N(w)_hat = -(u . grad w)_hat, dealiased, from split w_hat."""
    n = c["n"]
    kx, ky, ksq = c["kx"], c["ky"], c["ksq_safe"]
    # psi_hat = w_hat / k^2; u = d psi/dy, v = -d psi/dx
    pr, pi = wr / ksq, wi / ksq
    # i*k multiply in split form: (r, i) -> (-k*i, k*r)
    ur, ui = -ky * pi, ky * pr          # u_hat = i ky psi_hat
    vr, vi = kx * pi, -kx * pr           # v_hat = -i kx psi_hat
    wxr, wxi = -kx * wi, kx * wr         # dw/dx_hat
    wyr, wyi = -ky * wi, ky * wr         # dw/dy_hat
    u = _irfft2_split(ur, ui, n)
    v = _irfft2_split(vr, vi, n)
    wx = _irfft2_split(wxr, wxi, n)
    wy = _irfft2_split(wyr, wyi, n)
    adv = u * wx + v * wy
    ar, ai = _rfft2_split(adv)
    m = c["mask"]
    return -ar * m, -ai * m


def ns2d_step(c, wr, wi):
    """One Heun (RK2) step with exact viscous factor, split-spectral state."""
    wr, wi = c.field(wr), c.field(wi)
    n1r, n1i = _nonlinear(c, wr, wi)
    dt = c["dt"]
    # predictor: full step of N, full viscous decay
    pr = (wr + dt * n1r) * c["visc"]
    pi = (wi + dt * n1i) * c["visc"]
    n2r, n2i = _nonlinear(c, pr, pi)
    # corrector: average the slopes, each decayed to t+dt
    wr2 = wr * c["visc"] + 0.5 * dt * (n1r * c["visc"] + n2r)
    wi2 = wi * c["visc"] + 0.5 * dt * (n1i * c["visc"] + n2i)
    return wr2, wi2


def ns2d_rollout(c, w0, steps: int):
    """Integrate real vorticity w0 [..., n, n] for `steps` steps; returns
    the final real vorticity field (leading batch dims broadcast)."""
    wr, wi = _rfft2_split(c.field(w0))
    m = c["mask"]
    wr, wi = wr * m, wi * m
    for _ in range(steps):
        wr, wi = ns2d_step(c, wr, wi)
    return _irfft2_split(wr, wi, c["n"])


def taylor_green_vorticity(n: int, k: int = 1, *, device=None):
    """Taylor-Green vortex initial vorticity w = 2k cos(kx) cos(ky) on
    [0, 2pi)^2 — an exact decaying solution of the unforced equations:
    w(t) = w(0) * exp(-2 k^2 nu t) (its nonlinear term vanishes).  Float32
    on ``device`` (the current CUDA device by default)."""
    xs = np.arange(n, dtype=np.float32) * (2.0 * np.pi / n)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    return host_table(2.0 * k * np.cos(k * X) * np.cos(k * Y), resolve_device(device))
