"""Pseudo-spectral 1-D viscous Burgers equation on the FFT stack (torch
port of ``fft_wgpu_tpu.models.burgers``).

    u_t + u u_x = nu u_xx   on [0, 2pi), periodic

The classic FNO benchmark problem (the model family's data-generating
solver).  Spectral form with the advection in conservation form:

    d/dt u_hat = -(ik/2) (u^2)_hat - nu k^2 u_hat

integrated exactly for the viscous term (integrating factor) and with
Heun RK2 for the nonlinear term, 2/3-rule dealiased.  State is the SPLIT
(re, im) half spectrum; batched leading dims ride the batched R2C/C2R
routes (on a CUDA tensor of pow2 n in 128..16384 the R2C and C2R kernels'
planar entries, two each a step).  The rollout is a Python loop over the
steps.

Validated against the exact Cole-Hopf solution:
phi = 1 + eps e^{-nu t} cos x  =>  u = 2 nu eps e^{-nu t} sin x / phi.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.complex_utils import host_table
from ..ops.rfft import irfft_last_split, rfft_last_split
from ._plan import StepperPlan, resolve_device

__all__ = ["BurgersPlan", "burgers_init", "burgers_step", "burgers_rollout",
           "cole_hopf_solution", "random_initial_condition"]


class BurgersPlan(StepperPlan):
    """Immutable Burgers stepper config (see :class:`StepperPlan`)."""


def burgers_init(n: int, nu: float, dt: float, *, device=None) -> BurgersPlan:
    """Precompute wavenumbers, dealias mask, and the exact viscous
    integrating factor for an n-point grid on [0, 2pi), on ``device`` (the
    current CUDA device by default)."""
    device = resolve_device(device)
    k = np.fft.rfftfreq(n, 1.0 / n).astype(np.float32)  # 0..n/2
    mask = (k <= n / 3.0).astype(np.float32)
    visc = np.exp(-nu * k * k * dt).astype(np.float32)
    return BurgersPlan({
        "n": n, "dt": dt, "k": host_table(k, device), "mask": host_table(mask, device),
        "visc": host_table(visc, device),
    }, device)


def _nonlinear(c, ur, ui):
    """N(u)_hat = -(ik/2) (u^2)_hat, dealiased, from the split spectrum."""
    n, k, m = c["n"], c["k"], c["mask"]
    u = irfft_last_split(ur, ui, n, 1.0 / n)
    ar, ai = rfft_last_split(u * u, None)
    # multiply by -(ik/2): (r, i) -> (k*i/2, -k*r/2), then dealias
    return 0.5 * k * ai * m, -0.5 * k * ar * m


def burgers_step(c, ur, ui):
    """One Heun (RK2) step with exact viscous decay, split state."""
    ur, ui = c.field(ur), c.field(ui)
    dt, visc = c["dt"], c["visc"]
    n1r, n1i = _nonlinear(c, ur, ui)
    pr = (ur + dt * n1r) * visc
    pi = (ui + dt * n1i) * visc
    n2r, n2i = _nonlinear(c, pr, pi)
    ur2 = ur * visc + 0.5 * dt * (n1r * visc + n2r)
    ui2 = ui * visc + 0.5 * dt * (n1i * visc + n2i)
    return ur2, ui2


def burgers_rollout(c, u0, steps: int):
    """Integrate real u0 [..., n] for `steps` steps; returns the real field
    at t = steps * dt.  Batched leading dims run through the batched
    R2C/C2R pipeline unchanged."""
    ur, ui = rfft_last_split(c.field(u0), None)
    m = c["mask"]
    ur, ui = ur * m, ui * m
    for _ in range(steps):
        ur, ui = burgers_step(c, ur, ui)
    return irfft_last_split(ur, ui, c["n"], 1.0 / c["n"])


def cole_hopf_solution(n: int, nu: float, eps: float, t: float, *, device=None):
    """Exact single-mode Cole-Hopf solution u(x, t) on the n-point grid:
    phi = 1 + eps e^{-nu t} cos x, u = 2 nu (eps e^{-nu t} sin x) / phi
    (u = -2 nu phi_x / phi solves Burgers when phi solves the heat
    equation).  Requires |eps| < 1.  Float32 on ``device`` (the current
    CUDA device by default)."""
    x = np.arange(n, dtype=np.float64) * (2.0 * np.pi / n)
    e = eps * np.exp(-nu * t)
    u = 2.0 * nu * e * np.sin(x) / (1.0 + e * np.cos(x))
    return host_table(u, resolve_device(device))


def random_initial_condition(generator, n: int, batch: int = 1, scale: float = 1.0,
                             decay: float = 2.0, *, device=None):
    """FNO-style Gaussian-random-field initial conditions [batch, n]:
    spectrum ~ scale * (1 + k^2)^(-decay/2) with random phases, zero mean.
    The normal planes are drawn from ``generator`` (a ``torch.Generator``,
    where the JAX function takes a key; the streams differ) on its own
    device; the fields are computed on ``device`` (the current CUDA device
    by default)."""
    device = resolve_device(device)
    k = np.fft.rfftfreq(n, 1.0 / n).astype(np.float32)
    amp = host_table(scale * (1.0 + k * k) ** (-decay / 2.0), device)
    draw_on = generator.device if generator is not None else device
    cr, ci = (torch.randn((batch, k.size), generator=generator, device=draw_on).to(device) * amp
              for _ in range(2))
    cr[:, 0] = 0.0  # zero mean
    ci[:, 0] = 0.0
    if n % 2 == 0:
        ci[:, -1] = 0.0  # real Nyquist
    return irfft_last_split(cr, ci, n, 1.0)
