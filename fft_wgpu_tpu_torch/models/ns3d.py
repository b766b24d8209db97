"""Pseudo-spectral incompressible 3-D Navier-Stokes on the distributed
pencil FFT stack (torch port of ``fft_wgpu_tpu.models.ns3d``).

    du/dt + (u . grad) u = -grad p + nu lap(u),   div u = 0

solved in rotational form on a [n, n, n] periodic box [0, 2pi)^3: the
nonlinear term is the Lamb vector u x omega evaluated pseudo-spectrally
(2/3-rule dealiased), pressure is eliminated by the Leray projection
P(F) = F - k (k . F)/k^2, viscosity integrates exactly via the spectral
integrating factor, and advection uses Heun RK2, as the JAX model does.

Every transform is a pencil-decomposed distributed 3-D R2C/C2R over a 2-D
``DeviceMesh`` (``parallel.pencil``).  The spectra live on each rank as its
local shard of the transposed pencil layout [n, n/px, Kp/py] (Kp = n/2+1
padded with zeros to a multiple of py; ``transposed_spectra=False``: the
natural [n/px, n/py, Kp]), and the wavenumber grids are the same local
slices, zero (mask) or one (k^2) on the padded columns, so the spectral
arithmetic is elementwise on the shard.  The JAX model runs 9 transforms
of one field per nonlinear evaluation; here the six inverse ones (u and
omega) are one batched inverse transform of [6, ...] and the three forward
ones one of [3, ...]: 4 transform calls per RK2 step.  The rollout is a
Python loop over steps (``lax.scan`` has no counterpart), cached per step
count on the plan as the JAX model caches its compiled programs.

``ns3d_step`` and ``project_divergence_free`` take spectra shards in the
plan's layout (with no mesh, the whole padded spectra); ``ns3d_rollout``
takes the real velocity [3, n, n, n] (a DTensor sharded on axes 1-2, or
the global array on every rank) and returns it, a DTensor on a mesh.

Oracle: the ABC flow is a Beltrami field (curl u = u), so its Lamb vector
vanishes and the exact solution is pure viscous decay u(t) = u0 exp(-nu t).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.complex_utils import default_device
from ..parallel import pencil
from ..parallel.mesh import make_pencil_mesh

__all__ = ["NS3DPlan", "ns3d_init", "ns3d_step", "ns3d_rollout",
           "abc_flow", "project_divergence_free"]


class NS3DPlan:
    """Immutable stepper config (plan-object semantics: build once with
    :func:`ns3d_init`, replay many): the scalars, the mesh, the 1-D
    wavenumbers, the rollouts cached per step count, and the local grids
    of this rank's spectra shard, built once per device."""

    def __init__(self, consts):
        self._consts = consts
        self._jit_cache = {}
        self._tables = {}

    def __getitem__(self, key):
        return self._consts[key]

    def tables(self, device) -> dict:
        """This rank's kx, ky, kz (broadcastable), ksq_safe, mask and visc
        in the spectra's local layout, float32 on ``device``."""
        device = torch.device(device)
        hit = self._tables.get(device)
        if hit is None:
            hit = self._tables[device] = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in _local_tables(self).items()}
        return hit


def _wavenumbers(n: int):
    """Integer wavenumbers of an rfft3d layout [n, n, n//2+1] on
    [0, 2pi)^3, as float32 1-D arrays."""
    kx = np.fft.fftfreq(n, 1.0 / n).astype(np.float32)
    kz = np.fft.rfftfreq(n, 1.0 / n).astype(np.float32)
    return kx, kx.copy(), kz


def _local_tables(c) -> dict:
    """The grids of this rank's shard: the 1-D wavenumbers sliced to it
    (kz padded to Kp with zeros: ``pencil._spectrum_shard``), then k^2,
    the zero-safe k^2, the 2/3-rule mask and the viscous factor formed in
    float32 numpy as the JAX model forms them on the global grid; the
    padded columns get mask 0 and k^2 1."""
    n, nu, dt = c["n"], c["nu"], c["dt"]
    ax, ay = pencil._mesh_axes(c["mesh"], 2)

    def shard(grid, fill=0.0):
        return pencil._spectrum_shard(grid, (ax.size, ax.index), (ay.size, ay.index),
                                      c["transposed"], fill)

    kx = shard(c["kx"][:, None, None])
    ky = shard(c["ky"][None, :, None])
    kz = shard(c["kz"][None, None, :])
    pad = shard(np.zeros((1, 1, c["kz"].size), bool), fill=True)
    ksq = kx * kx + ky * ky + kz * kz
    cut = n / 3.0
    mask = ((np.abs(kx) <= cut) & (np.abs(ky) <= cut) & (kz <= cut) & ~pad).astype(np.float32)
    return {"kx": kx, "ky": ky, "kz": kz,
            "ksq_safe": np.where((ksq == 0.0) | pad, 1.0, ksq).astype(np.float32),
            "mask": mask, "visc": np.exp(-nu * ksq * dt).astype(np.float32)}


def ns3d_init(n: int, nu: float, dt: float, mesh=None, overlap_chunks: int | None = None,
              comm_dtype=None, transposed_spectra: bool = True) -> NS3DPlan:
    """Spectral constants for an n^3 grid; ``mesh`` is the 2-D pencil mesh
    (default: with a process group, the pencil mesh over every rank; with
    none, this process alone).  ``comm_dtype=torch.bfloat16`` runs every
    transform's corner turns in bf16 (about 1e-3 relative rounding of the
    spectrum a step; default exact float32).  ``transposed_spectra``
    (default True) keeps the spectra in the transposed pencil layout, each
    R2C/C2R pair paying 4 corner turns instead of 8; False keeps natural
    spectra.  The grids are built on the device of the first rollout's
    input."""
    kx, ky, kz = _wavenumbers(n)
    return NS3DPlan({
        "n": n, "nu": float(nu), "dt": float(dt),
        "mesh": pencil._default_mesh(mesh, None, make_pencil_mesh),
        "chunks": overlap_chunks,
        "comm_dtype": pencil._norm_comm_dtype(comm_dtype),
        "transposed": bool(transposed_spectra),
        "kx": kx, "ky": ky, "kz": kz,
    })


def _run_args(c):
    ax, ay = pencil._mesh_axes(c["mesh"], 2)
    return ax, ay, pencil._chunks(c["mesh"], c["chunks"]), c["comm_dtype"]


def _rfft3(c, x):
    """Real shards [.., n/px, n/py, n] -> padded spectra in the plan's layout."""
    ax, ay, chunks, comm = _run_args(c)
    return pencil._rfft3d_local(x, ax, ay, None, chunks, comm, c["transposed"])


def _irfft3(c, X):
    """Padded spectra in the plan's layout -> real shards [.., n/px, n/py, n]."""
    ax, ay, chunks, comm = _run_args(c)
    n = c["n"]
    return pencil._irfft3d_local(X, n, ax, ay, pencil._irfft_scale(n, n, n, None), chunks,
                                 comm, c["transposed"])


def _project(t, F):
    """Leray projection of stacked spectra F [3, ...]."""
    kx, ky, kz = t["kx"], t["ky"], t["kz"]
    div = (kx * F[0] + ky * F[1] + kz * F[2]) / t["ksq_safe"]
    return torch.stack([F[0] - kx * div, F[1] - ky * div, F[2] - kz * div])


def project_divergence_free(c, Fx, Fy, Fz):
    """Leray projection in spectral space: F - k (k . F) / k^2 (the k=0
    mode passes through untouched: ksq_safe avoids the 0/0), of spectra
    shards in the plan's layout."""
    return tuple(_project(c.tables(Fx.device), torch.stack([Fx, Fy, Fz])).unbind(0))


def _nonlinear(c, t, U):
    """P(u x omega)_hat, dealiased, from the stacked velocity spectra."""
    kx, ky, kz = t["kx"], t["ky"], t["kz"]
    UW = torch.cat([U, torch.stack([
        1j * (ky * U[2] - kz * U[1]),   # vorticity: omega_hat = i k x u_hat
        1j * (kz * U[0] - kx * U[2]),
        1j * (kx * U[1] - ky * U[0])])])
    uw = _irfft3(c, UW)
    u, w = uw[:3], uw[3:]
    lamb = torch.stack([u[1] * w[2] - u[2] * w[1],   # Lamb vector u x omega
                        u[2] * w[0] - u[0] * w[2],
                        u[0] * w[1] - u[1] * w[0]])
    return _project(t, _rfft3(c, lamb) * t["mask"])


def _step(c, t, U):
    dt, E = c["dt"], t["visc"]
    N1 = _nonlinear(c, t, U)
    P = (U + dt * N1) * E
    N2 = _nonlinear(c, t, P)
    return U * E + 0.5 * dt * (N1 * E + N2)


def ns3d_step(c, Ux, Uy, Uz):
    """One Heun (RK2) step with the exact viscous integrating factor on the
    complex velocity spectra (shards in the plan's layout)."""
    return tuple(_step(c, c.tables(Ux.device), torch.stack([Ux, Uy, Uz])).unbind(0))


def ns3d_rollout(c, u0, steps: int):
    """Integrate the real velocity u0 [3, n, n, n] for ``steps`` RK2 steps;
    returns the final real velocity [3, n, n, n].  The initial spectrum is
    dealiased and Leray-projected, so u0 need not be exactly
    divergence-free.  A tensor computes on its own device, other input on
    the current CUDA device."""
    run = c._jit_cache.get(steps)
    if run is None:

        def run(u0):
            mesh, n = c["mesh"], c["n"]
            x = pencil._local(u0, mesh, (1, 2), torch.float32)
            t = c.tables(x.device)
            U = _project(t, _rfft3(c, x) * t["mask"])
            for _ in range(steps):
                U = _step(c, t, U)
            return pencil._wrap(_irfft3(c, U), mesh, (1, 2), (3, n, n, n))

        c._jit_cache[steps] = run
    return run(u0)


def abc_flow(n: int, A: float = 1.0, B: float = 1.0, C: float = 1.0, *, device=None):
    """Arnold-Beltrami-Childress velocity on [0, 2pi)^3, a curl eigenflow
    (curl u = u), so u x omega = 0 and the exact NS solution is
    u(t) = u0 exp(-nu t).  Real [3, n, n, n] float32 (built in float64) on
    ``device`` (default: the current CUDA device)."""
    s = np.arange(n, dtype=np.float64) * (2.0 * np.pi / n)
    x = s[:, None, None]
    y = s[None, :, None]
    z = s[None, None, :]
    zero = np.zeros((n, n, n))
    ux = A * np.sin(z) + C * np.cos(y) + zero
    uy = B * np.sin(x) + A * np.cos(z) + zero
    uz = C * np.sin(y) + B * np.cos(x) + zero
    u = torch.from_numpy(np.stack([ux, uy, uz]).astype(np.float32))
    return u.to(default_device() if device is None else device)
