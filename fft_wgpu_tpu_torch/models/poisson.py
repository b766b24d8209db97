"""Spectral Poisson solver — the canonical FFT-framework application (torch
port of ``fft_wgpu_tpu.models.poisson``'s local solve).

Solves  laplacian(u) = f  on a periodic box via diagonalization in Fourier
space: u_hat = -f_hat / |k|^2 (zero-mean gauge), through the N-D R2C/C2R
pair ``rfftn`` / ``irfftn``; on a mesh, :func:`solve_poisson_distributed`
runs the same math through the distributed pencil pair ``rfft3d`` /
``irfft3d`` (``parallel.pencil``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.complex_utils import host_table, to_device
from ..ops.rfft import irfftn, rfftn

__all__ = ["solve_poisson", "solve_poisson_distributed"]


def _ksq_grids(shape, lengths):
    """|k|^2 grid for an rfftn-shaped spectrum of a real field."""
    *rest, last = shape
    ks = []
    for n, L in zip(rest, lengths[:-1]):
        ks.append((2 * np.pi / L) * np.fft.fftfreq(n) * n)
    ks.append((2 * np.pi / lengths[-1]) * np.arange(last // 2 + 1))
    grids = np.meshgrid(*ks, indexing="ij")
    ksq = sum(g**2 for g in grids).astype(np.float32)
    ksq[(0,) * len(shape)] = 1.0  # avoid div-by-zero at the DC mode
    return ksq


@functools.lru_cache(maxsize=16)
def _tables(shape, lengths, device):
    """|k|^2 and the zero-mean mask (DC killed) of an rfftn spectrum, as
    float32 tensors on ``device``, built once per (shape, lengths, device)."""
    spec_shape = shape[:-1] + (shape[-1] // 2 + 1,)
    mask = np.ones(spec_shape, np.float32)
    mask[(0,) * len(shape)] = 0.0  # zero-mean gauge: kill the DC mode
    return host_table(_ksq_grids(shape, lengths), device), host_table(mask, device)


def solve_poisson(f, lengths=None):
    """u with laplacian(u) = f (periodic, zero-mean).  f: real [..grid..];
    a tensor is solved on its own device, other input on the current CUDA
    device."""
    f = to_device(f)
    shape = tuple(f.shape)
    lengths = tuple(lengths or (2 * math.pi,) * f.ndim)
    ksq, mask = _tables(shape, lengths, f.device)
    F = rfftn(f)
    U = -F / ksq * mask
    return irfftn(U, s=shape)


def solve_poisson_distributed(f, mesh=None, lengths=None, *, comm_dtype=None):
    """Distributed 3-D Poisson solve through the pencil R2C/C2R pair.

    Rides the transposed-spectrum round trip (4 corner turns instead of
    8): the spectral divide is elementwise on each rank's shard of the
    transposed layout, with |k|^2 sliced to it (one on the padded
    half-spectrum columns) and the DC mode zeroed on the rank that holds
    it.  ``f`` is real [X, Y, Z]: a DTensor in the natural distribution or
    the global array on every rank; the result is a DTensor on ``mesh``
    (default: the pencil mesh over every rank; with no process group, this
    process alone and a plain tensor).  ``comm_dtype=torch.bfloat16``
    halves the turns' wire bytes (see ``parallel.pencil.fft3d``)."""
    from ..parallel import pencil
    from ..parallel.mesh import make_pencil_mesh

    mesh = pencil._default_mesh(mesh, f, make_pencil_mesh)
    shape = tuple(f.shape)
    lengths = tuple(lengths or (2 * math.pi,) * 3)
    ax, ay = pencil._mesh_axes(mesh, 2)
    chunks = pencil._chunks(mesh, None)
    comm = pencil._norm_comm_dtype(comm_dtype)
    x = pencil._local(f, mesh, (0, 1), torch.float32)
    F = pencil._rfft3d_local(x, ax, ay, None, chunks, comm, True)   # [X, Y/px, Kp/py]
    U = -F / _local_ksq(shape, lengths, (ax.size, ax.index), (ay.size, ay.index), F.device)
    if ax.index == 0 and ay.index == 0:
        U[0, 0, 0] = 0.0  # zero-mean gauge: the DC mode
    u = pencil._irfft3d_local(U, shape[-1], ax, ay,
                              pencil._irfft_scale(*shape, None), chunks, comm, True)
    return pencil._wrap(u, mesh, (0, 1), shape)


@functools.lru_cache(maxsize=16)
def _local_ksq(shape, lengths, xpart, ypart, device):
    """|k|^2 of this rank's shard of the transposed layout [X, Y/px, Kp/py]
    (``pencil._spectrum_shard``; one on the padded columns), ``xpart`` and
    ``ypart`` its (mesh size, coordinate) pairs, float32 on ``device``,
    built once."""
    from ..parallel import pencil

    ksq = pencil._spectrum_shard(_ksq_grids(shape, lengths), xpart, ypart, True, fill=1.0)
    return host_table(np.ascontiguousarray(ksq), device)
