"""Data-parallel batched transforms (torch port of
``fft_wgpu_tpu.parallel.batched``).

The pencil module handles transforms whose AXES span ranks; a large batch
of independent transforms needs no communication at all: the batch
dimension is sharded over the mesh's first axis and each rank transforms
its rows through the plan (on a card, the row kernel's complex64 entry for
a pow2 n in 128..16384).  The result is a ``DTensor`` sharded on axis 0
(replicated over any other mesh axis); a plain tensor input is the global
batch, present on every rank, and each rank slices its rows.  With no mesh
and no process group, the whole batch is transformed here.
"""

from __future__ import annotations

import torch

from ..core.twiddle import FORWARD, INVERSE
from .mesh import make_mesh
from .pencil import _default_mesh, _local, _wrap

__all__ = ["fft_batch_sharded", "ifft_batch_sharded"]


def _run(x, mesh, sign, scale):
    from ..plan.plan import get_plan

    mesh = _default_mesh(mesh, x, make_mesh)
    shape = tuple(x.shape)
    loc = _local(x, mesh, (0,), torch.complex64)
    p = get_plan(shape[-1], "auto")
    y = p._run(loc, -1, sign, scale)
    return _wrap(y, mesh, (0,), shape)


def fft_batch_sharded(x, mesh=None):
    """Forward FFT of [batch, ..., n] with the batch sharded over the mesh.

    Embarrassingly parallel: no collectives; each rank transforms its rows
    with the local kernels."""
    return _run(x, mesh, FORWARD, None)


def ifft_batch_sharded(x, mesh=None):
    """Inverse (1/N) counterpart of :func:`fft_batch_sharded`."""
    return _run(x, mesh, INVERSE, 1.0 / x.shape[-1])
