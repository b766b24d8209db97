"""The FNO-3D training step sharded over a ``dp`` x ``tp`` mesh on
``torch.distributed``: the batch data-parallel on ``dp``, the spectral
weights tensor-parallel on ``tp`` over their output channel.

The JAX package gets this step from GSPMD: the unsharded
``fno3d_apply`` / ``value_and_grad`` jitted over sharding annotations
(``tests/test_distributed.py``'s ``test_fno3d_dp_tp_training_step``).
Here the partition is written out.

Layout.  The mesh is a 2-D ``DeviceMesh`` with dims named ``dp`` and ``tp``
(``parallel.mesh``; ``make_pencil_mesh(axis_names=("dp", "tp"))`` is the
JAX test's).  On each rank ``blocks[i].wr``/``wi`` are the rank's slice
``[m1, m2, m3, width, width/tp]`` of the output channels (JAX's
``P(None, None, None, None, "tp")``); ``lift``, ``proj``, ``pw`` and ``b``
are replicated.  A rank runs its ``dp`` shard of the batch.

A spectral block, with ``h`` [b, X, Y, Z, width] replicated over ``tp``:

1. split: this rank's slice of h's input channels (a view); backward, an
   all-gather over ``tp`` on the channel axis;
2. ``fftn`` of the slice [b, width/tp, X, Y, Z] and its low corner;
3. all-gather of the corner [b, width/tp, m1, m2, m3] over ``tp``;
   backward, a reduce-scatter onto the input-channel slices (each rank's
   corner gradient is a partial sum over its own output channels);
4. the spectral product of this rank's output channels (its weight
   slice), the pad and ``ifftn`` of width/tp channels;
5. all-gather of the conv output over ``tp`` on the channel axis, so the
   pointwise product, the bias and the GELU run replicated; backward,
   this rank's slice of the gradient (no communication: the gradient
   downstream is the same on every ``tp`` rank).

So each FFT is done once across the ``tp`` ranks.  After the backward one
all-reduce over ``dp`` of a flat buffer of the loss and every gradient,
divided by ``dp``, gives every rank the global batch's mean loss and
gradients (the weight slices' reduced over ``dp`` only); the update is
p - lr * grad in place, as ``models.spectral.train_step``.

A collective on a mesh dimension of size 1 is the identity, with no call
and no copy: on a 1 x 1 mesh, and on the path with no process group
(``mesh=None`` in a plain process), the step launches what
``spectral.train_step`` launches.  The collectives follow the group's
backend as ``parallel.pencil``'s turns do: NCCL takes CUDA tensors as they
lie, gloo CPU tensors, a CUDA tensor on a gloo group is staged through the
host (timed in :data:`STATS`), and any other backend raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..models.spectral import FNO3d, _corner_conv, _low_corner, _sgd
from .mesh import make_pencil_mesh
from .pencil import _ALONE, _as_tensor, _Axis, _backend, _staged

__all__ = ["ShardedFNO3d", "shard_params", "gather_params", "value_and_grad", "train_step",
           "reset_stats", "STATS"]

# What the collectives did since the last reset_stats(): calls of each kind
# and the bytes of their buffers on this rank (an all-gather's output, a
# reduce-scatter's input, an all-reduce's buffer), and, for CUDA tensors on
# a gloo group, the host seconds and bytes of the staging copies and the
# host seconds of the collectives between them.
STATS = {"all_gathers": 0, "reduce_scatters": 0, "all_reduces": 0, "gather_bytes": 0,
         "scatter_bytes": 0, "reduce_bytes": 0, "host_stage_s": 0.0, "host_stage_bytes": 0,
         "host_exchange_s": 0.0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = type(STATS[k])(0)


# --------------------------------------------------------------------- #
# the collectives
# --------------------------------------------------------------------- #
def _collective(op, out: torch.Tensor, inp: torch.Tensor, axis: _Axis) -> torch.Tensor:
    """``op(out, inp)``, a collective of ``axis``'s group that writes
    ``out`` (which may be ``inp``) from ``inp``, on the group's backend: the
    tensors as they lie, or a CUDA pair on gloo through host copies."""
    if _backend(axis.group, inp) == "gloo" and inp.is_cuda:
        _staged(op, out, inp, STATS)
    else:
        op(out, inp)
    return out


def _all_gather(x: torch.Tensor, axis: _Axis) -> torch.Tensor:
    """The ranks' ``x`` [n, ...] stacked along dim 0 in coordinate order:
    [size * n, ...]."""
    x = x.contiguous()
    out = torch.empty((axis.size * x.shape[0],) + x.shape[1:], dtype=x.dtype, device=x.device)
    STATS["all_gathers"] += 1
    STATS["gather_bytes"] += out.nbytes
    return _collective(lambda o, i: dist.all_gather(list(o.chunk(axis.size)), i,
                                                    group=axis.group), out, x, axis)


def _reduce_scatter(x: torch.Tensor, axis: _Axis) -> torch.Tensor:
    """Block ``index`` of dim 0 of the ranks' ``x`` [size * n, ...], summed
    over the ranks: [n, ...]."""
    x = x.contiguous()
    out = torch.empty((x.shape[0] // axis.size,) + x.shape[1:], dtype=x.dtype, device=x.device)
    STATS["reduce_scatters"] += 1
    STATS["scatter_bytes"] += x.nbytes
    return _collective(lambda o, i: dist.reduce_scatter(o, list(i.chunk(axis.size)),
                                                        group=axis.group), out, x, axis)


def _block(x: torch.Tensor, axis: _Axis) -> torch.Tensor:
    """This rank's block of dim 0 of ``x`` (a view)."""
    n = x.shape[0] // axis.size
    return x.narrow(0, axis.index * n, n)


class _Split(torch.autograd.Function):
    """This rank's block of dim 0 of a tensor replicated over ``axis``; the
    backward all-gathers the blocks' gradients into the whole one."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _block(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axis), None


class _Gather(torch.autograd.Function):
    """The all-gather of dim 0 over ``axis``.  Its backward is the
    reduce-scatter where each rank's gradient is a partial sum
    (``partial``), else this rank's block of the gradient, which is then
    the same on every rank."""

    @staticmethod
    def forward(ctx, x, axis, partial):
        ctx.axis, ctx.partial = axis, partial
        return _all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _reduce_scatter(g, ctx.axis), None, None
        return _block(g, ctx.axis), None, None


def _split_channels(h, axis: _Axis):
    """h [b, *grid, c] -> this rank's slice [b, *grid, c/tp] of the
    channels (a view); the identity on a dimension of size 1."""
    if axis.size == 1:
        return h
    return _Split.apply(h.movedim(-1, 0), axis).movedim(0, -1)


def _gather_channels(t, axis: _Axis, partial: bool):
    """t [b, c/tp, ...] (real, or complex as (re, im) pairs) -> [b, c, ...]
    gathered over ``axis`` (see :class:`_Gather`); the identity on a
    dimension of size 1."""
    if axis.size == 1:
        return t
    v = torch.view_as_real(t) if t.is_complex() else t
    v = _Gather.apply(v.movedim(1, 0), axis, partial).movedim(0, 1)
    return torch.view_as_complex(v) if t.is_complex() else v


def _sharded_conv(block, h, modes, tp: _Axis):
    """One block's spectral conv on this rank: h [b, *grid, c] replicated
    over ``tp`` -> the whole conv output [b, *grid, c], replicated."""
    Xc = _gather_channels(_low_corner(_split_channels(h, tp), modes), tp, partial=True)
    y = _corner_conv(block, Xc, h.shape[1:-1])  # [b, c/tp, *grid]
    return _gather_channels(y, tp, partial=False).movedim(1, -1)


# --------------------------------------------------------------------- #
# the sharded model and its step
# --------------------------------------------------------------------- #
class ShardedFNO3d(FNO3d):
    """This rank's part of an ``FNO3d`` on a ``dp`` x ``tp`` mesh: the
    spectral weights' output-channel slice and the replicated rest (made by
    :func:`shard_params`).  Calling it runs this rank's shard of a batch
    through the sharded blocks and returns its prediction, replicated over
    ``tp``."""

    def __init__(self, lift, proj, blocks, mesh, dp: _Axis, tp: _Axis, dp_name: str):
        super().__init__(lift, proj, blocks)
        self.mesh, self.dp, self.tp, self.dp_name = mesh, dp, tp, dp_name

    def forward(self, x):
        """x: this rank's shard [b/dp, X, Y, Z, in_ch] of the batch, a
        float32 tensor."""
        modes = self.modes
        return self._layers(x.to(torch.float32),
                            lambda blk, h: _sharded_conv(blk, h, modes, self.tp))


def _axis(mesh, name: str) -> _Axis:
    """Mesh dimension ``name`` as the collectives see it: its group (None
    on a dimension of size 1), its size and this rank's coordinate."""
    d = mesh.mesh_dim_names.index(name)
    size = mesh.size(d)
    return _Axis(mesh.get_group(d) if size > 1 else None, size, mesh.get_coordinate()[d])


def _dp_tp_axes(mesh, dp: str, tp: str) -> tuple:
    if mesh is None:
        if not dist.is_initialized():
            return None, _ALONE, _ALONE
        mesh = make_pencil_mesh(axis_names=(dp, tp))
    names = mesh.mesh_dim_names
    if names is None or sorted(names) != sorted((dp, tp)):
        raise ValueError(f"the sharded FNO step needs a 2-D mesh with dims {dp!r} and "
                         f"{tp!r}, got dims {names}")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    return mesh, _axis(mesh, dp), _axis(mesh, tp)


def shard_params(model: FNO3d, mesh=None, dp: str = "dp", tp: str = "tp") -> ShardedFNO3d:
    """This rank's sharded form of the unsharded ``model`` (every rank
    holds the whole of it: from ``models.spectral.init_fno3d``, or
    ``from_numpy`` of a JAX pytree), on the model's device: each block's
    ``wr``/``wi`` sliced to this rank's ``width/tp`` output channels, the
    rest copied.  ``mesh`` is a ``DeviceMesh`` with dims ``dp`` and ``tp``;
    with no mesh and no process group, the path with no group (a 1 x 1
    layout in this process); with a group and no mesh, the pencil mesh over
    every rank with those dim names.  ``ValueError`` if the mesh lacks
    those dims or ``width`` does not divide over ``tp``."""
    if not isinstance(model, FNO3d):
        raise TypeError(f"shard_params takes an FNO3d, got {type(model).__name__}")
    mesh, a_dp, a_tp = _dp_tp_axes(mesh, dp, tp)
    width = model.lift.shape[1]
    if width % a_tp.size:
        raise ValueError(f"width {width} does not divide over tp = {a_tp.size}")
    w = width // a_tp.size

    def own(t):
        return t.detach().narrow(-1, a_tp.index * w, w).clone()

    def copy(t):
        return t.detach().clone()

    blocks = [{"wr": own(b.wr), "wi": own(b.wi), "pw": copy(b.pw), "b": copy(b.b)}
              for b in model.blocks]
    return ShardedFNO3d(copy(model.lift), copy(model.proj), blocks, mesh, a_dp, a_tp, dp)


def gather_params(sharded: ShardedFNO3d) -> FNO3d:
    """The whole ``FNO3d`` on every rank (all-gathers of the weight slices
    over ``tp``), on the sharded model's device: for checks and
    checkpoints.  Every rank of the mesh must call it."""
    tp = sharded.tp

    def whole(t):
        t = t.detach()
        if tp.size == 1:
            return t.clone()
        return _all_gather(t.movedim(-1, 0), tp).movedim(0, -1).contiguous()

    blocks = [{"wr": whole(b.wr), "wi": whole(b.wi), "pw": b.pw.detach().clone(),
               "b": b.b.detach().clone()} for b in sharded.blocks]
    return FNO3d(sharded.lift.detach().clone(), sharded.proj.detach().clone(), blocks)


def _batch_shard(x, sharded: ShardedFNO3d) -> torch.Tensor:
    """This rank's ``dp`` shard of the batch: a DTensor's local tensor in
    ``[Shard(0) on dp, Replicate() on tp]`` (other placements are
    redistributed), or the slice of a global batch present on every rank
    (no communication).  ``ValueError`` if the batch does not divide over
    ``dp``."""
    mesh, dp = sharded.mesh, sharded.dp
    if x.shape[0] % dp.size:
        raise ValueError(f"batch {x.shape[0]} does not divide over dp = {dp.size}")
    if isinstance(x, DTensor):
        want = tuple(Shard(0) if n == sharded.dp_name else Replicate()
                     for n in x.device_mesh.mesh_dim_names)
        if tuple(x.placements) != want:
            x = x.redistribute(x.device_mesh, want)
        return x.to_local()
    x = _as_tensor(x, mesh)
    if dp.size == 1:
        return x
    n = x.shape[0] // dp.size
    return x.narrow(0, dp.index * n, n)


def _dp_mean(dp: _Axis, loss, grads):
    """``(loss, grads)`` averaged over ``dp``: one all-reduce of a flat
    buffer of the loss and every gradient, divided by ``dp``; the identity
    on a dimension of size 1."""
    if dp.size == 1:
        return loss, grads
    flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
    STATS["all_reduces"] += 1
    STATS["reduce_bytes"] += flat.nbytes
    _collective(lambda o, i: dist.all_reduce(o, group=dp.group), flat, flat, dp)
    flat /= dp.size
    parts = flat[1:].split([g.numel() for g in grads])
    return flat[0], [v.view(g.shape) for v, g in zip(parts, grads)]


def value_and_grad(sharded: ShardedFNO3d, x, y):
    """The mean squared error of the sharded model over the global batch
    (``x``, ``y`` [batch, X, Y, Z, ch]: DTensors in ``[Shard(0) on dp,
    Replicate() on tp]``, or the whole batch on every rank) and its
    gradient by every parameter of this rank, in ``parameters()`` order
    (a weight slice's gradient is its slice's): ``(loss, grads)``, the
    same loss on every rank, a 0-d tensor on the model's device."""
    xl, yl = _batch_shard(x, sharded), _batch_shard(y, sharded)
    loss = torch.mean((sharded(xl) - yl.to(torch.float32)) ** 2)
    grads = torch.autograd.grad(loss, list(sharded.parameters()))
    return _dp_mean(sharded.dp, loss.detach(), grads)


def train_step(sharded: ShardedFNO3d, x, y, lr=1e-3):
    """One SGD step of the sharded model on the global batch (as
    :func:`value_and_grad` takes it): p - lr * grad of the global batch's
    mean squared error, in place, as ``models.spectral.train_step``.
    Returns ``(sharded, loss)``, the loss before the step."""
    loss, grads = value_and_grad(sharded, x, y)
    _sgd(sharded, grads, lr)
    return sharded, loss
