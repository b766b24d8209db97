"""Distributed FFTs: slab / pencil decomposition over a device mesh (torch
port of ``fft_wgpu_tpu.parallel.pencil``).

The JAX package writes these with ``shard_map`` over a ``jax.sharding.Mesh``
and ``jax.lax.all_to_all`` corner turns.  Here a mesh is a
``torch.distributed.DeviceMesh`` (``parallel.mesh``), one rank per device,
and every transform runs on each rank's local shard with explicit
``all_to_all_single`` exchanges on the group of one mesh dimension, so the
chunking and the wire dtype stay in this module's hands (DTensor's
``redistribute`` does not do the corner turns).

Decompositions
--------------
* ``fft3d`` — pencil: [X, Y, Z] on a 2-D mesh (X/px, Y/py pencils along Z).
  Z-FFT local -> turn(py): Z<->Y -> Y-FFT -> turn(px): Y<->X -> X-FFT.
  ``transposed_output=True`` skips the two turns that restore the input
  distribution (P3DFFT-style); ``ifft3d(transposed_input=True)`` takes
  that layout back through the mirror schedule, 4 turns a round trip.
* ``fft2d`` — slab: [X, Y] on a 1-D mesh.
* ``fft1d_distributed`` — one long vector by the distributed four-step:
  factor FFTs with a corner turn between them and the inter-factor
  twiddle plane sliced per rank.
* ``rfft3d`` / ``irfft3d`` — the real pair, the R2C/C2R on Z local.

Data.  The public transforms take and return ``DTensor``s on the mesh in
the JAX function's layout: natural ``[Shard(-3) on px, Shard(-2) on py]``,
transposed ``[Shard(-2) on px, Shard(-1) on py]`` (non-negative dims, as
DTensor keeps them); leading axes are batch, present on every rank.  A
plain tensor (or array) is the whole global array, present on every rank:
each rank slices its shard with no communication, as ``shard_map``'s
``in_specs`` do.  With no mesh and no process group (a plain process) a
transform takes the path with no group, on which every turn is the
identity, and returns a plain tensor on the input's device.  With a
process group and no mesh it builds the JAX defaults (the pencil mesh
over every rank, or one axis over every rank), once per group.

The local passes are the plan layer's (``Plan._execute_c64``, else
``Plan._execute_split_axis``): on a card, a complex64 shard of a pow2
length in 128..16384 takes the row kernel (last axis), the axis(-2)
kernel (axis -2) and the axis(-3) entry on its free view (axes before),
one launch each with no transpose; the R2C/C2R on Z the real kernels'
complex64 sink and source.  Other lengths take the plan's other routes.

Exchanges.  A turn packs the shard with the split axis in front (one
device copy, fused with the cast to a bf16 wire where ``comm_dtype``
asks for it), exchanges it with ``all_to_all_single`` and unpacks the
received blocks onto the concat axis (one device copy, fused with the
cast back): two full passes over the shard, counted in :data:`STATS`
(a pack or an unpack that is already a view of the right layout copies
nothing and counts nothing).  On a mesh dimension of size 1 the turn is
the identity: no call and no copy.  The exchange follows the group's
backend: on NCCL the CUDA tensors go on the wire as they are; gloo's
all-to-all is given CPU tensors, so a CUDA shard on a gloo group is
staged through the host, each turn a device-to-host copy, the exchange
and a host-to-device copy, synchronously, its host seconds counted in
:data:`STATS`; any other backend raises.  No exchange is retried on
another backend.  ``torch.autograd`` runs through every turn: the
backward of an exchange is the same exchange of the gradient, so a
gradient crosses the process boundary.

Pipelining.  ``overlap_chunks`` splits each FFT -> turn pair along a
spectator axis: chunk i's exchange is issued asynchronously, chunk i+1's
FFT is launched, then chunk i's exchange is waited on and unpacked into
its slice of the output, so the wire overlaps the next chunk's compute.
"""

from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..core.complex_utils import default_device, merge, split
from ..core.twiddle import FORWARD, INVERSE, twiddle_np
from ..ops import cuda_fft
from ..ops import rfft as _rfft
from ..ops.fourstep import choose_factors
from ..ops.nd import _nd_scale, fftn_split
from .mesh import make_mesh, make_pencil_mesh

__all__ = ["fft3d", "ifft3d", "fft2d", "ifft2d", "fft1d_distributed", "rfft3d", "irfft3d"]

# What the exchanges did since the last reset_stats(): turns exchanged,
# device copies made to pack (split axis in front, wire dtype) and to
# unpack (onto the concat axis, float32), copies of a pipeline chunk or a
# padded half-spectrum axis, and, for CUDA shards on a gloo group, the
# host seconds and bytes of the staging copies and the host seconds of the
# exchanges between them.
STATS = {"turns": 0, "pack_copies": 0, "unpack_copies": 0, "chunk_copies": 0,
         "pad_copies": 0, "host_stage_s": 0.0, "host_stage_bytes": 0, "host_exchange_s": 0.0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = type(STATS[k])(0)


# --------------------------------------------------------------------- #
# meshes, shards and DTensors
# --------------------------------------------------------------------- #
class _Axis:
    """One mesh dimension as a turn sees it: its group (None when the
    dimension has size 1: no exchange), its size and this rank's
    coordinate along it."""

    __slots__ = ("group", "size", "index")

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index


_ALONE = _Axis(None, 1, 0)
_DEFAULT_MESHES: dict = {}


def _mesh_axes(mesh, ndim: int) -> tuple:
    if mesh is None:
        return (_ALONE,) * ndim
    if mesh.ndim != ndim:
        raise ValueError(f"expected a {ndim}-D mesh, got {mesh.ndim}-D {mesh}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return tuple(_Axis(mesh.get_group(d) if mesh.size(d) > 1 else None, mesh.size(d), coord[d])
                 for d in range(ndim))


def _default_mesh(mesh, x, build):
    """``mesh``, else a DTensor input's mesh, else (with a process group)
    ``build()`` over every rank, made once per group; None with no group."""
    if mesh is not None:
        return mesh
    if isinstance(x, DTensor):
        return x.device_mesh
    if not dist.is_initialized():
        return None
    world = dist.group.WORLD
    hit = _DEFAULT_MESHES.get(build)
    if hit is None or hit[0] is not world:
        hit = _DEFAULT_MESHES[build] = (world, build())
    return hit[1]


def _chunk(length: int, parts: int, index: int) -> tuple:
    """(start, size) of shard ``index`` of ``parts`` along an axis of
    ``length``: ``torch.chunk``'s rule, DTensor's for an uneven axis."""
    c = -(-length // parts)
    start = min(index * c, length)
    return start, max(0, min(c, length - start))


def _as_tensor(x, mesh) -> torch.Tensor:
    """A tensor as itself; other input (numpy) on the mesh's device type's
    current device, or on the current CUDA device."""
    if isinstance(x, torch.Tensor):
        return x
    arr = torch.from_numpy(np.ascontiguousarray(x))
    if mesh is not None and mesh.device_type == "cpu":
        return arr
    return arr.to(default_device())


def _local(x, mesh, dims, dtype, even=True) -> torch.Tensor:
    """This rank's shard of ``x`` with tensor dim ``dims[i]`` sharded over
    mesh dimension i: a DTensor's local tensor in those placements (other
    placements are redistributed), or the slice of a global array.  With
    ``even`` the sharded axes must divide evenly."""
    if isinstance(x, DTensor):
        want = tuple(Shard(d) for d in dims)
        if tuple(x.placements) != want:
            x = x.redistribute(mesh, want)
        return x.to_local().to(dtype)
    x = _as_tensor(x, mesh)
    if mesh is not None:
        coord = mesh.get_coordinate()
        for m, d in enumerate(dims):
            parts = mesh.size(m)
            if even and x.shape[d] % parts:
                raise ValueError(f"axis {d} of length {x.shape[d]} does not divide over "
                                 f"the mesh dimension of size {parts}")
            start, size = _chunk(x.shape[d], parts, coord[m])
            x = x.narrow(d, start, size)
    return x.to(dtype)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def _wrap(loc, mesh, dims, shape):
    """The local shard as a DTensor of global ``shape`` (``dims[i]``
    sharded over mesh dimension i, the rest replicated); with no mesh, the
    tensor itself (it is the global array)."""
    if mesh is None:
        return loc
    placements = [Shard(d) for d in dims] + [Replicate()] * (mesh.ndim - len(dims))
    return DTensor.from_local(loc, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


# --------------------------------------------------------------------- #
# the corner turn
# --------------------------------------------------------------------- #
def _norm_comm_dtype(comm_dtype):
    """The corner-turn wire dtype: None (and float32) keep full float32,
    bfloat16 halves the wire bytes; anything else raises ``ValueError``."""
    if comm_dtype is None:
        return None
    if isinstance(comm_dtype, torch.dtype):
        dt = comm_dtype
    else:
        try:
            name = comm_dtype if isinstance(comm_dtype, str) else np.dtype(comm_dtype).name
        except TypeError:
            name = None
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(name)
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"comm_dtype must be None, float32 or bfloat16, got {comm_dtype}")
    return None if dt == torch.float32 else dt


def _backend(group, t: torch.Tensor) -> str:
    """The backend that exchanges ``t`` on ``group``: "nccl" (CUDA tensors
    on the wire as they are) or "gloo" (CPU tensors; a CUDA one staged
    through the host).  Any other raises."""
    name = dist.get_backend(group)
    if ":" in name:  # a combined group, "cpu:gloo,cuda:nccl"
        name = dict(p.split(":") for p in name.split(",")).get(t.device.type, name)
    if name == "nccl" and t.device.type != "cuda":
        raise ValueError("an NCCL group exchanges CUDA tensors, got a "
                         f"{t.device.type} tensor")
    if name not in ("nccl", "gloo"):
        raise ValueError(f"no corner turn on a {name!r} group: NCCL or gloo")
    return name


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The (contiguous) tensor as the wire carries it: flat (its blocks
    along the first axis are equal runs of the flat buffer), a bfloat16
    (re, im) pair as one 32-bit word (gloo has no 16-bit types)."""
    t = t.view(-1)
    return t.view(torch.int32) if t.dtype == torch.bfloat16 else t


def _staged(op, out: torch.Tensor, inp: torch.Tensor, stats: dict) -> None:
    """``op(out, inp)``, a gloo collective that writes ``out`` (which may be
    ``inp``) from ``inp``, on host copies of the CUDA tensors: device to
    host, the collective, host to device, synchronously; the host seconds
    and bytes counted in ``stats``."""
    torch.cuda.synchronize(inp.device)
    t0 = time.perf_counter()
    h_in = inp.cpu()
    h_out = h_in if out is inp else torch.empty(out.shape, dtype=out.dtype)
    stats["host_stage_s"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    op(h_out, h_in)
    stats["host_exchange_s"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    out.copy_(h_out)
    torch.cuda.synchronize(inp.device)
    stats["host_stage_s"] += time.perf_counter() - t0
    stats["host_stage_bytes"] += inp.nbytes + out.nbytes


def _exchange(send: torch.Tensor, axis: _Axis, async_op: bool):
    """``all_to_all_single`` of the packed ``send`` [m, ...] (block j to the
    rank at coordinate j) on ``axis``'s group: (recv, work or None)."""
    STATS["turns"] += 1
    recv = torch.empty(send.shape, dtype=send.dtype, device=send.device)
    if _backend(axis.group, send) == "gloo" and send.is_cuda:
        _staged(lambda o, i: dist.all_to_all_single(_wire(o), _wire(i), group=axis.group),
                recv, send, STATS)
        return recv, None
    work = dist.all_to_all_single(_wire(recv), _wire(send), group=axis.group,
                                  async_op=async_op)
    return recv, work


class _Exchange(torch.autograd.Function):
    """The exchange of a packed buffer, differentiable.  It is a
    permutation of the ranks' blocks that is its own inverse and its own
    adjoint, so the backward is the same exchange of the gradient.  The
    forward issues it asynchronously and hands its work to ``works``: the
    caller waits before reading the output."""

    @staticmethod
    def forward(ctx, send, axis, works):
        ctx.axis = axis
        recv, work = _exchange(send, axis, async_op=True)
        works.append(work)
        return recv

    @staticmethod
    def backward(ctx, g):
        recv, _ = _exchange(g.contiguous(), ctx.axis, async_op=False)
        return recv, None, None


def _copy(v: torch.Tensor, dtype) -> torch.Tensor:
    """``v`` as a new contiguous tensor of ``dtype``: one device pass,
    differentiable."""
    return torch.empty(v.shape, dtype=dtype, device=v.device).copy_(v)


def _pack(x: torch.Tensor, m: int, split_axis: int, comm) -> torch.Tensor:
    """Complex ``x`` as the send buffer of a turn: its ``split_axis`` cut in
    ``m`` blocks, the block index in front, as (re, im) pairs of the wire
    dtype, contiguous: one device copy, or none where that is a view."""
    v = torch.view_as_real(x).unflatten(split_axis, (m, -1)).movedim(split_axis, 0)
    wire = comm or torch.float32
    if v.is_contiguous() and v.dtype == wire:
        return v
    STATS["pack_copies"] += 1
    return _copy(v, wire)


def _unpack(recv: torch.Tensor, concat_axis: int, out=None) -> torch.Tensor:
    """The received blocks [m, ..., 2] (block j from the rank at coordinate
    j) laid along ``concat_axis`` as float32 complex: one device copy, into
    ``out`` where given (a complex view of the result's slice), or none
    where that is a view."""
    c = concat_axis
    if out is None:
        if c == 0 and recv.dtype == torch.float32:
            return torch.view_as_complex(recv.flatten(0, 1))
        shape = list(recv.shape[1:])
        shape[c] *= recv.shape[0]
        out = torch.empty(shape[:-1], dtype=torch.complex64, device=recv.device)
    STATS["unpack_copies"] += 1
    torch.view_as_real(out).unflatten(c, (recv.shape[0], -1)).movedim(c, 0).copy_(recv)
    return out


class _Turn:
    """A turn in flight: :meth:`finish` waits for its exchange and unpacks."""

    def __init__(self, x, axis: _Axis, split_axis: int, concat_axis: int, comm):
        self.concat_axis, self.works = concat_axis, []
        self.recv = _Exchange.apply(_pack(x, axis.size, split_axis, comm), axis, self.works)

    def finish(self, out=None) -> torch.Tensor:
        for w in self.works:
            if w is not None:
                w.wait()
        return _unpack(self.recv, self.concat_axis, out)


def _a2a(x, axis: _Axis, split_axis: int, concat_axis: int, comm):
    """All-to-all on ``axis``: ``split_axis`` scattered over its ranks,
    ``concat_axis`` gathered; the identity on a dimension of size 1."""
    if axis.size == 1:
        return x
    return _Turn(x, axis, split_axis, concat_axis, comm).finish()


def _fft_axis_local(x, axis: int, sign: int, scale):
    """Local FFT of complex ``x`` along ``axis`` through the plan layer: the
    kernels' complex64 entries where the plan routes ``x`` to them, else
    the planes on the plan's route for that axis."""
    from ..plan.plan import get_plan

    p = get_plan(x.shape[axis])
    y = p._execute_c64(x, axis, sign, scale)
    if y is not None:
        return y
    return merge(*p._execute_split_axis(*split(x), sign, scale, axis))


def _fft_then_a2a(x, fft_axis, sign, scale, axis: _Axis, split_axis, concat_axis,
                  chunk_axis, chunks, comm):
    """FFT along ``fft_axis`` then the turn on ``axis``, pipelined in
    ``chunks`` slices along ``chunk_axis`` (in neither the FFT nor the
    turn): chunk i's exchange is issued, chunk i+1's FFT launched, then
    chunk i's exchange waited on and unpacked into its slice of the
    output.  ``chunks`` of 1, or more than the axis holds, is the
    unpipelined schedule."""
    if axis.size == 1:
        return _fft_axis_local(x, fft_axis, sign, scale)
    n = x.shape[chunk_axis]
    if chunks <= 1 or n < chunks:
        return _a2a(_fft_axis_local(x, fft_axis, sign, scale), axis, split_axis,
                    concat_axis, comm)
    shape = list(x.shape)
    shape[split_axis] //= axis.size
    shape[concat_axis] *= axis.size
    out = torch.empty(shape, dtype=torch.complex64, device=x.device)
    step = -(-n // chunks)
    pending = None
    for s in range(0, n, step):
        c = x.narrow(chunk_axis, s, min(step, n - s))
        if not c.is_contiguous():
            STATS["chunk_copies"] += 1
            c = c.contiguous()
        turn = _Turn(_fft_axis_local(c, fft_axis, sign, scale), axis, split_axis,
                     concat_axis, comm)
        if pending is not None:
            pending[0].finish(out.narrow(chunk_axis, *pending[1]))
        pending = turn, (s, c.shape[chunk_axis])
    pending[0].finish(out.narrow(chunk_axis, *pending[1]))
    return out


# --------------------------------------------------------------------- #
# 3-D pencil FFT
# --------------------------------------------------------------------- #
def _chunks(mesh, overlap_chunks):
    if overlap_chunks is not None:
        return overlap_chunks
    # a measured pin for (card, mesh size) where tune_overlap_chunks ran,
    # else 4 on a mesh of several ranks, 1 alone
    from ..plan.autotune import default_overlap_chunks

    return default_overlap_chunks(mesh)


def _fft3d_local(x, ax: _Axis, ay: _Axis, sign, scale, chunks, comm, transposed_output):
    """Natural shard [.., X/px, Y/py, Z] -> natural, or transposed
    [.., X, Y/px, Z/py]."""
    o = x.ndim - 3
    x = _fft_then_a2a(x, o + 2, sign, None, ay, o + 2, o + 1, o, chunks, comm)  # Z
    x = _fft_then_a2a(x, o + 1, sign, None, ax, o + 1, o, o + 2, chunks, comm)  # Y
    x = _fft_axis_local(x, o, sign, scale)                                       # X
    if not transposed_output:
        x = _a2a(x, ax, o, o + 1, comm)      # -> [.., X/px, Y, Z/py]
        x = _a2a(x, ay, o + 1, o + 2, comm)  # -> [.., X/px, Y/py, Z]
    return x


def _fft3d_local_t(x, ax: _Axis, ay: _Axis, sign, scale, chunks, comm):
    """The mirror schedule: transposed shard [.., X, Y/px, Z/py] ->
    natural [.., X/px, Y/py, Z]."""
    o = x.ndim - 3
    x = _fft_then_a2a(x, o, sign, None, ax, o, o + 1, o + 2, chunks, comm)      # X
    x = _fft_then_a2a(x, o + 1, sign, None, ay, o + 1, o + 2, o, chunks, comm)  # Y
    return _fft_axis_local(x, o + 2, sign, scale)                               # Z


def _fft3d_impl(x, mesh, sign, norm, transposed_output, overlap_chunks, comm_dtype,
                transposed_input):
    mesh = _default_mesh(mesh, x, make_pencil_mesh)
    comm = _norm_comm_dtype(comm_dtype)
    if transposed_input and transposed_output:
        raise ValueError("transposed_input and transposed_output are mutually exclusive")
    shape = tuple(x.shape)
    if len(shape) < 3:
        raise ValueError("fft3d expects at least 3 dimensions")
    o = len(shape) - 3
    ax, ay = _mesh_axes(mesh, 2)
    natural, transposed = (o, o + 1), (o + 1, o + 2)
    scale = _nd_scale(math.prod(shape[-3:]), sign, norm)
    chunks = _chunks(mesh, overlap_chunks)
    loc = _local(x, mesh, transposed if transposed_input else natural, torch.complex64)
    if transposed_input:
        y = _fft3d_local_t(loc, ax, ay, sign, scale, chunks, comm)
    else:
        y = _fft3d_local(loc, ax, ay, sign, scale, chunks, comm, transposed_output)
    return _wrap(y, mesh, transposed if transposed_output else natural, shape)


def fft3d(x, mesh=None, norm=None, *, transposed_output=False,
          overlap_chunks: int | None = None, comm_dtype=None, transposed_input=False):
    """Distributed 3-D forward FFT over the LAST three axes, pencil-
    decomposed over a 2-D mesh (leading axes are batch, on every rank).

    ``overlap_chunks`` pipelines each FFT -> turn pair in that many chunks
    so the exchanges overlap pencil compute (default: the tuned pin for
    this card and mesh size, else 4 on a mesh of several ranks, 1 alone).

    ``comm_dtype=torch.bfloat16`` (or ``"bfloat16"``) sends the corner
    turns in bf16 (compute stays float32), halving the wire bytes; each
    turn rounds the intermediate spectrum to about 3 decimal digits, so
    it is opt-in.  float16 and other dtypes raise ``ValueError``.

    ``transposed_output=True`` returns the natural logical array in the
    TRANSPOSED distribution (X whole, Y/px, Z/py), skipping the two
    restoring turns; feed it to ``ifft3d(..., transposed_input=True)`` for
    a round trip of 4 turns instead of 8."""
    return _fft3d_impl(x, mesh, FORWARD, norm, transposed_output, overlap_chunks,
                       comm_dtype, transposed_input)


def ifft3d(x, mesh=None, norm=None, *, transposed_output=False,
           overlap_chunks: int | None = None, comm_dtype=None, transposed_input=False):
    """Distributed 3-D inverse FFT (the 1/N scale folded into the last
    pass).  ``comm_dtype`` as in :func:`fft3d`; ``transposed_input``
    consumes a ``transposed_output`` spectrum through the mirror schedule
    (X-FFT -> turn -> Y-FFT -> turn -> Z-FFT)."""
    return _fft3d_impl(x, mesh, INVERSE, norm, transposed_output, overlap_chunks,
                       comm_dtype, transposed_input)


# --------------------------------------------------------------------- #
# 2-D slab FFT
# --------------------------------------------------------------------- #
def _fft2d_impl(x, mesh, sign, norm, comm_dtype):
    mesh = _default_mesh(mesh, x, make_mesh)
    comm = _norm_comm_dtype(comm_dtype)
    shape = tuple(x.shape)
    if len(shape) < 2:
        raise ValueError("fft2d expects at least 2 dimensions")
    o = len(shape) - 2
    (ax,) = _mesh_axes(mesh, 1)
    scale = _nd_scale(math.prod(shape[-2:]), sign, norm)
    y = _local(x, mesh, (o,), torch.complex64)      # [.., X/p, Y]
    y = _fft_axis_local(y, o + 1, sign, None)       # Y-FFT
    y = _a2a(y, ax, o + 1, o, comm)                 # -> [.., X, Y/p]
    y = _fft_axis_local(y, o, sign, scale)          # X-FFT
    y = _a2a(y, ax, o, o + 1, comm)                 # -> [.., X/p, Y]
    return _wrap(y, mesh, (o,), shape)


def fft2d(x, mesh=None, norm=None, *, comm_dtype=None):
    """Distributed 2-D forward FFT over the LAST two axes, slab-decomposed
    over a 1-D mesh (leading axes are batch).  ``comm_dtype`` as in
    :func:`fft3d`."""
    return _fft2d_impl(x, mesh, FORWARD, norm, comm_dtype)


def ifft2d(x, mesh=None, norm=None, *, comm_dtype=None):
    """Distributed 2-D inverse FFT (slab)."""
    return _fft2d_impl(x, mesh, INVERSE, norm, comm_dtype)


# --------------------------------------------------------------------- #
# Distributed 1-D FFT (one long vector, four-step across the mesh)
# --------------------------------------------------------------------- #
def _divisible_factors(n: int, p: int) -> tuple[int, int] | None:
    """Most-balanced n = n1 * n2 with p | n1 and p | n2, or None."""
    if p <= 0 or n % (p * p):
        return None
    m = n // (p * p)
    best = None
    d = 1
    while d * d <= m:
        if m % d == 0:
            best = d  # largest divisor <= sqrt(m)
        d += 1
    if best is None:
        return None
    return p * best, p * (m // best)


@functools.lru_cache(maxsize=4)
def _twiddle_plane(n1: int, n2: int, sign: int, parts: int, index: int, device):
    """This rank's columns of the four-step's twiddle plane
    tw[k1, m2] = exp(sign 2 pi i k1 m2 / (n1 n2)) (float64, cast once to
    float32: ``core.twiddle.twiddle_np``), m2 in its block of n2 / parts,
    as a complex64 tensor on ``device``."""
    twr, twi = twiddle_np(n1, n2, sign)
    w = n2 // parts
    tw = np.empty((n1, w), np.complex64)
    tw.real, tw.imag = twr[:, index * w:(index + 1) * w], twi[:, index * w:(index + 1) * w]
    return torch.from_numpy(tw).to(device)


def _turn_transposed(d, axis: _Axis, comm):
    """[n1/p, n2] rows of D -> this rank's [n2/p, n1] rows of D^T (its
    contiguous block of the natural-order output): the turn's unpack
    writes the transpose, so it is one copy; alone, the transpose."""
    if axis.size == 1:
        STATS["unpack_copies"] += 1
        return d.t().contiguous()
    turn = _Turn(d, axis, 1, 0, comm)
    for w in turn.works:
        if w is not None:
            w.wait()
    r = turn.recv  # [p, n1/p, n2/p, 2]
    STATS["unpack_copies"] += 1
    out = _copy(r.permute(2, 0, 1, 3), torch.float32)
    return torch.view_as_complex(out).reshape(r.shape[2], -1)


def fft1d_distributed(x, mesh=None, *, inverse=False, norm=None, comm_dtype=None):
    """1-D FFT of one vector sharded across a 1-D mesh.

    The distributed four-step: x[n] is A[n1, n2] with n1 sharded; a turn
    makes n1 whole, the n1-point FFTs run along axis 0 (the axis(-2)
    kernel, no transpose), the twiddle plane multiplies each rank's m2
    columns, a turn makes n2 whole, the n2-point FFTs run along the rows,
    and the last turn leaves each rank its contiguous block of the
    natural-order output.  ``x`` is a DTensor of [n] sharded on axis 0, or
    the global array of any shape (flattened).  Factors are
    ``ops.fourstep.choose_factors``', else the most balanced pair both
    divisible by the mesh size; a length with no such pair takes the
    replicated whole transform on every rank (a route chosen before any
    launch) and returns it replicated.  ``comm_dtype`` as in
    :func:`fft3d`."""
    mesh = _default_mesh(mesh, x, make_mesh)
    comm = _norm_comm_dtype(comm_dtype)
    (axis,) = _mesh_axes(mesh, 1)
    p = axis.size
    n = math.prod(x.shape)
    sign = INVERSE if inverse else FORWARD
    if norm in (None, "backward"):
        scale = 1.0 / n if inverse else None
    elif norm == "ortho":
        scale = n**-0.5
    elif norm == "forward":
        scale = None if inverse else 1.0 / n
    else:
        raise ValueError(f"invalid norm {norm!r}")

    n1, n2 = choose_factors(n)
    if n1 % p or n2 % p:
        pair = _divisible_factors(n, p)
        if pair is None:
            v = x.full_tensor() if isinstance(x, DTensor) else _as_tensor(x, mesh)
            y = _fft_axis_local(v.reshape(n).to(torch.complex64), 0, sign, scale)
            if mesh is None:
                return y
            return DTensor.from_local(y, mesh, [Replicate()], run_check=False)
        n1, n2 = pair
    if isinstance(x, DTensor):
        a = _local(x, mesh, (0,), torch.complex64).reshape(n1 // p, n2)
    else:
        a = _local(_as_tensor(x, mesh).reshape(n1, n2), mesh, (0,), torch.complex64)
    a = _a2a(a, axis, 1, 0, comm)                                    # -> [n1, n2/p]
    a = _fft_axis_local(a, 0, sign, None)                            # B[k1, m2]
    a = a * _twiddle_plane(n1, n2, sign, p, axis.index, a.device)    # C = B * tw
    a = _a2a(a, axis, 0, 1, comm)                                    # -> [n1/p, n2]
    a = _fft_axis_local(a, 1, sign, scale)                           # D[k1, k2]
    y = _turn_transposed(a, axis, comm)                              # [n2/p, n1]
    return _wrap(y.reshape(-1), mesh, (0,), (n,))


# --------------------------------------------------------------------- #
# 3-D R2C / C2R pencil transforms (real simulation data)
# --------------------------------------------------------------------- #
def _r2c_z(x):
    """R2C of a real shard along Z: the R2C kernel's complex64 sink on a
    card (pow2 Z in its envelope), else the planes' route; odd Z a C2C of
    a zero imaginary plane, its half spectrum kept."""
    z = x.shape[-1]
    if z % 2 == 0:
        if _rfft._rfft_c64(x.device, z):
            return cuda_fft.rfft_rows_c64(x.contiguous(), None)
        return merge(*_rfft.rfft_last_split(x, None))
    re, im = fftn_split(x, torch.zeros_like(x), (x.ndim - 1,), FORWARD, None)
    return merge(re[..., : z // 2 + 1], im[..., : z // 2 + 1])


def _c2r_z(X, n: int):
    """C2R along Z of the half spectrum ``X`` [.., n//2 + 1], scaled 1/n:
    the C2R kernel's complex64 source on a card (pow2 n), else the planes'
    route; odd n the Hermitian extension and an inverse C2C."""
    if n % 2 == 0:
        if _rfft._irfft_c64(X.device, n):
            return cuda_fft.irfft_rows_c64(X.contiguous(), n, 1.0 / n)
        return _rfft.irfft_last_split(*split(X), n, 1.0 / n)
    fr, fi = _rfft._hermitian_extend(*split(X), n)
    return fftn_split(fr, fi, (fr.ndim - 1,), INVERSE, 1.0 / n)[0]


def _pad_last(X, width: int):
    """``X`` with its last axis zero-padded to ``width`` (a copy where it
    grows)."""
    pad = width - X.shape[-1]
    if pad == 0:
        return X
    STATS["pad_copies"] += 1
    return torch.nn.functional.pad(X, (0, pad))


def _kp(nb: int, py: int) -> int:
    """The half-spectrum axis padded to a multiple of py for its turns."""
    return -(-nb // py) * py


def _spectrum_shard(grid: np.ndarray, xpart, ypart, transposed: bool, fill=0.0) -> np.ndarray:
    """This rank's shard of a numpy ``grid`` over an rfft3d spectrum's
    last three axes [X, Y, Kz], in the layout the padded spectra live in
    (:func:`_rfft3d_local`): Kz padded with ``fill`` to Kp (a multiple of
    py), then the transposed [X, Y/px, Kp/py] or the natural
    [X/px, Y/py, Kp] slice.  ``xpart`` and ``ypart`` are (mesh size, this
    rank's coordinate) of px and py; an axis of length 1 broadcasts and
    is left whole."""
    (px, ix), (py, iy) = xpart, ypart
    nb = grid.shape[-1]
    if nb > 1:
        widths = [(0, 0)] * (grid.ndim - 1) + [(0, _kp(nb, py) - nb)]
        grid = np.pad(grid, widths, constant_values=fill)
    dims = (-2, -1) if transposed else (-3, -2)
    for d, (parts, index) in zip(dims, ((px, ix), (py, iy))):
        if grid.shape[d] > 1:
            start, size = _chunk(grid.shape[d], parts, index)
            grid = np.take(grid, range(start, start + size), axis=d)
    return grid


def _rfft3d_local(x, ax: _Axis, ay: _Axis, scale, chunks, comm, transposed_output):
    """Real natural shard [.., X/px, Y/py, Z] -> its spectrum with the
    half-spectrum axis padded to Kp (a multiple of py; the pad is zeros):
    natural [.., X/px, Y/py, Kp] or transposed [.., X, Y/px, Kp/py]."""
    o = x.ndim - 3
    nb = x.shape[-1] // 2 + 1
    X = _pad_last(_r2c_z(x), _kp(nb, ay.size))
    X = _a2a(X, ay, o + 2, o + 1, comm)                                     # [.., Xl, Y, Kp/py]
    X = _fft_then_a2a(X, o + 1, FORWARD, None, ax, o + 1, o, o + 2, chunks, comm)  # Y
    X = _fft_axis_local(X, o, FORWARD, scale)                               # X
    if not transposed_output:
        X = _a2a(X, ax, o, o + 1, comm)      # [.., X/px, Y, Kp/py]
        X = _a2a(X, ay, o + 1, o + 2, comm)  # [.., X/px, Y/py, Kp]
    return X


def _irfft3d_local(X, n_last: int, ax: _Axis, ay: _Axis, scale, chunks, comm,
                   transposed_input):
    """The padded spectrum shard (as :func:`_rfft3d_local` leaves it) ->
    the real natural shard [.., X/px, Y/py, n_last]."""
    o = X.ndim - 3
    if transposed_input:
        X = _fft_then_a2a(X, o, INVERSE, scale, ax, o, o + 1, o + 2, chunks, comm)      # X
        X = _fft_then_a2a(X, o + 1, INVERSE, None, ay, o + 1, o + 2, o, chunks, comm)   # Y
    else:
        X = _a2a(X, ay, o + 2, o + 1, comm)                                     # [.., Xl, Y, Kp/py]
        X = _fft_then_a2a(X, o + 1, INVERSE, None, ax, o + 1, o, o + 2, chunks, comm)  # Y
        X = _fft_axis_local(X, o, INVERSE, scale)                               # X
        X = _a2a(X, ax, o, o + 1, comm)
        X = _a2a(X, ay, o + 1, o + 2, comm)                                     # [.., X/px, Y/py, Kp]
    return _c2r_z(X[..., : n_last // 2 + 1], n_last)


def _irfft_scale(Xn: int, Yn: int, n_last: int, norm):
    """The complex stage's scale: the C2R contributes 1/n_last, so this
    brings the net inverse scale to 1/total (backward), total**-0.5
    (ortho) or 1 (forward)."""
    total = Xn * Yn * n_last
    if norm in (None, "backward"):
        return 1.0 / (Xn * Yn)
    if norm == "ortho":
        return total**-0.5 * n_last
    if norm == "forward":
        return float(n_last)
    raise ValueError(f"invalid norm {norm!r}")


def rfft3d(x, mesh=None, norm=None, *, overlap_chunks: int | None = None,
           comm_dtype=None, transposed_output=False):
    """Distributed 3-D R2C: rfft over Z locally, then complex pencil FFTs
    over Y and X.  Input real [X, Y, Z] (natural distribution); output
    complex [X, Y, Z//2+1], natural, or with ``transposed_output=True``
    transposed (X whole, Y/px, Kz/py: pair it with
    ``irfft3d(transposed_input=True)`` for a 4-turn round trip; the ns3d
    stepper runs this way).  ``overlap_chunks`` and ``comm_dtype`` as in
    :func:`fft3d`.

    Kz = Z//2+1 is never a multiple of py: each rank pads its half-spectrum
    axis with zeros to a multiple of py for the turns, and the result
    holds the logical width: natural shards are the padded ones sliced to
    Kz (a view), and in the transposed layout the last shards along py
    are uneven (``torch.chunk``'s rule, DTensor's), the padded columns
    sliced off as a view.  Odd Z takes a C2C of a zero imaginary plane."""
    mesh = _default_mesh(mesh, x, make_pencil_mesh)
    comm = _norm_comm_dtype(comm_dtype)
    shape = tuple(x.shape)
    if len(shape) < 3:
        raise ValueError("rfft3d expects at least 3 dimensions")
    o = len(shape) - 3
    ax, ay = _mesh_axes(mesh, 2)
    nb = shape[-1] // 2 + 1
    loc = _local(x, mesh, (o, o + 1), torch.float32)
    y = _rfft3d_local(loc, ax, ay, _nd_scale(math.prod(shape[-3:]), FORWARD, norm),
                      _chunks(mesh, overlap_chunks), comm, transposed_output)
    if transposed_output:
        y = y.narrow(-1, 0, _chunk(nb, ay.size, ay.index)[1])
        dims = (o + 1, o + 2)
    else:
        y = y[..., :nb]
        dims = (o, o + 1)
    return _wrap(y, mesh, dims, shape[:-1] + (nb,))


def irfft3d(X, n_last: int, mesh=None, norm=None, *, overlap_chunks: int | None = None,
            comm_dtype=None, transposed_input=False):
    """Distributed 3-D C2R inverse of :func:`rfft3d`.

    ``n_last`` is the real length of the Z axis (numpy irfft's ``n``); the
    half-spectrum axis must hold n_last//2 + 1 bins.  ``overlap_chunks``
    and ``comm_dtype`` as in :func:`rfft3d`; ``transposed_input=True``
    consumes an ``rfft3d(transposed_output=True)`` spectrum through the
    mirror schedule (X-iFFT -> turn -> Y-iFFT -> turn -> C2R)."""
    mesh = _default_mesh(mesh, X, make_pencil_mesh)
    comm = _norm_comm_dtype(comm_dtype)
    shape = tuple(X.shape)
    if len(shape) < 3:
        raise ValueError("irfft3d expects at least 3 dimensions")
    Xn, Yn, nb = shape[-3:]
    if nb != n_last // 2 + 1:
        raise ValueError(f"irfft3d: {nb} bins for n_last={n_last}, expected {n_last // 2 + 1}")
    o = len(shape) - 3
    ax, ay = _mesh_axes(mesh, 2)
    kp = _kp(nb, ay.size)
    if transposed_input:
        loc = _pad_last(_local(X, mesh, (o + 1, o + 2), torch.complex64, even=False),
                        kp // ay.size)
    else:
        loc = _pad_last(_local(X, mesh, (o, o + 1), torch.complex64), kp)
    y = _irfft3d_local(loc, n_last, ax, ay, _irfft_scale(Xn, Yn, n_last, norm),
                       _chunks(mesh, overlap_chunks), comm, transposed_input)
    return _wrap(y, mesh, (o, o + 1), shape[:-1] + (n_last,))
