"""Device mesh construction helpers (torch port of
``fft_wgpu_tpu.parallel.mesh``).

A JAX device becomes a rank of the default ``torch.distributed`` process
group, with one device per rank; a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over those ranks.  Build it
once and pass it to the distributed transforms (``parallel.pencil``,
``parallel.batched``).  Every rank of the mesh must call these functions,
in the same order: a ``DeviceMesh`` creates one process group per mesh
dimension, a collective call.

The mesh's device type is ``"cuda"`` on a machine with a card and
``"cpu"`` elsewhere (``device_type`` overrides it); the exchanges follow
the backend of the group underneath (NCCL or gloo, ``parallel.pencil``).
"""

from __future__ import annotations

import math
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "make_pencil_mesh", "make_hybrid_mesh"]


def _world_ranks() -> list:
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call "
            "parallel.multihost.initialize() first (the transforms take "
            "mesh=None without one and then run on this process alone)")
    return list(range(dist.get_world_size()))


def _check_increasing(ranks: np.ndarray) -> None:
    """The exchanges send block j of a mesh dimension to the rank at
    coordinate j, and ``torch.distributed`` orders a group's ranks by their
    global rank, so along every mesh dimension the ranks must increase."""
    for d in range(ranks.ndim):
        if ranks.shape[d] > 1 and not (np.diff(ranks, axis=d) > 0).all():
            raise ValueError(
                f"mesh ranks {ranks.tolist()} do not increase along dimension {d}")


def make_mesh(shape=None, axis_names=("x",), devices=None, *,
              device_type: str | None = None) -> DeviceMesh:
    """Build a mesh over ``devices``, a list of ranks (default: every rank
    of the process group).  ``shape=None`` puts them all on one axis."""
    devices = list(devices if devices is not None else _world_ranks())
    if shape is None:
        shape = (len(devices),)
    if math.prod(shape) != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    ranks = np.asarray(devices, dtype=np.int64).reshape(shape)
    _check_increasing(ranks)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.from_numpy(ranks),
                      mesh_dim_names=tuple(axis_names))


def make_pencil_mesh(devices=None, axis_names=("px", "py"), *,
                     device_type: str | None = None) -> DeviceMesh:
    """2-D mesh as square as possible, (p1, p2) with p1 <= p2: the pencil
    decomposition's layout (BASELINE.json config 5)."""
    devices = list(devices if devices is not None else _world_ranks())
    nd = len(devices)
    p1 = 1
    for d in range(int(math.isqrt(nd)), 0, -1):
        if nd % d == 0:
            p1 = d
            break
    return make_mesh((p1, nd // p1), axis_names, devices, device_type=device_type)


def _nodes(devices) -> list:
    """The node of each rank: from ``LOCAL_WORLD_SIZE`` (torchrun's ranks a
    node, consecutive), else an all-gather of the host names."""
    lws = os.environ.get("LOCAL_WORLD_SIZE")
    if lws:
        return [r // int(lws) for r in devices]
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return [names[r] for r in devices]


def make_hybrid_mesh(axis_names=("dcn", "ici"), devices=None, *,
                     device_type: str | None = None) -> DeviceMesh:
    """Multi-node 2-D mesh: the MINOR axis holds the ranks of one node (its
    exchanges ride NVLink), the MAJOR axis crosses nodes (the network).

    The TPU's ``slice_index`` becomes the node: it comes from
    ``LOCAL_WORLD_SIZE`` (ranks ``[k * L, (k + 1) * L)`` on node k, as
    torchrun places them), or else from an all-gather of the host names
    (every rank of the group must call this).  One node gives a [1, n]
    mesh.  Nodes of unequal rank counts raise ``ValueError``.  Lay the
    pencil transforms' corner turns on the minor axis and only batch
    parallelism on the major one: the network's all-to-all bandwidth is
    far below NVLink's (``utils.roofline.pencil_fft3d_model``)."""
    devices = list(devices if devices is not None else _world_ranks())
    groups: dict = {}
    for r, k in zip(devices, _nodes(devices)):
        groups.setdefault(k, []).append(r)
    counts = {len(v) for v in groups.values()}
    if len(counts) != 1:
        raise ValueError(
            f"uneven nodes: {sorted((str(k), len(v)) for k, v in groups.items())}")
    per = counts.pop()
    ordered = [r for k in sorted(groups, key=lambda k: min(groups[k]))
               for r in sorted(groups[k])]
    return make_mesh((len(groups), per), axis_names, ordered, device_type=device_type)
