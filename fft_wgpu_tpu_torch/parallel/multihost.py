"""Multi-process bring-up helpers (torch port of
``fft_wgpu_tpu.parallel.multihost``).

Each process joins the ``torch.distributed`` default process group before
any mesh is built: one process (rank) per device, NCCL for CUDA ranks and
gloo for CPU ones.  Nothing on a machine tells a program of its cluster:
the arguments, or torchrun's environment, say where the others are.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import make_pencil_mesh

__all__ = ["initialize", "global_pencil_mesh"]


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None):
    """Join the process group (idempotent) and return (rank, world size).

    ``coordinator_address`` is ``host:port`` (a TCP store on rank 0's
    host), a ``tcp://`` or ``file://`` URL; without it the rendezvous is
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``), and ``num_processes`` / ``process_id`` default to
    ``WORLD_SIZE`` / ``RANK``.  ``backend`` defaults to NCCL where there is
    a card and gloo elsewhere; a CUDA rank takes device ``LOCAL_RANK``
    (else its rank modulo the cards) as its current device."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def global_pencil_mesh(axis_names=("px", "py"), *, device_type: str | None = None):
    """Pencil mesh over every rank of the process group (all hosts)."""
    return make_pencil_mesh(axis_names=axis_names, device_type=device_type)
