"""Distributed 3-D Navier-Stokes DNS on the pencil mesh (the port of
``examples/ns3d_dns.py``): the exact ABC-Beltrami viscous decay, then a
decaying-turbulence rollout whose kinetic energy must fall; 4 distributed
transform calls per RK2 step (the u and omega inverses batched, the Lamb
vector's forwards batched).

Run alone (no process group: one process, every corner turn the identity):
    python -m fft_wgpu_tpu_torch.examples.ns3d_dns [--device cpu] [--small]
or on N cards, one rank each (NCCL, the pencil mesh over the ranks):
    torchrun --nproc-per-node=N -m fft_wgpu_tpu_torch.examples.ns3d_dns
"""

import os
import time

import numpy as np
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from fft_wgpu_tpu_torch.examples._common import cli, device_of, host, on
from fft_wgpu_tpu_torch.models import ns3d
from fft_wgpu_tpu_torch.parallel.mesh import make_pencil_mesh
from fft_wgpu_tpu_torch.parallel.multihost import initialize


def _whole(u):
    return host(u.full_tensor() if isinstance(u, DTensor) else u)


def main(device=None, small=False):
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        initialize()  # launched by torchrun
    dev = device_of(device)
    mesh = make_pencil_mesh(device_type=dev.type) if dist.is_initialized() else None
    print(f"mesh: {tuple(mesh.shape) if mesh is not None else 'none (one process)'} on {dev}")
    n = 16 if small else 32

    # 1. exactness: a Beltrami flow decays analytically, u(t) = u0 e^{-nu t}
    nu, dt, steps = 0.05, 0.05, (10 if small else 40)
    c = ns3d.ns3d_init(n, nu, dt, mesh)
    u0 = ns3d.abc_flow(n, device=dev)
    t0 = time.perf_counter()
    uT = _whole(ns3d.ns3d_rollout(c, u0, steps))
    t1 = time.perf_counter()
    expect = host(u0) * np.exp(-nu * dt * steps, dtype=np.float32)
    err = np.linalg.norm(uT - expect) / np.linalg.norm(expect)
    print(f"ABC decay over t={nu * dt * steps:.2f}: rel err {err:.2e} "
          f"({steps} steps in {t1 - t0:.1f}s incl. kernel loads)")
    assert err < 1e-4

    # 2. decaying turbulence: random velocity, the energy must fall
    rng = np.random.default_rng(0)
    u = rng.standard_normal((3, n, n, n)).astype(np.float32)
    c2 = ns3d.ns3d_init(n, nu=2e-3, dt=2e-3, mesh=mesh)
    chunk = 5 if small else 25
    e_prev = None
    for k in range(3):
        u = _whole(ns3d.ns3d_rollout(c2, on(u, dev), chunk))
        e = float((u ** 2).mean())
        print(f"t={(k + 1) * chunk * 2e-3:.3f}: kinetic energy {e:.4f}")
        assert e_prev is None or e < e_prev, "unforced energy must decay"
        e_prev = e
    print("OK")


if __name__ == "__main__":
    cli(main)
