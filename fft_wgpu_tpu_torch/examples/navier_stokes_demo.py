"""Pseudo-spectral 2-D Navier-Stokes (the port of
``examples/navier_stokes_demo.py``): the Taylor-Green vortex against its
analytic decay, then a decaying-turbulence rollout whose enstrophy must
fall.

Run: python -m fft_wgpu_tpu_torch.examples.navier_stokes_demo [--device cpu]
"""

import time

import numpy as np

from fft_wgpu_tpu_torch.examples._common import cli, device_of, host, on
from fft_wgpu_tpu_torch.models import navier_stokes as ns


def main(device=None, small=False):
    dev = device_of(device)
    n, nu, dt = (64, 5e-3, 5e-3) if small else (128, 5e-3, 5e-3)
    c = ns.ns2d_init(n, nu, dt, device=dev)

    # 1. exactness: the Taylor-Green vortex decays analytically
    k, steps = 2, (20 if small else 100)
    w0 = ns.taylor_green_vorticity(n, k, device=dev)
    t0 = time.perf_counter()
    wT = host(ns.ns2d_rollout(c, w0, steps))
    first_s = time.perf_counter() - t0
    want = host(w0) * np.exp(-2.0 * k * k * nu * dt * steps)
    err = np.linalg.norm(wT - want) / np.linalg.norm(want)
    print(f"Taylor-Green {steps} steps: rel-L2 vs analytic = {err:.2e} "
          f"(first call incl. kernel loads: {first_s:.1f}s)")

    # 2. decaying turbulence from random vorticity (the enstrophy must fall)
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((n, n)).astype(np.float32)
    w0 -= w0.mean()
    t0 = time.perf_counter()
    wT = host(ns.ns2d_rollout(c, on(w0, dev), steps))
    run_s = time.perf_counter() - t0
    z0, zT = float((w0 ** 2).sum()), float((wT ** 2).sum())
    print(f"decaying turbulence: enstrophy {z0:.1f} -> {zT:.1f} ({steps} steps in {run_s:.2f}s)")
    assert err < 5e-4 and zT < z0


if __name__ == "__main__":
    cli(main)
