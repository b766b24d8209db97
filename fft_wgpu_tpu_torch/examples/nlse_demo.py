"""Split-step Fourier NLSE (the port of ``examples/nlse_demo.py``): a moving
bright soliton against its analytic solution, then two solitons that
collide and pass through each other with their mass intact.

Run: python -m fft_wgpu_tpu_torch.examples.nlse_demo [--device cpu]
"""

import time

import numpy as np

from fft_wgpu_tpu_torch.examples._common import cli, device_of, host
from fft_wgpu_tpu_torch.models import bright_soliton, nlse_init, nlse_rollout


def main(device=None, small=False):
    dev = device_of(device)
    n, L, dt = 1024, 100.0, 1e-3
    steps, collide = (400, 1200) if small else (4000, 12000)

    # 1. exactness: one moving soliton against the closed-form solution
    c = nlse_init((n,), L, dt, g=1.0, device=dev)
    psi0 = bright_soliton(n, L, eta=1.2, v=2.0, x0=-20.0, device=dev)
    t0 = time.perf_counter()
    got = host(nlse_rollout(c, psi0, steps)).astype(np.complex128)
    first_s = time.perf_counter() - t0
    want = host(bright_soliton(n, L, eta=1.2, v=2.0, x0=-20.0, t=steps * dt, device=dev))
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"moving soliton, {steps} steps: rel-L2 vs analytic = {err:.2e} "
          f"(first call incl. kernel loads: {first_s:.1f}s)")

    # 2. two-soliton collision: counter-propagating solitons emerge with
    # their mass intact (an elastic collision)
    s1 = bright_soliton(n, L, eta=1.0, v=+1.5, x0=-15.0, device=dev)
    s2 = bright_soliton(n, L, eta=0.8, v=-1.5, x0=+15.0, device=dev)
    psi0 = (s1[0] + s2[0], s1[1] + s2[1])
    m0 = float((psi0[0] ** 2 + psi0[1] ** 2).sum())
    t0 = time.perf_counter()
    fr, fi = nlse_rollout(c, psi0, collide)  # through the collision and out
    run_s = time.perf_counter() - t0
    m1 = float((fr ** 2 + fi ** 2).sum())
    amp = host((fr ** 2 + fi ** 2).sqrt())
    print(f"collision: mass drift {abs(m1 - m0) / m0:.2e}, post-collision peak amplitude "
          f"~ {amp.max():.2f} ({collide} steps in {run_s:.2f}s)")
    # both substeps conserve mass; the drift is float32 accumulation
    assert err < 5e-3 and abs(m1 - m0) / m0 < 5e-3


if __name__ == "__main__":
    cli(main)
