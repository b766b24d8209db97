"""Spectral Poisson solve (the port of ``examples/poisson_demo.py``):
laplacian(u) = f on a periodic 2-D box, against the analytic solution.

Run: python -m fft_wgpu_tpu_torch.examples.poisson_demo [--device cpu]
"""

import numpy as np

from fft_wgpu_tpu_torch.examples._common import cli, device_of, host, on
from fft_wgpu_tpu_torch.models.poisson import solve_poisson


def main(device=None, small=False):
    dev = device_of(device)
    n = 64 if small else 256
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    X, Y = np.meshgrid(x, x, indexing="ij")
    u_true = np.sin(3 * X) * np.cos(Y)
    f = -(9 + 1) * u_true  # the Laplacian of u_true

    u = host(solve_poisson(on(f.astype(np.float32), dev)))
    err = np.linalg.norm(u - u_true) / np.linalg.norm(u_true)
    print(f"Poisson {n}x{n}: rel-L2 error vs analytic = {err:.2e}")
    assert err < 1e-4


if __name__ == "__main__":
    cli(main)
