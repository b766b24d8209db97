"""Chebyshev collocation boundary-value problem (the port of
``examples/chebyshev_bvp.py``): solve u''(x) = f(x) on [-1, 1] with
u(-1) = u(1) = 0, the differentiation operator built column by column
from the DCT route's spectral derivative (``ops/chebyshev.py``), against a
manufactured solution; then the Clenshaw-Curtis integral of the result.

Run: python -m fft_wgpu_tpu_torch.examples.chebyshev_bvp [--device cpu]
"""

import numpy as np

import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.examples._common import cli, device_of, host, on


def main(device=None, small=False):
    dev = device_of(device)
    n = 48
    x = host(ft.cheb_points(n, device=dev)).astype(np.float64)

    u_exact = (1 - x * x) * np.exp(x)
    # u = (1-x^2)e^x: u'' = e^x(1 - x^2 - 4x - 2)
    f = np.exp(x) * (-x * x - 4 * x - 1)

    # the second-derivative collocation operator: D2's columns are the
    # batched spectral derivatives of the identity's columns
    eye = np.eye(n + 1, dtype=np.float32)
    D2 = host(ft.cheb_derivative(on(eye.T, dev), order=2)).astype(np.float64).T

    A = D2.copy()  # Dirichlet conditions in the first and last rows
    rhs = f.copy()
    A[0, :] = 0.0
    A[0, 0] = 1.0
    A[-1, :] = 0.0
    A[-1, -1] = 1.0
    rhs[0] = rhs[-1] = 0.0

    u = np.linalg.solve(A, rhs)
    rel = np.linalg.norm(u - u_exact) / np.linalg.norm(u_exact)
    print(f"BVP u'' = f, Dirichlet, n = {n}: rel-L2 vs exact = {rel:.2e}")

    # int_{-1}^{1} (1-x^2) e^x dx = 4/e
    got = float(ft.cheb_integrate(on(u.astype(np.float32), dev)))
    want = 4.0 / np.e
    print(f"Clenshaw-Curtis integral: {got:.6f} (exact 4/e = {want:.6f}, "
          f"err {abs(got - want):.1e})")
    assert rel < 1e-3 and abs(got - want) < 1e-4


if __name__ == "__main__":
    cli(main)
