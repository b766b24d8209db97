"""Forward FFT example and micro-bench (the port of ``examples/basic.py``,
itself the reference's examples/basic.rs): 2500 rows of 512 points, one
transform against numpy, then a timed loop of transforms on the device
(the host boundary crossed once on each side).

Run: python -m fft_wgpu_tpu_torch.examples.basic [--device cpu]
"""

import time

import numpy as np
import torch

import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.examples._common import cli, device_of, host, on, rel_l2


def main(device=None, small=False):
    dev = device_of(device)
    batch, n, iters = (64, 512, 10) if small else (2500, 512, 1000)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(
        np.complex64)

    p = ft.plan(n)
    xd = on(x, dev)
    err = rel_l2(host(p.forward(xd)), np.fft.fft(x, axis=-1))
    print(f"forward {batch}x{n}: rel-L2 vs numpy = {err:.2e}")
    # the reference's forward example never asserts; this one does
    assert err < 1e-5, f"forward parity failed: rel-L2 {err:.2e} >= 1e-5"

    # timed loop, chained on the device: each transform feeds the next
    y = p.forward(xd)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        y = p.forward(y)
    _ = float(y[..., 0].real.sum())  # one read back, after the loop
    dt = time.perf_counter() - t0
    gf = 5 * n * np.log2(n) * batch * iters / dt / 1e9
    print(f"{iters} iters in {dt:.3f}s -> {dt / iters * 1e6:.1f} us/iter, {gf:.0f} GFLOP/s "
          f"on {dev}")


if __name__ == "__main__":
    cli(main)
