"""Inverse FFT example with the 1/N folded in, against numpy (the port of
``examples/basic_inverse.py``, itself the reference's
examples/basic_inverse.rs): the 2500 x 512 batch through ``Inverse``.

Run: python -m fft_wgpu_tpu_torch.examples.basic_inverse [--device cpu]
"""

import numpy as np

import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.examples._common import cli, device_of, host, on, rel_l2


def main(device=None, small=False):
    dev = device_of(device)
    batch, n = (64, 512) if small else (2500, 512)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(
        np.complex64)

    inv = ft.Inverse(n)  # the reference-shaped API
    err = rel_l2(host(inv.proc(on(x, dev))), np.fft.ifft(x, axis=-1))
    print(f"inverse {batch}x{n}: rel-L2 vs numpy = {err:.2e}")
    assert err < 1e-5


if __name__ == "__main__":
    cli(main)
