"""Two-pass inverse: the unnormalized IFFT, then a standalone normalize
(the port of ``examples/basic_inverse2.py``, itself the reference's
examples/basic_inverse2.rs): ``Onlyinverse.proc`` then ``Normalize.proc``
on data moved to the device as planar float32 by ``device_put_complex``.

Run: python -m fft_wgpu_tpu_torch.examples.basic_inverse2 [--device cpu]
"""

import numpy as np

import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.examples._common import cli, device_of, rel_l2


def main(device=None, small=False):
    dev = device_of(device)
    batch, n = (64, 512) if small else (2500, 512)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(
        np.complex64)

    only = ft.Onlyinverse(n)
    nrm = ft.Normalize(n)
    xd = ft.device_put_complex(x, device=dev)
    y = ft.device_get_complex(nrm.proc(only.proc(xd)))
    err = rel_l2(y, np.fft.ifft(x, axis=-1))
    print(f"two-pass inverse {batch}x{n}: rel-L2 vs numpy = {err:.2e}")
    assert err < 1e-5


if __name__ == "__main__":
    cli(main)
