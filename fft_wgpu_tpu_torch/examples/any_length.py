"""Any-length FFT demo (the port of ``examples/any_length.py``): every
length class on its route, each against numpy.

  * pow2 in [128, 16384]       -> the row kernel
  * composite, factors <= 256  -> the composite-row kernel (4095 = 63*65)
  * prime / big prime factors  -> Bluestein's fused chirp kernel
  * odd composite (real input) -> the composite R2C kernel

Run: python -m fft_wgpu_tpu_torch.examples.any_length [--device cpu]
"""

import numpy as np

import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.examples._common import cli, device_of, host, on, rel_l2


def check(tag, got, want, tol=1e-5):
    rel = rel_l2(got, want)
    assert rel < tol, f"{tag}: rel {rel:.2e} >= {tol}"
    print(f"  {tag}: rel {rel:.2e}")


def main(device=None, small=False):
    dev = device_of(device)
    rng = np.random.default_rng(0)
    rows = 2 if small else 16

    print("C2C, one route per length class:")
    for n, why in [
        (4096, "pow2 -> row kernel"),
        (4095, "63*65 -> composite-row kernel"),
        (4093, "prime -> Bluestein's fused chirp kernel"),
        (4097, "17*241 -> composite-row kernel"),
        (1000, "25*40 -> composite-row kernel"),
    ]:
        x = (rng.standard_normal((rows, n))
             + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
        got = host(ft.fft(on(x, dev)))
        check(f"fft n={n:5d} ({why})", got, np.fft.fft(x, axis=-1))

    print("R2C on an odd composite length (no even-pack path exists):")
    xr = rng.standard_normal((rows, 1005)).astype(np.float32)
    got = host(ft.rfft(on(xr, dev)))
    check("rfft n=1005 (15*67 -> composite R2C kernel)", got, np.fft.rfft(xr, axis=-1))

    print("CZT rides the same fused chirp kernels:")
    x = (rng.standard_normal((rows, 700))
         + 1j * rng.standard_normal((rows, 700))).astype(np.complex64)
    import scipy.signal as sig

    got = host(ft.czt(on(x, dev), m=450))
    check("czt 700 -> 450 bins", got, sig.czt(np.asarray(x, np.complex128), m=450), tol=1e-4)
    print("all any-length routes verified")


if __name__ == "__main__":
    cli(main)
