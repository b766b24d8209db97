"""Non-Cartesian MRI-style reconstruction on the NUFFT stack (the port of
``examples/mri_recon.py``): radial k-space samples of a phantom by the
type-2 NUFFT, then the density-compensated adjoint (type-1) recon:

    k-space data  y_j = (type-2 NUFFT)(image)        [forward model]
    recon         x^  = (type-1 NUFFT)(w_j * y_j)    [adjoint + DCF]

Run: python -m fft_wgpu_tpu_torch.examples.mri_recon [--device cpu]
"""

import numpy as np

import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.examples._common import cli, device_of, host, on


def phantom(n):
    """An analytic phantom: three Gaussian blobs and a rectangle."""
    yy, xx = np.mgrid[0:n, 0:n] / n - 0.5
    img = np.zeros((n, n), np.float32)
    for (cx, cy, sx, sy, a) in [(-0.12, 0.0, 0.18, 0.25, 1.0),
                                (0.15, 0.1, 0.08, 0.06, 0.7),
                                (0.1, -0.18, 0.05, 0.09, 0.5)]:
        img += a * np.exp(-(((xx - cx) / sx) ** 2 + ((yy - cy) / sy) ** 2))
    img[(np.abs(xx + 0.3) < 0.06) & (np.abs(yy) < 0.2)] += 0.6
    return img


def radial_trajectory(n_spokes, n_read, n):
    """Radial spokes through the k-space centre: (kx, ky) in mode units in
    [-n/2, n/2) and the ramp density compensation."""
    ang = np.pi * np.arange(n_spokes) / n_spokes
    r = (np.arange(n_read) - n_read / 2) / n_read * n
    kx = (r[None, :] * np.cos(ang[:, None])).ravel()
    ky = (r[None, :] * np.sin(ang[:, None])).ravel()
    dcf = np.abs(np.tile(r, n_spokes)) + 0.5
    return kx.astype(np.float32), ky.astype(np.float32), dcf.astype(np.float32)


def main(device=None, small=False):
    dev = device_of(device)
    n = 64 if small else 128
    img = phantom(n)
    kx, ky, dcf = radial_trajectory(2 * n, 2 * n, n)

    # nufft2d2 takes point coordinates in radians: mode units k map to
    # points x = 2 pi k / n of the conjugate variable
    xp, yp = on((2 * np.pi / n) * kx, dev), on((2 * np.pi / n) * ky, dev)
    y = ft.nufft2d2(xp, yp, on(img.astype(np.complex64), dev))
    rec = np.abs(host(ft.nufft2d1(xp, yp, y * on(dcf, dev), (n, n))))
    rec *= img.mean() / max(rec.mean(), 1e-12)  # DC gain normalisation

    err = np.linalg.norm(rec - img) / np.linalg.norm(img)
    psnr = 20 * np.log10(img.max() / (np.sqrt(np.mean((rec - img) ** 2)) + 1e-12))
    print(f"radial spokes={2 * n}, read={2 * n}, grid {n}x{n}: "
          f"rel L2 {err:.3f}, PSNR {psnr:.1f} dB")
    assert psnr > 15.0, "gridding recon should be recognizable"


if __name__ == "__main__":
    cli(main)
