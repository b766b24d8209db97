"""Multirate and filtering tour (the port of ``examples/multirate_demo.py``):
design an anti-alias FIR, resample an audio-style signal by a rational
rate, filter, decimate, and route stock ``torch.fft`` calls through the
port's kernels (``torch_backend``, where the JAX example uses
``jnp_backend``).

Run: python -m fft_wgpu_tpu_torch.examples.multirate_demo [--device cpu]
"""

import numpy as np
import torch

import fft_wgpu_tpu_torch as ft
import fft_wgpu_tpu_torch.torch_backend as tb
from fft_wgpu_tpu_torch.examples._common import cli, device_of, host, on


def main(device=None, small=False):
    dev = device_of(device)
    fs = 48_000.0
    t = np.arange(int(0.05 * fs)) / fs  # 50 ms
    # two tones: one inside the resampled band, one that must be removed
    # by the anti-alias filter
    sig = (np.sin(2 * np.pi * 3_000 * t)
           + 0.5 * np.sin(2 * np.pi * 21_000 * t)).astype(np.float32)
    x = on(sig, dev)

    # 48 kHz -> 32 kHz (up 2 / down 3): 21 kHz is above the new 16 kHz
    # Nyquist and must be suppressed by the kaiser anti-alias FIR
    y = ft.resample_poly(x, 2, 3)
    print(f"resample_poly: {len(sig)} @48k -> {y.shape[-1]} @32k")

    spec = np.abs(host(ft.rfft(y)))
    f = host(ft.rfftfreq(y.shape[-1], d=3 / (2 * fs), device=dev))
    keep = spec[np.argmin(np.abs(f - 3_000))]
    alias_band = spec[f > 10_000].max()
    print(f"3 kHz tone kept: {keep:.1f}; residual above 10 kHz: "
          f"{alias_band:.2e} ({20 * np.log10(alias_band / keep):.0f} dB)")
    assert alias_band < 1e-2 * keep

    # an 80 dB-stopband kaiser lowpass through the width= handle
    h = ft.firwin(121, 8_000.0, width=2_000.0, fs=fs)
    lp = ft.upfirdn(h, x)  # plain FIR filtering (up = down = 1)
    print(f"firwin taps: {len(h)}, filtered len: {lp.shape[-1]}")

    d = ft.decimate(x, 4)  # the zero-phase FIR path
    print(f"decimate 4x: {len(sig)} -> {d.shape[-1]}")

    # route existing torch.fft call sites through the port
    with tb.accelerated():
        X = torch.fft.rfft(x)  # runs on the port's kernels
    ref = np.fft.rfft(sig)
    rel = np.linalg.norm(host(X) - ref) / np.linalg.norm(ref)
    print(f"torch_backend rfft rel vs numpy: {rel:.2e}")
    assert rel < 1e-5
    print("multirate demo ok")


if __name__ == "__main__":
    cli(main)
