"""Spectral-analysis pipeline (the port of ``examples/spectral_pipeline.py``)
on the segment-spectrum kernels: welch, coherence, a spectrogram, the
stft/istft round trip, a matched filter by oaconvolve, and welch under
the "fast" dot precision.

Run: python -m fft_wgpu_tpu_torch.examples.spectral_pipeline [--device cpu]
"""

import numpy as np

import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.examples._common import cli, device_of, host, on


def main(device=None, small=False):
    dev = device_of(device)
    rng = np.random.default_rng(0)
    fs = 10_000.0
    t = np.arange(1 << (18 if small else 20)) / fs
    # two tones and noise, and a correlated channel
    xh = (np.sin(2 * np.pi * 440.0 * t) + 0.5 * np.sin(2 * np.pi * 1250.0 * t)
          + 0.3 * rng.standard_normal(t.size)).astype(np.float32)
    yh = (0.7 * xh + 0.3 * rng.standard_normal(t.size)).astype(np.float32)
    x, y = on(xh, dev), on(yh, dev)

    f, pxx = ft.welch(x, fs=fs, nperseg=4096)
    fa, pa = host(f), host(pxx)
    p440 = fa[np.argmax(np.where((fa > 300) & (fa < 600), pa, 0.0))]
    p1250 = fa[np.argmax(np.where((fa > 1000) & (fa < 1500), pa, 0.0))]
    print(f"welch peaks: {p440:.1f} Hz and {p1250:.1f} Hz (expect 440, 1250)")
    assert abs(p440 - 440.0) < 5 and abs(p1250 - 1250.0) < 5

    f, cxy = ft.coherence(x, y, fs=fs, nperseg=4096)  # one sweep: Pxy, Pxx, Pyy
    c440 = float(host(cxy)[np.argmin(np.abs(host(f) - 440.0))])
    print(f"coherence at 440 Hz: {c440:.3f} (strong: the tone is shared)")
    assert c440 > 0.9

    f, tt, S = ft.spectrogram(x, fs=fs, nperseg=1024, noverlap=512)
    print(f"spectrogram: {tuple(S.shape)} (bins x segments)")

    Z = ft.stft(x[: 1 << 16], n_fft=512, hop_length=128)
    xr = host(ft.istft(Z, n_fft=512, hop_length=128, length=1 << 16))
    err = np.linalg.norm(xr - xh[: 1 << 16]) / np.linalg.norm(xh[: 1 << 16])
    print(f"stft->istft roundtrip rel-L2: {err:.2e}")
    assert err < 1e-5

    h = np.sin(2 * np.pi * 440.0 * np.arange(129) / fs).astype(np.float32)
    det = host(ft.oaconvolve(x, on(h[::-1].copy(), dev), mode="same"))
    print(f"matched filter output power: {float((det ** 2).mean()):.3f}")

    # the "fast" mode: TF32 in the matmul stages (the kernels read no mode)
    with ft.dot_precision("fast"):
        f, pxx_fast = ft.welch(x, fs=fs, nperseg=4096)
    rel = np.linalg.norm(host(pxx_fast) - pa) / np.linalg.norm(pa)
    print(f"fast-precision welch vs accurate: rel {rel:.1e}")
    assert rel < 0.05


if __name__ == "__main__":
    cli(main)
