"""STFT demo (the port of ``examples/stft_demo.py``): a chirp's
spectrogram, then the perfect-reconstruction check of istft(stft(x)).

Run: python -m fft_wgpu_tpu_torch.examples.stft_demo [--device cpu]
"""

import numpy as np

from fft_wgpu_tpu_torch.examples._common import cli, device_of, host, on
from fft_wgpu_tpu_torch.ops.stft import istft, stft


def main(device=None, small=False):
    dev = device_of(device)
    sr, dur = 16000, (0.5 if small else 2.0)
    t = np.arange(int(sr * dur)) / sr
    sig = np.sin(2 * np.pi * (200 * t + 400 * t ** 2)).astype(np.float32)  # a chirp

    Z = stft(on(sig, dev), n_fft=512, hop_length=128)
    mag = np.abs(host(Z))
    peak_bins = mag.argmax(axis=0)
    print(f"spectrogram {mag.shape}; peak bin drifts {peak_bins[2]} -> {peak_bins[-3]} (chirp)")

    y = host(istft(Z, n_fft=512, hop_length=128, length=len(sig)))
    err = np.linalg.norm(y - sig) / np.linalg.norm(sig)
    print(f"istft(stft(x)) rel-L2 = {err:.2e}")
    assert err < 1e-4


if __name__ == "__main__":
    cli(main)
