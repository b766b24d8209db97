"""Time-frequency tour (the port of ``examples/tf_analysis.py``): one chirp
analysed four ways, ShortTimeFFT (linear, sliding window), Wigner-Ville
(quadratic, the sharpest ridge), the CWT (multi-scale) and Thomson's
multitaper (a stationary PSD), each ridge against the chirp's
instantaneous frequency.

Run: python -m fft_wgpu_tpu_torch.examples.tf_analysis [--device cpu]
"""

import numpy as np

import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.examples._common import cli, device_of, host, on


def main(device=None, small=False):
    dev = device_of(device)
    fs, n = 1000.0, 2048
    t = np.arange(n) / fs
    f0, f1 = 50.0, 350.0
    finst = f0 + (f1 - f0) * t / t[-1]  # a linear chirp, 50 -> 350 Hz
    phase = 2 * np.pi * np.cumsum(finst) / fs
    x = on(np.sin(phase).astype(np.float32), dev)

    # 1. the sliding-window STFT (scipy's ShortTimeFFT API)
    win = host(ft.hann_window(128, device=dev))
    st = ft.ShortTimeFFT(win, hop=32, fs=fs, scale_to="magnitude", device=dev)
    S = np.abs(host(st.stft(x)))
    tt = st.t(n)
    ridge_err = [abs(st.f[np.argmax(S[:, p])] - np.interp(tt[p], t, finst))
                 for p in range(len(tt)) if 0.15 <= tt[p] <= 1.85]
    print(f"ShortTimeFFT ridge: mean |f_est - f_inst| = {np.mean(ridge_err):.1f} Hz "
          f"(resolution {st.delta_f:.1f} Hz)")

    # 2. Wigner-Ville of the analytic signal
    fw, W = (host(v) for v in ft.wigner_ville(ft.hilbert(x), fs=fs))
    werr = [abs(fw[np.argmax(W[i])] - finst[i]) for i in range(n // 8, 7 * n // 8, 64)]
    print(f"Wigner-Ville ridge:  mean |f_est - f_inst| = {np.mean(werr):.1f} Hz "
          f"(grid {fs / (2 * n):.2f} Hz)")

    # 3. the CWT (morlet2): a log-frequency view
    w0 = 6.0
    freqs = np.geomspace(30.0, 450.0, 48)
    scales = w0 * fs / (2 * np.pi * freqs)
    C = np.abs(host(ft.cwt(x, scales, "morlet2", w=w0)))
    cerr = [abs(freqs[np.argmax(C[:, i])] - finst[i]) for i in range(n // 8, 7 * n // 8, 64)]
    print(f"CWT (morlet2) ridge: mean |f_est - f_inst| = {np.mean(cerr):.1f} Hz "
          f"(48 log-spaced scales)")

    # 4. the multitaper PSD of the whole record: the chirp spreads its
    # energy across the swept band
    f, P = ft.multitaper(x, fs=fs, NW=4.0, weights="adaptive")
    f, P = host(f), host(P).astype(np.float64)
    band = (f >= f0) & (f <= f1)
    frac = P[band].sum() / P.sum()
    print(f"multitaper: {frac:.1%} of power inside the swept band [{f0:.0f}, {f1:.0f}] Hz")

    assert np.mean(ridge_err) < 2 * st.delta_f
    assert np.mean(werr) < 5.0
    assert frac > 0.9


if __name__ == "__main__":
    cli(main)
