#!/usr/bin/env python3
"""Drive the torch port's paths once on one CUDA card: the batched 1-D
main path (n = 128..16384), the large-N path (four-step and whole-row),
BASELINE config 4 (2-D 4096 x 4096, R2C/C2R, 3-D 256^3), the non-pow2
path (composite, Bluestein and chirp-z transforms), the fused epilogues
(spectral filter, analytic signal, FFT and overlap-add convolution, the
CWT plan, composite 2-D frames), the spectral estimators (welch,
periodogram, csd, coherence, spectrogram, multitaper), and the per-segment
spectra (stft, istft, ShortTimeFFT, the complex spectrogram modes,
resample), and the transform long tail (scipy.fft's DCT/DST and fht, the
Chebyshev, MDCT, spectral-calculus, Fourier-filter, structured-solver,
cepstrum, envelope, channelizer and Wigner-Ville calls), and the
signal-processing and non-uniform tail (multirate filtering, 2-D
convolution and Wiener filtering, fractional Fourier transforms, NUFFTs).

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit and scipy.  It builds the fifteen kernel libraries from
``fft_wgpu_tpu_torch/csrc`` (one nvcc each, all at once) and runs five
phases, one line each or more; any failure raises and the script exits
non-zero without a result line:

1. device  — the card's name and power limit (nvidia-smi's line as it
             prints it, then the versions), TF32 off, the kernel builds, and
             ptxas's registers, stack and spills of ax0_gen_fft,
             rows_t_fft and chirp_fft (m = 8192 and 16384), and of every
             instantiation of rows_fft, big_fft, ax0_fft, r2c_fft,
             fft2f_fft, spec_fft (B20, and B19's psd_pairs),
             filt_fft's filtered rows (and bank), spec_c2c_fft,
             welch_acc_fft and c2r_fft (C2R and its product form);
2. kernel  — each kernel against its plain torch version and torch.fft,
             both signs, scale None and 1/n (rel-L2 <= 1e-5 each):
             rows_fft for every n in 128..16384 at rows 1 and 1000 and at
             4096 x 4096 and 2500 x 512, through its planar entry
             (rows_fft) and its complex64 entry (rows_fft_c64, also in
             place); ax0_fft for every n at m = 7 and
             m = 1000 (a leading batch of 2), at the 2^22 pass-1 shape
             1024 x 4096 and at config 4's 4096 x 4096 and ragged
             4096 x 2049, through its planar entry and its complex64 entry
             (ax0_fft_c64, also in place at every n); rows_t_fft for every
             n at R = 1 and 200, without
             the outer twiddle, with the four-step's (outer_n = R*n) and
             with a non-pow2 one (3 * 2^12), and at the 2^22 pass-2 shape;
             big_fft for every n of its envelope at rows 1 and 3, and at
             256 x 2^16, planar (big_fft) and complex64 (big_fft_c64);
             the axis(-3) pass (ax0_fft on a free view) at [2, n, 7, 130]
             and 256^3, and its complex64 entry (ax3_fft_c64) at
             [2, n, 7, 13] for every n, 256^3 and 512^3; fft2f_fft at every
             plane of its envelope, single and batched, and 256^3, through
             its planar and complex64 entries (fft2f_fft_c64, also in
             place) against the plain version of its own passes
             (cuda_fft._fft2f_passes); r2c_fft and c2r_fft
             for every n at rows 3 and 1000, ragged and padded, and at
             4096 x 4096, r2c_fft's complex64 sink (r2c_fft_c64) and
             c2r_fft's complex64 source (c2r_fft_c64) at the same shapes,
             c2r_fft in both sources also against the plain version of its
             own passes (cuda_fft._c2r_passes);
             gen_fft and r2c_gen_fft (ragged and padded) at twenty-one
             composite n from 640 to 16383 (the two-factor splits, then
             one n for each pass type of their mixed-radix plans), rows 1
             and 1000, and at the non-pow2 path's 1024 x 4095, 1024 x 4097
             and 2048 x 1000 (R2C: 1024 x 4095 and 1024 x 1000), and at
             rows 3 against the plain version of their own passes
             (cuda_fft._mixed_radix, _mixed_radix_real); chirp_fwd,
             chirp_inv and chirp_full (the two fused) at every pow2 m of
             128..16384 with signal and output lengths that are not
             multiples of 128, rows 3 and 1000, chirp_full also against
             the plain version of its own passes (cuda_fft.
             _chirp_full_passes), and at that path's own calls (Bluestein
             4093 and 4097, the ZoomFFT) with its tables, chirp_full there
             against float64 references;
             the fused epilogues' kernels: filt at every n, rows 3 and
             1000, and at 4096 x 4096, through its planar entry and its
             complex64 entry (filt_c64, against the plain version of its
             own passes, cuda_fft._filt_passes; also on rows of n/2 + 1
             points, zero past them, and in place); bank at every n for
             banks of 1 and 7 rows, and at 128 x 16384, also against the
             plain version of its own passes (cuda_fft._bank_passes); the
             bits of the kernels kept as they were (rows_fft in both
             entries) against those recorded from them before
             (KEPT_BITS); c2r_prod at every n, ragged and
             padded, B of A's shape and broadcast, at 2048 x 8192 and 547 x
             2048, also against the plain version of its own passes
             (cuda_fft._c2r_prod_passes); ax0_gen at every composite n at
             m = 7 and 1000, and at 16 x 1080 x 1920, and the axis(-3)
             pass at [2, 1000, 7, 130];
             ax0_gen again against the plain version of its own passes
             (cuda_fft._mixed_radix_axis) at every n, m = 7 and 1000;
             the segment-spectrum kernels welch, psd (spec_fft's
             psd_pairs, also against the plain version of its passes and
             epilogue, cuda_welch._psd_passes), csd, coh, c2c (the
             planes of a complex signal; c2c_c64 its complex64 entry from a
             complex64 signal, from two planes and from one real plane),
             spec
             (spec_fft's planar sink; spec_c64 its complex64 sink, both
             against the plain version of its own passes,
             cuda_welch._spec_passes) and spec_c2c (spec_c2c_fft's planar
             source and sink; spec_c2c_c64 its complex64 sink from a
             complex64 signal, from two planes and from one real plane,
             both against the plain version of its own passes,
             cuda_welch._spec_c2c_passes) against their plain
             versions and float64 torch.fft of the frames at every pow2
             nfft, nperseg = nfft and odd nperseg < nfft, hops nperseg,
             nperseg/2 and nperseg - nperseg/8, one signal with no detrend
             and three with "constant", a ragged last tile (spec also with
             odd and even rolls, the padded output and stft's reflect
             pad; welch_acc_fft's kinds welch, coh, csd, c2c and c2c_c64
             also at odd segment counts and against the plain version of
             their own passes and epilogue, cuda_welch._acc_passes (welch:
             both its designs), and scipy.signal's welch, coherence and
             csd and the two-sided welch in float64), and at path 6's and
             path 7's shapes, each run twice for the same bits;
3. main    — seven paths (1-3, 5-8), the launch counts set to 0 just
             before each and read just after (path 8 reads them around
             each call): plan / fft / ifft / Forward at the 1-D sizes
             users call (row kernel; axis(-2) then transposed rows; whole
             row; a complex64 tensor along its last axis through the
             complex64 entries of the row and whole-row kernels, counted
             as rows_fft_c64 and big_fft_c64 beside rows_fft and big_fft,
             which count both entries), then config 4: fft2 / ifft2 at
             4096 x 4096 (the complex64 entries of the row and axis(-2)
             kernels, ax0_fft_c64 counted beside ax0_fft), rfft at 4096 x
             4096 (r2c_fft's complex64 sink), irfft of complex64 4096 x
             2049 (c2r_fft's complex64 source, c2r_fft_c64 counted beside
             c2r_fft) and the rfft2 / irfft2 round trip (irfft2 of
             complex64: ax0_fft's and c2r_fft's complex64 entries), fftn /
             ifftn at 256^3 (the fused plane's complex64
             entry, then axis(-3)'s, fft2f_fft_c64 counted beside
             fft2f_fft) and
             fftn at 512^3 (axis(-3), axis(-2) and rows through their
             complex64 entries), then the non-pow2
             path: fft / ifft / plan at the JAX package's benchmark
             sizes (4095, 4097 and 1000 composite;
             4093 prime), a direct Bluestein call at 4097 (m = 16384),
             the two chirp passes as the JAX package calls them (B11,
             then B12) at 4093, rfft at 4095 and 1000, irfft at 4095, czt
             and ZoomFFT over 1024 signals of 4096 samples; then the fused
             epilogues:
             SpectralFilter of complex64 and hilbert of real 4096 x 4096
             (filt_c64 counted beside filt), fftconvolve of two
             2048 x 4096 signals, oaconvolve of 2^20 samples with 129
             taps, the CWT plan of 8192 samples over widths 1..128, fft2 /
             ifft2 of 16 x 1080 x 1920 frames; then the spectral
             estimators: welch of 2^22 samples (nperseg 4096, hop 2048) and
             of 64 x 2^20 at scipy's defaults, its median, csd and
             coherence of two 2^22 signals, spectrogram of 2^22 (psd and
             magnitude), periodogram of 64 x 16384, multitaper of 16384
             (K = 7), csd of two independent 2^22 signals at nperseg 256
             (32767 segments: B17's rounding bias, cancelled by its swap)
             and the two-sided welch of a complex64 and of a real 2^22
             signal (B21's complex64 entry, c2c_c64 counted beside c2c),
             each against scipy.signal (float64 numpy for multitaper); then
             the per-segment spectra: stft of 2^20 samples and of 8 x 2^17
             (n_fft 512, hop 128; B20's complex64 sink, spec_c64 counted
             beside spec) against float64 numpy and its istft
             round trip, spectrogram(mode="complex") of 2^22 (nperseg
             4096, noverlap 2048), the two-sided psd and complex
             spectrograms and csd of complex 2^22 signals (B22's complex64
             source and sink, spec_c2c_c64 counted beside spec_c2c),
             ShortTimeFFT(hann(1024), hop 256, fs 48000) at mfft 1024 and
             2048 and its istft, resample of 256 x 8192 to 16384 and
             6144, against scipy.signal; each call's launches are
             checked; small inputs against float64 numpy after each
             window, and numpy input, which must run on the card; then
             the transform long tail (path 8, :func:`long_tail`): dct,
             idct, dst and idst of types 1-4 on real 4096 x 4096 (types 1
             at n = 2049 and DST-I at 2047), dctn and idctn type 2 of
             4096 x 4096, mdct and imdct of 2^22 samples at N = 1024,
             cheb_coeffs and cheb_derivative of 1024 x 4097, fht of
             1024 x 4096, spectral_derivative of 4096 x 4096 along each
             axis, spectral_laplacian of 256^3, fourier_gaussian and
             fourier_shift between fft2 and ifft2 of 4096 x 4096,
             circulant_solve of 1024 x 4096, toeplitz_solve at n = 4096
             with 64 right-hand sides, bccb_solve of a 4096 x 4096 blur,
             grf_sample of 2^20 + 1 lags (its covariance; its synthesis
             of one noise draw against numpy), real_cepstrum of
             1024 x 4096, minimum_phase of a 255-tap filter, envelope of
             64 x 2^20, channelize of 2^22 samples into 1024 channels and
             wigner_ville of 4096 samples, each against float64 scipy or
             numpy, with three exact launch counts (dct type 2: rows_fft
             1; dctn: ax0_fft 1 + rows_fft 1; spectral_derivative along
             the last axis: r2c_fft and c2r_fft 1 each, through their
             complex64 ends), each call's launches listed, and its CUDA
             events, device ms and idle share from the profiler; the
             signal-processing and non-uniform tail (path 9,
             :func:`signal_tail`, run after phase 5): resample_poly of
             stereo 2^18 at 147/160 (nfft 2^26), decimate by 8 and
             savgol_filter (window 101, order 3) of 64 x 2^20, a complex
             upfirdn of 16 x 2^16 (up 4, down 3), convolve2d of a 1080p
             frame with a 31 x 31 Gaussian at symmetric edges,
             correlate2d of a complex 512^2 field with a 64^2 template,
             wiener of 1024^2, frft of 256 x 4096 chirps at a = 0.5 and
             0.9, frft2 of a 1024^2 beam, dfrft of 64 x 1024, the NUFFTs
             of types 1 and 2 at 2^16 modes (2^20 points), 256^2 (radial
             MRI, 2^18 points) and 128^3 (2^20 points), and of type 3 in
             1-D (2^16 points) and 2-D (2^14), each against float64
             scipy, the kernel quadrature or the direct NUDFT, with three
             exact launch counts (nufft2d1: one 2-D transform of its 512^2
             fine grid; frft at a = 0.5: forward and inverse of
             256 x 2^15 and 256 x 2^16; resample_poly: the R2C of the
             signal rows and of the taps row and the C2R at 2^26, each
             counted from bare calls in the same run), each call's
             launches, other device work by name, peak bytes, events,
             device ms and idle share;
4. grad    — gradients against the plain versions' (CPU for the N-D,
             real and non-pow2 ones): fft (row kernel; the four-step at
             2 x 2^20; the whole row at 4 x 2^16; the row and whole-row
             kernels through their planar entries too; composite 4095 and
             prime 4093 at 64 rows, the latter chirp_full forward and back),
             rfft at 1005 and 4096 (the complex64 sink), irfft of complex64
             at 4096 (the complex64 source), rfft2, batched fft2
             and fft2 of one 256 x 1024 complex64 plane,
             SpectralFilter of complex64 (the complex64 entries of the row
             and filtered kernels), fftconvolve (both inputs), the CWT plan and
             fft2 at 1080 x 1920; welch, csd (both inputs), spectrogram
             and the two-sided welch of a complex signal at 2^16 samples;
             stft, ShortTimeFFT.stft with a phase shift and the complex
             two-sided spectrogram at 2^16; dct type 2 and
             spectral_derivative at 64 x 4096; nufft1d1 of 4096 points
             to 4096 modes in its values and convolve2d of 500 x 1000 by
             13 x 25 in both inputs;
5. times   — CUDA-event medians of each kernel (rows_fft, big_fft, filt
             and spec_c2c in both layouts), its plain version, torch.fft and
             plan.forward at the main shapes, beside a plane copy of the
             same bytes; a torch.profiler breakdown of plan(4096).forward
             and of the whole-row fft, which must run their kernel alone
             (no split, no merge), and of fft2, rfft, and irfft and
             irfft2 of complex64 at 4096 x 4096,
             fftn at 256^3, stft of 2^20, SpectralFilter of complex64 and
             hilbert at 4096 x 4096 and the complex spectrogram of complex64
             2^22, which must run their kernels alone, once each, and of
             welch, coherence, csd and the two-sided welch of complex64 and
             real input at 2^22, each one welch_acc_fft launch beside its
             sums and normalisation; fft2 at 4096 x 4096 by three routes
             (transposed rows twice, row then axis(-2) planar and
             complex64) and the fused plane at 256^3 in both layouts
             against row then axis(-2) in both; fftn at 512^3; the fused
             epilogues', the estimators' and the per-segment spectra's
             kernels at their path's shapes beside torch.fft's composition
             (ax0_gen also at 16 x 4095 x 512)
             of the same function; a torch.profiler breakdown of the
             non-pow2 path's, the fused epilogues', the estimators' and the
             per-segment spectra's calls.

torch.fft is an oracle and a baseline here, never the implementation.  The
last two lines are a JSON object describing the kernels (each with its
main-path launches, times, the torch.fft time and its bound: the larger of
its bytes at 3.35 TB/s and 5*n*log2(n) flops per complex row (half that
per real row) at 67 TFLOP/s, the H100 SXM's data-sheet rates), then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

TOL = 1e-5  # relative L2, the JAX package's oracle bar
SEED = 0
LIBS = ("rows_fft", "ax0_fft", "rows_t_fft", "big_fft", "fft2f_fft", "r2c_fft",
        "c2r_fft", "gen_fft", "r2c_gen_fft", "chirp_fft", "filt_fft", "ax0_gen_fft",
        "spec_fft", "spec_c2c_fft", "welch_acc_fft")
# Kernels as the launch counters name them: the axis(-3) pass is the axis(-2)
# kernels on a free view, with its own entry point and counter; chirp_fft
# holds three kernels (chirp_fwd, chirp_inv and the two fused, chirp_full),
# each with its own, filt_fft two entries of one kernel (filt, bank),
# c2r_fft a second kernel (c2r_prod), welch_acc_fft four (welch: B16, coh: B18, csd: B17, c2c:
# B21), spec_fft two (spec: B20, psd: B19), spec_c2c_fft one (spec_c2c:
# B22); rows_fft, ax0_fft (on axis
# -2 and on the axis(-3) view), fft2f_fft, r2c_fft, c2r_fft, big_fft, filt,
# c2c, spec_fft and spec_c2c_fft two layouts each (rows_fft_c64,
# ax0_fft_c64, ax3_fft_c64, fft2f_fft_c64, r2c_fft_c64, c2r_fft_c64,
# big_fft_c64, filt_c64, c2c_c64, spec_c64 and spec_c2c_c64: their
# complex64 entries, counted apart too).
KERNELS = ("rows_fft", "rows_fft_c64", "ax0_fft", "ax0_fft_c64", "ax3_fft", "ax3_fft_c64",
           "rows_t_fft", "fft2f_fft", "fft2f_fft_c64", "r2c_fft", "r2c_fft_c64", "c2r_fft",
           "c2r_fft_c64", "big_fft", "big_fft_c64", "gen_fft", "r2c_gen_fft",
           "chirp_fwd", "chirp_inv", "chirp_full", "filt", "filt_c64", "bank", "c2r_prod",
           "ax0_gen", "welch", "psd", "csd", "coh", "c2c", "c2c_c64", "spec", "spec_c64",
           "spec_c2c", "spec_c2c_c64")
# Composite lengths of phase 2's sweep: factors (20, 32), (25, 40), (15, 67),
# (23, 89), (63, 65), (17, 241), (81, 81), (100, 100), (127, 129); then one
# for each pass type of the composite kernels' mixed-radix plan: powers of 2
# with 3 and 5 (1920, 3072, 12288), 13^3, 7^4, 11^4, 5^6, the generic
# primes 251 and 127 (1004, 16129), 7 and 13 at more butterflies a thread
# (14406, 16224), R2C's half length 17 * 19 with its generic pass last (646),
# and the 1080p frames' height (1080 = 9 * 3 * 5 * 8).
GEN_NS = (640, 1000, 1005, 2047, 4095, 4097, 6561, 10000, 16383, 1920, 3072, 12288,
          2197, 2401, 14641, 15625, 1004, 16129, 14406, 16224, 646, 1080)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
F32_FLOPS_PER_S = 67e12    # H100 SXM float32 on the CUDA cores (data sheet)


# sha256 (first 16 hex digits) of the outputs of kernels this work keeps as
# they were, on kept_bits's inputs: B1 (rows_fft, both entries; its row types
# moved into mixed_fft.cuh).  Recorded from the kernels before that work (the
# libraries of commit 9602cd4, which commits e09b20d, a87236e and d70af66
# kept; NVIDIA H100 80GB HBM3, by scripts/time_composite_rows.py --set
# bits); the other kernels' digests were taken out when their kernel changed
# (B16-B19 and B21 when they left welch_fft.cu, B10 when the bank became
# the filtered rows' kernel with its strides swapped and B7 when it became
# c2r_fft.cu's staged design beside B8).
KEPT_BITS = {
    "rows_fft 128": "f4898d7e20440177", "rows_fft_c64 128": "f8f226c7db5eb860",
    "rows_fft 256": "82f279a213465b27", "rows_fft_c64 256": "d23f7c08ec2be4d8",
    "rows_fft 512": "8502651580d6b439", "rows_fft_c64 512": "5b41b67485e3818c",
    "rows_fft 1024": "d044325a2756e4fc", "rows_fft_c64 1024": "9e838d2b8ef30c44",
    "rows_fft 2048": "28f19421d9941639", "rows_fft_c64 2048": "6a45edcc385cf1ac",
    "rows_fft 4096": "49f5dcbcebd219b6", "rows_fft_c64 4096": "2802eb379c85eca6",
    "rows_fft 8192": "a2279294e2854e4d", "rows_fft_c64 8192": "bd4cd6dd5b46cd92",
    "rows_fft 16384": "28cc39cf96dc770d", "rows_fft_c64 16384": "528b0ca7f625ab05"}


def kept_bits(cuda_fft, dev) -> dict:
    """sha256 (16 hex digits) of each kept kernel's outputs on inputs made
    with numpy from SEED: rows_fft through both entries at every pow2 n,
    both signs.  ``cuda_fft`` may be another checkout's module (the
    parent's, to record KEPT_BITS)."""
    import hashlib

    import torch

    rng = np.random.default_rng(SEED)

    def real(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    def digest(outs):
        h = hashlib.sha256()
        for o in outs:
            h.update(o.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    out = {}
    for e in range(7, 15):
        n = 1 << e
        # the two 7-row planes of the bank's digest, drawn still so that the
        # rows' inputs are the ones KEPT_BITS was recorded on
        re, im, _, _ = real(37, n), real(37, n), real(7, n), real(7, n)
        x = torch.complex(re, im)
        out[f"rows_fft {n}"] = digest([*cuda_fft._launch(re, im, -1, None),
                                       *cuda_fft._launch(re, im, 1, 1.0 / n)])
        out[f"rows_fft_c64 {n}"] = digest([cuda_fft._launch_c64(x, -1, None),
                                           cuda_fft._launch_c64(x, 1, 1.0 / n)])
    torch.cuda.synchronize()
    return out


def rel_l2(got, want) -> float:
    import torch

    got = got.to(torch.complex128)
    want = want.to(torch.complex128)
    denom = torch.linalg.vector_norm(want)
    if denom == 0:
        return float(torch.linalg.vector_norm(got))
    return float(torch.linalg.vector_norm(got - want) / denom)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def check_close(got, want, what: str) -> float:
    check(tuple(got.shape) == tuple(want.shape),
          f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(got.isfinite().all()), f"{what}: non-finite output")
    err = rel_l2(got, want)
    check(err <= TOL, f"{what}: rel-L2 {err:.3e} > {TOL:.0e}")
    return err


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time in ms the card could take for work that must move
    ``nbytes`` and do ``flops``, and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fft_flops(n: int, rows: int) -> float:
    """The nominal 5*n*log2(n) flops of an n-point complex FFT, times rows."""
    return 5.0 * n * math.log2(n) * rows


def rfft_flops(n: int, rows: int) -> float:
    """The nominal flops of an n-point real FFT (an n/2-point complex one
    and the recombination): half a complex one's, times rows."""
    return fft_flops(n, rows) / 2


def multitaper_ref(x: np.ndarray, NW: float, K: int) -> np.ndarray:
    """Thomson's adaptive multitaper PSD of a real float64 signal in float64
    numpy (scipy's dpss tapers, one-sided, fs = 1, constant detrend, 10
    fixed-point steps of the weights from the mean of the first two
    eigenspectra): the estimator's definition, written out on the host."""
    from scipy.signal.windows import dpss

    n = x.shape[-1]
    tapers, lam = dpss(n, NW, K, return_ratios=True)
    v = x - x.mean()
    Sk = np.abs(np.fft.rfft(v * tapers, axis=-1)) ** 2
    s2 = np.mean(v * v)
    lamc = lam[:, None]
    S = Sk[:2].mean(0)
    for _ in range(10):
        b = S / (lamc * S + (1 - lamc) * s2 + 1e-30)
        w = b * b * lamc
        S = (w * Sk).sum(0) / (w.sum(0) + 1e-30)
    mult = np.full(n // 2 + 1, 2.0)
    mult[0] = 1.0
    if n % 2 == 0:
        mult[-1] = 1.0
    return S * mult


def ptxas_summary(log: str) -> list:
    """One "kernel<template arguments>: registers, stack, spill stores" entry
    per kernel of ax0_gen_fft's, rows_t_fft's, chirp_fft's, rows_fft's,
    big_fft's, ax0_fft's, r2c_fft's, fft2f_fft's, spec_fft's (B20 and B19),
    filt_fft's, spec_c2c_fft's, welch_acc_fft's and c2r_fft's nvcc
    -Xptxas -v logs (chirp_fft's at m =
    2^13 and 2^14)."""
    out, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(ax0_gen_fft_kernel|rows_t_fft_kernel|"
                      r"chirp_fwd_kernel|chirp_inv_kernel|chirp_full_kernel|rows_fft_kernel|"
                      r"big_fft_kernel|ax0_fft_kernel|r2c_fft_kernel|fft2f_fft_kernel|"
                      r"spec_fft_kernel|psd_pairs_kernel|filt_fft_kernel|spec_c2c_kernel|"
                      r"welch_acc_kernel|c2r_fft_kernel|c2r_prod_kernel)"
                      r"I(\w*?)EE", line)
        if m and m[1].startswith("chirp") and not m[2].endswith(("13", "14")):
            m = None
        if m:
            targs = re.sub(r"L[ib](n?)(\d+)E?", lambda t: ("-" if t[1] else "") + t[2] + ",",
                           m[2]).rstrip(",")
            kernel = f"{m[1]}<{targs}>"
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and kernel:
            stack, spill = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append(f"{kernel}: {m[1]} registers, {stack} B stack, {spill} B spill stores")
            kernel = None
    return out


def kernel_part(event_name: str, names) -> str:
    """Which of ``names`` a profiled device event is (``<name>_kernel`` as a
    whole word of its demangled name, or the start of a copy's name, as
    "Memcpy DtoD"), else "other"."""
    return next((k for k in names if re.search(rf"\b{k}_kernel\b", event_name)
                 or event_name.startswith(k)), "other")


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of fn() in ms, one CUDA-event pair per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def time_in_turns(fns: dict, reps: int = 30) -> dict:
    """Two rounds in turns, so drift on the card hits every version alike;
    the median of each version's two medians."""
    samples = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            samples[k].append(time_ms(fns[k], reps))
    return {k: statistics.median(v) for k, v in samples.items()}


def counts() -> dict:
    """The launch counters of every port kernel, by kernel name."""
    from fft_wgpu_tpu_torch.ops import bigfft, cuda_fft, cuda_welch

    return {"rows_fft": cuda_fft.launches, "ax0_fft": cuda_fft.ax0_launches,
            "ax3_fft": cuda_fft.ax3_launches, "rows_t_fft": cuda_fft.rows_t_launches,
            "fft2f_fft": cuda_fft.fft2f_launches, "r2c_fft": cuda_fft.r2c_launches,
            "c2r_fft": cuda_fft.c2r_launches, "big_fft": bigfft.launches,
            "gen_fft": cuda_fft.gen_launches, "r2c_gen_fft": cuda_fft.r2c_gen_launches,
            "c2r_fft_c64": cuda_fft.c2r_c64_launches,
            "chirp_fwd": cuda_fft.chirp_fwd_launches,
            "chirp_inv": cuda_fft.chirp_inv_launches,
            "chirp_full": cuda_fft.chirp_full_launches, "filt": cuda_fft.filt_launches,
            "bank": cuda_fft.bank_launches, "c2r_prod": cuda_fft.c2r_prod_launches,
            "ax0_gen": cuda_fft.ax0_gen_launches, "welch": cuda_welch.welch_launches,
            "psd": cuda_welch.psd_launches, "csd": cuda_welch.csd_launches,
            "coh": cuda_welch.coh_launches, "c2c": cuda_welch.c2c_launches,
            "spec": cuda_welch.spec_launches, "spec_c2c": cuda_welch.spec_c2c_launches,
            "rows_fft_c64": cuda_fft.c64_launches, "big_fft_c64": bigfft.c64_launches,
            "ax0_fft_c64": cuda_fft.ax0_c64_launches,
            "ax3_fft_c64": cuda_fft.ax3_c64_launches,
            "fft2f_fft_c64": cuda_fft.fft2f_c64_launches,
            "r2c_fft_c64": cuda_fft.r2c_c64_launches, "spec_c64": cuda_welch.spec_c64_launches,
            "filt_c64": cuda_fft.filt_c64_launches,
            "c2c_c64": cuda_welch.c2c_c64_launches,
            "spec_c2c_c64": cuda_welch.spec_c2c_c64_launches}


def reset_counts() -> None:
    from fft_wgpu_tpu_torch.ops import bigfft, cuda_fft, cuda_welch

    cuda_fft.c64_launches = bigfft.c64_launches = 0
    cuda_fft.ax0_c64_launches = cuda_fft.ax3_c64_launches = cuda_fft.r2c_c64_launches = 0
    cuda_fft.c2r_c64_launches = 0
    cuda_fft.fft2f_c64_launches = cuda_welch.spec_c64_launches = 0
    cuda_fft.filt_c64_launches = cuda_welch.spec_c2c_c64_launches = 0
    cuda_welch.c2c_c64_launches = 0
    cuda_fft.launches = cuda_fft.ax0_launches = cuda_fft.ax3_launches = 0
    cuda_fft.rows_t_launches = cuda_fft.fft2f_launches = 0
    cuda_fft.r2c_launches = cuda_fft.c2r_launches = bigfft.launches = 0
    cuda_fft.gen_launches = cuda_fft.r2c_gen_launches = 0
    cuda_fft.chirp_fwd_launches = cuda_fft.chirp_inv_launches = 0
    cuda_fft.chirp_full_launches = 0
    cuda_fft.filt_launches = cuda_fft.bank_launches = 0
    cuda_fft.c2r_prod_launches = cuda_fft.ax0_gen_launches = 0
    cuda_welch.welch_launches = cuda_welch.psd_launches = 0
    cuda_welch.csd_launches = cuda_welch.coh_launches = cuda_welch.c2c_launches = 0
    cuda_welch.spec_launches = cuda_welch.spec_c2c_launches = 0


def through(what, fn, **want):
    """Run fn(); the launch counts must rise by exactly ``want``
    (kernel name -> launches), and no other kernel may launch."""
    import torch

    before = counts()
    out = fn()
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in counts().items()}
    expect = {k: want.get(k, 0) for k in delta}
    check(delta == expect, f"{what}: launches {delta}, expected {expect}")
    return out


def breakdown(fn, names, reps=20, counted=None, scheduled=True, others=None):
    """Device ms per call of each kernel in ``names`` and of the rest
    (the facade's split and merge, pads), and the device launches per
    call of each part, from a torch.profiler window of ``reps`` calls
    after one warm-up step of the profiler (a call traced and dropped:
    a window that starts the trace has been seen to miss the first
    launch; with ``scheduled`` false, a plain window with no warm-up
    step); idle is 1 - device
    busy / the CUDA-event median of a call.  ``counted``, where given,
    gets the wrappers' launch counts over the window's calls, and
    ``others`` the device ms per call of each device event of the rest,
    by its name."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    event_ms = time_ms(fn, reps)
    for _ in range(3):  # a window now and then comes back with no device events
        plan = schedule(wait=0, warmup=1, active=1, repeat=1) if scheduled else None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=plan) as prof:
            if plan is not None:
                fn()
                torch.cuda.synchronize()
                prof.step()
            before = counts()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            after = counts()
            if plan is not None:
                prof.step()
        if counted is not None:
            counted.clear()
            counted.update({k: v - before[k] for k, v in after.items() if v != before[k]})
        parts = dict.fromkeys(names + ("other",), 0.0)
        n_launch = dict.fromkeys(names + ("other",), 0)
        if others is not None:
            others.clear()
        for e in prof.events():
            # the schedule's step marker has a device row of its own
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.name.startswith("ProfilerStep")):
                continue
            part = kernel_part(e.name, names)
            parts[part] += e.time_range.elapsed_us() / 1e3 / reps
            n_launch[part] += 1
            if part == "other" and others is not None:
                others[e.name] = others.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
        busy = sum(parts.values())
        if busy > 0:
            break
    check(busy > 0, "the profiler saw no device time in three windows")
    return {"events": event_ms, **parts, "idle": 1.0 - busy / event_ms,
            **{f"{k} launches": v / reps for k, v in n_launch.items()}}


# The kernels a call of the transform long tail (path 8) may launch, as the
# profiler names them (``<name>_kernel``); the rest of its device work (the
# gathers, products, pads and copies around them) is "other".
LONG_TAIL_KERNELS = ("rows_fft", "ax0_fft", "rows_t_fft", "fft2f_fft", "r2c_fft", "c2r_fft",
                     "big_fft", "gen_fft", "r2c_gen_fft", "ax0_gen_fft", "chirp_full")
FHT_TOL = 2e-4  # tests/test_fftlog.py's bar against scipy.fft.fht
TOEPLITZ_TOL = 1e-4  # tests/test_structured.py's bar against solve_toeplitz
MINIMUM_PHASE_TOL = 5e-4  # tests/test_cepstrum.py's bar against scipy (homomorphic)


def long_tail(ft, dev, gen, smi) -> dict:
    """Path 8: the scipy.fft long tail and the transform-domain solvers at
    their users' sizes, each call once with the launch counts read around
    it and its output held against a float64 oracle on the host (scipy or
    numpy), then timed: CUDA events over 10 calls, and the device ms of its
    kernels and of the rest, and the device's idle share, from a
    torch.profiler window of 10 calls.  Three launch counts are exact: dct
    type 2 of real 4096 x 4096 is one row-kernel launch and nothing else,
    dctn type 2 of 4096 x 4096 one axis(-2) and one row launch, and
    spectral_derivative of 4096 x 4096 along the last axis one R2C launch
    into its complex64 sink and one C2R launch from its complex64 source;
    every other call must launch some port kernel, and its launches are
    listed.  Returns each call's record."""
    import scipy.fft as sfft
    import scipy.linalg as sla
    import scipy.ndimage as ndi
    import scipy.signal as ss
    import torch
    from numpy.lib.stride_tricks import sliding_window_view

    from fft_wgpu_tpu_torch.ops import structured

    t0 = time.perf_counter()
    workers = os.cpu_count() or 1
    calls = {}

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def crandn(*shape):
        return torch.complex(randn(*shape), randn(*shape))

    def host(t):
        """A tensor's float64 (complex128) copy on the host."""
        t = t.detach().cpu()
        return t.numpy().astype(np.complex128 if t.is_complex() else np.float64)

    def hold(what, got, want, tol=TOL):
        got = got.detach().cpu() if isinstance(got, torch.Tensor) else torch.from_numpy(got)
        want = torch.from_numpy(np.ascontiguousarray(want))
        check(tuple(got.shape) == tuple(want.shape),
              f"path 8 {what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        check(bool(got.isfinite().all()), f"path 8 {what}: non-finite output")
        err = rel_l2(got, want)
        check(err <= tol, f"path 8 {what}: rel-L2 {err:.3e} > {tol:.0e} against float64")
        return err

    def run(name, fn, want, tol=TOL, exact=None, measure="rel-L2"):
        """fn() once, its launches read around it (exactly ``exact`` where
        given, some port kernel in any case) and its output held against
        ``want``: a float64 array, or a function of the output returning
        (part of the output, its float64 oracle), or one returning the
        error (``measure``) of a check it made itself."""
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        check(bool(delta), f"path 8 {name}: launched no port kernel")
        if exact is not None:
            check(delta == exact, f"path 8 {name}: launches {delta}, expected {exact}")
        if callable(want):
            judged = want(out)
            err = judged if isinstance(judged, float) else hold(name, *judged, tol)
        else:
            err = hold(name, out, want, tol)
        calls[name] = {"fn": fn, "launches": delta, "err": err, "measure": measure}
        return out

    # scipy.fft's DCT/DST, types 1-4, along the last axis of real 4096 x 4096
    # (types 1 at n = 2049 and DST-I at 2047: extensions of 4096 points)
    x = randn(4096, 4096)
    x64 = host(x)
    x2049, x2047 = randn(4096, 2049), randn(4096, 2047)
    for t in (1, 2, 3, 4):
        for name in ("dct", "idct", "dst", "idst"):
            v = x if t != 1 else x2049 if name in ("dct", "idct") else x2047
            run(f"{name} type {t} {tuple(v.shape)}",
                lambda fn=getattr(ft, name), v=v, t=t: fn(v, type=t),
                getattr(sfft, name)(host(v), type=t, workers=workers),
                exact={"rows_fft": 1} if (name, t) == ("dct", 2) else None)
    # the 2-D DCT-II of an image and its inverse (a Neumann Poisson solve's pair)
    run("dctn type 2 4096x4096", lambda: ft.dctn(x, type=2),
        sfft.dctn(x64, type=2, workers=workers), exact={"ax0_fft": 1, "rows_fft": 1})
    run("idctn type 2 4096x4096", lambda: ft.idctn(x, type=2),
        sfft.idctn(x64, type=2, workers=workers))

    # the MDCT of 2^22 samples at N = 1024 (an AAC long block), sine window,
    # against the direct cosine sum; the IMDCT of its coefficients against
    # the direct synthesis, windowed, doubled and overlap-added
    N = 1024
    s = randn(1 << 22)
    s64 = host(s)
    tt, kk = np.arange(2 * N), np.arange(N)
    M = np.cos(np.pi / N * (tt[None, :] + 0.5 + N / 2) * (kk[:, None] + 0.5))
    win = np.sin(np.pi * (tt + 0.5) / (2 * N))
    C = run("mdct 2^22 N 1024", lambda: ft.mdct(s, N),
            (sliding_window_view(s64, 2 * N)[::N] * win) @ M.T)

    def imdct_ref(c):
        fr = (host(c) @ M) * (2.0 / N) * win
        F = fr.shape[0]
        y = np.zeros((F + 1) * N)
        y[:F * N] += fr[:, :N].ravel()
        y[N:] += fr[:, N:].ravel()
        return y

    y = run("imdct 2^22 N 1024", lambda: ft.imdct(C), imdct_ref(C))
    hold("imdct(mdct) 2^22 interior (TDAC)", y[N:-N], s64[N:-N])
    del y, s64, M

    # Chebyshev coefficients and derivatives of 1024 fields of 4097 random
    # values at the points (DCT-I, the recurrence, DCT-I synthesis)
    U = randn(1024, 4097)
    A64 = sfft.dct(host(U), type=1, workers=workers) / 4096
    A64[:, 0] *= 0.5
    A64[:, -1] *= 0.5
    run("cheb_coeffs 1024x4097", lambda: ft.cheb_coeffs(U), A64)
    b = np.zeros((4098, 1024))
    At = A64.T.copy()
    for k in range(4095, -1, -1):  # b_k = b_{k+2} + 2 (k+1) a_{k+1}
        b[k] = b[k + 2] + 2 * (k + 1) * At[k + 1]
    b = b[:4097].T.copy()  # b_0 halved, then doubled again for the synthesis
    b[:, -1] *= 2
    run("cheb_derivative 1024x4097", lambda: ft.cheb_derivative(U),
        sfft.dct(b, type=1, workers=workers) * 0.5)
    del A64, b, At

    # the fast Hankel transform of 1024 log-spaced signals of 4096 points
    n, dln, mu = 4096, 0.005, 0.5
    r = np.exp((np.arange(n) - (n - 1) / 2) * dln)
    a = torch.from_numpy(((r**2 * np.exp(-(r**2) / 2)) * (1 + 0.1 * host(randn(1024, n))))
                         .astype(np.float32)).to(dev)
    offset = float(sfft.fhtoffset(dln, mu))
    run("fht 1024x4096", lambda: ft.fht(a, dln, mu, offset=offset),
        sfft.fht(host(a), dln, mu, offset=offset), tol=FHT_TOL)

    # spectral derivatives of a 4096 x 4096 periodic field along each axis,
    # and the Laplacian of a 256^3 one
    k = np.arange(2049)
    for axis, shape in ((-1, (1, -1)), (0, (-1, 1))):
        run(f"spectral_derivative 4096x4096 axis {axis}",
            lambda axis=axis: ft.spectral_derivative(x, axis=axis),
            sfft.irfft(sfft.rfft(x64, axis=axis, workers=workers) * (1j * k).reshape(shape),
                       n=4096, axis=axis, workers=workers),
            exact={"r2c_fft": 1, "r2c_fft_c64": 1, "c2r_fft": 1, "c2r_fft_c64": 1}
            if axis == -1 else None)
    g = randn(256, 256, 256)
    kf = np.fft.fftfreq(256) * 256
    ksq = kf[:, None, None] ** 2 + kf[None, :, None] ** 2 + np.arange(129)[None, None, :] ** 2
    run("spectral_laplacian 256^3", lambda: ft.spectral_laplacian(g),
        sfft.irfftn(sfft.rfftn(host(g), workers=workers) * -ksq, s=(256,) * 3,
                    workers=workers))
    del ksq

    # scipy.ndimage's Fourier filters between fft2 and ifft2 of an image
    X64 = sfft.fft2(x64, workers=workers)
    for name, p in (("fourier_gaussian", 2.0), ("fourier_shift", (1.5, -2.25))):
        run(f"{name} 4096x4096 (fft2, filter, ifft2)",
            lambda name=name, p=p: ft.ifft2(getattr(ft, name)(ft.fft2(x), p)),
            sfft.ifft2(getattr(ndi, name)(X64, p), workers=workers))
    del X64

    # circulant and Toeplitz solves, a BCCB deblur and a Gaussian random field
    c = torch.from_numpy((0.5 ** np.arange(4096)).astype(np.float32)).to(dev) * (
        1 + 0.1 * randn(4096))
    B = randn(1024, 4096)
    run("circulant_solve 1024x4096", lambda: ft.circulant_solve(c, B),
        sfft.ifft(sfft.fft(host(B), workers=workers) / np.fft.fft(host(c))).real)
    ct = torch.exp(-torch.arange(4096, device=dev, dtype=torch.float32) / 7.0)
    bt = randn(64, 4096)
    # scipy's Levinson solve of all 64 right-hand sides
    run("toeplitz_solve n 4096 x 64", lambda: ft.toeplitz_solve(ct, bt),
        sla.solve_toeplitz(host(ct), host(bt).T).T, tol=TOEPLITZ_TOL)
    m = np.arange(4096)
    d2 = np.minimum(m, 4096 - m)[:, None] ** 2 + np.minimum(m, 4096 - m)[None, :] ** 2
    kern = np.exp(-d2 / (2 * 1.5**2))
    kb = torch.from_numpy((kern / kern.sum()).astype(np.float32)).to(dev)
    yb = ft.bccb_matvec(kb, x) + 1e-3 * randn(4096, 4096)  # a blurred, noisy image
    K, Y = sfft.fft2(host(kb), workers=workers), sfft.fft2(host(yb), workers=workers)
    run("bccb_solve 4096x4096 reg 1e-3", lambda: ft.bccb_solve(kb, yb, reg=1e-3),
        sfft.ifft2(np.conj(K) * Y / (np.abs(K) ** 2 + 1e-3), workers=workers).real)
    del K, Y, kern, d2
    nl = (1 << 20) + 1
    acf = np.exp(-np.arange(nl) / 50.0)
    grf_gen = torch.Generator(device=dev).manual_seed(SEED)

    def covariance(out):
        """the empirical covariance of the two fields at lags 0..7 within
        0.05 of the acf (7 standard errors at 2^21 samples of correlation
        length 50)"""
        f = host(out)
        check(f.shape == (2, nl), f"path 8 grf_sample: shape {f.shape}")
        emp = np.array([np.mean(f[:, :nl - k] * f[:, k:]) for k in range(8)])
        err = float(np.abs(emp - acf[:8]).max())
        check(err < 0.05, f"path 8 grf_sample: covariance {emp} against {acf[:8]}")
        return err

    run("grf_sample 2^20+1 lags x 2", lambda: ft.grf_sample(acf, grf_gen, 2), covariance,
        measure="max |covariance - acf| over lags 0-7")
    sqrt_lam, _ = structured._grf_embedding(acf)
    er, ei = randn(1, 1 << 21), randn(1, 1 << 21)
    sl = torch.from_numpy(sqrt_lam.astype(np.float32)).to(dev)
    F = np.fft.fft((host(er) + 1j * host(ei)) * sl.double().cpu().numpy())
    hold("grf_sample's synthesis of one noise draw (_grf_from_noise)",
         structured._grf_from_noise(sl, er, ei, 2, nl),
         np.concatenate([F.real[:, :nl], F.imag[:, :nl]]))
    del er, ei, sl, F

    # cepstra: the real cepstrum of 1024 frames of 4096, and the minimum-phase
    # version of a 255-tap filter at scipy's default n_fft (2^16)
    xr = randn(1024, 4096)
    run("real_cepstrum 1024x4096", lambda: ft.real_cepstrum(xr),
        sfft.irfft(np.log(np.abs(sfft.rfft(host(xr), workers=workers))), n=4096,
                   workers=workers))
    h = ss.firwin(255, 0.2).astype(np.float32)
    h32 = torch.from_numpy(h).to(dev)
    run("minimum_phase 255 taps n_fft 2^16", lambda: ft.minimum_phase(h32),
        ss.minimum_phase(h.astype(np.float64)), tol=MINIMUM_PHASE_TOL)

    # the envelope of 64 channels of 2^20 samples (scipy on every eighth), the
    # WOLA channelizer of 2^22 complex samples into 1024 channels, and the
    # Wigner-Ville distribution of 4096 complex samples
    e = randn(64, 1 << 20)
    run("envelope 64x2^20", lambda: ft.envelope(e),
        lambda out: (out[:, ::8], ss.envelope(host(e[::8]))))
    z = crandn(1 << 22)
    hb = host(ft.prototype_lowpass(1024, device=dev)).reshape(8, 1024)
    blocks = host(z).reshape(4096, 1024)
    acc = sum(blocks[j:j + 4089] * hb[j] for j in range(8))
    run("channelize 2^22 1024 channels", lambda: ft.channelize(z, 1024),
        np.fft.fft(acc, axis=-1))
    del blocks, acc
    w = crandn(4096)
    w64 = host(w)
    t_, tau = np.arange(4096)[:, None], np.arange(4096)[None, :]
    lag = w64[np.clip(t_ + tau, 0, 4095)] * np.conj(w64[np.clip(t_ - tau, 0, 4095)])
    lag *= tau <= np.minimum(t_, 4095 - t_)
    run("wigner_ville 4096", lambda: ft.wigner_ville(w)[1],
        2 * np.fft.fft(lag, axis=-1).real - lag[:, :1].real)
    del lag, x64
    checked = time.perf_counter() - t0

    # the inputs stay alive in the calls' closures until they are timed
    for name, rec in calls.items():
        fn = rec.pop("fn")
        # a window can miss launches (§7 of PERF.md): take it again, at most
        # three times, until it holds the call's kernel launches
        per_call = sum(v for k, v in rec["launches"].items() if not k.endswith("_c64"))
        for _ in range(3):
            prof = breakdown(fn, LONG_TAIL_KERNELS, reps=10)
            if sum(prof[f"{k} launches"] for k in LONG_TAIL_KERNELS) >= per_call:
                break
        rec["ms"] = prof["events"]
        rec["kernel_ms"] = sum(prof[k] for k in LONG_TAIL_KERNELS)
        rec["other_ms"] = prof["other"]
        rec["idle"] = prof["idle"]
        print(f"long tail: {smi} | {name} | {rec['ms']:.4f} ms (CUDA events, median of 10) | "
              f"device ms (torch.profiler, 10 calls): kernels {rec['kernel_ms']:.4f}, other "
              f"{rec['other_ms']:.4f}, idle {rec['idle']:.3f} | launches {rec['launches']} | "
              f"{rec['measure']} {rec['err']:.3e}", flush=True)
    total = time.perf_counter() - t0
    print(f"main: transform long-tail path (path 8), {len(calls)} calls checked against "
          f"float64 in {checked:.1f} s, timed in {total - checked:.1f} s ({total:.1f} s in all)",
          flush=True)
    return calls


# The kernels a call of the signal-processing and non-uniform long tail
# (path 9) may launch, as the profiler names them; the rest of its device
# work (scatters, gathers, products, pads, matmuls) is listed by name.
SIGNAL_TAIL_KERNELS = ("rows_fft", "ax0_fft", "rows_t_fft", "fft2f_fft", "r2c_fft", "c2r_fft",
                       "big_fft", "gen_fft", "r2c_gen_fft", "ax0_gen_fft", "c2r_prod",
                       "chirp_full")
# The JAX package's tests' bars against their oracles: tests/test_multirate.py
# (upfirdn 2e-5, resample_poly and decimate 5e-5), tests/test_conv2d.py
# (Savitzky-Golay and complex even templates 1e-4, wiener 2e-4),
# tests/test_frft.py (the quadrature 2e-5 in the core interval, 5e-5
# elsewhere), tests/test_nufft.py (types 1 and 2 5e-5, type 3 2e-4).
UPFIRDN_TOL, RESAMPLE_TOL, SAVGOL_TOL, WIENER_TOL = 2e-5, 5e-5, 1e-4, 2e-4
FRFT_CORE_TOL, FRFT_TOL, NUFFT_TOL, NUFFT3_TOL = 2e-5, 5e-5, 5e-5, 2e-4


def nudft(freqs, pts, vals, isign: int, chunk: int = 1 << 14) -> np.ndarray:
    """The direct non-uniform DFT in float64 on the host (torch on the CPU,
    every core): sum_j vals[..., j] exp(isign i freqs[k] . pts[j]) for each
    row k of freqs [K, D], pts [M, D], in chunks of points."""
    import torch

    F = torch.as_tensor(np.asarray(freqs, np.float64))
    P = torch.as_tensor(np.asarray(pts, np.float64))
    V = torch.as_tensor(np.asarray(vals)).to(torch.complex128)
    out = 0
    for lo in range(0, P.shape[0], chunk):
        ph = F @ P[lo:lo + chunk].T
        out = out + V[..., lo:lo + chunk] @ torch.polar(torch.ones_like(ph), isign * ph).T
    return out.numpy()


def frft_kernel(n: int, a: float) -> np.ndarray:
    """The continuous FrFT kernel's quadrature on the grid (n - N/2)/sqrt(N)
    in float64 (tests/test_frft.py's oracle): frft(f, a) = f @ K.T."""
    alpha = np.mod(a, 4.0) * np.pi / 2
    x = (np.arange(n) - n // 2) / np.sqrt(n)
    cot, csc = 1 / np.tan(alpha), 1 / np.sin(alpha)
    A = np.exp(-1j * (np.pi * np.sign(np.sin(alpha)) / 4 - alpha / 2)) / np.sqrt(
        abs(np.sin(alpha)))
    return A * np.exp(1j * np.pi * (cot * (x[:, None] ** 2 + x[None, :] ** 2)
                                    - 2 * csc * x[:, None] * x[None, :])) / np.sqrt(n)


def signal_tail(ft, dev, gen, smi) -> dict:
    """Path 9: the signal-processing and non-uniform long tail at its users'
    sizes (multirate, 2-D convolution and filtering, fractional Fourier
    transforms, NUFFTs), each call once with the launch counts read around
    it, its peak device bytes above its inputs, and its output held against
    a float64 oracle on the host (scipy, numpy, the kernel quadrature, or
    the direct NUDFT on a random subset of 256 outputs, 64 in 3-D), then
    timed: CUDA events over 10 calls, and the device ms of the port's
    kernels and of the rest (listed by name), and the device's idle share,
    from a torch.profiler window of 10 calls.  Three launch counts are
    exact, each against bare calls of the transforms it composes, counted
    in this run: nufft2d1 at 256^2 modes launches the port kernels of one
    2-D transform of its 512^2 planar fine grid; frft of [256, 4096] at
    a = 0.5 those of the forward and inverse transforms of [256, 2^15] and
    of [256, 2^16]; resample_poly of [2, 2^18] at 147/160 those of
    rfft_last_split of the signal rows and of the taps row and of
    irfft_last_split, at nfft 2^26.  dfrft is two matmuls and launches no
    port kernel; every other call must.  Returns each call's record."""
    import scipy.signal as ss
    import torch

    from fft_wgpu_tpu_torch.core.twiddle import FORWARD, INVERSE
    from fft_wgpu_tpu_torch.ops import cuda_fft, frft, nd, nufft
    from fft_wgpu_tpu_torch.ops.rfft import irfft_last_split, rfft_last_split

    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    rng = np.random.default_rng(SEED + 9)
    calls = {}

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def crandn(*shape):
        return torch.complex(randn(*shape), randn(*shape))

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def host(t):
        t = t.detach().cpu()
        return t.numpy().astype(np.complex128 if t.is_complex() else np.float64)

    def launched(fn):
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v - before[k] for k, v in counts().items() if v != before[k]}

    def summed(*deltas):
        out = {}
        for d in deltas:
            for k, v in d.items():
                out[k] = out.get(k, 0) + v
        return out

    def run(name, fn, want, tol, exact=None, kernels=True):
        """fn() once: its launches (exactly ``exact`` where given, some port
        kernel unless ``kernels`` is false), its peak device bytes above
        the live ones before it, and its output against ``want``, a
        float64 array or a function of the output returning (part of the
        output, its float64 oracle)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out, delta = launched(fn)
        peak = torch.cuda.max_memory_allocated(dev) - base
        check(bool(delta) == kernels, f"path 9 {name}: launches {delta}")
        if exact is not None:
            check(delta == exact, f"path 9 {name}: launches {delta}, expected {exact}")
        got, ref = want(out) if callable(want) else (out, want)
        got = got.detach().cpu() if isinstance(got, torch.Tensor) else torch.from_numpy(got)
        ref = torch.from_numpy(np.ascontiguousarray(ref))
        check(tuple(got.shape) == tuple(ref.shape),
              f"path 9 {name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        check(bool(got.isfinite().all()), f"path 9 {name}: non-finite output")
        err = rel_l2(got, ref)
        check(err <= tol, f"path 9 {name}: rel-L2 {err:.3e} > {tol:.0e} against float64")
        calls[name] = {"fn": fn, "launches": delta, "err": err, "tol": tol, "peak": peak}
        return out

    # ---- multirate: 48 -> 44.1 kHz stereo, a decimation by 8, a complex
    # channel filter upsampled by 4/3, Savitzky-Golay smoothing
    x = randn(2, 1 << 18)
    taps_n = 2 * 10 * 160 + 1  # resample_poly's Kaiser design at max(up, down) = 160
    nfft = 1 << (((1 << 18) - 1) * 147 + taps_n + 160 - 1).bit_length()
    check(nfft == 1 << 26, f"path 9 resample_poly: nfft {nfft}")
    _, bare = launched(lambda: rfft_last_split(torch.zeros(2, nfft, device=dev), None))
    _, bare_h = launched(lambda: rfft_last_split(torch.zeros(1, nfft, device=dev), None))
    bins = torch.zeros(2, nfft // 2 + 1, device=dev)
    _, bare_c2r = launched(lambda: irfft_last_split(bins, bins, nfft, 1.0 / nfft))
    del bins
    run("resample_poly [2, 2^18] up 147 down 160 (nfft 2^26)",
        lambda x=x: ft.resample_poly(x, 147, 160), ss.resample_poly(host(x), 147, 160, axis=-1),
        RESAMPLE_TOL, exact=summed(bare, bare_h, bare_c2r))
    x = randn(64, 1 << 20)
    run("decimate [64, 2^20] q 8 FIR", lambda x=x: ft.decimate(x, 8),
        lambda y: (y[::8], ss.decimate(host(x[::8]), 8, ftype="fir")), RESAMPLE_TOL)
    z = crandn(16, 1 << 16)
    hc = ss.firwin(64, 0.2) * np.exp(0.5j * np.pi * np.arange(64))  # a band-shifted channel
    run("upfirdn complex [16, 2^16] up 4 down 3, 64 complex taps",
        lambda z=z: ft.upfirdn(hc, z, 4, 3), ss.upfirdn(hc, host(z), 4, 3), UPFIRDN_TOL)
    run("savgol_filter [64, 2^20] window 101 order 3 interp",
        lambda x=x: ft.savgol_filter(x, 101, 3),
        lambda y: (y[::8], ss.savgol_filter(host(x[::8]), 101, 3)), SAVGOL_TOL)
    del x, z

    # ---- 2-D: a 1080p frame blurred with a 31 x 31 Gaussian at symmetric
    # edges, template matching of a 64^2 patch in a complex 512^2 field,
    # the adaptive Wiener filter of a 1024^2 image
    img = randn(1080, 1920)
    g1 = np.exp(-0.5 * ((np.arange(31) - 15) / 5.0) ** 2)
    k = np.outer(g1, g1) / np.outer(g1, g1).sum()
    kt = on_card(k.astype(np.float32))
    run("convolve2d 1080x1920 31x31 Gaussian same symm",
        lambda img=img: ft.convolve2d(img, kt, mode="same", boundary="symm"),
        ss.fftconvolve(np.pad(host(img), 15, mode="symmetric"), k.astype(np.float32)
                       .astype(np.float64), mode="valid"), TOL)
    field, tmpl = crandn(512, 512), crandn(64, 64)
    run("correlate2d complex 512^2 with a 64^2 template valid",
        lambda field=field, tmpl=tmpl: ft.correlate2d(field, tmpl, mode="valid"),
        ss.fftconvolve(host(field), np.conj(host(tmpl)[::-1, ::-1]), mode="valid"),
        SAVGOL_TOL)
    im = randn(1024, 1024)
    run("wiener 1024^2 mysize 5", lambda im=im: ft.wiener(im, 5), ss.wiener(host(im), 5), WIENER_TOL)
    del img, field, tmpl, im

    # ---- fractional Fourier transforms: a chirp-rate search over 256 radar
    # returns of 4096 samples (Gaussian-windowed chirps at rates about the
    # -cot(45 deg) = -1 that a = 0.5 focuses: there the kernel quadrature is
    # well sampled; positive rates alias it, as tests/test_frft.py notes of
    # its range), an optical propagation of a defocused beam on 1024^2, the
    # discrete FrFT
    n = 4096
    grid = (np.arange(n) - n // 2) / np.sqrt(n)
    rates, t0s = rng.uniform(-1.2, -0.2, (256, 1)), rng.uniform(-3, 3, (256, 1))
    sig = np.exp(-((grid - t0s) / 4.0) ** 2) * np.exp(1j * np.pi * rates * grid * grid)
    s_card = on_card(sig.astype(np.complex64))
    L1, L2 = frft._conv_lengths(n)
    check((L1, L2) == (1 << 15, 1 << 16), f"path 9 frft: lengths {L1}, {L2}")
    bare_f = []
    for L in (L1, L2):
        zr = torch.zeros(256, L, device=dev)
        p = ft.get_plan(L)
        bare_f += [launched(lambda: p._execute_split(zr, zr, FORWARD, None))[1],
                   launched(lambda: p._execute_split(zr, zr, INVERSE, 1.0 / L))[1]]
    del zr
    rows = rng.choice(256, 8, replace=False)
    for a, tol in ((0.5, FRFT_TOL), (0.9, FRFT_CORE_TOL)):
        K = frft_kernel(n, a)
        run(f"frft complex [256, 4096] a {a}", lambda a=a, s=s_card: ft.frft(s, a),
            lambda y, K=K: (y[rows], sig[rows].astype(np.complex64).astype(np.complex128) @ K.T),
            tol, exact=summed(*bare_f) if a == 0.5 else None)
    del K, s_card
    n = 1024
    grid = (np.arange(n) - n // 2) / np.sqrt(n)
    beam = np.exp(-(grid / 2.0) ** 2) * np.exp(1j * np.pi * 0.3 * grid * grid)
    field = np.outer(beam, beam * np.exp(-0.5j * grid)).astype(np.complex64)
    K = frft_kernel(n, 0.5)
    f_card = on_card(field)
    run("frft2 complex 1024^2 (0.5, 0.5)", lambda f=f_card: ft.frft2(f, (0.5, 0.5)),
        K @ field.astype(np.complex128) @ K.T, FRFT_TOL)
    u = crandn(64, 1024)
    V = frft._dfrft_basis(1024)[0].astype(np.float64)
    ph = np.exp(-0.25j * np.pi * frft._dfrft_basis(1024)[1])
    run("dfrft [64, 1024] a 0.5 (two matmuls)", lambda u=u: ft.dfrft(u, 0.5),
        ((host(u) @ V) * ph) @ V.T, TOL, kernels=False)
    del f_card, u, K, V

    # ---- NUFFTs: unevenly sampled spectra (2^16 modes, 2^20 points),
    # radial MRI (256 spokes x 1024 samples onto 256^2), 3-D MRI (2^20
    # points onto 128^3), and type 3 on free-space grids in the kernels'
    # envelope
    def points(m, lo=0.0, hi=2 * np.pi):
        return rng.uniform(lo, hi, m).astype(np.float32)

    def modes(ns, idx):
        return np.stack(np.unravel_index(idx, ns), -1) - np.array([v // 2 for v in ns])

    def all_modes(ns):
        return modes(ns, np.arange(int(np.prod(ns))))

    M = 1 << 20
    xs = points(M)
    c = crandn(M)
    sub = rng.choice(1 << 16, 256, replace=False)
    run("nufft1d1 2^20 points -> 2^16 modes", lambda xs=on_card(xs), c=c: ft.nufft1d1(xs, c, 1 << 16),
        lambda f: (f[sub], nudft(modes((1 << 16,), sub), xs[:, None], host(c), 1)), NUFFT_TOL)
    f1 = crandn(1 << 16)
    pts = rng.choice(M, 256, replace=False)
    run("nufft1d2 2^16 modes -> 2^20 points", lambda xs=on_card(xs), f1=f1: ft.nufft1d2(xs, f1),
        lambda v: (v[pts], nudft(xs[pts, None], all_modes((1 << 16,)), host(f1), -1)),
        NUFFT_TOL)
    theta = np.repeat(np.pi * np.arange(256) / 256, 1024)
    r = np.tile(np.pi * (np.arange(1024) - 512) / 512, 256)
    kx, ky = (r * np.cos(theta)).astype(np.float32), (r * np.sin(theta)).astype(np.float32)
    c2 = crandn(1 << 18)
    nf2 = nufft._fine_n(256)
    gz = torch.zeros(nf2, nf2, device=dev)
    _, bare2 = launched(lambda: nd.fftn_split(gz, gz, (0, 1), INVERSE, None))
    del gz
    sub = rng.choice(256 * 256, 256, replace=False)
    kxy = np.stack([kx, ky], -1)
    run("nufft2d1 radial 256 x 1024 -> 256^2", lambda kx=on_card(kx), ky=on_card(ky), c2=c2:
        ft.nufft2d1(kx, ky, c2, (256, 256)),
        lambda f: (f.reshape(-1)[sub], nudft(modes((256, 256), sub), kxy, host(c2), 1)),
        NUFFT_TOL, exact=bare2)
    f2 = crandn(256, 256)
    pts = rng.choice(1 << 18, 256, replace=False)
    run("nufft2d2 256^2 -> radial 256 x 1024", lambda kx=on_card(kx), ky=on_card(ky), f2=f2: ft.nufft2d2(kx, ky, f2),
        lambda v: (v[pts], nudft(kxy[pts], all_modes((256, 256)), host(f2).reshape(-1), -1)),
        NUFFT_TOL)
    p3 = [points(M) for _ in range(3)]
    p3c = [on_card(v) for v in p3]
    xyz = np.stack(p3, -1)
    c3 = crandn(M)
    sub = rng.choice(128 ** 3, 64, replace=False)
    run("nufft3d1 2^20 points -> 128^3 (chunked spread)",
        lambda p3c=p3c, c3=c3: ft.nufft3d1(*p3c, c3, (128, 128, 128)),
        lambda f: (f.reshape(-1)[sub], nudft(modes((128,) * 3, sub), xyz, host(c3), 1)),
        NUFFT_TOL)
    f3 = crandn(128, 128, 128)
    pts = rng.choice(M, 64, replace=False)
    run("nufft3d2 128^3 -> 2^20 points (chunked gather)", lambda p3c=p3c, f3=f3: ft.nufft3d2(*p3c, f3),
        lambda v: (v[pts], nudft(xyz[pts], all_modes((128,) * 3), host(f3).reshape(-1), -1)),
        NUFFT_TOL)
    del c, f1, c2, f2, p3c, c3, f3
    grids = {}
    for dims, m, X, S in ((1, 1 << 16, 50.0, 63.0), (2, 1 << 14, 20.0, 25.0)):
        pts3 = [points(m, -X, X) for _ in range(dims)]
        frs = [points(m, -S, S) for _ in range(dims)]
        for v, e in zip(pts3 + frs, [X] * dims + [S] * dims):
            v[:2] = (-e, e)  # the extents, exactly
        nt = nufft._t3_geom((-X, X), (-S, S))[4]
        nf = nufft._fine_n(nt)
        check(cuda_fft._ax0_supported(nf), f"path 9 nufft{dims}d3: fine grid {nf} off the kernels")
        grids[dims] = (nt, nf)
        cv = crandn(m)
        outs = rng.choice(m, 256, replace=False)
        name = f"nufft{dims}d3 2^{m.bit_length() - 1} points, grid {nt}^{dims}, fine {nf}^{dims}"
        run(name, lambda pts3=pts3, frs=frs, cv=cv, dims=dims: getattr(ft, f"nufft{dims}d3")(
            *map(on_card, pts3), cv, *map(on_card, frs)),
            lambda f, pts3=pts3, frs=frs, cv=cv, outs=outs: (
                f[outs], nudft(np.stack([v[outs] for v in frs], -1), np.stack(pts3, -1),
                               host(cv), 1)), NUFFT3_TOL)
    checked = time.perf_counter() - t0

    for name, rec in calls.items():
        fn = rec.pop("fn")
        per_call = sum(v for k, v in rec["launches"].items() if not k.endswith("_c64"))
        others = {}
        for _ in range(3):  # a window can miss launches (PERF.md §7)
            prof = breakdown(fn, SIGNAL_TAIL_KERNELS, reps=10, others=others)
            if sum(prof[f"{k} launches"] for k in SIGNAL_TAIL_KERNELS) >= per_call:
                break
        rec["ms"] = prof["events"]
        rec["kernel_ms"] = sum(prof[k] for k in SIGNAL_TAIL_KERNELS)
        rec["other_ms"] = prof["other"]
        rec["idle"] = prof["idle"]
        work = {}
        for k, v in others.items():  # a kernel's name without its arguments
            k = re.sub(r"[<(].*", "", re.sub(r"^void |\(anonymous namespace\)::", "", k))
            work[k] = work.get(k, 0.0) + v
        rec["other_work"] = dict(sorted(work.items(), key=lambda kv: -kv[1])[:4])
        print(f"signal tail: {smi} | {name} | {rec['ms']:.4f} ms (CUDA events, median of 10) | "
              f"device ms (torch.profiler, 10 calls): kernels {rec['kernel_ms']:.4f}, other "
              f"{rec['other_ms']:.4f}, idle {rec['idle']:.3f} | launches {rec['launches']} | "
              f"other device work (ms) "
              + ", ".join(f"{k} {v:.4f}" for k, v in rec["other_work"].items())
              + f" | peak {rec['peak'] / 2**20:.1f} MiB | rel-L2 {rec['err']:.3e} "
              f"(bar {rec['tol']:.0e})", flush=True)
    total = time.perf_counter() - t0
    print(f"main: signal-processing and non-uniform long tail (path 9), {len(calls)} calls "
          f"checked against float64 in {checked:.1f} s, timed in {total - checked:.1f} s "
          f"({total:.1f} s in all); type-3 grids {grids}", flush=True)
    return calls


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import fft_wgpu_tpu_torch as ft
    from fft_wgpu_tpu_torch.ops import bigfft, bluestein, cuda_fft, cuda_welch, czt, stockham
    from fft_wgpu_tpu_torch.ops import cwt as cwt_mod
    from fft_wgpu_tpu_torch.utils import build

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def crand(*shape):
        return torch.complex(torch.randn(shape, device=dev, generator=gen),
                             torch.randn(shape, device=dev, generator=gen))

    def planes(x):
        return x.real.contiguous(), x.imag.contiguous()

    def oracle(x, sign, scale, dim=-1):
        y = (torch.fft.fft(x, dim=dim) if sign < 0
             else torch.fft.ifft(x, dim=dim, norm="forward"))
        return y * (1.0 if scale is None else scale)

    def outer_oracle(x, sign, scale, outer):
        # transpose(fft(x * w)), w = exp(sign*2pi*i*((r*m) mod outer_n)/outer_n)
        x = x.to(torch.complex128)
        if outer is not None:
            rows, n = x.shape[-2:]
            r = torch.arange(rows, device=dev, dtype=torch.int64)[:, None]
            m = torch.arange(n, device=dev, dtype=torch.int64)[None, :]
            ang = (sign * 2 * math.pi / outer[1]) * ((r * m) % outer[1]).double()
            x = x * torch.polar(torch.ones_like(ang), ang)
        return oracle(x, sign, scale).transpose(-1, -2)

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    def timed_build(name):
        lib = build.build(name)
        return name, lib, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(LIBS)) as pool:
        built = list(pool.map(timed_build, LIBS))  # one nvcc each, all at once
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} | built "
          + ", ".join(f"{name} in {s:.1f} s -> {lib.name}" for name, lib, s in built),
          flush=True)
    for name, lib, _ in built:  # what ptxas reported for the redesigned kernels
        if name in ("ax0_gen_fft", "rows_t_fft", "chirp_fft", "rows_fft", "big_fft",
                    "ax0_fft", "r2c_fft", "fft2f_fft", "spec_fft", "filt_fft", "spec_c2c_fft",
                    "welch_acc_fft", "c2r_fft"):
            print(f"ptxas: {name} | " + "; ".join(ptxas_summary(
                lib.with_suffix(".log").read_text())), flush=True)

    # ---- 2. each kernel vs plain version vs torch.fft ---------------------
    max_abs = dict.fromkeys(KERNELS, 0.0)

    def compare(name, got, plain, want, what):
        err_p = check_close(got, plain, f"{name} vs plain {what}")
        err_o = check_close(got, want, f"{name} vs torch.fft {what}")
        max_abs[name] = max(max_abs[name], float((got - plain).abs().max()))
        return max(err_p, err_o)

    def sweep(name, shapes, run, plain, want, dim=-1):
        worst, cases = 0.0, 0
        for shape, extra in shapes:
            x = crand(*shape)
            re, im = planes(x)
            n = math.prod(shape[-2:]) if dim is None else shape[dim]
            for sign in (-1, 1):
                for scale in (None, 1.0 / n):
                    got = torch.complex(*run(re, im, sign, scale, extra))
                    ref = torch.complex(*plain(re, im, sign, scale, extra))
                    what = f"{shape} {extra} sign={sign} scale={scale}"
                    worst = max(worst, compare(name, got, ref,
                                               want(x, sign, scale, extra), what))
                    cases += 1
        torch.cuda.synchronize()
        print(f"kernel {name}: {cases} cases ok | worst rel-L2 {worst:.3e} | "
              f"max abs err vs plain {max_abs[name]:.3e}", flush=True)

    pow2 = [1 << e for e in range(7, 15)]
    sweep("rows_fft",
          [((rows, n), None) for n in pow2 for rows in (1, 1000)]
          + [((4096, 4096), None), ((2500, 512), None)],
          lambda re, im, s, sc, _: cuda_fft._launch(re, im, s, sc),
          lambda re, im, s, sc, _: cuda_fft.fft_batched_split_reference(re, im, s, sc),
          lambda x, s, sc, _: oracle(x, s, sc))

    def c64(launch):
        """A complex64 entry as a sweep's planar run: (re, im) in and out."""
        def run(re, im, s, sc, _):
            y = launch(torch.complex(re, im), s, sc)
            return y.real, y.imag
        return run

    sweep("rows_fft_c64",
          [((rows, n), None) for n in pow2 for rows in (1, 1000)]
          + [((4096, 4096), None), ((2500, 512), None)],
          c64(cuda_fft._launch_c64),
          lambda re, im, s, sc, _: cuda_fft.fft_batched_split_reference(re, im, s, sc),
          lambda x, s, sc, _: oracle(x, s, sc))
    for n in pow2:  # in place: the output is the input
        x = crand(37, n)
        plain, want = cuda_fft.fft_batched_c64_reference(x, 1, 1.0 / n), oracle(x, 1, 1.0 / n)
        check(cuda_fft._launch_c64(x, 1, 1.0 / n, out=x) is x, "rows_fft_c64 out=x")
        compare("rows_fft_c64", x, plain, want, f"in place 37x{n}")
    sweep("ax0_fft",
          [((2, n, m), None) for n in pow2 for m in (7, 1000)]
          + [((1024, 4096), None), ((4096, 4096), None), ((4096, 2049), None)],
          lambda re, im, s, sc, _: cuda_fft._ax0_launch(re, im, s, sc),
          lambda re, im, s, sc, _: cuda_fft.fft_axis0_split_reference(re, im, s, sc),
          lambda x, s, sc, _: oracle(x, s, sc, dim=-2), dim=-2)
    sweep("ax0_fft_c64",
          [((2, n, m), None) for n in pow2 for m in (7, 1000)]
          + [((1024, 4096), None), ((4096, 4096), None), ((4096, 2049), None)],
          c64(cuda_fft._ax0_launch_c64),
          lambda re, im, s, sc, _: cuda_fft.fft_axis0_split_reference(re, im, s, sc),
          lambda x, s, sc, _: oracle(x, s, sc, dim=-2), dim=-2)
    for n in pow2:  # in place: the output is the input
        x = crand(2, n, 45)
        plain = cuda_fft.fft_axis0_c64_reference(x, -1, None)
        want = oracle(x, -1, None, dim=-2)
        check(cuda_fft._ax0_launch_c64(x, -1, None, out=x) is x, "ax0_fft_c64 out=x")
        compare("ax0_fft_c64", x, plain, want, f"in place 2x{n}x45")
    sweep("rows_t_fft",
          [((rows, n), outer) for n in pow2 for rows in (1, 200)
           for outer in (None, (rows, rows * n), (rows, 3 << 12))]
          + [((1024, 4096), (1024, 1 << 22))],
          lambda re, im, s, sc, o: cuda_fft._rows_t_launch(re, im, s, sc, o),
          lambda re, im, s, sc, o: cuda_fft.fft_rows_transposed_split_reference(
              re, im, s, sc, outer=o),
          outer_oracle)
    big_ns = [1 << e for e in range(15, 19) if bigfft._supported(1 << e)]
    sweep("big_fft",
          [((rows, n), None) for n in big_ns for rows in (1, 3)]
          + [((256, 1 << 16), None)],
          lambda re, im, s, sc, _: bigfft._launch(re, im, s, sc),
          lambda re, im, s, sc, _: bigfft.fft_big_split_reference(re, im, s, sc),
          lambda x, s, sc, _: oracle(x, s, sc))
    sweep("big_fft_c64",
          [((rows, n), None) for n in big_ns for rows in (1, 3)]
          + [((256, 1 << 16), None)],
          c64(bigfft._launch_c64),
          lambda re, im, s, sc, _: bigfft.fft_big_split_reference(re, im, s, sc),
          lambda x, s, sc, _: oracle(x, s, sc))
    sweep("ax3_fft",
          [((2, n, 7, 130), None) for n in (128, 1000, 1024, 16384)]
          + [((256, 256, 256), None)],
          lambda re, im, s, sc, _: cuda_fft._ax3_launch(re, im, s, sc),
          lambda re, im, s, sc, _: cuda_fft.fft_axis3_split_reference(re, im, s, sc),
          lambda x, s, sc, _: oracle(x, s, sc, dim=-3), dim=-3)
    sweep("ax3_fft_c64",  # 512^3: fftn's first axis on the complex64 route
          [((2, n, 7, 13), None) for n in pow2] + [((256, 256, 256), None),
                                                   ((512, 512, 512), None)],
          c64(cuda_fft._ax3_launch_c64),
          lambda re, im, s, sc, _: cuda_fft.fft_axis3_split_reference(re, im, s, sc),
          lambda x, s, sc, _: oracle(x, s, sc, dim=-3), dim=-3)

    def oracle2(x, sign, scale):
        y = torch.fft.fft2(x) if sign < 0 else torch.fft.ifft2(x, norm="forward")
        return y * (1.0 if scale is None else scale)

    # the fused plane in both layouts, every plane of its envelope, single
    # and batched, against the plain version of its own passes and exchange
    fft2f_shapes = [((*lead, a, b), None) for a, b in ((128, 128), (128, 256), (256, 128),
                                                       (128, 512), (512, 128), (256, 256))
                    for lead in ((), (5,))] + [((256, 256, 256), None)]

    def fft2f_plain(re, im, s, sc, _):
        y = cuda_fft._fft2f_passes(torch.complex(re, im), s, sc)
        return y.real, y.imag

    sweep("fft2f_fft", fft2f_shapes, lambda re, im, s, sc, _: cuda_fft._fft2f_launch(re, im, s, sc),
          fft2f_plain, lambda x, s, sc, _: oracle2(x, s, sc), dim=None)
    sweep("fft2f_fft_c64", fft2f_shapes, c64(cuda_fft._fft2f_launch_c64), fft2f_plain,
          lambda x, s, sc, _: oracle2(x, s, sc), dim=None)
    for shape, _ in fft2f_shapes:  # in place: the output is the input
        x = crand(*shape)
        plain = cuda_fft._fft2f_passes(x, 1, 0.5)
        want = oracle2(x, 1, 0.5)
        check(cuda_fft._fft2f_launch_c64(x, 1, 0.5, out=x) is x, "fft2f_fft_c64 out=x")
        compare("fft2f_fft_c64", x, plain, want, f"in place {shape}")

    def real_sweep():
        """R2C and C2R against their plain versions and torch.fft: ragged and
        padded, scale None and 1/n; C2R, from planes and from complex64,
        also against the plain version of its own passes, with nonzero
        imaginary DC and Nyquist parts and, padded, garbage pad columns,
        which it must not read."""
        worst, cases = 0.0, 0
        for rows, n in [(rows, 1 << e) for e in range(7, 15) for rows in (3, 1000)] \
                + [(4096, 4096)]:
            x = torch.randn(rows, n, device=dev, generator=gen)
            mp = n // 2 + 1
            for pad in (False, True):
                for scale in (None, 1.0 / n):
                    s = 1.0 if scale is None else scale
                    what = f"{rows}x{n} pad={pad} scale={scale}"
                    kr, ki = cuda_fft._r2c_launch(x, scale, pad)
                    pr, pi = cuda_fft.rfft_rows_split_reference(x, scale, pad_out=pad)
                    got = torch.complex(kr, ki)
                    err = check_close(got, torch.complex(pr, pi), f"r2c_fft vs plain {what}")
                    X = torch.fft.rfft(x)
                    err = max(err, check_close(got[:, :mp], X * s,
                                               f"r2c_fft vs torch.fft {what}"))
                    if not pad:  # the complex64 sink: the same bins, no merge
                        got_c = cuda_fft._r2c_launch_c64(x, scale)
                        plain_c = cuda_fft.rfft_rows_c64_reference(x, scale)
                        err = max(err, check_close(got_c, plain_c,
                                                   f"r2c_fft_c64 vs plain {what}"),
                                  check_close(got_c, X * s, f"r2c_fft_c64 vs torch.fft {what}"))
                        max_abs["r2c_fft_c64"] = max(max_abs["r2c_fft_c64"], float(
                            (got_c - plain_c).abs().max()))
                        cases += 1
                    check(not kr[:, mp:].any() and not ki[:, mp:].any(),
                          f"r2c_fft pad columns not zero {what}")
                    max_abs["r2c_fft"] = max(max_abs["r2c_fft"], float(
                        (got - torch.complex(pr, pi)).abs().max()))
                    Xr, Xi = kr.clone(), ki.clone()
                    Xi[:, 0] += 3.0
                    Xi[:, mp - 1] -= 2.0
                    Xr[:, mp:], Xi[:, mp:] = 1e6, -1e6
                    yp = cuda_fft.irfft_rows_split_reference(Xr, Xi, n, scale, padded_in=pad)
                    yo = torch.fft.irfft(X, n=n, norm="forward") * s * s
                    ys = cuda_fft._c2r_passes(Xr, Xi, n, scale)
                    for name, y in (("c2r_fft", cuda_fft._c2r_launch(Xr, Xi, n, scale)),
                                    ("c2r_fft_c64", cuda_fft._c2r_launch_c64(
                                        torch.complex(Xr, Xi), n, scale))):
                        err = max(err, check_close(y, yp, f"{name} vs plain {what}"),
                                  check_close(y, yo, f"{name} vs torch.fft {what}"),
                                  check_close(y, ys, f"{name} vs its passes {what}"))
                        max_abs[name] = max(max_abs[name], float((y - yp).abs().max()))
                    worst = max(worst, err)
                    cases += 3
        torch.cuda.synchronize()
        print(f"kernel r2c_fft, r2c_fft_c64, c2r_fft, c2r_fft_c64: {cases} cases ok | worst "
              f"rel-L2 {worst:.3e} | max abs err vs plain {max_abs['r2c_fft']:.3e}, "
              f"{max_abs['r2c_fft_c64']:.3e}, {max_abs['c2r_fft']:.3e}, "
              f"{max_abs['c2r_fft_c64']:.3e}", flush=True)

    real_sweep()

    sweep("gen_fft", [((rows, n), None) for n in GEN_NS for rows in (1, 1000)]
          + [((1024, 4095), None), ((1024, 4097), None), ((2048, 1000), None)],
          lambda re, im, s, sc, _: cuda_fft._gen_launch(re, im, s, sc),
          lambda re, im, s, sc, _: cuda_fft.fft_rows_general_split_reference(re, im, s, sc),
          lambda x, s, sc, _: oracle(x, s, sc))

    def r2c_gen_sweep():
        """Composite R2C against its plain version and torch.fft, ragged and
        padded, scale None and 1/n; the pad columns must be exact zeros."""
        worst, cases = 0.0, 0
        for rows, n in [(rows, n) for n in GEN_NS for rows in (1, 1000)] \
                + [(1024, 4095), (1024, 1000)]:
            x = torch.randn(rows, n, device=dev, generator=gen)
            mp = n // 2 + 1
            for pad in (False, True):
                for scale in (None, 1.0 / n):
                    what = f"{rows}x{n} pad={pad} scale={scale}"
                    kr, ki = cuda_fft._r2c_gen_launch(x, scale, pad)
                    got = torch.complex(kr, ki)
                    plain = torch.complex(*cuda_fft.rfft_rows_general_split_reference(
                        x, scale, pad_out=pad))
                    err = check_close(got, plain, f"r2c_gen_fft vs plain {what}")
                    want = torch.fft.rfft(x) * (1.0 if scale is None else scale)
                    err = max(err, check_close(got[:, :mp], want,
                                               f"r2c_gen_fft vs torch.fft {what}"))
                    check(not kr[:, mp:].any() and not ki[:, mp:].any(),
                          f"r2c_gen_fft pad columns not zero {what}")
                    max_abs["r2c_gen_fft"] = max(max_abs["r2c_gen_fft"],
                                                 float((got - plain).abs().max()))
                    worst = max(worst, err)
                    cases += 1
        torch.cuda.synchronize()
        print(f"kernel r2c_gen_fft: {cases} cases ok | worst rel-L2 {worst:.3e} | "
              f"max abs err vs plain {max_abs['r2c_gen_fft']:.3e}", flush=True)

    r2c_gen_sweep()

    def mixed_sweep():
        """Both composite kernels against the plain torch version of their
        own passes (cuda_fft._mixed_radix, _mixed_radix_real) at every
        length, both signs and scales, ragged and padded."""
        worst, cases = 0.0, 0
        for n in GEN_NS:
            x = crand(3, n)
            re, im = planes(x)
            for sign in (-1, 1):
                for scale in (None, 1.0 / n):
                    got = torch.complex(*cuda_fft._gen_launch(re, im, sign, scale))
                    want = torch.complex(*cuda_fft._mixed_radix(re, im, sign, scale))
                    worst = max(worst, check_close(
                        got, want, f"gen_fft vs _mixed_radix {n} sign={sign} scale={scale}"))
                    cases += 1
            for pad in (False, True):
                for scale in (None, 1.0 / n):
                    got = torch.complex(*cuda_fft._r2c_gen_launch(re, scale, pad))
                    want = torch.complex(*cuda_fft._mixed_radix_real(re, scale, pad))
                    worst = max(worst, check_close(
                        got, want, f"r2c_gen_fft vs _mixed_radix_real {n} pad={pad} "
                                   f"scale={scale}"))
                    cases += 1
        torch.cuda.synchronize()
        print(f"kernel gen_fft, r2c_gen_fft vs their passes' plain version: {cases} cases "
              f"ok | worst rel-L2 {worst:.3e}", flush=True)

    mixed_sweep()

    def chirp_sweep():
        """The chirp passes against their plain versions and torch.fft at
        every pow2 m, with signal and output lengths that are not multiples
        of 128: chirp_fwd y = FFT_m(pad(h x)), chirp_inv y = g (s FFT_m(H x))[:n_out],
        chirp_full (the two fused, signs -1 then +1) y = g (s FFT_+(H FFT_-(pad(h x))))[:n_out],
        the latter also against the plain version of its own passes.  Then at
        the non-pow2 path's own calls: Bluestein at 4093 (m = 8192) and 4097
        (m = 16384), both directions (the tables of each sign), and the
        ZoomFFT of 1024 x 4096 to 1024 bins (L = 8192), 1024 rows each, with
        the chirp, filter and output tables those calls use, chirp_inv fed
        chirp_fwd's output, and chirp_full against float64 references of the
        whole transform."""
        worst, cases = 0.0, 0
        for m in pow2:
            n_in, n_out = m // 2 + 3, 3 * m // 4 + 1
            h, H, g = crand(n_in), crand(m), crand(n_out)
            tabs = (*planes(h), *planes(H), *planes(g))
            for rows in (3, 1000):
                x, X = crand(rows, n_in), crand(rows, m)
                for sign in (-1, 1):
                    what = f"m={m} rows={rows} n_in={n_in} sign={sign}"
                    got = torch.complex(*cuda_fft._chirp_fwd_launch(
                        *planes(x), *planes(h), m, sign))
                    Y = oracle(torch.nn.functional.pad(x * h, (0, m - n_in)), sign, None)
                    worst = max(worst, compare(
                        "chirp_fwd", got, torch.complex(*cuda_fft.fft_chirp_forward_split_reference(
                            *planes(x), *planes(h), m, sign)), Y, what))
                    for scale in (None, 1.0 / m):
                        what = f"m={m} rows={rows} n_out={n_out} sign={sign} scale={scale}"
                        got = torch.complex(*cuda_fft._chirp_inv_launch(
                            *planes(X), *planes(H), *planes(g), n_out, sign, scale))
                        plain = torch.complex(*cuda_fft.fft_chirp_inverse_split_reference(
                            *planes(X), *planes(H), *planes(g), n_out, sign, scale))
                        want = g * oracle(X * H, sign, scale)[:, :n_out]
                        worst = max(worst, compare("chirp_inv", got, plain, want, what))
                        cases += 1
                        if sign > 0:  # chirp_full: first sign -1 only
                            continue
                        what = f"m={m} rows={rows} n_in={n_in} n_out={n_out} scale={scale}"
                        got = torch.complex(*cuda_fft._chirp_full_launch(
                            *planes(x), *tabs, m, n_out, scale))
                        plain = torch.complex(*cuda_fft.fft_chirp_full_split_reference(
                            *planes(x), *tabs, m, n_out, scale))
                        want = g * oracle(Y.to(torch.complex128) * H, 1, scale)[:, :n_out]
                        worst = max(worst, compare("chirp_full", got, plain, want, what))
                        worst = max(worst, check_close(got, torch.complex(
                            *cuda_fft._chirp_full_passes(*planes(x), *tabs, m, n_out, scale)),
                            f"chirp_full vs its passes' plain version {what}"))
                        cases += 1
                    cases += 1
        zf = ft.ZoomFFT(4096, [0.1, 0.35], m=1024)
        ((ar, ai), (wr, wi), (vr, vi)), L = czt._device_tables(4096, 1024, zf.w, zf.a, dev)
        calls = [(f"ZoomFFT 1024x4096 m=1024 L={L}", (ar, ai), (vr, vi), (wr, wi), L, 1024,
                  (1.0 / L,), None)]
        for n in (4093, 4097):
            for sign in (-1, 1):
                (cr, ci, bfr, bfi), m = bluestein._chirp_tables(n, sign, dev)
                calls.append((f"Bluestein 1024x{n} m={m} sign={sign}", (cr, ci), (bfr, bfi),
                              (cr, ci), m, n, (1.0 / m, 1.0 / (m * n)), sign))
        for what, h, H, g, m, n_out, scales, sign in calls:
            x = crand(1024, h[0].shape[0])
            re, im = planes(x)
            fr, fi = cuda_fft._chirp_fwd_launch(re, im, *h, m, -1)
            worst = max(worst, compare(
                "chirp_fwd", torch.complex(fr, fi),
                torch.complex(*cuda_fft.fft_chirp_forward_split_reference(re, im, *h, m, -1)),
                oracle(torch.nn.functional.pad(x * torch.complex(*h), (0, m - x.shape[-1])),
                       -1, None), what))
            # the whole transform in float64: the direct sum of the zoom, the
            # DFT (sign -1) or the unnormalized inverse DFT (sign +1)
            x64 = x.to(torch.complex128)
            if sign is None:
                j = torch.arange(4096, device=dev, dtype=torch.float64)
                k = torch.arange(1024, device=dev, dtype=torch.float64)
                whole = x64 @ torch.exp(-j[:, None] * complex(np.log(zf.a))
                                        + (j[:, None] * k[None, :]) * complex(np.log(zf.w)))
            else:
                whole = torch.fft.fft(x64) if sign < 0 else torch.fft.ifft(x64) * n_out
            for scale in scales:
                got = torch.complex(*cuda_fft._chirp_inv_launch(fr, fi, *H, *g, n_out, 1, scale))
                plain = torch.complex(*cuda_fft.fft_chirp_inverse_split_reference(
                    fr, fi, *H, *g, n_out, 1, scale))
                want = torch.complex(*g) * oracle(torch.complex(fr, fi) * torch.complex(*H), 1,
                                                  scale)[:, :n_out]
                worst = max(worst, compare("chirp_inv", got, plain, want,
                                           f"{what} scale={scale}"))
                got = torch.complex(*cuda_fft._chirp_full_launch(re, im, *h, *H, *g, m, n_out,
                                                                 scale))
                plain = torch.complex(*cuda_fft.fft_chirp_full_split_reference(
                    re, im, *h, *H, *g, m, n_out, scale))
                worst = max(worst, compare("chirp_full", got, plain, whole * (scale * m),
                                           f"{what} scale={scale} vs float64"))
                cases += 2
            cases += 1
        torch.cuda.synchronize()
        print(f"kernel chirp_fwd, chirp_inv, chirp_full: {cases} cases ok | worst rel-L2 "
              f"{worst:.3e} | max abs err vs plain {max_abs['chirp_fwd']:.3e}, "
              f"{max_abs['chirp_inv']:.3e}, {max_abs['chirp_full']:.3e}", flush=True)

    chirp_sweep()

    # the fused epilogues: B9 (filt, and its complex64 entry filt_c64: also
    # on rows of n/2 + 1 points, zero past them, and in place), B10 (bank),
    # B8 (c2r_prod), B2-composite
    filt_shapes = ([((rows, n), planes(crand(n))) for n in pow2 for rows in (3, 1000)]
                   + [((4096, 4096), planes(crand(4096)))])
    sweep("filt", filt_shapes,
          lambda re, im, s, sc, h: cuda_fft._filt(re, im, *h, s, sc),
          lambda re, im, s, sc, h: cuda_fft.fft_filtered_split_reference(re, im, *h, s, sc),
          lambda x, s, sc, h: oracle(x * torch.complex(*h), s, sc))

    def filt_c64_run(re, im, s, sc, e):
        """filt_c64 on the first e[2] points of each row (None: all), as a
        sweep's planar run; e[:2] the filter's planes, read as one complex
        row."""
        y = cuda_fft._filt_launch_c64(torch.complex(re, im)[..., :e[2]], torch.complex(*e[:2]),
                                      s, sc)
        return y.real, y.imag

    def filt_c64_plain(re, im, s, sc, e):
        y = cuda_fft._filt_passes(torch.complex(re, im)[..., :e[2]], torch.complex(*e[:2]), s,
                                  sc)
        return y.real, y.imag

    def filt_c64_want(x, s, sc, e):
        v = x[..., :e[2]]
        v = torch.nn.functional.pad(v, (0, x.shape[-1] - v.shape[-1]))
        return oracle(v * torch.complex(*e[:2]), s, sc)

    sweep("filt_c64", [(shape, (*h, None)) for shape, h in filt_shapes]
          + [((rows, n), (*planes(crand(n)), n // 2 + 1)) for n in pow2 for rows in (3, 1000)],
          filt_c64_run, filt_c64_plain, filt_c64_want)
    for n in pow2:  # in place: the output is the input
        x, h = crand(37, n), crand(n)
        plain = cuda_fft._filt_passes(x, h, 1, 1.0 / n)
        want = oracle(x * h, 1, 1.0 / n)
        check(cuda_fft._filt_launch_c64(x, h, 1, 1.0 / n, out=x) is x, "filt_c64 out=x")
        compare("filt_c64", x, plain, want, f"in place 37x{n}")
    # B1 (its row types moved into mixed_fft.cuh) gives the bits it gave before
    got = kept_bits(cuda_fft, dev)
    check(got == KEPT_BITS, "kept kernels' bits changed: "
          + str({k: v for k, v in got.items() if KEPT_BITS.get(k) != v}))
    print(f"kernel rows_fft, rows_fft_c64: {len(got)} outputs, the bits recorded before "
          f"(KEPT_BITS)", flush=True)
    bank_shapes = ([((n,), planes(crand(rows, n))) for n in pow2 for rows in (1, 7)]
                   + [((16384,), planes(crand(128, 16384)))])
    sweep("bank", bank_shapes,
          lambda re, im, s, sc, h: cuda_fft._bank(re, im, *h, s, sc),
          lambda re, im, s, sc, h: cuda_fft.fft_bank_split_reference(re, im, *h, s, sc),
          lambda x, s, sc, h: oracle(x * torch.complex(*h), s, sc))
    worst = 0.0
    for shape, h in bank_shapes:  # against the plain version of its own passes
        re, im = planes(crand(*shape))
        for sign in (-1, 1):
            for scale in (None, 1.0 / shape[-1]):
                worst = max(worst, check_close(
                    torch.complex(*cuda_fft._bank(re, im, *h, sign, scale)),
                    cuda_fft._bank_passes(re, im, *h, sign, scale),
                    f"bank vs its passes {shape} x {h[0].shape[0]} sign={sign} scale={scale}"))
    print(f"kernel bank: {4 * len(bank_shapes)} cases vs its passes ok | worst rel-L2 "
          f"{worst:.3e}", flush=True)

    def c2r_prod_sweep():
        """The product C2R against its plain version, the plain version of its
        own passes (cuda_fft._c2r_prod_passes) and torch.fft's irfft of the
        product: ragged and padded (the pad columns hold garbage, which it
        must not read), B of A's shape and one broadcast row, scale None and
        1/n; the product's DC and Nyquist imaginary parts are ignored."""
        worst, cases = 0.0, 0
        for rows, n, bcasts in [(rows, 1 << e, (False, True)) for e in range(7, 15)
                                for rows in (3, 1000)] + [(2048, 8192, (False,)),
                                                          (547, 2048, (True,))]:
            mp = n // 2 + 1
            for pad in (False, True):
                bins = cuda_fft.pad_bins(n) if pad else mp
                for bcast in bcasts:
                    A, B = crand(rows, bins), crand(1 if bcast else rows, bins)
                    A[:, mp:], B[:, mp:] = 1e6, -1e6
                    Ar, Ai = planes(A)
                    Br, Bi = (t[0] for t in planes(B)) if bcast else planes(B)
                    P = (A * B)[:, :mp]
                    P.imag[:, 0] = P.imag[:, -1] = 0.0
                    for scale in (None, 1.0 / n):
                        s = 1.0 if scale is None else scale
                        what = f"{rows}x{n} pad={pad} broadcast={bcast} scale={scale}"
                        y = cuda_fft._c2r_prod_launch(Ar, Ai, Br, Bi, n, scale)
                        yp = cuda_fft.irfft_prod_rows_split_reference(Ar, Ai, Br, Bi, n, scale,
                                                                      padded_in=pad)
                        worst = max(worst, compare(
                            "c2r_prod", y, yp, torch.fft.irfft(P, n=n, norm="forward") * s,
                            what), check_close(y, cuda_fft._c2r_prod_passes(
                                Ar, Ai, Br, Bi, n, scale), f"c2r_prod vs its passes {what}"))
                        cases += 1
        torch.cuda.synchronize()
        print(f"kernel c2r_prod: {cases} cases ok | worst rel-L2 {worst:.3e} | "
              f"max abs err vs plain {max_abs['c2r_prod']:.3e}", flush=True)

    c2r_prod_sweep()
    sweep("ax0_gen",
          [((2, n, m), None) for n in GEN_NS for m in (7, 1000)] + [((16, 1080, 1920), None)],
          lambda re, im, s, sc, _: cuda_fft._ax0_launch(re, im, s, sc),
          lambda re, im, s, sc, _: cuda_fft.fft_axis0_split_reference(re, im, s, sc),
          lambda x, s, sc, _: oracle(x, s, sc, dim=-2), dim=-2)

    def ax0_gen_passes_sweep():
        """B2c against the plain version of its own passes along axis -2
        (cuda_fft._mixed_radix_axis) at every length, m = 7 and 1000, both
        signs and scales."""
        worst, cases = 0.0, 0
        for n in GEN_NS:
            for m in (7, 1000):
                x = crand(2, n, m)
                re, im = planes(x)
                for sign in (-1, 1):
                    for scale in (None, 1.0 / n):
                        got = torch.complex(*cuda_fft._ax0_launch(re, im, sign, scale))
                        want = torch.complex(*cuda_fft._mixed_radix_axis(re, im, sign, scale))
                        worst = max(worst, check_close(
                            got, want, f"ax0_gen vs _mixed_radix_axis {n} m={m} sign={sign} "
                                       f"scale={scale}"))
                        cases += 1
        torch.cuda.synchronize()
        print(f"kernel ax0_gen vs its passes' plain version: {cases} cases ok | worst rel-L2 "
              f"{worst:.3e}", flush=True)

    ax0_gen_passes_sweep()

    # the segment-spectrum kernels: B16 (welch), B19 (psd), B17 (csd), B18
    # (coh), B21 (c2c: y is the imaginary plane; c2c_c64: x complex64, or
    # planes x and y, or x real with no imaginary plane), B20 (spec), B22
    # (spec_c2c: y is the imaginary plane; spec_c2c_c64: as c2c_c64)
    def torch_segments(kind, x, y, w, nperseg, hop, nfft, detrend, roll_s=0, pad_out=False,
                       pad=0):
        """torch.fft's composition of a kernel's function (reflect pad,
        frames, detrend, window, zero pad and roll, rfft or fft, then the
        spectra or their power or cross product, summed over segments), in
        x's dtype: float64 it is phase 2's oracle, float32 phase 5's
        baseline; never the implementation."""
        if pad:
            x = torch.nn.functional.pad(x[None], (pad, pad), mode="reflect")[0]

        def spectra(v):
            fr = v.unfold(-1, nperseg, hop)
            if detrend == "constant":
                fr = fr - fr.mean(-1, keepdim=True)
            fft = torch.fft.fft if v.is_complex() else torch.fft.rfft
            if roll_s:
                fr = torch.nn.functional.pad(fr * w.to(x.dtype), (0, nfft - nperseg))
                return fft(fr.roll(-roll_s, -1))
            return fft(fr * w.to(x.dtype), n=nfft)

        if kind in ("spec", "spec_c64"):
            X = spectra(x)
            if pad_out:
                X = torch.nn.functional.pad(X, (0, cuda_fft.pad_bins(nfft) - X.shape[-1]))
            return (X,) if kind == "spec_c64" else (X.real, X.imag)
        if kind in ("spec_c2c", "spec_c2c_c64"):
            X = spectra(x if x.is_complex() else torch.complex(
                x, torch.zeros_like(x) if y is None else y))
            return (X,) if kind == "spec_c2c_c64" else (X.real, X.imag)
        if kind in ("c2c", "c2c_c64"):
            X = spectra(x if x.is_complex() else torch.complex(
                x, torch.zeros_like(x) if y is None else y))
            return ((X.real ** 2 + X.imag ** 2).sum(-2),)
        X = spectra(x)
        if kind == "psd":
            return (X.real ** 2 + X.imag ** 2,)
        if kind == "welch":
            return ((X.real ** 2 + X.imag ** 2).sum(-2),)
        Y = spectra(y)
        P = (X.conj() * Y).sum(-2)
        if kind == "csd":
            return P.real, P.imag
        return (P.real, P.imag, (X.real ** 2 + X.imag ** 2).sum(-2),
                (Y.real ** 2 + Y.imag ** 2).sum(-2))

    def flat(outs):
        return torch.cat([o.reshape(-1) for o in outs])

    def wide(v):
        return None if v is None else v.to(torch.complex128 if v.is_complex() else torch.float64)

    def welch_case(kind, x, y, w, args, what, with_oracle=True, opts=(0, False, 0)):
        """One kernel launch against its plain version (B20 and B22, both
        sinks each: the plain version of the kernel's own passes) and float64
        torch.fft; a second launch must give the same bits.  ``opts``: B20's
        (roll_s, pad_out, reflect pad)."""
        if kind in ("spec_c2c", "spec_c2c_c64"):
            def run():
                return cuda_welch._spec_c2c_launch(x, y, w, *args, kind == "spec_c2c_c64")
            X = cuda_welch._spec_c2c_passes(x, y, w, *args)
            plain = (X,) if kind == "spec_c2c_c64" else (X.real, X.imag)
        elif kind in ("spec", "spec_c64"):
            def run():
                return cuda_welch._spec_launch(x, w, *args, *opts[:2], kind == "spec_c64",
                                               pad=opts[2])
            X = cuda_welch._spec_passes(x, w, *args, opts[0], pad=opts[2])
            if opts[1]:
                X = torch.nn.functional.pad(X, (0, cuda_fft.pad_bins(args[2]) - X.shape[-1]))
            plain = (X,) if kind == "spec_c64" else (X.real, X.imag)
        else:
            def run():
                return cuda_welch._launch(kind, x, y, w, *args)
            plain, _ = cuda_welch._reference(kind, x, y, w, *args)
        got = run()
        err = check_close(flat(got), flat(plain), f"{kind} vs plain {what}")
        # welch_acc_fft: the plain version of its passes and epilogue too (B16:
        # of both its designs, whichever the source runs at this nfft); B19
        # (spec_fft's psd_pairs) too
        acc = "c2c" if kind == "c2c_c64" else kind
        for half in {"welch": (False, True), "coh": (False,), "csd": (False,),
                     "c2c": (False,)}.get(acc, ()):
            err = max(err, check_close(flat(got), flat(cuda_welch._acc_passes(
                acc, x, y, w, *args, half=half)), f"{kind} vs its passes' plain version {what}"))
        if kind == "psd":
            err = max(err, check_close(got[0], cuda_welch._psd_passes(x, w, *args),
                                       f"psd vs its passes' plain version {what}"))
        if with_oracle:
            oracle = torch_segments(kind, wide(x), wide(y), w, *args, *opts)
            err = max(err, check_close(flat(got), flat(oracle),
                                       f"{kind} vs float64 torch.fft {what}"))
        if kind == "spec" and opts[1]:
            check(not got[0][..., args[2] // 2 + 1:].any()
                  and not got[1][..., args[2] // 2 + 1:].any(),
                  f"spec pad columns not zero {what}")
        again = run()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{kind} {what}: two runs differ in their bits")
        max_abs[kind] = max(max_abs[kind], float((flat(got) - flat(plain)).abs().max()))
        return err

    def vs_scipy_acc(kind, x, y, w, args, what):
        """B16's, B17's and B21's sums or B18's coherence against
        scipy.signal in float64: welch and csd with scaling "spectrum" (the
        mean over segments of the sums, over sum(w)^2; one-sided, the inner
        bins doubled; B21's two-sided welch of x + iy or of complex64 x)
        and coherence."""
        import scipy.signal as ss

        nperseg, hop, nfft, detrend = args
        w64 = w.double().cpu().numpy()
        kw = {"window": w64, "nperseg": nperseg, "noverlap": nperseg - hop, "nfft": nfft,
              "detrend": detrend or False, "axis": -1}
        got = cuda_welch._launch(kind, x, y, w, *args)
        num = 1 + (x.shape[-1] - nperseg) // hop
        mult = np.full(nfft // 2 + 1, 2.0)
        mult[0] = mult[-1] = 1.0
        if kind in ("welch", "csd"):
            P = (ss.welch(x.double().cpu().numpy(), scaling="spectrum", **kw)[1]
                 if kind == "welch" else ss.csd(x.double().cpu().numpy(),
                                                y.double().cpu().numpy(), scaling="spectrum",
                                                **kw)[1])
            got = got[0] if kind == "welch" else torch.complex(*got)
            return check_close(got.cpu(), torch.from_numpy(P * num * w64.sum() ** 2 / mult),
                               f"{kind} vs scipy.signal float64 {what}")
        if kind in ("c2c", "c2c_c64"):
            v = x if x.is_complex() else torch.complex(x, torch.zeros_like(x) if y is None else y)
            with warnings.catch_warnings():  # scipy: complex input, two-sided
                warnings.simplefilter("ignore")
                P = ss.welch(v.cpu().numpy().astype(np.complex128), scaling="spectrum",
                             return_onesided=False, **kw)[1]
            return check_close(got[0].cpu(), torch.from_numpy(P * num * w64.sum() ** 2),
                               f"{kind} vs scipy.signal float64 {what}")
        C = ss.coherence(x.double().cpu().numpy(), y.double().cpu().numpy(), **kw)[1]
        Pr, Pi, Sxx, Syy = (o.double() for o in got)
        return check_close(((Pr * Pr + Pi * Pi) / (Sxx * Syy)).cpu(), torch.from_numpy(C),
                           f"coh vs scipy.signal float64 {what}")

    def welch_sweep():
        worst, cases = 0.0, 0
        for nfft in pow2:
            for nperseg in (nfft, nfft - nfft // 4 + 1):
                for hop in (nperseg, nperseg // 2, nperseg - nperseg // 8):
                    for lead, detrend in (((), False), ((3,), "constant")):
                        t = nperseg + 37 * hop + hop // 3  # a ragged last tile
                        x = torch.randn(*lead, t, device=dev, generator=gen)
                        y = torch.randn(*lead, t, device=dev, generator=gen)
                        w = torch.rand(nperseg, device=dev, generator=gen) + 0.5
                        args = (nperseg, hop, nfft, detrend)
                        what = f"{lead} t={t} nperseg={nperseg} hop={hop} nfft={nfft} {detrend}"
                        for kind, v, u in (("welch", x, None), ("psd", x, None), ("csd", x, y),
                                           ("coh", x, y), ("c2c", x, y),
                                           ("c2c_c64", torch.complex(x, y), None),
                                           ("c2c_c64", x, y), ("c2c_c64", x, None),
                                           ("spec", x, None),
                                           ("spec_c64", x, None), ("spec_c2c", x, y),
                                           ("spec_c2c_c64", torch.complex(x, y), None),
                                           ("spec_c2c_c64", x, y), ("spec_c2c_c64", x, None)):
                            worst = max(worst, welch_case(kind, v, u, w, args, what))
                            cases += 1
                        # B20's roll of each padded frame (odd: scalar loads;
                        # even: pair loads), its padded output and stft's
                        # reflect pad of each end of the signal
                        for kind, opts in (("spec", (nfft // 2 + 3, True, 0)),
                                           ("spec_c64", (nfft // 2 + 3, False, 0)),
                                           ("spec_c64", (6, False, 0)),
                                           ("spec_c64", (0, False, nfft // 2))):
                            worst = max(worst, welch_case(kind, x, None, w, args, what,
                                                          opts=opts))
                            cases += 1
                        # welch_acc_fft: odd segment counts (B16's last frame
                        # with a zero plane; B17's and B18's last unswapped),
                        # and scipy.signal
                        for num in (37, 39):
                            t = nperseg + (num - 1) * hop + hop // 3
                            x = torch.randn(*lead, t, device=dev, generator=gen)
                            y = torch.randn(*lead, t, device=dev, generator=gen)
                            what = (f"{lead} t={t} ({num} segments) nperseg={nperseg} "
                                    f"hop={hop} nfft={nfft} {detrend}")
                            for kind, v, u in (("welch", x, None), ("coh", x, y), ("csd", x, y),
                                               ("c2c", x, y),
                                               ("c2c_c64", torch.complex(x, y), None),
                                               ("c2c_c64", x, None)):
                                worst = max(worst, welch_case(kind, v, u, w, args, what),
                                            vs_scipy_acc(kind, v, u, w, args, what))
                                cases += 1
        # path 6's own shapes (float64 oracle in phase 3, against scipy)
        n22 = 1 << 22
        x, y = (torch.randn(n22, device=dev, generator=gen) for _ in range(2))
        hann = ft.hann_window(4096, device=dev)
        tukey = ft.get_window(("tukey", 0.25), 4096, device=dev)
        xb = torch.randn(64, 1 << 20, device=dev, generator=gen)
        xp = torch.randn(64, 16384, device=dev, generator=gen)
        for kind, v, u, w, args in (
                ("welch", x, None, hann, (4096, 2048, 4096, "constant")),
                ("welch", xb, None, ft.hann_window(256, device=dev), (256, 128, 256, "constant")),
                ("welch", xp, None, torch.ones(16384, device=dev),
                 (16384, 16384, 16384, "constant")),
                ("psd", x, None, hann, (4096, 2048, 4096, "constant")),
                ("psd", x, None, tukey, (4096, 3584, 4096, "constant")),
                ("csd", x, y, hann, (4096, 2048, 4096, "constant")),
                ("coh", x, y, hann, (4096, 2048, 4096, "constant")),
                ("c2c", x, y, hann, (4096, 2048, 4096, "constant")),
                ("c2c_c64", torch.complex(x, y), None, hann, (4096, 2048, 4096, "constant")),
                ("c2c_c64", x, None, hann, (4096, 2048, 4096, "constant"))):
            what = f"path 6 {tuple(v.shape)} nperseg={args[0]} hop={args[1]}"
            worst = max(worst, welch_case(kind, v, u, w, args, what, with_oracle=False))
            cases += 1
        # path 7's shapes: stft of 2^20 and 8 x 2^17 at n_fft 512, hop 128
        # (the center pad read in place); the complex spectrogram, the
        # two-sided ones and csd at 2^22; ShortTimeFFT(hann(1024), 256) at
        # mfft 1024 and 2048, whose default phase shift is a roll of 512
        h512, h1024 = ft.hann_window(512, device=dev), ft.hann_window(1024, device=dev)
        xs, x8 = (torch.randn(*s, device=dev, generator=gen) for s in ((1 << 20,), (8, 1 << 17)))
        xt = torch.randn((1 << 20) + 1024, device=dev, generator=gen)
        for kind, v, u, w, args, opts in (
                ("spec_c64", xs, None, h512, (512, 128, 512, False), (0, False, 256)),
                ("spec_c64", x8, None, h512, (512, 128, 512, False), (0, False, 256)),
                ("spec", x, None, tukey, (4096, 2048, 4096, "constant"), (0, False, 0)),
                ("spec_c64", x, None, tukey, (4096, 2048, 4096, "constant"), (0, False, 0)),
                ("spec_c2c", x, y, tukey, (4096, 2048, 4096, "constant"), (0, False, 0)),
                ("spec_c2c", x, y, hann, (4096, 2048, 4096, "constant"), (0, False, 0)),
                ("spec_c2c_c64", torch.complex(x, y), None, tukey, (4096, 2048, 4096, "constant"),
                 (0, False, 0)),
                ("spec_c2c_c64", torch.complex(x, y), None, hann, (4096, 2048, 4096, "constant"),
                 (0, False, 0)),
                ("spec_c64", xt, None, h1024, (1024, 256, 1024, False), (512, False, 0)),
                ("spec", xt, None, h1024, (1024, 256, 2048, False), (512, True, 0)),
                ("spec_c64", xt, None, h1024, (1024, 256, 2048, False), (512, False, 0))):
            what = f"path 7 {tuple(v.shape)} nperseg={args[0]} hop={args[1]} nfft={args[2]}"
            worst = max(worst, welch_case(kind, v, u, w, args, what, with_oracle=False,
                                          opts=opts))
            cases += 1
        del x, y, xb, xp, xs, x8, xt
        torch.cuda.synchronize()
        names = ("welch", "psd", "csd", "coh", "c2c", "c2c_c64", "spec", "spec_c64", "spec_c2c",
                 "spec_c2c_c64")
        print(f"kernel {', '.join(names)}: {cases} cases ok, each run twice with the "
              f"same bits | worst rel-L2 {worst:.3e} | max abs err vs plain "
              + ", ".join(f"{max_abs[k]:.3e}" for k in names), flush=True)

    welch_sweep()

    # ---- 3. main path at users' sizes ------------------------------------
    errs = {}

    two_pass = {"ax0_fft": 1, "rows_t_fft": 1}
    # a complex64 tensor along its last axis: the complex64 entry, no split
    row, whole = {"rows_fft": 1, "rows_fft_c64": 1}, {"big_fft": 1, "big_fft_c64": 1}
    reset_counts()  # path 1: the 1-D main path and large N

    x = crand(4096, 4096)  # BASELINE config 2: 128 MiB of complex64
    p = ft.plan(4096)
    X = through("plan(4096).forward", lambda: p.forward(x), **row)
    errs["plan4096_fwd"] = check_close(X, torch.fft.fft(x), "plan(4096).forward")
    xi = through("plan(4096).inverse", lambda: p.inverse(X), **row)
    errs["plan4096_roundtrip"] = check_close(xi, x, "plan(4096) inverse round trip")
    xu = through("plan(4096).inverse_unnormalized",
                 lambda: p.inverse_unnormalized(X), **row)
    errs["plan4096_onlyinv_norm"] = check_close(
        p.normalize(xu), x, "plan(4096) inverse_unnormalized + normalize")
    X0 = through("plan(4096).forward axis=0", lambda: p.forward(x, axis=0), ax0_fft=1,
                 ax0_fft_c64=1)
    errs["plan4096_axis0"] = check_close(X0, torch.fft.fft(x, dim=0),
                                         "plan(4096).forward(axis=0)")
    del x, X, xi, xu, X0

    x = crand(2500, 512)  # the README quick-start shape
    X = through("fft 2500x512", lambda: ft.fft(x), **row)
    errs["fft_2500x512"] = check_close(X, torch.fft.fft(x), "fft 2500x512")
    errs["ifft_2500x512"] = check_close(
        through("ifft 2500x512", lambda: ft.ifft(X), **row), x, "ifft 2500x512")
    Xf = through("Forward(512).proc", lambda: ft.Forward(512).proc(x), **row)
    errs["Forward512"] = check_close(Xf, torch.fft.fft(x), "Forward(512).proc")

    x1 = crand(1, 1024)  # BASELINE config 1, against the f64 naive DFT
    X1 = through("fft 1x1024", lambda: ft.fft(x1), **row)
    want = torch.from_numpy(ft.naive_dft(x1.cpu().numpy()))
    errs["fft_1x1024_naive"] = check_close(X1.cpu(), want, "fft 1x1024 vs naive_dft")

    n = 1 << 22  # BASELINE config 3: 32 MiB of complex64, via four-step
    x = crand(1, n)
    p = ft.plan(n)
    X = through("plan(2^22).forward", lambda: p.forward(x), **two_pass)
    errs["plan2^22_fwd"] = check_close(X, torch.fft.fft(x), "plan(2^22).forward")
    errs["plan2^22_roundtrip"] = check_close(
        through("plan(2^22).inverse", lambda: p.inverse(X), **two_pass), x,
        "plan(2^22) inverse round trip")
    xu = through("plan(2^22).inverse_unnormalized",
                 lambda: p.inverse_unnormalized(X), **two_pass)
    errs["plan2^22_onlyinv_norm"] = check_close(
        p.normalize(xu), x, "plan(2^22) inverse_unnormalized + normalize")
    del x, X, xu
    for rows, e, kernels in ((4, 22, two_pass), (1, 20, two_pass),
                             (256, 16, whole), (1, 17, whole)):
        x = crand(rows, 1 << e)
        X = through(f"fft {rows}x2^{e}", lambda: ft.fft(x), **kernels)
        errs[f"fft_{rows}x2^{e}"] = check_close(X, torch.fft.fft(x), f"fft {rows}x2^{e}")
        errs[f"ifft_{rows}x2^{e}"] = check_close(
            through(f"ifft {rows}x2^{e}", lambda: ft.ifft(X), **kernels), x,
            f"ifft {rows}x2^{e}")
        del x, X
    try:
        ft.fft(crand(1, bigfft.BIG_MAX_N * 2), executor="bigfft")
    except bigfft.Unsupported:
        pass
    else:
        raise RuntimeError("check failed: executor='bigfft' beyond its envelope "
                           "did not raise Unsupported")
    path1 = counts()
    for name in ("rows_fft", "rows_fft_c64", "ax0_fft", "rows_t_fft", "big_fft", "big_fft_c64"):
        check(path1[name] > 0, f"1-D main path launched no {name} kernel")
    print(f"main: 1-D path, {len(errs)} checks ok, launches {path1} | "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)

    # path 2: BASELINE config 4, 2-D 4096 x 4096 + R2C/C2R, and 3-D 256^3 and
    # 512^3; complex64 planes and rfft run the kernels' complex64 entries
    errs = {}
    reset_counts()
    x = crand(4096, 4096)  # 128 MiB of complex64
    c2d = {"rows_fft": 1, "rows_fft_c64": 1, "ax0_fft": 1, "ax0_fft_c64": 1}
    X = through("fft2 4096^2", lambda: ft.fft2(x), **c2d)
    errs["fft2_4096"] = check_close(X, torch.fft.fft2(x), "fft2 4096^2")
    errs["ifft2_4096"] = check_close(
        through("ifft2 4096^2", lambda: ft.ifft2(X), **c2d), x, "ifft2 4096^2 round trip")
    del x, X
    r = torch.randn(4096, 4096, device=dev, generator=gen)
    R = through("rfft 4096^2", lambda: ft.rfft(r), r2c_fft=1, r2c_fft_c64=1)
    check(R.dtype == torch.complex64 and R.shape == (4096, 2049), "rfft 4096^2: its output")
    errs["rfft_4096"] = check_close(R, torch.fft.rfft(r), "rfft 4096^2")
    # irfft of complex64: c2r_fft's complex64 source on the tensor as it lies
    back = through("irfft 4096^2", lambda: ft.irfft(R), c2r_fft=1, c2r_fft_c64=1)
    errs["irfft_4096"] = check_close(back, r, "irfft(rfft) 4096^2 round trip")
    errs["irfft_4096_torch"] = check_close(back, torch.fft.irfft(R), "irfft 4096^2")
    R = through("rfft2 4096^2", lambda: ft.rfft2(r), r2c_fft=1, ax0_fft=1)
    errs["rfft2_4096"] = check_close(R, torch.fft.rfft2(r), "rfft2 4096^2")
    # irfft2 of complex64: axis 0 through ax0_fft's complex64 entry, then
    # c2r_fft's complex64 source; no split, no merge
    back = through("irfft2 4096^2", lambda: ft.irfft2(R, s=r.shape), ax0_fft=1,
                   ax0_fft_c64=1, c2r_fft=1, c2r_fft_c64=1)
    errs["irfft2_4096"] = check_close(back, r, "irfft2(rfft2) 4096^2 round trip")
    errs["irfft2_4096_torch"] = check_close(back, torch.fft.irfft2(R, s=r.shape),
                                            "irfft2 4096^2")
    del r, R, back
    x = crand(256, 256, 256)  # 128 MiB: fused plane over axes 1-2, then axis 0,
    # both through their complex64 entries
    c3d = {"fft2f_fft": 1, "fft2f_fft_c64": 1, "ax3_fft": 1, "ax3_fft_c64": 1}
    X = through("fftn 256^3", lambda: ft.fftn(x), **c3d)
    errs["fftn_256^3"] = check_close(X, torch.fft.fftn(x), "fftn 256^3")
    errs["ifftn_256^3"] = check_close(
        through("ifftn 256^3", lambda: ft.ifftn(X), **c3d), x, "ifftn 256^3 round trip")
    del x, X
    x = crand(512, 512, 512)  # 1 GiB: planes outside the fused envelope, per axis
    X = through("fftn 512^3", lambda: ft.fftn(x), rows_fft=1, rows_fft_c64=1, ax0_fft=1,
                ax0_fft_c64=1, ax3_fft=1, ax3_fft_c64=1)
    errs["fftn_512^3"] = check_close(X, torch.fft.fftn(x), "fftn 512^3")
    del x, X
    path2 = counts()
    for name in ("rows_fft", "ax0_fft", "ax3_fft", "fft2f_fft", "r2c_fft", "c2r_fft",
                 "rows_fft_c64", "ax0_fft_c64", "ax3_fft_c64", "fft2f_fft_c64", "r2c_fft_c64",
                 "c2r_fft_c64"):
        check(path2[name] > 0, f"config 4 path launched no {name} kernel")
    # small inputs against float64 numpy on the host, through the same
    # kernels, outside config 4's count window
    xs = crand(8, 128, 256)
    want = np.fft.fftn(xs.cpu().numpy().astype(np.complex128), axes=(1, 2))
    got = through("fftn 8x128x256", lambda: ft.fftn(xs, axes=(1, 2)), fft2f_fft=1,
                  fft2f_fft_c64=1)
    errs["fftn_small_np"] = check_close(got.cpu(), torch.from_numpy(want), "fftn vs numpy")
    rs = torch.randn(128, 128, 256, device=dev, generator=gen)
    want = np.fft.rfftn(rs.cpu().numpy().astype(np.float64))
    got = through("rfftn 128x128x256", lambda: ft.rfftn(rs), r2c_fft=1, ax3_fft=1,
                  ax0_fft=1)
    errs["rfftn_small_np"] = check_close(got.cpu(), torch.from_numpy(want), "rfftn vs numpy")
    print(f"main: config 4 path, {len(errs)} checks ok, launches {path2} | "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)

    # path 3: non-pow2 lengths at the sizes of the JAX package's benchmark
    # rows (bench.py: composite 4095, 4097 and 1000, Bluestein 4093 and 4097)
    errs = {}
    reset_counts()
    gen1, chirp = {"gen_fft": 1}, {"chirp_full": 1}
    for rows, n in ((1024, 4095), (1024, 4097), (2048, 1000)):
        x = crand(rows, n)
        X = through(f"fft {rows}x{n}", lambda: ft.fft(x), **gen1)
        errs[f"fft_{n}"] = check_close(X, torch.fft.fft(x), f"fft {rows}x{n}")
        errs[f"ifft_{n}"] = check_close(through(f"ifft {rows}x{n}", lambda: ft.ifft(X), **gen1),
                                        x, f"ifft {rows}x{n} round trip")
        p = ft.plan(n)
        errs[f"plan_fwd_{n}"] = check_close(
            through(f"plan({n}).forward", lambda: p.forward(x), **gen1), torch.fft.fft(x),
            f"plan({n}).forward")
        errs[f"plan_inv_{n}"] = check_close(
            through(f"plan({n}).inverse", lambda: p.inverse(X), **gen1), x,
            f"plan({n}).inverse")
        xu = through(f"plan({n}).inverse_unnormalized", lambda: p.inverse_unnormalized(X),
                     **gen1)
        errs[f"plan_onlyinv_{n}"] = check_close(p.normalize(xu), x,
                                                f"plan({n}) inverse_unnormalized + normalize")
        del x, X, xu
    x = crand(1024, 4093)  # prime: Bluestein, m = 8192
    X = through("fft 1024x4093", lambda: ft.fft(x), **chirp)
    errs["fft_4093"] = check_close(X, torch.fft.fft(x), "fft 1024x4093")
    errs["ifft_4093"] = check_close(through("ifft 1024x4093", lambda: ft.ifft(X), **chirp),
                                    x, "ifft 1024x4093 round trip")
    # the JAX package's two passes (its Bluestein's route), public entry points
    (cr, ci, bfr, bfi), m = bluestein._chirp_tables(4093, -1, dev)
    A = through("fft_chirp_forward_split 1024x4093", lambda: cuda_fft.fft_chirp_forward_split(
        *planes(x), cr, ci, m, -1), chirp_fwd=1)
    Y = through("fft_chirp_inverse_split 1024x8192", lambda: torch.complex(
        *cuda_fft.fft_chirp_inverse_split(*A, bfr, bfi, cr, ci, 4093, 1, 1.0 / m)), chirp_inv=1)
    errs["chirp_pair_4093"] = check_close(Y, torch.fft.fft(x),
                                          "fft_chirp_forward_split + inverse 1024x4093")
    del A, Y
    x = crand(1024, 4097)  # a direct call: m = 16384
    Y = through("fft_bluestein_split 1024x4097",
                lambda: torch.complex(*bluestein.fft_bluestein_split(*planes(x), -1)), **chirp)
    errs["bluestein_4097"] = check_close(Y, torch.fft.fft(x), "fft_bluestein_split 1024x4097")
    del x, X, Y
    for rows, n in ((1024, 1000), (1024, 4095)):  # even composite, and odd
        r = torch.randn(rows, n, device=dev, generator=gen)
        R = through(f"rfft {rows}x{n}", lambda: ft.rfft(r), r2c_gen_fft=1)
        errs[f"rfft_{n}"] = check_close(R, torch.fft.rfft(r), f"rfft {rows}x{n}")
    # odd n: the Hermitian extension, then the composite C2C
    back = through("irfft 1024x4095", lambda: ft.irfft(R, n=4095), **gen1)
    errs["irfft_4095"] = check_close(back, r, "irfft(rfft) 1024x4095 round trip")
    del r, R, back
    x = crand(1024, 4096)  # 1024 bins of a band of 1024 signals: L = 8192
    zf = ft.ZoomFFT(4096, [0.1, 0.35], m=1024)
    Z = through("ZoomFFT 1024x4096 m=1024", lambda: zf(x), **chirp)
    w, a = zf.w, zf.a
    Zc = through("czt 1024x4096 m=1024", lambda: ft.czt(x, m=1024, w=w, a=a), **chirp)
    # the direct sum in float64: X[k] = sum_j x[j] a^-j w^(jk)
    j = torch.arange(4096, device=dev, dtype=torch.float64)
    k = torch.arange(1024, device=dev, dtype=torch.float64)
    E = torch.exp(-j[:, None] * complex(np.log(a)) + (j[:, None] * k[None, :]) * complex(np.log(w)))
    want = x.to(torch.complex128) @ E
    errs["zoomfft_4096"] = check_close(Z, want, "ZoomFFT 1024x4096 vs float64 direct sum")
    errs["czt_4096"] = check_close(Zc, want, "czt 1024x4096 vs float64 direct sum")
    del x, Z, Zc, E, want
    path3 = counts()
    for name in ("gen_fft", "r2c_gen_fft", "chirp_fwd", "chirp_inv", "chirp_full"):
        check(path3[name] > 0, f"non-pow2 path launched no {name} kernel")
    # outside the window: small inputs against float64 numpy, numpy input
    xs = crand(5, 1031)
    want = np.fft.fft(xs.cpu().numpy().astype(np.complex128))
    got = through("fft 5x1031", lambda: ft.fft(xs), **chirp)
    errs["fft_1031_np"] = check_close(got.cpu(), torch.from_numpy(want), "fft 5x1031 vs numpy")
    rs = torch.randn(5, 1005, device=dev, generator=gen)
    want = np.fft.rfft(rs.cpu().numpy().astype(np.float64))
    got = through("rfft 5x1005", lambda: ft.rfft(rs), r2c_gen_fft=1)
    errs["rfft_1005_np"] = check_close(got.cpu(), torch.from_numpy(want), "rfft 5x1005 vs numpy")
    xn = crand(64, 4096).cpu().numpy()
    got = through("fft of a numpy array 64x4096", lambda: ft.fft(xn), rows_fft=1)
    check(got.device.type == "cuda", f"numpy input ran on {got.device}, not the card")
    errs["fft_numpy_in"] = check_close(got.cpu(), torch.from_numpy(np.fft.fft(xn)),
                                       "fft of a numpy array vs numpy")
    print(f"main: non-pow2 path, {len(errs)} checks ok, launches {path3} | "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)

    # path 5: the fused epilogues at the sizes of the JAX package's records
    # (bench.py's fused filter 4096 x 4096, PERFORMANCE.md's product C2R at
    # 2048 x 8192 and oaconvolve of 2^20 samples with 129 taps) and
    # composite 2-D frames (16 x 1080 x 1920)
    errs = {}
    x = crand(4096, 4096)
    H = crand(4096)
    sf = ft.SpectralFilter(H, 4096)
    r = torch.randn(4096, 4096, device=dev, generator=gen)
    a2, b2 = (torch.randn(2048, 4096, device=dev, generator=gen) for _ in range(2))
    sig, taps = (torch.randn(n, device=dev, generator=gen) for n in (1 << 20, 129))
    widths = np.arange(1, 129)
    cw = ft.CWT(8192, widths, device=dev)  # builds the bank spectrum: outside the window
    s8k = torch.randn(8192, device=dev, generator=gen)
    fr = crand(16, 1080, 1920)
    reset_counts()
    # complex64 in: the complex64 entries of the row and filtered kernels,
    # real in: the R2C kernel's complex64 sink and the filtered kernel's
    # complex64 entry on its n/2 + 1 bins; no split, no merge
    Y = through("SpectralFilter 4096^2", lambda: sf(x), rows_fft=1, rows_fft_c64=1, filt=1,
                filt_c64=1)
    errs["spectral_filter_4096"] = check_close(Y, torch.fft.ifft(torch.fft.fft(x) * H),
                                               "SpectralFilter 4096^2")
    Z = through("hilbert 4096^2", lambda: ft.hilbert(r), r2c_fft=1, r2c_fft_c64=1, filt=1,
                filt_c64=1)
    hw = torch.zeros(4096, device=dev)
    hw[0] = hw[2048] = 1.0
    hw[1:2048] = 2.0
    errs["hilbert_4096"] = check_close(Z, torch.fft.ifft(torch.fft.fft(r.double()) * hw),
                                       "hilbert 4096^2 vs float64")
    C = through("fftconvolve 2048x4096", lambda: ft.fftconvolve(a2, b2, axes=-1),
                r2c_fft=2, c2r_prod=1)
    want = torch.fft.irfft(torch.fft.rfft(a2.double(), n=8192)
                           * torch.fft.rfft(b2.double(), n=8192), n=8192)[:, :8191]
    errs["fftconvolve_2048x4096"] = check_close(C, want, "fftconvolve 2048x4096 vs float64")
    O = through("oaconvolve 2^20 x 129", lambda: ft.oaconvolve(sig, taps),
                r2c_fft=2, c2r_prod=1)
    L = 1 << 21
    want = torch.fft.irfft(torch.fft.rfft(sig.double(), n=L) * torch.fft.rfft(taps.double(), n=L),
                           n=L)[:(1 << 20) + 128]
    errs["oaconvolve_2^20x129"] = check_close(O, want, "oaconvolve 2^20 x 129 vs float64")
    W = through("CWT(8192, 1..128)", lambda: cw(s8k), rows_fft=1, bank=1)
    bank, lmax, _ = cwt_mod._build_bank(8192, widths, "ricker", None)
    full = torch.fft.ifft(torch.fft.fft(s8k.double(), n=cw.nfft)
                          * torch.fft.fft(torch.from_numpy(bank).to(dev), n=cw.nfft))
    want = full.real[:, (lmax - 1) // 2:(lmax - 1) // 2 + 8192]
    errs["cwt_8192x128"] = check_close(W, want, "CWT(8192, 1..128) vs float64")
    F = through("fft2 16x1080x1920", lambda: ft.fft2(fr), gen_fft=1, ax0_gen=1)
    errs["fft2_1080x1920"] = check_close(F, torch.fft.fft2(fr), "fft2 16x1080x1920")
    errs["ifft2_1080x1920"] = check_close(
        through("ifft2 16x1080x1920", lambda: ft.ifft2(F), gen_fft=1, ax0_gen=1), fr,
        "ifft2 16x1080x1920 round trip")
    path5 = counts()
    for name in ("filt", "filt_c64", "bank", "c2r_prod", "ax0_gen"):
        check(path5[name] > 0, f"fused-epilogue path launched no {name} kernel")
    del x, Y, r, Z, a2, b2, C, sig, O, W, full, F, want
    # outside the window: small inputs against float64 numpy
    xs = torch.randn(3, 1000, 5, device=dev, generator=gen)
    want = np.fft.fft(xs.cpu().numpy().astype(np.float64), axis=1)
    got = through("fft 3x1000x5 axis=1", lambda: ft.fft(xs, axis=1), ax0_gen=1)
    errs["fft_axis1_1000_np"] = check_close(got.cpu(), torch.from_numpy(want),
                                            "fft 3x1000x5 axis=1 vs numpy")
    a1, b1 = (torch.randn(5, n, device=dev, generator=gen) for n in (700, 90))
    want = np.stack([np.convolve(u, v) for u, v in zip(a1.cpu().double().numpy(),
                                                       b1.cpu().double().numpy())])
    got = through("fftconvolve 5x700 * 5x90", lambda: ft.fftconvolve(a1, b1, axes=-1),
                  r2c_fft=2, c2r_prod=1)
    errs["fftconvolve_small_np"] = check_close(got.cpu(), torch.from_numpy(want),
                                               "fftconvolve 5x700 vs numpy")
    print(f"main: fused-epilogue path, {len(errs)} checks ok, launches {path5} | "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    # path 6: the spectral estimators at the sizes of the JAX package's
    # records (bench.py and PERFORMANCE.md: welch of 2^22 samples at nperseg
    # 4096, hop 2048) and at scipy's defaults over 64 channels of 2^20
    import scipy.signal as ss

    errs = {}
    n22 = 1 << 22
    x, y = (torch.randn(n22, device=dev, generator=gen) for _ in range(2))
    xb = torch.randn(64, 1 << 20, device=dev, generator=gen)
    xp = torch.randn(64, 16384, device=dev, generator=gen)
    xm = torch.randn(16384, device=dev, generator=gen)
    xc = crand(n22)
    x64, y64 = x.cpu().double().numpy(), y.cpu().double().numpy()
    seg = {"nperseg": 4096, "noverlap": 2048}

    def vs_scipy(key, got, want, what):
        errs[key] = check_close(got.cpu(), torch.from_numpy(np.asarray(want)),
                                f"{what} vs scipy.signal float64")

    reset_counts()
    P = through("welch 2^22 nperseg 4096", lambda: ft.welch(x, **seg)[1], welch=1)
    vs_scipy("welch_2^22", P, ss.welch(x64, **seg)[1], "welch 2^22")
    P = through("welch 64x2^20 scipy defaults", lambda: ft.welch(xb)[1], welch=1)
    vs_scipy("welch_64x2^20", P, ss.welch(xb.cpu().double().numpy())[1], "welch 64x2^20")
    del P
    P = through("welch 2^22 median", lambda: ft.welch(x, average="median", **seg)[1], psd=1)
    vs_scipy("welch_median_2^22", P, ss.welch(x64, average="median", **seg)[1],
             "welch median 2^22")
    P = through("csd 2^22", lambda: ft.csd(x, y, **seg)[1], csd=1)
    vs_scipy("csd_2^22", P, ss.csd(x64, y64, **seg)[1], "csd 2^22")
    # two independent signals at many segments: the transform's rounding bias
    # in conj(X) Y grows as the segment count, the cross spectrum as its root
    P = through("csd 2^22 nperseg 256", lambda: ft.csd(x, y, nperseg=256)[1], csd=1)
    vs_scipy("csd_2^22_nperseg_256", P, ss.csd(x64, y64, nperseg=256)[1],
             "csd 2^22 nperseg 256 (32767 segments)")
    C = through("coherence 2^22", lambda: ft.coherence(x, y, **seg)[1], coh=1)
    vs_scipy("coherence_2^22", C, ss.coherence(x64, y64, **seg)[1], "coherence 2^22")
    for mode in ("psd", "magnitude"):
        f, t, S = through(f"spectrogram 2^22 {mode}",
                          lambda: ft.spectrogram(x, nperseg=4096, mode=mode), psd=1)
        fs_, ts_, Ss = ss.spectrogram(x64, nperseg=4096, mode=mode)
        vs_scipy(f"spectrogram_{mode}_2^22", S, Ss, f"spectrogram 2^22 {mode}")
        check(f.device.type == "cuda" and S.device.type == "cuda",
              "spectrogram outputs left the card")
        errs[f"spectrogram_t_{mode}"] = check_close(t.cpu().double(), torch.from_numpy(ts_),
                                                    "spectrogram segment times")
        del S, Ss
    P = through("periodogram 64x16384", lambda: ft.periodogram(xp)[1], welch=1)
    vs_scipy("periodogram_64x16384", P, ss.periodogram(xp.cpu().double().numpy())[1],
             "periodogram 64x16384")
    f, P = through("multitaper 16384 K=7", lambda: ft.multitaper(xm, NW=4.0, K=7), r2c_fft=1)
    errs["multitaper_16384"] = check_close(
        P.cpu().double(), torch.from_numpy(multitaper_ref(xm.cpu().double().numpy(), 4.0, 7)),
        "multitaper 16384 K=7 vs float64 numpy")
    with warnings.catch_warnings():  # scipy: complex input, two-sided
        warnings.simplefilter("ignore")
        want = ss.welch(xc.cpu().numpy().astype(np.complex128), **seg)[1]
    P = through("welch 2^22 complex (two-sided)", lambda: ft.welch(xc, **seg)[1], c2c=1,
                c2c_c64=1)
    vs_scipy("welch_complex_2^22", P, want, "welch 2^22 complex two-sided")
    P = through("welch 2^22 real two-sided",
                lambda: ft.welch(x, return_onesided=False, **seg)[1], c2c=1, c2c_c64=1)
    vs_scipy("welch_real_two-sided_2^22", P, ss.welch(x64, return_onesided=False, **seg)[1],
             "welch 2^22 real two-sided")
    path6 = counts()
    for name in ("welch", "psd", "csd", "coh", "c2c", "c2c_c64"):
        check(path6[name] > 0, f"spectral-estimator path launched no {name} kernel")
    del x, y, xb, xp, xc, P, C, want
    # outside the window: numpy input runs on the card
    xn = np.random.default_rng(SEED).standard_normal(5000)
    f, P = through("welch of a numpy array", lambda: ft.welch(xn, nperseg=512), welch=1)
    check(P.device.type == "cuda" and f.device.type == "cuda",
          f"numpy input ran on {P.device}, not the card")
    vs_scipy("welch_numpy_in", P, ss.welch(xn.astype(np.float32).astype(np.float64),
                                           nperseg=512)[1], "welch of a numpy array")
    print(f"main: spectral-estimator path, {len(errs)} checks ok, launches {path6} | "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)

    # path 7: the per-segment spectra at the sizes of the JAX package's
    # records (BENCHMARKS.md:163: stft of 2^20 samples at n_fft 512, hop 128;
    # PERFORMANCE.md:844-850: the spectrogram of 2^22 at nperseg 4096) and a
    # ShortTimeFFT of 48 kHz audio, each call against float64 numpy or
    # scipy.signal
    from numpy.lib.stride_tricks import sliding_window_view

    errs = {}
    x20 = torch.randn(1 << 20, device=dev, generator=gen)
    x8 = torch.randn(8, 1 << 17, device=dev, generator=gen)
    x = torch.randn(n22, device=dev, generator=gen)
    xc, yc = crand(n22), crand(n22)
    x64, xc64, yc64 = (v.cpu().numpy().astype(np.complex128 if v.is_complex() else np.float64)
                       for v in (x, xc, yc))
    hann512 = np.hanning(513)[:512]  # the periodic hann window, as ft.hann_window(512)

    def stft_ref(v):
        """float64 numpy stft: reflect pad, frames, window, rfft."""
        v = np.pad(v.cpu().double().numpy(), [(0, 0)] * (v.ndim - 1) + [(256, 256)],
                   mode="reflect")
        frames = sliding_window_view(v, 512, axis=-1)[..., ::128, :]
        return np.swapaxes(np.fft.rfft(frames * hann512, axis=-1), -1, -2)

    reset_counts()
    spec = {"spec": 1, "spec_c64": 1}  # B20's complex64 sink: no merge
    for key, v in (("stft_2^20", x20), ("stft_8x2^17", x8)):
        Z = through(f"stft {tuple(v.shape)} n_fft 512 hop 128",
                    lambda: ft.stft(v, 512, 128), **spec)
        vs_scipy(key, Z, stft_ref(v), f"stft {tuple(v.shape)} (float64 numpy)")
        back = through(f"istft {tuple(v.shape)}",
                       lambda: ft.istft(Z, 512, 128, length=v.shape[-1]), c2r_fft=1)
        errs[f"i{key}"] = check_close(back, v, f"istft(stft) {tuple(v.shape)} round trip")
    del Z, back
    seg = {"nperseg": 4096, "noverlap": 2048}
    f, t, S = through("spectrogram 2^22 complex",
                      lambda: ft.spectrogram(x, mode="complex", **seg), **spec)
    vs_scipy("spectrogram_complex_2^22", S, ss.spectrogram(x64, mode="complex", **seg)[2],
             "spectrogram 2^22 complex")
    with warnings.catch_warnings():  # scipy: complex input, two-sided
        warnings.simplefilter("ignore")
        for mode in ("psd", "complex"):  # B22's complex64 source and sink
            f, t, S = through(f"spectrogram 2^22 complex input {mode}",
                              lambda: ft.spectrogram(xc, mode=mode, **seg), spec_c2c=1,
                              spec_c2c_c64=1)
            vs_scipy(f"spectrogram_two_sided_{mode}_2^22", S,
                     ss.spectrogram(xc64, mode=mode, **seg)[2],
                     f"spectrogram 2^22 two-sided {mode}")
            del S
        P = through("csd 2^22 complex", lambda: ft.csd(xc, yc, **seg)[1], spec_c2c=2,
                    spec_c2c_c64=2)
        vs_scipy("csd_complex_2^22", P, ss.csd(xc64, yc64, **seg)[1], "csd 2^22 complex")
    del P
    hann1024 = ss.windows.hann(1024, sym=False)
    x20_64 = x20.cpu().double().numpy()
    for mfft in (1024, 2048):
        stf = ft.ShortTimeFFT(hann1024, 256, 48000.0, mfft=mfft)
        S = through(f"ShortTimeFFT 2^20 mfft {mfft}", lambda: stf.stft(x20), **spec)
        ref = ss.ShortTimeFFT(hann1024, 256, 48000.0, mfft=mfft)
        vs_scipy(f"short_time_fft_{mfft}", S, ref.stft(x20_64), f"ShortTimeFFT mfft {mfft}")
        if mfft == 1024:
            back = through("ShortTimeFFT.istft 2^20",
                           lambda: stf.istft(S, k1=1 << 20), c2r_fft=1)
            errs["short_time_fft_istft"] = check_close(back, x20,
                                                       "ShortTimeFFT istft round trip")
        del S
    xr = torch.randn(256, 8192, device=dev, generator=gen)
    xr64 = xr.cpu().double().numpy()
    resample_launches = {}
    for num in (16384, 6144):
        before = counts()
        R = ft.resample(xr, num, axis=-1)
        torch.cuda.synchronize()
        resample_launches[num] = {k: v - before[k] for k, v in counts().items()
                                  if v != before[k]}
        check(not any(k in resample_launches[num] for k in ("spec", "spec_c2c", "welch")),
              f"resample to {num} launched a segment-spectrum kernel")
        vs_scipy(f"resample_256x8192_to_{num}", R, ss.resample(xr64, num, axis=-1),
                 f"resample 256x8192 to {num}")
    del R
    path7 = counts()
    for name in ("spec", "spec_c64", "spec_c2c", "spec_c2c_c64"):
        check(path7[name] > 0, f"per-segment path launched no {name} kernel")
    # outside the window: numpy input runs on the card
    Zn = through("stft of a numpy array", lambda: ft.stft(x20.cpu().numpy()[:8192], 512, 128),
                 **spec)
    check(Zn.device.type == "cuda", f"numpy input ran on {Zn.device}, not the card")
    vs_scipy("stft_numpy_in", Zn, stft_ref(x20[:8192]), "stft of a numpy array")
    print(f"main: per-segment path, {len(errs)} checks ok, launches {path7}, resample "
          f"launches {resample_launches} | "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    del x20, x8, x, xc, yc, x64, xc64, yc64, x20_64, xr, xr64, Zn
    long_tail(ft, dev, gen, smi)  # path 8
    # The kernels line gives each kernel the launches of the path it was
    # ported for (the 1-D path for B1, B2, B4 and B15, the non-pow2 path for
    # B11-B14 and chirp_full, the fused-epilogue path for B8-B10 and
    # B2-composite, the estimators' path for B16-B19 and B21, the
    # per-segment path for B20 and B22, config 4 for the rest); each path's
    # counts are on its line.
    path_of = {"rows_fft": path1, "rows_fft_c64": path1, "ax0_fft": path1, "rows_t_fft": path1,
               "big_fft": path1, "big_fft_c64": path1,
               "gen_fft": path3, "r2c_gen_fft": path3, "chirp_fwd": path3,
               "chirp_inv": path3, "chirp_full": path3, "filt": path5, "filt_c64": path5,
               "bank": path5,
               "c2r_prod": path5,
               "ax0_gen": path5, "welch": path6, "psd": path6, "csd": path6, "coh": path6,
               "c2c": path6, "c2c_c64": path6, "spec": path7, "spec_c64": path7, "spec_c2c": path7,
               "spec_c2c_c64": path7}
    main_launches = {k: path_of.get(k, path2)[k] for k in KERNELS}

    # ---- 4. autograd on the card -----------------------------------------
    def grads(transform, shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        re = torch.randn(shape, device=dev, generator=g).requires_grad_()
        im = torch.randn(shape, device=dev, generator=g).requires_grad_()
        w = torch.rand(shape, device=dev, generator=g)
        yr, yi = transform(re, im)
        (w * (yr * yr + yi * yi)).sum().backward()
        return torch.complex(re.grad, im.grad)

    def via_fft(a, b):
        y = ft.fft(torch.complex(a, b))
        return y.real, y.imag

    def plain(a, b):
        return stockham.fft_last_axis(a, b, -1)

    gerrs = {}
    # fft of complex64: the complex64 entries forward and back; the planar
    # entries of the row and whole-row kernels called directly
    for what, shape, transform, kernels in (
            ("", (64, 4096), via_fft, {"rows_fft": 2, "rows_fft_c64": 2}),
            ("", (2, 1 << 20), via_fft, {"ax0_fft": 2, "rows_t_fft": 1, "rows_fft": 1}),
            ("", (4, 1 << 16), via_fft, {"big_fft": 2, "big_fft_c64": 2}),
            (" planar", (64, 4096), lambda a, b: cuda_fft.fft_batched_split(a, b, -1),
             {"rows_fft": 2}),
            (" planar", (4, 1 << 16), lambda a, b: bigfft.fft_big_split(a, b, -1),
             {"big_fft": 2})):
        gk = through(f"grad {shape}{what}", lambda: grads(transform, shape, SEED + 1),
                     **kernels)
        gp = grads(plain, shape, SEED + 1)
        gerrs[f"{shape[0]}x{shape[1]}{what}"] = check_close(
            gk, gp, f"grad of sum(w*|fft(x)|^2) {shape}{what} kernels vs plain")

    def grads_nd(fn, shape, seed, device):
        """d/dx of sum(w*|fn(x)|^2) for a real (rfft2, rfft) or complex input x."""
        g = torch.Generator().manual_seed(seed)
        a = torch.randn(shape, generator=g).to(device).requires_grad_()
        b = torch.randn(shape, generator=g).to(device).requires_grad_()
        y = fn(a) if fn in (ft.rfft2, ft.rfft) else fn(torch.complex(a, b))
        w = torch.rand(y.shape, generator=g).to(device)
        (w * y.abs() ** 2).sum().backward()
        return a.grad if b.grad is None else torch.complex(a.grad, b.grad)

    # rfft2: R2C, axis(-2); back: axis(-2), the row kernel.  Batched fft2
    # (16 planes): the fused plane forward and back.  fft2 of one complex64
    # plane: the row and axis(-2) kernels' complex64 entries forward and
    # back; rfft at 4096: the R2C kernel's complex64 sink, back the row
    # kernel's complex64 entry; irfft of complex64 at 4096: the C2R kernel's
    # complex64 source, back the R2C kernel's complex64 sink.  Non-pow2 fft: the
    # composite kernel forward and back (4095); the fused chirp kernel
    # forward and back (prime 4093).  rfft at 1005: the composite R2C
    # forward, the composite C2C back.
    for fn, shape, kernels in ((ft.rfft2, (256, 1024), {"r2c_fft": 1, "ax0_fft": 2,
                                                       "rows_fft": 1}),
                               (ft.fft2, (16, 256, 256), {"fft2f_fft": 2,
                                                          "fft2f_fft_c64": 2}),
                               (ft.fft2, (256, 1024), {"rows_fft": 2, "rows_fft_c64": 2,
                                                       "ax0_fft": 2, "ax0_fft_c64": 2}),
                               (ft.rfft, (64, 4096), {"r2c_fft": 1, "r2c_fft_c64": 1,
                                                      "rows_fft": 1, "rows_fft_c64": 1}),
                               (ft.irfft, (64, 2049), {"c2r_fft": 1, "c2r_fft_c64": 1,
                                                       "r2c_fft": 1, "r2c_fft_c64": 1}),
                               (ft.fft, (64, 4095), {"gen_fft": 2}),
                               (ft.fft, (64, 4093), {"chirp_full": 2}),
                               (ft.rfft, (64, 1005), {"r2c_gen_fft": 1, "gen_fft": 1})):
        gk = through(f"grad {fn.__name__} {shape}",
                     lambda: grads_nd(fn, shape, SEED + 2, dev), **kernels)
        gp = grads_nd(fn, shape, SEED + 2, torch.device("cpu"))  # the plain path
        gerrs[f"{fn.__name__} {shape}"] = check_close(
            gk.cpu(), gp, f"grad of sum(w*|{fn.__name__}(x)|^2) {shape} kernels vs plain")

    def grads_of(fn, shapes, seed, device, cplx):
        """d/d(inputs) of sum(w*|fn(*inputs)|^2), all inputs' gradients in
        one flat tensor; real or complex inputs made from ``seed``."""
        g = torch.Generator().manual_seed(seed)
        ins = []
        for shape in shapes:
            v = torch.randn(shape, generator=g)
            if cplx:
                v = torch.complex(v, torch.randn(shape, generator=g))
            ins.append(v.to(device).requires_grad_())
        y = fn(*ins)
        w = torch.rand(y.shape, generator=g).to(device)
        (w * y.abs() ** 2).sum().backward()
        return torch.cat([v.grad.reshape(-1) for v in ins])

    # the fused epilogues: SpectralFilter of complex64 (B1 and B9 forward,
    # the row kernel twice back, all through their complex64 entries), fftconvolve in both inputs (B6 twice and B8 forward; B6,
    # then B1 for each input, back), the CWT plan (B1 and B10 forward, B1
    # twice back; on the CPU its own nfft), fft2 of 1080 x 1920 (B2-composite
    # and B13 both ways)
    cw_cpu = ft.CWT(8192, widths, device="cpu")
    for what, fn, fn_cpu, shapes, cplx, kernels in (
            ("SpectralFilter 64x4096", sf, sf, [(64, 4096)], True,
             {"rows_fft": 3, "rows_fft_c64": 3, "filt": 1, "filt_c64": 1}),
            ("fftconvolve 64x1000 (both inputs)",
             lambda u, v: ft.fftconvolve(u, v, axes=-1), None,
             [(64, 1000), (64, 1000)], False, {"r2c_fft": 3, "c2r_prod": 1, "rows_fft": 2}),
            ("CWT(8192, 1..128)", cw, cw_cpu, [(8192,)], False, {"rows_fft": 3, "bank": 1}),
            ("fft2 1080x1920", ft.fft2, None, [(1080, 1920)], True,
             {"gen_fft": 2, "ax0_gen": 2})):
        gk = through(f"grad {what}", lambda: grads_of(fn, shapes, SEED + 3, dev, cplx),
                     **kernels)
        gp = grads_of(fn_cpu or fn, shapes, SEED + 3, torch.device("cpu"), cplx)
        gerrs[what] = check_close(gk.cpu(), gp, f"grad of sum(w*|f(x)|^2) {what} "
                                                "kernels vs plain")
    # the estimators and the per-segment spectra at 2^16 samples (nperseg
    # 256; stft n_fft 512; ShortTimeFFT mfft 512 with a phase shift): the
    # kernel forward; back, the frames rebuilt through B6 under autograd and
    # B1 for B6's adjoint, once per signal (complex input: B1 forward and
    # back)
    stf_grad = ft.ShortTimeFFT(np.hanning(256), 64, 1.0, mfft=512, phase_shift=30)
    # B20's complex64 sink forward; back, the R2C kernel's complex64 sink
    # and the row kernel's complex64 entry for its adjoint
    c64_spec = {"spec": 1, "spec_c64": 1, "r2c_fft": 1, "r2c_fft_c64": 1, "rows_fft": 1,
                "rows_fft_c64": 1}
    for what, fn, shapes, kernels, cplx in (
            ("welch 2^16", lambda u: ft.welch(u)[1], [(1 << 16,)],
             {"welch": 1, "r2c_fft": 1, "rows_fft": 1}, False),
            ("csd 2^16 (both inputs)", lambda u, v: ft.csd(u, v)[1], [(1 << 16,)] * 2,
             {"csd": 1, "r2c_fft": 2, "rows_fft": 2}, False),
            ("spectrogram 2^16 psd", lambda u: ft.spectrogram(u)[2], [(1 << 16,)],
             {"psd": 1, "r2c_fft": 1, "rows_fft": 1}, False),
            ("welch 2^16 complex (two-sided)", lambda u: ft.welch(u)[1], [(1 << 16,)],
             {"c2c": 1, "c2c_c64": 1, "rows_fft": 2, "rows_fft_c64": 2}, True),
            ("stft 2^16", lambda u: ft.stft(u, 512, 128), [(1 << 16,)], c64_spec, False),
            ("ShortTimeFFT.stft 2^16 phase shift", stf_grad.stft, [(1 << 16,)], c64_spec,
             False),
            ("spectrogram 2^16 complex two-sided",  # B22's complex64 sink, B1's entry
             lambda u: ft.spectrogram(u, mode="complex")[2], [(1 << 16,)],
             {"spec_c2c": 1, "spec_c2c_c64": 1, "rows_fft": 2, "rows_fft_c64": 2}, True)):
        gk = through(f"grad {what}", lambda: grads_of(fn, shapes, SEED + 4, dev, cplx),
                     **kernels)
        gp = grads_of(fn, shapes, SEED + 4, torch.device("cpu"), cplx)
        gerrs[what] = check_close(gk.cpu(), gp, f"grad of sum(w*|f(x)|^2) {what} "
                                                "kernels vs plain")
    # the transform long tail: dct type 2 (the row kernel forward and, for
    # its adjoint, back) and spectral_derivative (the R2C kernel's complex64
    # sink and the C2R kernel's complex64 source forward; back, the R2C
    # kernel's complex64 sink for the C2R's adjoint and the row kernel's
    # complex64 entry for the R2C's)
    for what, fn, kernels in (
            ("dct type 2 64x4096", lambda u: ft.dct(u, type=2), {"rows_fft": 2}),
            ("spectral_derivative 64x4096", ft.spectral_derivative,
             {"r2c_fft": 2, "r2c_fft_c64": 2, "c2r_fft": 1, "c2r_fft_c64": 1, "rows_fft": 1,
              "rows_fft_c64": 1})):
        gk = through(f"grad {what}", lambda: grads_of(fn, [(64, 4096)], SEED + 5, dev, False),
                     **kernels)
        gp = grads_of(fn, [(64, 4096)], SEED + 5, torch.device("cpu"), False)
        gerrs[what] = check_close(gk.cpu(), gp, f"grad of sum(w*|f(x)|^2) {what} "
                                                "kernels vs plain")
    # the signal-processing tail: nufft1d1 in its values (the spread, the
    # fine grid's row kernel forward; back, the row kernel and the gather)
    # and convolve2d in both inputs (the R2C and axis(-2) kernels for each
    # input and the axis(-2) and C2R kernels forward; their adjoints back)
    xs_grad = torch.from_numpy(np.random.default_rng(SEED + 6).uniform(
        0, 2 * np.pi, 4096).astype(np.float32))
    for what, fn, shapes, cplx, kernels in (
            ("nufft1d1 4096 points -> 4096 modes",
             lambda u: ft.nufft1d1(xs_grad.to(u.device), u, 4096), [(4096,)], True,
             {"rows_fft": 2}),
            ("convolve2d 500x1000 * 13x25 same",
             lambda u, v: ft.convolve2d(u, v, mode="same"), [(500, 1000), (13, 25)], False,
             {"r2c_fft": 3, "ax0_fft": 6, "c2r_fft": 1, "rows_fft": 2})):
        gk = through(f"grad {what}", lambda: grads_of(fn, shapes, SEED + 6, dev, cplx),
                     **kernels)
        gp = grads_of(fn, shapes, SEED + 6, torch.device("cpu"), cplx)
        gerrs[what] = check_close(gk.cpu(), gp, f"grad of sum(w*|f(x)|^2) {what} "
                                                "kernels vs plain")
    print("grad: rel-L2 vs plain " + ", ".join(f"{k} {v:.3e}" for k, v in gerrs.items()),
          flush=True)

    # ---- 5. times ----------------------------------------------------------
    def plane_copy(re, im):
        out_re, out_im = torch.empty_like(re), torch.empty_like(im)
        return lambda: (out_re.copy_(re), out_im.copy_(im))

    times = {}
    for rows, n in ((4096, 4096), (2500, 512)):
        x = crand(rows, n)
        re, im = planes(x)
        pn = ft.plan(n)
        times[f"rows_fft {rows}x{n}"] = time_in_turns({
            "kernel": lambda: cuda_fft._launch(re, im, -1, None),
            "kernel_c64": lambda: cuda_fft._launch_c64(x, -1, None),
            "plain": lambda: cuda_fft.fft_batched_split_reference(re, im, -1),
            "plain_c64": lambda: cuda_fft.fft_batched_c64_reference(x, -1),
            "torch.fft": lambda: torch.fft.fft(x),
            "plan.forward": lambda: pn.forward(x),
        })
        del x, re, im

    x = crand(4096, 4096)  # fft2's axis(-2) pass: both layouts
    re, im = planes(x)
    times["ax0_fft 4096x4096"] = time_in_turns({
        "kernel": lambda: cuda_fft._ax0_launch(re, im, -1, None),
        "kernel_c64": lambda: cuda_fft._ax0_launch_c64(x, -1, None),
        "plain": lambda: cuda_fft.fft_axis0_split_reference(re, im, -1),
        "plain_c64": lambda: cuda_fft.fft_axis0_c64_reference(x, -1),
        "torch.fft": lambda: torch.fft.fft(x, dim=-2),
        "copy": plane_copy(re, im),
    }, reps=20)
    del x, re, im
    x = crand(1024, 4096)  # the 2^22 four-step's pass shapes
    re, im = planes(x)
    outer = (1024, 1 << 22)
    times["ax0_fft 1024x4096"] = time_in_turns({
        "kernel": lambda: cuda_fft._ax0_launch(re, im, -1, None),
        "kernel_c64": lambda: cuda_fft._ax0_launch_c64(x, -1, None),
        "plain": lambda: cuda_fft.fft_axis0_split_reference(re, im, -1),
        "torch.fft": lambda: torch.fft.fft(x, dim=-2),
        "copy": plane_copy(re, im),
    }, reps=20)
    times["rows_t_fft 1024x4096"] = time_in_turns({
        "kernel": lambda: cuda_fft._rows_t_launch(re, im, -1, None, outer),
        "kernel_no_outer": lambda: cuda_fft._rows_t_launch(re, im, -1, None, None),
        "plain": lambda: cuda_fft.fft_rows_transposed_split_reference(
            re, im, -1, outer=outer),
        "torch.fft": lambda: torch.fft.fft(x),
        "copy": plane_copy(re, im),
    }, reps=20)
    del x, re, im

    x = crand(256, 1 << 16)
    re, im = planes(x)
    times["big_fft 256x2^16"] = time_in_turns({
        "kernel": lambda: bigfft._launch(re, im, -1, None),
        "kernel_c64": lambda: bigfft._launch_c64(x, -1, None),
        "plain": lambda: bigfft.fft_big_split_reference(re, im, -1),
        "plain_c64": lambda: bigfft.fft_big_c64_reference(x, -1),
        "torch.fft": lambda: torch.fft.fft(x),
        "copy": plane_copy(re, im),
    }, reps=20)
    del x, re, im

    for rows, e in ((1, 22), (4, 22), (1, 20), (256, 16)):
        x = crand(rows, 1 << e)
        re, im = planes(x)
        pn = ft.plan(1 << e)
        times[f"plan {rows}x2^{e}"] = time_in_turns({
            "plan.forward": lambda: pn.forward(x),
            "forward_split": lambda: pn.forward_split(re, im),
            "torch.fft": lambda: torch.fft.fft(x),
            "copy": plane_copy(re, im),
        }, reps=20)
        del x, re, im
    x = crand(256, 256, 256)  # config 4's 3-D passes
    re, im = planes(x)
    times["fft2f_fft 256x256x256"] = time_in_turns({
        "kernel": lambda: cuda_fft._fft2f_launch(re, im, -1, None),
        "kernel_c64": lambda: cuda_fft._fft2f_launch_c64(x, -1, None),
        "rows_fft + ax0_fft": lambda: cuda_fft._ax0_launch(
            *cuda_fft._launch(re, im, -1, None), -1, None),
        "rows_fft_c64 + ax0_fft_c64": lambda: cuda_fft._ax0_launch_c64(
            cuda_fft._launch_c64(x, -1, None), -1, None),
        "plain": lambda: cuda_fft.fft2_fused_split_reference(re, im, -1),
        "plain_c64": lambda: cuda_fft._fft2f_passes(x, -1),
        "torch.fft": lambda: torch.fft.fft2(x),
        "fftn": lambda: ft.fftn(x),
        "torch.fft fftn": lambda: torch.fft.fftn(x),
        "copy": plane_copy(re, im),
    }, reps=10)
    times["ax3_fft 256^3"] = time_in_turns({
        "kernel": lambda: cuda_fft._ax3_launch(re, im, -1, None),
        "kernel_c64": lambda: cuda_fft._ax3_launch_c64(x, -1, None),
        "plain": lambda: cuda_fft.fft_axis3_split_reference(re, im, -1),
        "plain_c64": lambda: cuda_fft.fft_axis3_c64_reference(x, -1),
        "torch.fft": lambda: torch.fft.fft(x, dim=0),
        "copy": plane_copy(re, im),
    }, reps=10)
    del x, re, im

    r = torch.randn(4096, 4096, device=dev, generator=gen)  # config 4's R2C/C2R
    Rr, Ri = cuda_fft._r2c_launch(r, None, False)
    R = torch.fft.rfft(r)
    out = torch.empty_like(r)
    times["r2c_fft 4096x4096"] = time_in_turns({
        "kernel": lambda: cuda_fft._r2c_launch(r, None, False),
        "kernel_padded": lambda: cuda_fft._r2c_launch(r, None, True),
        "kernel_c64": lambda: cuda_fft._r2c_launch_c64(r, None),
        "rfft": lambda: ft.rfft(r),
        "plain": lambda: cuda_fft.rfft_rows_split_reference(r),
        "plain_c64": lambda: cuda_fft.rfft_rows_c64_reference(r),
        "torch.fft": lambda: torch.fft.rfft(r),
        "copy": lambda: out.copy_(r),
    }, reps=20)
    Rc = torch.complex(Rr, Ri)
    times["c2r_fft 4096x4096"] = time_in_turns({
        "kernel": lambda: cuda_fft._c2r_launch(Rr, Ri, 4096, 1.0 / 4096),
        "kernel_c64": lambda: cuda_fft._c2r_launch_c64(Rc, 4096, 1.0 / 4096),
        "irfft": lambda: ft.irfft(Rc),
        "plain": lambda: cuda_fft.irfft_rows_split_reference(Rr, Ri, 4096, 1.0 / 4096),
        "plain_c64": lambda: cuda_fft.irfft_rows_c64_reference(Rc, 4096, 1.0 / 4096),
        "torch.fft": lambda: torch.fft.irfft(R, n=4096),
        "copy": lambda: out.copy_(r),
    }, reps=20)
    del r, Rr, Ri, R, Rc, out

    x = crand(4096, 4096)  # config 4's plane by both routes
    re, im = planes(x)
    times["fft2 4096x4096"] = time_in_turns({
        "rows_t_fft x2": lambda: cuda_fft._rows_t_launch(
            *cuda_fft._rows_t_launch(re, im, -1, None, None), -1, None, None),
        "rows_fft + ax0_fft": lambda: cuda_fft._ax0_launch(
            *cuda_fft._launch(re, im, -1, None), -1, None),
        "rows_fft_c64 + ax0_fft_c64": lambda: cuda_fft._ax0_launch_c64(
            cuda_fft._launch_c64(x, -1, None), -1, None),
        "fft2": lambda: ft.fft2(x),
        "torch.fft": lambda: torch.fft.fft2(x),
        "copy": plane_copy(re, im),
    }, reps=20)
    del x, re, im

    x = crand(1024, 4095)  # the non-pow2 path's shapes
    re, im = planes(x)
    times["gen_fft 1024x4095"] = time_in_turns({
        "kernel": lambda: cuda_fft._gen_launch(re, im, -1, None),
        "plain": lambda: cuda_fft.fft_rows_general_split_reference(re, im, -1),
        "torch.fft": lambda: torch.fft.fft(x),
        "fft": lambda: ft.fft(x),
        "copy": plane_copy(re, im),
    }, reps=20)
    times["r2c_gen_fft 1024x4095"] = time_in_turns({
        "kernel": lambda: cuda_fft._r2c_gen_launch(re, None, False),
        "kernel_padded": lambda: cuda_fft._r2c_gen_launch(re, None, True),
        "plain": lambda: cuda_fft.rfft_rows_general_split_reference(re),
        "torch.fft": lambda: torch.fft.rfft(re),
        "rfft": lambda: ft.rfft(re),
        "copy": lambda: torch.empty_like(re).copy_(re),
    }, reps=20)
    del x, re, im
    for rows, n in ((1024, 4097), (2048, 1000), (17280, 1920)):
        x = crand(rows, n)
        re, im = planes(x)
        times[f"gen_fft {rows}x{n}"] = time_in_turns({
            "kernel": lambda: cuda_fft._gen_launch(re, im, -1, None),
            "plain": lambda: cuda_fft.fft_rows_general_split_reference(re, im, -1),
            "torch.fft": lambda: torch.fft.fft(x),
        }, reps=20)
        del x, re, im
    r = torch.randn(1024, 1000, device=dev, generator=gen)
    times["r2c_gen_fft 1024x1000"] = time_in_turns({
        "kernel": lambda: cuda_fft._r2c_gen_launch(r, None, False),
        "plain": lambda: cuda_fft.rfft_rows_general_split_reference(r),
        "torch.fft": lambda: torch.fft.rfft(r),
    }, reps=20)
    del r
    x = crand(1024, 4093)  # Bluestein, m = 8192: the two passes on their own data
    re, im = planes(x)
    (cr, ci, bfr, bfi), m = bluestein._chirp_tables(4093, -1, dev)
    Ar, Ai = cuda_fft._chirp_fwd_launch(re, im, cr, ci, m, -1)
    times["chirp 1024x4093"] = time_in_turns({
        "chirp_fwd": lambda: cuda_fft._chirp_fwd_launch(re, im, cr, ci, m, -1),
        "chirp_inv": lambda: cuda_fft._chirp_inv_launch(Ar, Ai, bfr, bfi, cr, ci, 4093, 1,
                                                        1.0 / m),
        "chirp_full": lambda: cuda_fft._chirp_full_launch(re, im, cr, ci, bfr, bfi, cr, ci, m,
                                                          4093, 1.0 / m),
        "chirp_fwd_plain": lambda: cuda_fft.fft_chirp_forward_split_reference(
            re, im, cr, ci, m, -1),
        "chirp_inv_plain": lambda: cuda_fft.fft_chirp_inverse_split_reference(
            Ar, Ai, bfr, bfi, cr, ci, 4093, 1, 1.0 / m),
        "chirp_full_plain": lambda: cuda_fft.fft_chirp_full_split_reference(
            re, im, cr, ci, bfr, bfi, cr, ci, m, 4093, 1.0 / m),
        "bluestein": lambda: bluestein.fft_bluestein_split(re, im, -1),
        "torch.fft": lambda: torch.fft.fft(x),
        "fft": lambda: ft.fft(x),
        "copy": plane_copy(Ar, Ai),
    }, reps=20)
    x = crand(1024, 4097)  # Bluestein, m = 16384, and the zoom, L = 8192: chirp_full
    re, im = planes(x)
    (cr, ci, bfr, bfi), m = bluestein._chirp_tables(4097, -1, dev)
    times["chirp_full 1024x4097"] = time_in_turns({
        "chirp_full": lambda: cuda_fft._chirp_full_launch(re, im, cr, ci, bfr, bfi, cr, ci, m,
                                                          4097, 1.0 / m),
        "bluestein": lambda: bluestein.fft_bluestein_split(re, im, -1),
        "torch.fft": lambda: torch.fft.fft(x),
    }, reps=20)
    x = crand(1024, 4096)
    re, im = planes(x)
    zf = ft.ZoomFFT(4096, [0.1, 0.35], m=1024)
    ((zar, zai), (zwr, zwi), (zvr, zvi)), L = czt._device_tables(4096, 1024, zf.w, zf.a, dev)
    times["chirp_full ZoomFFT 1024x4096 m=1024"] = time_in_turns({
        "chirp_full": lambda: cuda_fft._chirp_full_launch(re, im, zar, zai, zvr, zvi, zwr, zwi,
                                                          L, 1024, 1.0 / L),
        "ZoomFFT": lambda: zf(x),
    }, reps=20)
    del x, re, im, Ar, Ai

    x = crand(4096, 4096)  # the fused-epilogue path's shapes
    re, im = planes(x)
    hr, hi = planes(H)
    r = torch.randn(4096, 4096, device=dev, generator=gen)
    times["filt 4096x4096"] = time_in_turns({
        "kernel": lambda: cuda_fft._filt(re, im, hr, hi, 1, 1.0 / 4096),
        "kernel_c64": lambda: cuda_fft._filt_launch_c64(x, H, 1, 1.0 / 4096),
        "plain": lambda: cuda_fft.fft_filtered_split_reference(re, im, hr, hi, 1, 1.0 / 4096),
        "plain_c64": lambda: cuda_fft._filt_passes(x, H, 1, 1.0 / 4096),
        "torch.fft": lambda: torch.fft.ifft(x * H),
        "SpectralFilter": lambda: sf(x),
        "torch.fft SpectralFilter": lambda: torch.fft.ifft(torch.fft.fft(x) * H),
        "hilbert": lambda: ft.hilbert(r),
        "torch.fft hilbert": lambda: torch.fft.ifft(torch.fft.fft(r) * hw),
        "copy": plane_copy(re, im),
    }, reps=20)
    xb, Bk = crand(16384), crand(128, 16384)
    (xbr, xbi), (bkr, bki) = planes(xb), planes(Bk)
    times["bank 128x16384"] = time_in_turns({
        "kernel": lambda: cuda_fft._bank(xbr, xbi, bkr, bki, 1, 1.0 / 16384),
        "plain": lambda: cuda_fft.fft_bank_split_reference(xbr, xbi, bkr, bki, 1,
                                                           1.0 / 16384),
        "torch.fft": lambda: torch.fft.ifft(xb * Bk),
        "CWT": lambda: cw(s8k),
        "copy": plane_copy(bkr, bki),
    }, reps=20)
    A, B = crand(2048, 4097), crand(2048, 4097)
    (Ar, Ai), (Br, Bi) = planes(A), planes(B)
    a2, b2 = (torch.randn(2048, 4096, device=dev, generator=gen) for _ in range(2))
    sig, taps = (torch.randn(n, device=dev, generator=gen) for n in (1 << 20, 129))
    times["c2r_prod 2048x8192"] = time_in_turns({
        "kernel": lambda: cuda_fft._c2r_prod_launch(Ar, Ai, Br, Bi, 8192, 1.0 / 8192),
        "plain": lambda: cuda_fft.irfft_prod_rows_split_reference(Ar, Ai, Br, Bi, 8192,
                                                                  1.0 / 8192),
        "torch.fft": lambda: torch.fft.irfft(A * B, n=8192),
        "fftconvolve": lambda: ft.fftconvolve(a2, b2, axes=-1),
        "torch.fft fftconvolve": lambda: torch.fft.irfft(
            torch.fft.rfft(a2, n=8192) * torch.fft.rfft(b2, n=8192), n=8192)[:, :8191],
        "oaconvolve 2^20x129": lambda: ft.oaconvolve(sig, taps),
        "torch.fft 2^20x129": lambda: torch.fft.irfft(
            torch.fft.rfft(sig, n=1 << 21) * torch.fft.rfft(taps, n=1 << 21),
            n=1 << 21)[:(1 << 20) + 128],
    }, reps=20)
    del re, im, A, B, Ar, Ai, Br, Bi
    x = crand(16, 4095, 512)
    re, im = planes(x)
    times["ax0_gen 16x4095x512"] = time_in_turns({
        "kernel": lambda: cuda_fft._ax0_launch(re, im, -1, None),
        "plain": lambda: cuda_fft.fft_axis0_split_reference(re, im, -1),
        "torch.fft": lambda: torch.fft.fft(x, dim=-2),
        "copy": plane_copy(re, im),
    }, reps=10)
    del x
    fr = crand(16, 1080, 1920)
    re, im = planes(fr)
    times["ax0_gen 16x1080x1920"] = time_in_turns({
        "kernel": lambda: cuda_fft._ax0_launch(re, im, -1, None),
        "plain": lambda: cuda_fft.fft_axis0_split_reference(re, im, -1),
        "torch.fft": lambda: torch.fft.fft(fr, dim=-2),
        "gen_fft": lambda: cuda_fft._gen_launch(re, im, -1, None),
        "fft2": lambda: ft.fft2(fr),
        "torch.fft fft2": lambda: torch.fft.fft2(fr),
        "copy": plane_copy(re, im),
    }, reps=10)
    del re, im

    profiles = {}

    def alone(call, fn, kernels, want, copies=0, reps=20, others=False):
        """Profile ``call``: its kernels alone, each once a call, and
        ``copies`` device-to-device copies a call (the fresh grids an
        estimator returns), no other device work (with ``others``: beside
        the call's torch work, an estimator's normalisation and sums); over
        the same calls the wrappers' counters rise by ``want`` (counter ->
        launches) a call and no other counter moves.  A window that sees
        other work, or counters off, fails at once; one that sees fewer
        launches is taken again (at most five, every other one without the
        profiler's schedule: three scheduled windows in a row have come back
        short)."""
        names = kernels + (("Memcpy DtoD",) if copies else ())
        per_call = {**dict.fromkeys(kernels, 1), "Memcpy DtoD": copies}
        for attempt in range(5):
            counted = {}
            got = breakdown(fn, names, reps, counted, scheduled=attempt % 2 == 0)
            check(others or got["other launches"] == 0, f"{call}: other device work: {got}")
            check(counted == {k: reps * v for k, v in want.items()},
                  f"{call}: launches {counted} in {reps} calls, expected {want} a call")
            if all(got[f"{k} launches"] == per_call[k] for k in names):
                profiles[call] = got
                return
        check(False, f"{call}: not its kernels once each a call: {got}")

    # the 1-D main path on complex64: its kernel alone, no split or merge
    for rows, n, kernel in ((4096, 4096, "rows_fft"), (256, 1 << 16, "big_fft")):
        x = crand(rows, n)
        pn = ft.plan(n)
        alone(f"plan({n}).forward {rows}x{n}", lambda: pn.forward(x), (kernel,),
              row if kernel == "rows_fft" else whole)
    # fft2 of a complex64 plane and rfft: their kernels alone, no split or merge
    x = crand(4096, 4096)
    r = torch.randn(4096, 4096, device=dev, generator=gen)
    alone("fft2 4096x4096", lambda: ft.fft2(x), ("rows_fft", "ax0_fft"), c2d)
    alone("rfft 4096x4096", lambda: ft.rfft(r), ("r2c_fft",), {"r2c_fft": 1, "r2c_fft_c64": 1})
    # irfft and irfft2 of complex64: the C2R kernel's complex64 source (after
    # ax0_fft's complex64 entry for irfft2) alone, no split, no merge
    R = ft.rfft(r)
    alone("irfft 4096x4096 complex64", lambda: ft.irfft(R), ("c2r_fft",),
          {"c2r_fft": 1, "c2r_fft_c64": 1})
    alone("irfft2 4096x4096 complex64", lambda: ft.irfft2(R, s=(4096, 4096)),
          ("ax0_fft", "c2r_fft"), {"ax0_fft": 1, "ax0_fft_c64": 1, "c2r_fft": 1,
                                   "c2r_fft_c64": 1})
    # fftn of 256^3 complex64 (the fused plane, then axis -3; ax0_fft_kernel
    # is the axis(-3) pass) and stft of 2^20 (B20's complex64 sink): their
    # kernels alone, no split and no merge
    x = crand(256, 256, 256)
    alone("fftn 256^3", lambda: ft.fftn(x), ("fft2f_fft", "ax0_fft"), c3d)
    x20 = torch.randn(1 << 20, device=dev, generator=gen)
    alone("stft 2^20 n_fft 512 hop 128", lambda: ft.stft(x20, 512, 128), ("spec_fft",), spec)
    del x20
    for rows, n in ((1024, 4095), (1024, 4097), (2048, 1000)):
        x = crand(rows, n)
        profiles[f"fft {rows}x{n}"] = breakdown(lambda: ft.fft(x), ("gen_fft",))
    x = crand(1024, 4093)
    profiles["fft 1024x4093"] = breakdown(lambda: ft.fft(x), ("chirp_full",))
    r = torch.randn(1024, 4095, device=dev, generator=gen)
    profiles["rfft 1024x4095"] = breakdown(lambda: ft.rfft(r), ("r2c_gen_fft",))
    r1000 = torch.randn(1024, 1000, device=dev, generator=gen)
    profiles["rfft 1024x1000"] = breakdown(lambda: ft.rfft(r1000), ("r2c_gen_fft",))
    x = crand(17280, 1920)  # the 1080p frames' rows
    profiles["fft 17280x1920"] = breakdown(lambda: ft.fft(x), ("gen_fft",))
    del r1000
    R = torch.fft.rfft(r)
    profiles["irfft 1024x4095"] = breakdown(lambda: ft.irfft(R, n=4095), ("gen_fft",))
    x = crand(1024, 4096)
    zf = ft.ZoomFFT(4096, [0.1, 0.35], m=1024)
    profiles["ZoomFFT 1024x4096 m=1024"] = breakdown(lambda: zf(x), ("chirp_full",))
    # SpectralFilter of complex64 and hilbert: their two kernels alone (the
    # complex64 entries: no split, no merge, no zero plane)
    x = crand(4096, 4096)
    r = torch.randn(4096, 4096, device=dev, generator=gen)
    alone("SpectralFilter 4096x4096 complex64", lambda: sf(x), ("rows_fft", "filt_fft"),
          {"rows_fft": 1, "rows_fft_c64": 1, "filt": 1, "filt_c64": 1})
    alone("hilbert 4096x4096", lambda: ft.hilbert(r), ("r2c_fft", "filt_fft"),
          {"r2c_fft": 1, "r2c_fft_c64": 1, "filt": 1, "filt_c64": 1})
    profiles["fftconvolve 2048x4096"] = breakdown(lambda: ft.fftconvolve(a2, b2, axes=-1),
                                                  ("r2c_fft", "c2r_prod"))
    profiles["oaconvolve 2^20x129"] = breakdown(lambda: ft.oaconvolve(sig, taps),
                                                ("r2c_fft", "c2r_prod"))
    profiles["CWT 8192 x 128 widths"] = breakdown(lambda: cw(s8k), ("rows_fft", "filt_fft"))
    profiles["fft2 16x1080x1920"] = breakdown(lambda: ft.fft2(fr), ("gen_fft", "ax0_gen_fft"),
                                              reps=5)
    del x, r, R, a2, b2, sig, taps, fr

    # the estimators' kernels at path 6's shapes, beside their plain versions
    # and torch.fft's composition of the same function
    x, y = (torch.randn(1 << 22, device=dev, generator=gen) for _ in range(2))
    xb = torch.randn(64, 1 << 20, device=dev, generator=gen)
    hann = ft.hann_window(4096, device=dev)
    tukey = ft.get_window(("tukey", 0.25), 4096, device=dev)
    hann256 = ft.hann_window(256, device=dev)
    seg = {"nperseg": 4096, "noverlap": 2048}
    xc = torch.complex(x, y)
    path6_calls = {
        "welch 2^22 nperseg 4096": lambda: ft.welch(x, **seg),
        "welch 64x2^20 scipy defaults": lambda: ft.welch(xb),
        "welch median 2^22": lambda: ft.welch(x, average="median", **seg),
        "csd 2^22": lambda: ft.csd(x, y, **seg),
        "coherence 2^22": lambda: ft.coherence(x, y, **seg),
        "spectrogram 2^22": lambda: ft.spectrogram(x, nperseg=4096),
        "welch 2^22 complex": lambda: ft.welch(xc, **seg),
        "welch 2^22 real two-sided": lambda: ft.welch(x, return_onesided=False, **seg),
    }
    welch_shapes = {  # key -> (kind, x, y, window, args, the estimator's call)
        "welch 2^22 nperseg 4096 hop 2048": ("welch", x, None, hann,
                                             (4096, 2048, 4096, "constant"),
                                             "welch 2^22 nperseg 4096"),
        "welch 64x2^20 nperseg 256 hop 128": ("welch", xb, None, hann256,
                                              (256, 128, 256, "constant"),
                                              "welch 64x2^20 scipy defaults"),
        "csd 2^22 nperseg 4096 hop 2048": ("csd", x, y, hann, (4096, 2048, 4096, "constant"),
                                           "csd 2^22"),
        "coh 2^22 nperseg 4096 hop 2048": ("coh", x, y, hann, (4096, 2048, 4096, "constant"),
                                           "coherence 2^22"),
        "psd 2^22 nperseg 4096 hop 3584": ("psd", x, None, tukey,
                                           (4096, 3584, 4096, "constant"), "spectrogram 2^22"),
        "c2c 2^22 nperseg 4096 hop 2048": ("c2c", x, y, hann, (4096, 2048, 4096, "constant"),
                                           "welch 2^22 complex"),
    }
    for key, (kind, v, u, w, args, call) in welch_shapes.items():
        fns = {"kernel": lambda: cuda_welch._launch(kind, v, u, w, *args),
               "plain": lambda: cuda_welch._reference(kind, v, u, w, *args)}
        if kind == "c2c":  # B21's complex64 entry on the same signal as it lies
            fns["kernel_c64"] = lambda: cuda_welch._launch("c2c_c64", xc, None, w, *args)
            fns["plain_c64"] = lambda: cuda_welch._reference("c2c_c64", xc, None, w, *args)
        times[key] = time_in_turns({
            **fns,
            "torch.fft": lambda: torch_segments(kind, v, u, w, *args),
            "estimator": path6_calls[call],
        }, reps=10)
    # welch_acc_fft's kernel, once a call exactly, beside the sum over its
    # blocks' rows and the estimator's normalisation
    acc_calls = {"welch 2^22 nperseg 4096": {"welch": 1},
                 "welch 64x2^20 scipy defaults": {"welch": 1}, "coherence 2^22": {"coh": 1},
                 "csd 2^22": {"csd": 1}, "welch 2^22 complex": {"c2c": 1, "c2c_c64": 1},
                 "welch 2^22 real two-sided": {"c2c": 1, "c2c_c64": 1}}
    for call, fn in path6_calls.items():
        if call in acc_calls:
            alone(call, fn, ("welch_acc",), acc_calls[call], others=True)
        else:  # B19: spec_fft's psd_pairs
            profiles[call] = breakdown(fn, ("psd_pairs",))

    # the per-segment kernels at path 7's shapes, beside their plain versions
    # and torch.fft's composition (unfold, detrend, window, rfft or fft)
    x20 = torch.randn(1 << 20, device=dev, generator=gen)
    x8 = torch.randn(8, 1 << 17, device=dev, generator=gen)
    xs = torch.nn.functional.pad(x20[None], (256, 256), mode="reflect")[0]  # stft's center pad
    yc = torch.complex(y, x)
    hann1024 = ss.windows.hann(1024, sym=False)
    stf = {m: ft.ShortTimeFFT(hann1024, 256, 48000.0, mfft=m) for m in (1024, 2048)}
    p0, p1 = stf[2048].p_range(1 << 20)
    xt = torch.randn((p1 - p0 - 1) * 256 + 1024, device=dev, generator=gen)  # the blended signal
    h512, h1024 = ft.hann_window(512, device=dev), ft.hann_window(1024, device=dev)
    Z20, S1024 = ft.stft(x20, 512, 128), stf[1024].stft(x20)
    xr = torch.randn(256, 8192, device=dev, generator=gen)
    path7_calls = {
        "stft 2^20 n_fft 512": lambda: ft.stft(x20, 512, 128),
        "stft 8x2^17 n_fft 512": lambda: ft.stft(x8, 512, 128),
        "istft 2^20 n_fft 512": lambda: ft.istft(Z20, 512, 128, length=1 << 20),
        "spectrogram 2^22 complex": lambda: ft.spectrogram(x, mode="complex", **seg),
        "spectrogram 2^22 complex input psd": lambda: ft.spectrogram(xc, **seg),
        "spectrogram 2^22 complex input complex":
            lambda: ft.spectrogram(xc, mode="complex", **seg),
        "csd 2^22 complex": lambda: ft.csd(xc, yc, **seg),
        "ShortTimeFFT 2^20 mfft 1024": lambda: stf[1024].stft(x20),
        "ShortTimeFFT 2^20 mfft 2048": lambda: stf[2048].stft(x20),
        "ShortTimeFFT.istft 2^20 mfft 1024": lambda: stf[1024].istft(S1024, k1=1 << 20),
        "resample 256x8192 to 16384": lambda: ft.resample(xr, 16384, axis=-1),
        "resample 256x8192 to 6144": lambda: ft.resample(xr, 6144, axis=-1),
    }
    spec_shapes = {  # key -> (kind, x, y, window, args, the call it serves)
        "spec stft 2^20 n_fft 512 hop 128": ("spec", xs, None, h512,
                                             (512, 128, 512, False, 0, False),
                                             "stft 2^20 n_fft 512"),
        "spec 2^22 nperseg 4096 hop 2048": ("spec", x, None, tukey,
                                            (4096, 2048, 4096, "constant", 0, False),
                                            "spectrogram 2^22 complex"),
        "spec ShortTimeFFT 2^20 mfft 2048 roll 512": ("spec", xt, None, h1024,
                                                      (1024, 256, 2048, False, 512, False),
                                                      "ShortTimeFFT 2^20 mfft 2048"),
        "spec_c2c 2^22 nperseg 4096 hop 2048": ("spec_c2c", x, y, tukey,
                                                (4096, 2048, 4096, "constant", 0, False),
                                                "spectrogram 2^22 complex input complex"),
    }
    spec_bounds = {}
    for key, (kind, v, u, w, args, call) in spec_shapes.items():
        if kind == "spec":  # B20 (spec_fft.cu): its planar and complex64 sinks
            fns = {"kernel": lambda: cuda_welch._spec_launch(v, w, *args),
                   "kernel_c64": lambda: cuda_welch._spec_launch(v, w, *args[:5], False, True),
                   "plain": lambda: cuda_welch._reference(kind, v, u, w, *args),
                   "plain_c64": lambda: cuda_welch._spec_passes(v, w, *args[:5])}
        elif kind == "spec_c2c":  # B22 (spec_c2c_fft.cu): planes in and out, and
            # complex64 in and out
            fns = {"kernel": lambda: cuda_welch._spec_c2c_launch(v, u, w, *args[:4]),
                   "kernel_c64": lambda: cuda_welch._spec_c2c_launch(xc, None, w, *args[:4],
                                                                     True),
                   "plain": lambda: cuda_welch._spec_c2c_passes(v, u, w, *args[:4]),
                   "plain_c64": lambda: cuda_welch._spec_c2c_passes(xc, None, w, *args[:4])}
        else:
            fns = {"kernel": lambda: cuda_welch._launch(kind, v, u, w, *args[:4]),
                   "plain": lambda: cuda_welch._reference(kind, v, u, w, *args)}
        times[key] = time_in_turns({
            **fns,
            "torch.fft": lambda: torch_segments(kind, v, u, w, *args),
            "estimator": path7_calls[call],
        }, reps=10)
        nperseg, hop, nfft = args[:3]
        num, planes_in = 1 + (v.shape[-1] - nperseg) // hop, 1 if u is None else 2
        bins = nfft // 2 + 1 if kind == "spec" else nfft
        flops = (rfft_flops if kind == "spec" else fft_flops)(nfft, num * v.numel() // v.shape[-1])
        spec_bounds[key] = bound(4 * planes_in * v.numel() + 4 * nperseg
                                 + 8 * num * bins * (v.numel() // v.shape[-1]), flops)
    for call, fn in path7_calls.items():
        if call == "spectrogram 2^22 complex input complex":
            # B22 alone, no split and no merge; beside it one copy of the
            # cached (f, t) grid, which the call returns as fresh tensors
            alone(call, fn, ("spec_c2c",), {"spec_c2c": 1, "spec_c2c_c64": 1}, copies=1)
            continue
        profiles[call] = breakdown(fn, ("welch_acc", "spec_fft", "spec_c2c", "r2c_fft",
                                        "c2r_fft", "rows_fft", "gen_fft"))
    for key, (ms, by) in spec_bounds.items():
        print(f"bound: {key} | {ms:.4f} ms ({by}; each input read once, the spectra written "
              f"once, at 3.35 TB/s and 67 TFLOP/s)", flush=True)
    del x, y, xb, xc, yc, x20, x8, xs, xt, Z20, S1024, xr

    x = crand(512, 512, 512)  # 1 GiB: axis(-3), axis(-2), row kernel
    times["fftn 512^3"] = {"fftn": time_ms(lambda: ft.fftn(x), reps=5, warmup=1),
                           "torch.fft": time_ms(lambda: torch.fft.fftn(x), reps=5,
                                                warmup=1)}
    del x
    for shape, t in times.items():
        rounds = "1 round" if shape == "fftn 512^3" else "2 rounds"
        print(f"times: {smi} | {shape} | median ms (CUDA events, {rounds}) | "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)
    for call, parts in profiles.items():
        print(f"profile: {smi} | {call} | device ms per call (torch.profiler, 20 calls) | "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()), flush=True)

    def entry(name, source, replaces, shape, nbytes, flops, ms="kernel", plain="plain"):
        """One kernel's record: its times at ``shape`` (``ms``/``plain`` name
        the timed versions), torch.fft's time there and its bound for
        ``nbytes`` moved (each input read once, each output written once)
        and ``flops`` done."""
        bound_ms, bound_by = bound(nbytes, flops)
        return {"name": name, "route": "cuda",
                "source": f"fft_wgpu_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": main_launches[name],
                "max_abs_err": max_abs[name], "ms": times[shape][ms],
                "plain_ms": times[shape][plain], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": times[shape]["torch.fft"]}

    # Path 9 runs last: after its windows (the 2^20-point NUFFTs launch
    # thousands of kernels a window) later torch.profiler windows in the
    # same process were seen to miss one or two of 20 launches, whatever
    # memory was freed (PERF.md §7), and phase 5 holds windows to exact
    # launch counts.
    signal_tail(ft, dev, gen, smi)  # path 9
    c2c = 16  # bytes per point of a planar complex64 row, read and written
    r2c = lambda n, rows: (4 * n + 8 * (n // 2 + 1)) * rows  # noqa: E731
    print(json.dumps({"kernels": [
        # rows_fft, ax0_fft (axis -2 and the axis(-3) view), r2c_fft, c2r_fft
        # and big_fft through each of their two entries (the planar one, and
        # the complex64 one of the 1-D main path, fft2, fftn, rfft and irfft)
        entry("rows_fft", "rows_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:946",
              "rows_fft 4096x4096", c2c * 4096 * 4096, fft_flops(4096, 4096)),
        entry("rows_fft_c64", "rows_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:946",
              "rows_fft 4096x4096", c2c * 4096 * 4096, fft_flops(4096, 4096),
              ms="kernel_c64", plain="plain_c64"),
        entry("ax0_fft", "ax0_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:1180",
              "ax0_fft 1024x4096", c2c * 1024 * 4096, fft_flops(1024, 4096)),
        entry("ax0_fft_c64", "ax0_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:1180",
              "ax0_fft 4096x4096", c2c * 4096 * 4096, fft_flops(4096, 4096),
              ms="kernel_c64", plain="plain_c64"),
        entry("ax3_fft", "ax0_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:1342",
              "ax3_fft 256^3", c2c * 256 ** 3, fft_flops(256, 256 * 256)),
        entry("ax3_fft_c64", "ax0_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:1342",
              "ax3_fft 256^3", c2c * 256 ** 3, fft_flops(256, 256 * 256),
              ms="kernel_c64", plain="plain_c64"),
        entry("rows_t_fft", "rows_t_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:1494",
              "rows_t_fft 1024x4096", c2c * 1024 * 4096, fft_flops(4096, 1024)),
        entry("fft2f_fft", "fft2f_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:2274",
              "fft2f_fft 256x256x256", c2c * 256 ** 3, fft_flops(256 * 256, 256)),
        entry("fft2f_fft_c64", "fft2f_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:2274",
              "fft2f_fft 256x256x256", c2c * 256 ** 3, fft_flops(256 * 256, 256),
              ms="kernel_c64", plain="plain_c64"),
        entry("r2c_fft", "r2c_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:1801",
              "r2c_fft 4096x4096", r2c(4096, 4096), rfft_flops(4096, 4096)),
        entry("r2c_fft_c64", "r2c_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:1801",
              "r2c_fft 4096x4096", r2c(4096, 4096), rfft_flops(4096, 4096),
              ms="kernel_c64", plain="plain_c64"),
        entry("c2r_fft", "c2r_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:2076",
              "c2r_fft 4096x4096", r2c(4096, 4096), rfft_flops(4096, 4096)),
        entry("c2r_fft_c64", "c2r_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:2076",
              "c2r_fft 4096x4096", r2c(4096, 4096), rfft_flops(4096, 4096),
              ms="kernel_c64", plain="plain_c64"),
        entry("big_fft", "big_fft.cu", "fft_wgpu_tpu/ops/bigfft.py:139",
              "big_fft 256x2^16", c2c * 256 * 65536, fft_flops(65536, 256)),
        entry("big_fft_c64", "big_fft.cu", "fft_wgpu_tpu/ops/bigfft.py:139",
              "big_fft 256x2^16", c2c * 256 * 65536, fft_flops(65536, 256),
              ms="kernel_c64", plain="plain_c64"),
        entry("gen_fft", "gen_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:2865",
              "gen_fft 1024x4095", c2c * 1024 * 4095, fft_flops(4095, 1024)),
        entry("r2c_gen_fft", "r2c_gen_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:2970",
              "r2c_gen_fft 1024x4095", r2c(4095, 1024), rfft_flops(4095, 1024)),
        # the two Bluestein passes of a 4093-point transform, m = 8192, and
        # the two fused (B11 then B12: chirp_full, which replaces the pair);
        # library_ms is torch.fft's whole 4093-point transform
        entry("chirp_fwd", "chirp_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:2613",
              "chirp 1024x4093", 8 * (4093 + 8192) * 1024 + 8 * 4093,
              fft_flops(8192, 1024), ms="chirp_fwd", plain="chirp_fwd_plain"),
        entry("chirp_inv", "chirp_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:2672",
              "chirp 1024x4093", 8 * (8192 + 4093) * 1024 + 8 * (8192 + 4093),
              fft_flops(8192, 1024), ms="chirp_inv", plain="chirp_inv_plain"),
        entry("chirp_full", "chirp_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:2613",
              "chirp 1024x4093", 8 * (4093 + 4093) * 1024 + 8 * (4093 + 8192 + 4093),
              2 * fft_flops(8192, 1024), ms="chirp_full", plain="chirp_full_plain"),
        # the fused epilogues: each kernel's library_ms is torch.fft's
        # composition of the same function (multiply + ifft, multiply +
        # irfft, fft along axis -2)
        entry("filt", "filt_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:2406",
              "filt 4096x4096", c2c * 4096 * 4096 + 8 * 4096,
              fft_flops(4096, 4096) + 6 * 4096 * 4096),
        entry("filt_c64", "filt_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:2406",
              "filt 4096x4096", c2c * 4096 * 4096 + 8 * 4096,
              fft_flops(4096, 4096) + 6 * 4096 * 4096, ms="kernel_c64", plain="plain_c64"),
        entry("bank", "filt_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:2497",
              "bank 128x16384", 8 * 16384 + c2c * 128 * 16384,
              fft_flops(16384, 128) + 6 * 128 * 16384),
        entry("c2r_prod", "c2r_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:2163",
              "c2r_prod 2048x8192", 2 * 8 * 4097 * 2048 + 4 * 8192 * 2048,
              rfft_flops(8192, 2048) + 6 * 4097 * 2048),
        entry("ax0_gen", "ax0_gen_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:1180",
              "ax0_gen 16x1080x1920", c2c * 16 * 1080 * 1920, fft_flops(1080, 16 * 1920)),
        # the segment-spectrum kernels: each signal (or plane) read once,
        # the window once, the bins (B19: every segment's bins) written once;
        # one real nfft-point transform per segment and real signal, one
        # complex one per segment of the complex signal (B21, through its
        # planar and its complex64 entry); library_ms is torch.fft's
        # composition of the same function
        entry("welch", "welch_acc_fft.cu", "fft_wgpu_tpu/ops/pallas_welch.py:477",
              "welch 2^22 nperseg 4096 hop 2048", 4 * n22 + 4 * 4096 + 4 * 2049,
              rfft_flops(4096, 2047)),
        entry("csd", "welch_acc_fft.cu", "fft_wgpu_tpu/ops/pallas_welch.py:404",
              "csd 2^22 nperseg 4096 hop 2048", 8 * n22 + 4 * 4096 + 8 * 2049,
              2 * rfft_flops(4096, 2047)),
        entry("coh", "welch_acc_fft.cu", "fft_wgpu_tpu/ops/pallas_welch.py:440",
              "coh 2^22 nperseg 4096 hop 2048", 8 * n22 + 4 * 4096 + 16 * 2049,
              2 * rfft_flops(4096, 2047)),
        entry("psd", "spec_fft.cu", "fft_wgpu_tpu/ops/pallas_welch.py:514",
              "psd 2^22 nperseg 4096 hop 3584", 4 * n22 + 4 * 4096 + 4 * 1170 * 2049,
              rfft_flops(4096, 1170)),
        entry("c2c", "welch_acc_fft.cu", "fft_wgpu_tpu/ops/pallas_welch.py:582",
              "c2c 2^22 nperseg 4096 hop 2048", 8 * n22 + 4 * 4096 + 4 * 4096,
              fft_flops(4096, 2047)),
        entry("c2c_c64", "welch_acc_fft.cu", "fft_wgpu_tpu/ops/pallas_welch.py:582",
              "c2c 2^22 nperseg 4096 hop 2048", 8 * n22 + 4 * 4096 + 4 * 4096,
              fft_flops(4096, 2047), ms="kernel_c64", plain="plain_c64"),
        # the per-segment spectra (path 7's spectrogram shapes): every
        # segment's two planes written once
        entry("spec", "spec_fft.cu", "fft_wgpu_tpu/ops/pallas_welch.py:544",
              "spec 2^22 nperseg 4096 hop 2048", 4 * n22 + 4 * 4096 + 8 * 2047 * 2049,
              rfft_flops(4096, 2047)),
        entry("spec_c64", "spec_fft.cu", "fft_wgpu_tpu/ops/pallas_welch.py:544",
              "spec 2^22 nperseg 4096 hop 2048", 4 * n22 + 4 * 4096 + 8 * 2047 * 2049,
              rfft_flops(4096, 2047), ms="kernel_c64", plain="plain_c64"),
        entry("spec_c2c", "spec_c2c_fft.cu", "fft_wgpu_tpu/ops/pallas_welch.py:614",
              "spec_c2c 2^22 nperseg 4096 hop 2048", 8 * n22 + 4 * 4096 + 8 * 2047 * 4096,
              fft_flops(4096, 2047)),
        entry("spec_c2c_c64", "spec_c2c_fft.cu", "fft_wgpu_tpu/ops/pallas_welch.py:614",
              "spec_c2c 2^22 nperseg 4096 hop 2048", 8 * n22 + 4 * 4096 + 8 * 2047 * 4096,
              fft_flops(4096, 2047), ms="kernel_c64", plain="plain_c64"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
