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
convolution and Wiener filtering, fractional Fourier transforms, NUFFTs),
and the model family (the FNOs and their training step, the Burgers, KS,
2-D Navier-Stokes and NLSE steppers, the Poisson solve), the serving
surface, the CUDA-graph cache of the convenience calls, and the examples.

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
             with a non-pow2 one (3 * 2^12), and at the 2^22 pass-2 shape,
             through its planar entry and its complex64 entry
             (rows_t_fft_c64);
             big_fft for every n of its envelope at rows 1 and 3, and at
             256 x 2^16, planar (big_fft) and complex64 (big_fft_c64),
             and both at 2 x 2^15 and 2 x 2^18 against the plain model of
             its own decomposition (bigfft._big_passes), with its
             forward-inverse round trip's power gain at 64 x 2^16 and
             64 x 2^18 in both entries and how many of its clusters fit
             on the card at once, each n (cudaOccupancyMaxActiveClusters);
             the axis(-3) pass (ax0_fft on a free view) at [2, n, 7, 130]
             and 256^3, and its complex64 entry (ax3_fft_c64) at
             [2, n, 7, 13] for every n, 256^3 and 512^3; fft2f_fft at every
             plane of its envelope, single and batched, and 256^3, through
             its planar and complex64 entries (fft2f_fft_c64, also in
             place) against the plain version of its own passes
             (cuda_fft._fft2f_passes); r2c_fft and c2r_fft
             for every n at rows 1, 3 and 1000, ragged and padded, and at
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
             pass at [2, 1000, 7, 130] and [1080, 8, 24];
             ax0_gen again against the plain version of its own passes
             (cuda_fft._mixed_radix_axis) at every n, m = 7 and 1000, and
             in place at 646, 1004, 1080, 2047 and 16383 (m = 1925),
             bit-equal to its out-of-place call;
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
             the edges (:func:`edges`): lengths below 1 and empty operands
             through the transforms, the chirp-z family, the convolutions,
             hilbert and the DCTs, each of which must raise before any
             launch (one line, ``edges: <k> calls raised, 0 launches``);
             then the transform long tail (path 8, :func:`long_tail`): dct,
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
             device ms and idle share; the model family (path 10,
             :func:`models_path`, run after phase 5 and before path 9):
             the flagship FNO1d (modes 64, width 32, depth 2, x
             [8, 1024, 1]), FNO2d ([4, 256^2, 1]) and FNO3d ([2, 128^3,
             1]), a forward and one train_step each, their outputs, losses
             and every parameter's gradient against CPU copies (FNO3d's
             first sample), Burgers (1024 x 8192 and Cole-Hopf at 8192),
             Kuramoto-Sivashinsky (1024 x 128, and 20 steps against a
             float64 ETDRK4), 2-D Navier-Stokes (Taylor-Green and 20
             random fields at 256^2), the NLSE (bright solitons at 256
             and 4096, the free Gaussian at 256^2) and solve_poisson at
             256^3 (the residual of the spectral Laplacian), each call's
             launches exact, a step and a short rollout against CPU
             copies, the oracles at the JAX tests' bars, and each step's
             events, device ms, other device work by name and idle share;
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
             of the same function; big_fft in both layouts beside the
             four-step's two passes (complex64), torch.fft and a copy,
             device ms in turns at 64 x 2^15, 256 x 2^16, 16 x 2^17,
             256 x 2^17, 16 x 2^18 and 64 x 2^18, each with its bound;
             a torch.profiler breakdown of the
             non-pow2 path's, the fused epilogues', the estimators' and the
             per-segment spectra's calls.

Then the CUDA-graph cache (path 12, :func:`graph_cache_path`, after path 11
and before path 9, in a child process with a fresh profiler): each of the JAX package's cached_call sites at
PERF.md's shapes (rfft, irfft and the DCT family at 4096^2, fft2, stft and
istft at 2^20, welch, csd, coherence and the spectrograms at 2^22,
multitaper, oaconvolve 2^20 x 129, fftconvolve 2048 x 4096, hilbert) eager,
captured and replayed: eager's bits, a held result unchanged by a replay on
other inputs, the counters and the profiler's launches per replay as per
eager call, events ms and idle share eager and replayed, the host ms of the
capturing call; the routes of one launch an axis (rfft, irfft, fft2, stft
and hilbert at pow2 lengths, the complex spectrogram) making no cache
entry, beside the same sites at composite lengths, which capture; the
memory the graphs hold, LRU eviction past 256 keys, eviction past the byte
bound handing a graph's memory back, and a call that reads the host
raising at its capture.  Then the examples (path 13, :func:`examples_path`):
the fifteen of ``fft_wgpu_tpu_torch.examples`` at the JAX examples' sizes,
each asserting its own check.  Then the distributed layer (path 14,
:func:`distributed_path`, before path 9, one child process a rank): (a)
NCCL across every card of the machine, one rank a card (one card: a 1 x 1
mesh, every corner turn the identity), at BASELINE config 5's width:
``fft3d``/``ifft3d`` of a 1024^3 complex64 cube, the transposed 4-turn
round trip, ``rfft3d``/``irfft3d`` of a 1024^3 float32 cube,
``fft1d_distributed`` of 2^26 points, ``fft_batch_sharded`` 4096 x 4096,
``solve_poisson_distributed`` at 512^3 against ``solve_poisson``, the
ns3d ABC decay at 256^3 over 20 steps against u0 exp(-nu t), a random
field's step against the same scheme in torch.fft, one timed RK2 step at
512^3, and the gradient of an fft3d loss at 256^3 against its adjoint,
each with exact launch counts per rank and 1e-5 against torch.fft (the
ABC decay 1e-4, the ns3d step 2e-5); fft3d's device ms by kernel, events
ms, idle share and peak memory beside torch.fft.fftn's time and
``pencil_fft3d_model``'s floor; (b) a 2 x 2 mesh of 4 processes sharing
cuda:0 on a gloo group at 256^3, the turns staged through the host:
fft3d, the transposed round trip, bf16 turns (2e-2), the R2C/C2R pair,
an ns3d step and the fft3d gradient across the processes, the host
staging's ms apart from the kernels'.  Each part ends with the FNO-3D dp x
tp training step (:func:`fno_tp_path`) at path 10's width on its mesh
named ("dp", "tp"): its loss and every parameter against
``spectral.train_step`` of the global batch, exact launches on every rank,
the replicated parameters bit-identical across the ranks, events and
device ms a step, the collectives' bytes and host seconds.

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
# -2 and on the axis(-3) view), rows_t_fft, fft2f_fft, r2c_fft, c2r_fft,
# big_fft, filt, c2c, spec_fft and spec_c2c_fft two layouts each
# (rows_fft_c64, ax0_fft_c64, ax3_fft_c64, rows_t_fft_c64, fft2f_fft_c64, r2c_fft_c64, c2r_fft_c64,
# big_fft_c64, filt_c64, c2c_c64, spec_c64 and spec_c2c_c64: their
# complex64 entries, counted apart too).
KERNELS = ("rows_fft", "rows_fft_c64", "ax0_fft", "ax0_fft_c64", "ax3_fft", "ax3_fft_c64",
           "rows_t_fft", "rows_t_fft_c64", "fft2f_fft", "fft2f_fft_c64", "r2c_fft", "r2c_fft_c64", "c2r_fft",
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
# they were, on kept_bits's inputs: B1 (rows_fft, both entries).  Recorded
# from the kernel after the repair of ROADMAP §C C5, which changed its
# bits on purpose (each pass's twiddles w^k gathered from a table of the
# pass's powers, and butterfly constants of |w|^2 nearest 1; NVIDIA H100
# 80GB HBM3, by scripts/time_composite_rows.py --set bits); the other
# kernels' digests were taken out when their kernel changed (B16-B19 and
# B21 when they left welch_fft.cu, B10 when the bank became the filtered
# rows' kernel with its strides swapped and B7 when it became c2r_fft.cu's
# staged design beside B8).
KEPT_BITS = {
    "rows_fft 128": "fdce864e3af207bd", "rows_fft_c64 128": "e029f1ad74aa4edb",
    "rows_fft 256": "5aaaeeaabb907d81", "rows_fft_c64 256": "5a85fa8a7292233a",
    "rows_fft 512": "ccde15b5936cc40b", "rows_fft_c64 512": "a7e6c1bebdaad28d",
    "rows_fft 1024": "7ff8695f06e536c2", "rows_fft_c64 1024": "5e5db0691b4fb6aa",
    "rows_fft 2048": "c0232cb590d1a252", "rows_fft_c64 2048": "9864de1712d15fd0",
    "rows_fft 4096": "77737c7b4f07fced", "rows_fft_c64 4096": "91f828eaa5e62865",
    "rows_fft 8192": "715757ab85fdc6f0", "rows_fft_c64 8192": "825340d7b6c618b8",
    "rows_fft 16384": "7ef62f5b242c7e72", "rows_fft_c64 16384": "b46ec35f0ef559a6"}


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


def device_ms(fn, reps: int = 20) -> float:
    """Device ms per call of fn(): all of its device work in a
    torch.profiler window of ``reps`` calls after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window now and then comes back with no device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        if busy > 0:
            return busy / 1e3 / reps
    raise RuntimeError("check failed: the profiler saw no device time in three windows")


def device_in_turns(fns: dict, reps: int = 20) -> dict:
    """Device ms per call of each version, two rounds in turns; the mean
    of each version's two."""
    samples = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            samples[k].append(device_ms(fns[k], reps))
    return {k: sum(v) / len(v) for k, v in samples.items()}


# (rows, log2 n) of the whole-row kernel's table of times: the main path's
# shapes and each side of the static route's crossover
BIG_SHAPES = ((64, 15), (256, 16), (16, 17), (256, 17), (16, 18), (64, 18))


def big_times(dev, gen, smi) -> dict:
    """The whole-row kernel (B15) through both entries, the four-step's two
    passes (``fourstep.fft_last_axis_c64``: B2 then B4, complex64),
    torch.fft.fft and a copy of the rows (read once, written once), device
    ms in turns at each of BIG_SHAPES, each beside its bound (16 bytes a
    point, 5 n log2 n flops a row)."""
    import torch
    from fft_wgpu_tpu_torch.ops import bigfft, fourstep

    out = {}
    for rows, e in BIG_SHAPES:
        n = 1 << e
        x = torch.complex(torch.randn(rows, n, device=dev, generator=gen),
                          torch.randn(rows, n, device=dev, generator=gen))
        re, im = x.real.contiguous(), x.imag.contiguous()
        y = torch.empty_like(x)
        t = device_in_turns({
            "kernel": lambda: bigfft._launch(re, im, -1, None),
            "kernel_c64": lambda: bigfft._launch_c64(x, -1, None),
            "two-pass": lambda: fourstep.fft_last_axis_c64(x, -1),
            "torch.fft": lambda: torch.fft.fft(x),
            "copy": lambda: y.copy_(x),
        })
        ms, by = bound(16.0 * rows * n, fft_flops(n, rows))
        out[f"{rows}x2^{e}"] = dict(t, bound=ms)
        print(f"times: {smi} | big_fft {rows}x2^{e} | device ms (torch.profiler, 20 calls, 2 "
              "rounds in turns) | " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
              + f" | bound {ms:.4f} ({by})", flush=True)
        del x, re, im, y
    return out


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
            "rows_t_fft_c64": cuda_fft.rows_t_c64_launches,
            "fft2f_fft_c64": cuda_fft.fft2f_c64_launches,
            "r2c_fft_c64": cuda_fft.r2c_c64_launches, "spec_c64": cuda_welch.spec_c64_launches,
            "filt_c64": cuda_fft.filt_c64_launches,
            "c2c_c64": cuda_welch.c2c_c64_launches,
            "spec_c2c_c64": cuda_welch.spec_c2c_c64_launches}


def reset_counts() -> None:
    from fft_wgpu_tpu_torch.ops import bigfft, cuda_fft, cuda_welch

    cuda_fft.c64_launches = bigfft.c64_launches = 0
    cuda_fft.ax0_c64_launches = cuda_fft.ax3_c64_launches = cuda_fft.r2c_c64_launches = 0
    cuda_fft.c2r_c64_launches = cuda_fft.rows_t_c64_launches = 0
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


def edges(ft, dev) -> int:
    """Calls with a length below 1 or an empty operand (ROADMAP §C C6-C14)
    on the card: each must raise, and no launch counter may move.  Prints
    one line and returns the number of calls."""
    import torch

    import fft_wgpu_tpu_torch.torch_backend as tb

    gen = torch.Generator(device=dev).manual_seed(SEED)
    c = torch.randn(3, 4, dtype=torch.complex64, device=dev, generator=gen)
    c64 = torch.randn(4, 2049, dtype=torch.complex64, device=dev, generator=gen)
    r = torch.randn(3, 64, device=dev, generator=gen)
    taps, empty = r[0, :3].contiguous(), r[0, :0]
    # lengths in the kernels' envelope, where a check made late would launch
    r256 = torch.randn(3, 256, device=dev, generator=gen)
    d129 = torch.randn(129, 1, device=dev, generator=gen)

    def accelerated(fn):
        with tb.accelerated():
            return fn()

    calls = {  # what -> (call, the exception it must raise)
        "irfft of 1 bin": (lambda: ft.irfft(c[:, :1]), ValueError),
        "irfft n=0, complex64 source": (lambda: ft.irfft(c64, n=0), ValueError),
        "irfftn s=(0, 4096), complex64 source": (lambda: ft.irfftn(c64, s=(0, 4096)),
                                                 ValueError),
        "hfft of 1 bin": (lambda: ft.hfft(c[:, :1]), ValueError),
        "irfft2 of 1 bin": (lambda: ft.irfft2(c[:, :1]), ValueError),
        "irfftn s=(3, 0)": (lambda: ft.irfftn(c, s=(3, 0)), ValueError),
        "hfftn s=(3, 0)": (lambda: ft.hfftn(c, s=(3, 0)), ValueError),
        "rfft n=0": (lambda: ft.rfft(r, n=0), ValueError),
        "rfftn s=(0, 256), the last axis's R2C first": (
            lambda: ft.rfftn(r256, s=(0, 256)), ValueError),
        "ifft2 of [3, 0]": (lambda: ft.ifft2(c[:, :0]), ValueError),
        "torch.fft.irfft of 1 bin, accelerated": (
            lambda: accelerated(lambda: torch.fft.irfft(c[:, :1])), RuntimeError),
        "czt m=0": (lambda: ft.czt(c, m=0), ValueError),
        "zoom_fft m=0": (lambda: ft.zoom_fft(c, 0.5, m=0), ValueError),
        "ZoomFFT m=0": (lambda: ft.ZoomFFT(4, 0.5, m=0)(c), ValueError),
        "czt of an empty signal": (lambda: ft.czt(c[:, :0]), ValueError),
        "convolve of an empty signal": (lambda: ft.convolve(empty, taps), ValueError),
        "correlate with empty taps": (lambda: ft.correlate(r[0], empty), ValueError),
        "hilbert N=0": (lambda: ft.hilbert(r, N=0), ValueError),
        "hilbert2 N=(3, 0)": (lambda: ft.hilbert2(r, N=(3, 0)), ValueError),
        "hilbert2 of [3, 0]": (lambda: ft.hilbert2(r[:, :0]), ValueError),
        "idct of [3, 0]": (lambda: ft.idct(r[:, :0]), ValueError),
        "dctn type 3 s=(3, 0)": (lambda: ft.dctn(r, 3, s=(3, 0)), ValueError),
        "dctn type 1 of [129, 1], axis 0's R2C first": (lambda: ft.dctn(d129, 1), ValueError),
    }
    for norm in ("ortho", "forward"):
        calls[f"irfft of 1 bin, norm={norm}"] = (
            lambda n=norm: ft.irfft(c[:, :1], norm=n), ValueError)
        calls[f"fftn s=(3, 0), norm={norm}"] = (
            lambda n=norm: ft.fftn(c, s=(3, 0), norm=n), ValueError)
    before = counts()
    for what, (call, error) in calls.items():
        try:
            call()
        except error:
            continue
        check(False, f"edges: {what} returned")
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    check(not moved, f"edges: launched {moved}")
    print(f"edges: {len(calls)} calls raised, 0 launches", flush=True)
    return len(calls)


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


# The kernels a step of the model family (path 10) may launch, as the
# profiler names them; the rest of its device work (the FNOs' einsums,
# matmuls and GELU, the steppers' products) is "other".
MODEL_KERNELS = ("rows_fft", "ax0_fft", "fft2f_fft", "r2c_fft", "c2r_fft")
# The JAX package's tests' bars against their oracles: tests/test_burgers.py
# (Cole-Hopf 1e-4), tests/test_ks.py (float64 ETDRK4 1e-4),
# tests/test_navier_stokes.py (Taylor-Green 1e-4), tests/test_nlse.py (the
# standing soliton 2e-4, the free Gaussian 1e-4), tests/test_poisson.py
# (the 2-D analytic solve 1e-4, here the residual of the spectral Laplacian).
COLE_HOPF_TOL = KS_REF_TOL = TAYLOR_GREEN_TOL = GAUSSIAN_TOL = POISSON_TOL = 1e-4
SOLITON_TOL = 2e-4
ROUND_TRIP_TOL = 6e-8  # |power gain - 1| of the row kernel's forward-inverse pair
# |power gain - 1| of complex64 plan(2^22)'s forward-inverse pair on its
# route before the transposed-rows kernel had a complex64 entry (split,
# the planar pair on radix-4 passes, merge): -8.965e-8 by
# scripts/time_composite_rows.py --set rows_t, NVIDIA H100 80GB HBM3,
# 700.00 W.  Past ROUND_TRIP_TOL already, so the complex64 pair is held
# to no worse.
FOURSTEP_ROUND_TRIP_TOL = 8.965e-8


# |power gain - 1| of the whole-row kernel's forward-inverse pair, 64 rows,
# through its planar and complex64 entries, in the two-crossing design it
# had before its one-crossing redesign (scripts/round_trip_gains.py on that
# tree; NVIDIA H100 80GB HBM3, 700.00 W): within ROUND_TRIP_TOL, as the
# redesign is held to be; printed beside its gains.
BIG_ROUND_TRIP_TWO_CROSSING = {
    ("big_fft", 1 << 16): -5.547e-08, ("big_fft_c64", 1 << 16): -5.527e-08,
    ("big_fft", 1 << 18): -5.025e-08, ("big_fft_c64", 1 << 18): -5.028e-08}


def big_checks(bigfft, dev, gen, sweep, c64, oracle) -> None:
    """The whole-row kernel (B15) beyond its sweep: both entries against
    the plain model of their own decomposition (``bigfft._big_passes``) at
    2^15 and 2^18, both signs; the forward-inverse round trip's power gain
    of both entries at 2^16 and 2^18, held within ROUND_TRIP_TOL, as the
    design before it was (BIG_ROUND_TRIP_TWO_CROSSING); and how many of its
    clusters fit on the card at once, each n and entry
    (cudaOccupancyMaxActiveClusters)."""
    import torch

    model = [((2, n), None) for n in (1 << 15, 1 << 18)]
    sweep("big_fft", model, lambda re, im, s, sc, _: bigfft._launch(re, im, s, sc),
          lambda re, im, s, sc, _: bigfft._big_passes(re, im, s, sc),
          lambda x, s, sc, _: oracle(x, s, sc))
    sweep("big_fft_c64", model, c64(bigfft._launch_c64),
          lambda re, im, s, sc, _: bigfft._big_passes(re, im, s, sc),
          lambda x, s, sc, _: oracle(x, s, sc))
    gains = []
    for n in (1 << 16, 1 << 18):
        x = torch.complex(torch.randn(64, n, device=dev, generator=gen),
                          torch.randn(64, n, device=dev, generator=gen))
        x64 = x.to(torch.complex128)
        for name, fft in (("big_fft", lambda v, s, sc: torch.complex(*bigfft._launch(
                               v.real.contiguous(), v.imag.contiguous(), s, sc))),
                          ("big_fft_c64", lambda v, s, sc: bigfft._launch_c64(v, s, sc))):
            y = fft(fft(x, -1, None), 1, 1.0 / n).to(torch.complex128)
            gain = float((y * x64.conj()).sum().real / x64.abs().square().sum()) - 1.0
            check(abs(gain) <= ROUND_TRIP_TOL, f"{name} round trip 64x{n}: gain - 1 {gain:+.3e}")
            gains.append(f"{name} 64x{n} {gain:+.3e} (two crossings "
                         f"{BIG_ROUND_TRIP_TWO_CROSSING[name, n]:+.3e})")
        del x, x64, y
    print(f"kernel big_fft: round-trip gain - 1 (held within {ROUND_TRIP_TOL:.0e}): "
          + ", ".join(gains), flush=True)
    fits = {f"2^{n.bit_length() - 1} C={bigfft._cluster(n)} {'c64' if c else 'f32'}":
            bigfft._max_clusters(n, c, dev)
            for n in (1 << e for e in range(15, 19)) for c in (True, False)}
    check(all(v > 0 for v in fits.values()), f"big_fft: a cluster does not fit: {fits}")
    print(f"kernel big_fft: clusters at once (cudaOccupancyMaxActiveClusters) {fits}", flush=True)


def ks_reference(u0: np.ndarray, length: float, h: float, steps: int) -> np.ndarray:
    """Kassam and Trefethen's ETDRK4 (kursiv.m) in float64 numpy on the
    host, the full spectrum, 2/3-rule dealiased (tests/test_ks.py's
    oracle)."""
    n = u0.shape[-1]
    k = 2.0 * np.pi / length * np.fft.fftfreq(n, 1.0 / n)
    lin = k * k - k ** 4
    E, E2 = np.exp(h * lin), np.exp(h * lin / 2.0)
    r = np.exp(1j * np.pi * (np.arange(1, 33) - 0.5) / 32)
    zr = h * lin[:, None] + r[None, :]
    Q = h * np.real(np.mean(np.expm1(zr / 2.0) / zr, axis=1))
    f1 = h * np.real(np.mean((-4.0 - zr + np.exp(zr) * (4.0 - 3.0 * zr + zr ** 2)) / zr ** 3, 1))
    f2 = h * np.real(np.mean((2.0 + zr + np.exp(zr) * (-2.0 + zr)) / zr ** 3, 1))
    f3 = h * np.real(np.mean((-4.0 - 3.0 * zr - zr ** 2 + np.exp(zr) * (4.0 - zr)) / zr ** 3, 1))
    dealias = (np.abs(np.fft.fftfreq(n, 1.0 / n)) <= n / 3.0).astype(float)
    g = -0.5j * k * dealias

    def N(v):
        u = np.real(np.fft.ifft(v, axis=-1))
        return g * np.fft.fft(u * u, axis=-1)

    v = np.fft.fft(u0.astype(np.float64), axis=-1) * dealias
    for _ in range(steps):
        nv = N(v)
        a = E2 * v + Q * nv
        na = N(a)
        b = E2 * v + Q * na
        nb = N(b)
        c = E2 * a + Q * (2.0 * nb - nv)
        v = E * v + f1 * nv + 2.0 * f2 * (na + nb) + f3 * N(c)
    return np.real(np.fft.ifft(v, axis=-1))


def models_path(dev, gen, smi) -> dict:
    """Path 10: the model family (``fft_wgpu_tpu_torch.models``) at full
    width on the card.  FNO1d, the repo's flagship (modes 64, width 32,
    depth 2, x [8, 1024, 1]), FNO2d (modes 16², width 32, depth 2, x [4,
    256, 256, 1]) and FNO3d (modes 8³, width 16, depth 2, x [2, 128³, 1]),
    each a forward and one train_step; Burgers (1024 random fields at n =
    8192, nu 0.01; Cole-Hopf at 8192), Kuramoto-Sivashinsky (n 128, L 32 pi,
    h 1/4, 1024 trajectories), 2-D Navier-Stokes (Taylor-Green at 256², 20
    random fields of 256²), the NLSE (a bright soliton at n 4096, the 2-D
    free Gaussian at 256²) and solve_poisson at 256³.  Each call runs once
    with its launches held exact (``through``); its output, and each
    training step's loss and gradients, against the same call on CPU
    copies (the plain path; FNO3d's on the first sample, about 12 s of
    the host's time for the whole batch's 25) at 1e-5 relative L2; the
    analytic oracles at the JAX tests' bars.  Then each step is timed:
    CUDA events, and the device ms of its kernels and of the rest and the
    device's idle share from a torch.profiler window.  Returns each timed
    call's record."""
    import copy

    import torch

    from fft_wgpu_tpu_torch import models
    from fft_wgpu_tpu_torch.models import navier_stokes, spectral
    from fft_wgpu_tpu_torch.ops import cuda_fft
    from fft_wgpu_tpu_torch.ops.rfft import rfft_last_split

    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = torch.device("cpu")
    errs, calls = {}, {}

    def hold(what, got, want, tol=TOL, group=None):
        """The card's ``got`` (a tensor or an (re, im) pair) against
        ``want`` (the CPU's, or a float64 oracle) by relative L2; the worst
        error of each ``group`` (else ``what``) is kept, with its count."""
        if isinstance(got, tuple):
            got, want = torch.complex(*got), torch.complex(*want)
        got = got.detach().cpu()
        want = (want.detach().cpu() if isinstance(want, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(want)))
        check(tuple(got.shape) == tuple(want.shape),
              f"path 10 {what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        check(bool(got.isfinite().all()), f"path 10 {what}: non-finite output")
        err = rel_l2(got, want)
        check(err <= tol, f"path 10 {what}: rel-L2 {err:.3e} > {tol:.0e}")
        worst, count = errs.get(group or what, (0.0, 0))
        errs[group or what] = (max(worst, err), count + 1)
        return err

    def to_cpu(v):
        """A tensor, or a tuple of them, copied to the CPU."""
        return tuple(map(to_cpu, v)) if isinstance(v, tuple) else v.detach().cpu()

    def timed(name, fn, launches, reps):
        calls[name] = {"fn": fn, "launches": launches, "reps": reps}

    # ---- the FNO family: forward and one SGD step (autograd) -------------
    def fno(name, model, x, y, fwd, step, reps, cpu_batch=None):
        """``model``'s forward, its loss and gradients and one train_step on
        the card, each exactly ``fwd`` / ``step`` / ``step`` launches; the
        forward, the loss and every parameter's gradient against a CPU
        copy (of the first ``cpu_batch`` samples where given: the card's
        gradients of those samples' loss); the step's loss, and its
        parameters against p - lr * grad."""
        ref = copy.deepcopy(model).to(cpu)
        weights = list(model.parameters())
        with torch.no_grad():
            out = through(f"path 10 {name} forward", lambda: model(x), **fwd)

        def grads(a, b):
            loss = models.mse_loss(model, a, b)
            return loss, torch.autograd.grad(loss, weights)

        loss, g = through(f"path 10 {name} loss and gradients", lambda: grads(x, y), **step)
        k = slice(None) if cpu_batch is None else slice(0, cpu_batch)
        xc, yc = to_cpu(x[k]), to_cpu(y[k])
        out_c = ref(xc)
        loss_c = torch.mean((out_c - yc) ** 2)
        g_c = torch.autograd.grad(loss_c, list(ref.parameters()))
        hold(f"{name} forward", out[k], out_c)
        loss_k, g_k = (loss, g) if cpu_batch is None else grads(x[k], y[k])
        hold(f"{name} loss", loss_k, loss_c)
        for (pname, _), a, b in zip(model.named_parameters(), g_k, g_c):
            hold(f"{name} d/d{pname}", a, b, group=f"{name} gradients")
        before = [w.detach().clone() for w in weights]
        _, got = through(f"path 10 {name} train_step",
                         lambda: models.train_step(model, x, y, lr=1e-3), **step)
        check(got.ndim == 0 and got.device == dev and not got.requires_grad,
              f"path 10 {name}: train_step's loss {got}")
        hold(f"{name} train_step loss", got, loss)
        for (pname, w), w0, gw in zip(model.named_parameters(), before, g):
            hold(f"{name} train_step {pname}", w, w0 - 1e-3 * gw,
                 group=f"{name} train_step's parameters")

        def forward():
            with torch.no_grad():
                return model(x)

        timed(f"{name} forward {tuple(x.shape)}", forward, fwd, reps)
        timed(f"{name} train_step {tuple(x.shape)}",
              lambda: models.train_step(model, x, y, lr=1e-3), step, reps)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    fno("FNO1d", models.init_fno1d(gen, modes=64, width=32, depth=2, device=dev),
        randn(8, 1024, 1), randn(8, 1024, 1),
        {"r2c_fft": 2, "r2c_fft_c64": 2, "c2r_fft": 2, "c2r_fft_c64": 2},
        {"r2c_fft": 4, "r2c_fft_c64": 4, "c2r_fft": 2, "c2r_fft_c64": 2, "rows_fft": 2,
         "rows_fft_c64": 2}, reps=20)
    fno("FNO2d", models.init_fno2d(gen, modes=(16, 16), width=32, depth=2, device=dev),
        randn(4, 256, 256, 1), randn(4, 256, 256, 1),
        {"fft2f_fft": 4, "fft2f_fft_c64": 2}, {"fft2f_fft": 8, "fft2f_fft_c64": 4}, reps=10)
    fno("FNO3d", spectral.init_fno3d(gen, modes=(8, 8, 8), width=16, depth=2, device=dev),
        randn(2, 128, 128, 128, 1), randn(2, 128, 128, 128, 1),
        {"fft2f_fft": 4, "fft2f_fft_c64": 2, "ax3_fft": 4, "ax3_fft_c64": 2},
        {"fft2f_fft": 8, "fft2f_fft_c64": 4, "ax3_fft": 8, "ax3_fft_c64": 4}, reps=5,
        cpu_batch=1)
    fno_done = time.perf_counter()

    # ---- the steppers: one step and a short rollout against CPU copies ----
    def stepper(name, plan, cpu_plan, step, state, want, rollout, u0, steps, start_end):
        """``step`` on the split state, exactly ``want`` launches, and
        ``rollout`` of ``steps`` steps from ``u0`` (``want`` a step plus
        ``start_end``), each against the CPU plan's."""
        got = through(f"path 10 {name} step", lambda: step(plan, *state), **want)
        hold(f"{name} step", got, step(cpu_plan, *to_cpu(state)))
        total = {k: steps * want.get(k, 0) + start_end.get(k, 0) for k in {*want, *start_end}}
        got = through(f"path 10 {name} rollout {steps}", lambda: rollout(plan, u0, steps), **total)
        hold(f"{name} rollout {steps}", got, rollout(cpu_plan, to_cpu(u0), steps))
        timed(f"{name} step", lambda: step(plan, *state), want, reps=20)

    # Burgers: 1024 random fields at n = 8192 (FNO training data), then
    # Cole-Hopf at 8192 (2000 steps to t = 1: dt inside the advective limit)
    n = 8192
    burgers = {"r2c_fft": 2, "c2r_fft": 2}
    bplan = models.burgers_init(n, 0.01, 1e-4, device=dev)
    u0 = models.random_initial_condition(gen, n, batch=1024, device=dev)
    ur, ui = rfft_last_split(u0, None)
    stepper("burgers 1024x8192", bplan, models.burgers_init(n, 0.01, 1e-4, device=cpu),
            models.burgers_step, (ur * bplan["mask"], ui * bplan["mask"]), burgers,
            models.burgers_rollout, u0, 5, {"r2c_fft": 1, "c2r_fft": 1})
    cplan = models.burgers_init(n, 0.1, 5e-4, device=dev)
    u = through("path 10 Cole-Hopf 8192 x 2000 steps", lambda: models.burgers_rollout(
        cplan, models.cole_hopf_solution(n, 0.1, 0.8, 0.0, device=dev), 2000),
        r2c_fft=4001, c2r_fft=4001)
    hold("Cole-Hopf 8192 t=1", u, models.cole_hopf_solution(n, 0.1, 0.8, 1.0, device=cpu),
         COLE_HOPF_TOL)

    # Kuramoto-Sivashinsky: Kassam-Trefethen's n 128, L 32 pi, h 1/4, on
    # 1024 trajectories (their initial condition, each row scaled)
    n, length, h = 128, 32.0 * np.pi, 0.25
    kplan = models.ks_init(n, length, h, device=dev)
    u0 = models.kt_initial_condition(n, length, device=dev) * (
        0.9 + 0.2 * torch.rand(1024, 1, device=dev, generator=gen))
    vr, vi = rfft_last_split(u0, None)
    stepper("KS 1024x128", kplan, models.ks_init(n, length, h, device=cpu), models.ks_step,
            (vr * kplan["mask"], vi * kplan["mask"]), {"r2c_fft": 4, "c2r_fft": 4},
            models.ks_rollout, u0, 20, {"r2c_fft": 1, "c2r_fft": 1})
    hold("KS 20 steps vs float64 ETDRK4", models.ks_rollout(kplan, u0, 20),
         ks_reference(u0.cpu().numpy(), length, h, 20), KS_REF_TOL)

    # 2-D Navier-Stokes at 256^2: Taylor-Green (k = 2, 50 steps), then 20
    # random zero-mean fields
    ns_step = {"ax0_fft": 10, "c2r_fft": 8, "r2c_fft": 2}
    tg = models.ns2d_init(256, 0.02, 0.01, device=dev)
    w0 = models.taylor_green_vorticity(256, 2, device=dev)
    w = through("path 10 Taylor-Green 256^2 x 50 steps", lambda: models.ns2d_rollout(tg, w0, 50),
                ax0_fft=502, c2r_fft=401, r2c_fft=101)
    hold("Taylor-Green 256^2 decay", w, (w0 * math.exp(-2.0 * 4 * 0.02 * 0.01 * 50)).double(),
         TAYLOR_GREEN_TOL)
    nplan = models.ns2d_init(256, 1e-3, 5e-3, device=dev)
    w0 = randn(20, 256, 256)
    w0 = w0 - w0.mean((-2, -1), keepdim=True)
    wr, wi = navier_stokes._rfft2_split(w0)
    stepper("NS2D 20x256^2", nplan, models.ns2d_init(256, 1e-3, 5e-3, device=cpu),
            models.ns2d_step, (wr * nplan["mask"], wi * nplan["mask"]), ns_step,
            models.ns2d_rollout, w0, 5, {"ax0_fft": 2, "c2r_fft": 1, "r2c_fft": 1})

    # NLSE: a standing bright soliton at n 256 (tests/test_nlse.py's own
    # grid, L 40, 1000 steps to t = 1) and at n 4096 (L 640, 1000 steps),
    # each held at the test's bar, and the free Gaussian on 256^2 (100
    # steps).  A rollout takes one forward-inverse round trip a step, so a
    # round trip that loses power drains its mass linearly: before the
    # repair of ROADMAP §C C5 the row kernel's gain was 1 - 1.3e-7 at 4096
    # and the soliton ended 2.9e-4 from the analytic one.  Its error and
    # mass drift are printed beside the plain path's, and the row kernel's
    # gain through both entries is held within ROUND_TRIP_TOL.
    def soliton(n, length, device):
        return (models.nlse_init((n,), length, 1e-3, g=1.0, device=device),
                models.bright_soliton(n, length, device=device),
                models.bright_soliton(n, length, t=1.0, device=cpu))

    sol, psi0, want = soliton(256, 40.0, dev)
    got = through("path 10 soliton 256 x 1000 steps", lambda: models.nlse_rollout(sol, psi0, 1000),
                  rows_fft=2000)
    hold("bright soliton 256 t=1", got, want, SOLITON_TOL)
    sol, psi0, want = soliton(4096, 640.0, dev)
    stepper("NLSE 4096", sol, models.nlse_init((4096,), 640.0, 1e-3, g=1.0, device=cpu),
            models.nlse_step, psi0, {"rows_fft": 2}, models.nlse_rollout, psi0, 10, {})
    drift = {}
    for where, (plan, p0, w) in (("card", (sol, psi0, want)), ("plain", soliton(4096, 640.0, cpu))):
        got = through("path 10 soliton 4096 x 1000 steps",
                      lambda: models.nlse_rollout(plan, p0, 1000),
                      **({"rows_fft": 2000} if where == "card" else {}))
        if where == "card":
            hold("bright soliton 4096 t=1", got, w, SOLITON_TOL)
        mass = [float((a.double() ** 2 + b.double() ** 2).sum()) for a, b in (got, p0)]
        drift[where] = (rel_l2(torch.complex(*to_cpu(got)), torch.complex(*w)),
                        mass[0] / mass[1] - 1.0)
    # the round trip's power gain, Re <y, x> / <x, x> - 1, of 1000 random
    # rows through the row kernel's two entries, and the plain path's
    gains = []
    for n in (256, 4096):
        xr, xi = randn(1000, n), randn(1000, n)
        x = torch.complex(xr, xi)
        for where, fft in (("card", lambda v, s, sc: torch.complex(*cuda_fft.fft_batched_split(
                               v.real.contiguous(), v.imag.contiguous(), s, sc))),
                           ("card c64", cuda_fft.fft_batched_c64),
                           ("plain", lambda v, s, sc: torch.complex(
                               *cuda_fft.fft_batched_split_reference(
                                   v.real.contiguous(), v.imag.contiguous(), s, sc)))):
            y = fft(fft(x, -1, None), 1, 1.0 / n).to(torch.complex128)
            x64 = x.to(torch.complex128)
            gain = float((y * x64.conj()).sum().real / x64.abs().square().sum()) - 1.0
            if where != "plain":
                check(abs(gain) <= ROUND_TRIP_TOL,
                      f"path 10 rows_fft round trip ({where}) n {n}: gain - 1 {gain:+.3e}")
            gains.append(f"{where} n {n} {gain:+.3e}")
    print("models: bright soliton 4096 t=1 (1000 steps) | "
          + ", ".join(f"{k}: rel-L2 {e:.3e} against the soliton, mass {m:+.3e}"
                      for k, (e, m) in drift.items())
          + " | rows_fft round-trip gain - 1 (held within "
          + f"{ROUND_TRIP_TOL:.0e}): " + ", ".join(gains), flush=True)
    x = (np.arange(256) - 128) * (120.0 / 256)
    free = models.nlse_init((256, 256), 120.0, 5e-3, g=0.0, device=dev)
    psi0 = models.free_gaussian([x, x], 2.5, device=dev)
    stepper("NLSE 256^2", free, models.nlse_init((256, 256), 120.0, 5e-3, g=0.0, device=cpu),
            models.nlse_step, psi0, {"fft2f_fft": 2}, models.nlse_rollout, psi0, 10, {})
    got = through("path 10 free Gaussian 256^2 x 100 steps",
                  lambda: models.nlse_rollout(free, psi0, 100), fft2f_fft=200)
    hold("free Gaussian 256^2 t=0.5", got, models.free_gaussian([x, x], 2.5, t=0.5, device=cpu),
         GAUSSIAN_TOL)

    # solve_poisson at 256^3, held by the residual of the spectral Laplacian
    # (float64 torch.fft on the card: an oracle)
    f = randn(256, 256, 256)
    poisson = {"r2c_fft": 1, "ax3_fft": 2, "ax3_fft_c64": 1, "ax0_fft": 2, "ax0_fft_c64": 1,
               "c2r_fft": 1, "c2r_fft_c64": 1}
    u = through("path 10 solve_poisson 256^3", lambda: models.solve_poisson(f), **poisson)
    hold("solve_poisson 256^3", u, models.solve_poisson(f.cpu()))
    k = torch.fft.fftfreq(256, 1.0 / 256, device=dev, dtype=torch.float64)
    ksq = k[:, None, None] ** 2 + k[None, :, None] ** 2 + k[None, None, :] ** 2
    lap = torch.fft.ifftn(-ksq * torch.fft.fftn(u.double())).real
    hold("solve_poisson 256^3 residual", lap, f.double() - f.double().mean(), POISSON_TOL)
    del lap, ksq, k
    timed("solve_poisson 256^3", lambda: models.solve_poisson(f), poisson, reps=10)
    checked = time.perf_counter() - t0

    for name, rec in calls.items():
        fn = rec.pop("fn")
        # a window can miss launches (PERF.md §7): take it again, at most
        # three times, until it holds the call's launches
        per_call = sum(v for k, v in rec["launches"].items() if not k.endswith("_c64"))
        others = {}
        for window in range(1, 4):
            prof = breakdown(fn, MODEL_KERNELS, reps=rec["reps"], others=others)
            if sum(prof[f"{k} launches"] for k in MODEL_KERNELS) >= per_call:
                break
        work = {}
        for k, v in others.items():  # a kernel's name without its arguments
            k = re.sub(r"[<(].*", "", re.sub(r"^void |\(anonymous namespace\)::", "", k))
            work[k] = work.get(k, 0.0) + v
        rec.update(ms=prof["events"], kernel_ms=sum(prof[k] for k in MODEL_KERNELS),
                   other_ms=prof["other"], idle=prof["idle"],
                   other_launches=prof["other launches"],
                   other_work=dict(sorted(work.items(), key=lambda kv: -kv[1])[:3]))
        print(f"models: {smi} | {name} | {rec['ms']:.4f} ms (CUDA events, median of "
              f"{rec['reps']}) | device ms (torch.profiler, {rec['reps']} calls, window "
              f"{window}): kernels {rec['kernel_ms']:.4f} ("
              + ", ".join(f"{k} {prof[k]:.4f}" for k in MODEL_KERNELS if prof[k])
              + f"), other {rec['other_ms']:.4f} ({rec['other_launches']:.0f} launches: "
              + ", ".join(f"{k} {v:.4f}" for k, v in rec["other_work"].items())
              + f"), idle {rec['idle']:.3f} | launches {rec['launches']}", flush=True)
    total = time.perf_counter() - t0
    print(f"models: checks (the worst rel-L2 of each, the card against the CPU copies at "
          f"{TOL:.0e} or the oracles at the JAX tests' bars) | "
          + ", ".join(f"{k} {v:.3e}" + (f" ({c})" if c > 1 else "") for k, (v, c) in errs.items()),
          flush=True)
    print(f"main: models path (path 10), {sum(c for _, c in errs.values())} checks ok, "
          f"{len(calls)} calls timed | "
          f"FNOs {fno_done - t0:.1f} s, checked in {checked:.1f} s, timed in "
          f"{total - checked:.1f} s ({total:.1f} s in all)", flush=True)
    return calls


# path 11's child process: load the AOT artifact in a fresh process whose
# build directory is empty, replay it, and say whether it matched the
# parent's output bit for bit and whether nvcc ran
AOT_CHILD = """
import json, sys, tempfile, torch
sys.path.insert(0, sys.argv[1])
from fft_wgpu_tpu_torch.utils import build
build.set_build_dir(tempfile.mkdtemp())
import fft_wgpu_tpu_torch as ft
sp = ft.load_plan(sys.argv[2])
x, want = torch.load(sys.argv[3])
x = x.cuda()
got = [g.cpu() for g in sp.forward_split(x.real.contiguous(), x.imag.contiguous())]
print(json.dumps({"equal": bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])),
                  "compiles": build.compiles, "libraries": sorted(build._LIBS)}))
"""


def serving_path(dev, gen, smi) -> dict:
    """Path 11: the serving surface on the card.  Tuned plans
    (``plan(n, autotune=True)``) at 16 and 256 x 2^17, 4 and 64 x 2^18
    and 4 x 2^20 (the whole-row kernel against the axis(-2) then the
    transposed-rows kernel, where the whole-row kernel takes the shape;
    256 rows fall in the largest rows bucket, and at 64 x 2^18 the two
    kernels have won) and at 1024 x 4097
    and 1024 x 3012 (the composite-row kernel against Bluestein's fused
    chirp kernel): every candidate's time and the winner, the result
    within 1e-5 of torch.fft, the second call's launches exact for the
    winner; the fused-plane crossover (``tune_fused_plane``, restored
    after, since later paths hold the plane route's launches).  The AOT
    artifact of plan(4096) on 4096 x 4096: replayed bit-equal to the plan,
    in this process and in a child process with an empty build directory
    and no nvcc run.  ``dot_precision("fast")``: the row kernel's bits
    unchanged, TF32 as it was after the block, the plain path's matmuls
    in TF32 inside it.  The scipy.fft and torch.fft backends on the card
    against float64 references, with their kernels' launches.  The CLI's
    ``info`` and ``selftest`` as subprocesses.  Returns the tuned
    routes."""
    import tempfile

    import scipy.fft as sf
    import torch

    import fft_wgpu_tpu_torch as ft
    import fft_wgpu_tpu_torch.scipy_backend as sb
    import fft_wgpu_tpu_torch.torch_backend as tb
    from fft_wgpu_tpu_torch.ops import cuda_fft
    from fft_wgpu_tpu_torch.plan import autotune
    from fft_wgpu_tpu_torch.utils import build

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    autotune._WISDOM_PATH = os.path.join(tmp, "wisdom.json")
    autotune._wisdom_loaded = True
    card = torch.cuda.get_device_name(dev)

    def crand(*shape):
        return torch.complex(torch.randn(shape, device=dev, generator=gen),
                             torch.randn(shape, device=dev, generator=gen))

    def hold(what, got, want, tol=TOL):
        err = rel_l2(got, want)
        check(err <= tol, f"path 11 {what}: rel-L2 {err:.3e} > {tol:.0e}")
        return err

    # tuned plans: each route's kernels, launched once by the second call
    second = {"pallas": {"rows_fft": 1, "rows_fft_c64": 1},
              "bigfft": {"big_fft": 1, "big_fft_c64": 1},
              "fourstep:two-pass": {"ax0_fft": 1, "ax0_fft_c64": 1, "rows_t_fft": 1,
                                    "rows_t_fft_c64": 1},
              "fourstep": {"ax0_fft": 1, "ax0_fft_c64": 1, "rows_t_fft": 1,
                           "rows_t_fft_c64": 1},
              "general": {"gen_fft": 1}, "bluestein": {"chirp_full": 1}}
    routes = {}
    for rows, n in ((16, 1 << 17), (256, 1 << 17), (4, 1 << 18), (64, 1 << 18), (4, 1 << 20),
                    (1024, 4097), (1024, 3012)):
        x = crand(rows, n)
        p = ft.plan(n, autotune=True)
        got = p.forward(x)  # measures, then runs the winner
        key = (card, n, 1 if rows == 1 else autotune._bucket(rows), -1)
        best = autotune.TUNE_CACHE[key]
        err = hold(f"tuned plan {rows}x{n}", got, torch.fft.fft(x))
        got = through(f"path 11 tuned plan {rows}x{n} ({best}), second call",
                      lambda: p.forward(x), **second[best])
        hold(f"tuned plan {rows}x{n} second call", got, torch.fft.fft(x))
        times = autotune.TIMES.get(key, {})
        routes[f"{rows}x{n}"] = best
        print(f"serving: {smi} | plan({n}, autotune=True) {rows}x{n} | candidates "
              + (", ".join(f"{ex} {t * 1e3:.4f} ms" for ex, t in times.items())
                 if times else f"one: {best} (nothing to time)")
              + f" | winner {best} | rel-L2 {err:.3e} | second call's launches "
              + f"{second[best]}", flush=True)
    saved = cuda_fft.FFT2F_MAX_ELEMS
    limit = autotune.tune_fused_plane(device=dev, persist=False)
    cuda_fft.FFT2F_MAX_ELEMS = saved
    print(f"serving: {smi} | tune_fused_plane | "
          + ", ".join(f"{a}^2: fused {t['fused'] * 1e3:.4f} ms, row+axis(-2) "
                      f"{t['two-pass'] * 1e3:.4f} ms"
                      for (_, c, a), t in ((k, v) for k, v in autotune.TIMES.items()
                                           if k[0] == "plane" and k[1] == card))
          + f" | crossover {limit} points (restored to {saved} for the later paths)",
          flush=True)

    # the AOT artifact of plan(4096) on 4096 x 4096
    p = ft.plan(4096)
    path = os.path.join(tmp, "plan4096.ftta")
    ft.export_plan(p, path, batch_shape=(4096,))
    x = crand(4096, 4096)
    re, im = x.real.contiguous(), x.imag.contiguous()
    want = p.forward_split(re, im)
    sp = ft.load_plan(path)
    got = through("path 11 AOT replay of plan(4096)", lambda: sp.forward_split(re, im),
                  rows_fft=1)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "path 11 AOT replay: not bit-equal to the plan")
    for op in ("inverse", "inverse_unnormalized"):
        got, ref = getattr(sp, f"{op}_split")(re, im), getattr(p, f"{op}_split")(re, im)
        check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              f"path 11 AOT replay {op}: not bit-equal to the plan")
    torch.save((x.cpu(), tuple(w.cpu() for w in want)), os.path.join(tmp, "io.pt"))
    child = subprocess.run([sys.executable, "-c", AOT_CHILD, root, path,
                            os.path.join(tmp, "io.pt")],
                           capture_output=True, text=True, timeout=300)
    check(child.returncode == 0, f"path 11 AOT child: rc {child.returncode}\n{child.stderr}")
    res = json.loads(child.stdout.strip().splitlines()[-1])
    check(res["equal"] and res["compiles"] == 0 and res["libraries"] == ["rows_fft"],
          f"path 11 AOT child: {res}")
    meta = sp._meta
    print(f"serving: {smi} | AOT plan(4096) 4096x4096 | {os.path.getsize(path)} bytes, "
          f"libraries {meta['libraries']}, routes "
          f"{ {op: r['route'] for op, r in meta['routes'].items()} }, capability "
          f"{meta['capability']} | replay bit-equal here and in a child process "
          f"(nvcc runs {res['compiles']}, libraries {res['libraries']})", flush=True)
    del x, re, im, want, got, ref

    # dot precision: the kernels read no mode; the plain path's matmuls do
    x = crand(64, 4096)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    accurate = p.forward(x)
    y = crand(64, 100)  # 100: no kernel, the plain path's DFT matmuls
    plain_accurate = ft.fft(y)
    with ft.dot_precision("fast"):
        fast = p.forward(x)
        plain_fast = ft.fft(y)
        check(torch.backends.cuda.matmul.allow_tf32 == tf32,
              "path 11 dot_precision: TF32 set outside the matmul guard")
    check(torch.backends.cuda.matmul.allow_tf32 == tf32, "path 11 dot_precision: TF32 not restored")
    check(torch.equal(accurate, fast), "path 11 dot_precision('fast') changed the row kernel's bits")
    ref = torch.fft.fft(y.to(torch.complex128))
    err_a = hold("plain path, accurate", plain_accurate, ref)
    err_f = rel_l2(plain_fast, ref)
    print(f"serving: {smi} | dot_precision | row kernel 64x4096 bit-equal in both modes, "
          f"TF32 {tf32} after | plain path 64x100 rel-L2 against float64: accurate "
          f"{err_a:.3e}, fast {err_f:.3e}", flush=True)

    # the interop backends on the card, against float64 references
    xn = (np.random.default_rng(SEED).standard_normal((2, 64, 4096))
          .astype(np.float32))
    zc = (xn[0] + 1j * xn[1]).astype(np.complex64)
    z2 = zc.reshape(256, 1024)[:, :512].copy()  # both axes on the kernels, no fused plane
    lines = []

    def backend_call(what, fn, want, kernel):
        fn()  # builds and uploads
        torch.cuda.synchronize()
        before = counts()
        got = fn()
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        check(delta.get(kernel, 0) >= 1, f"path 11 {what}: {kernel} did not launch ({delta})")
        got = got.cpu() if isinstance(got, torch.Tensor) else torch.from_numpy(np.asarray(got))
        err = rel_l2(got, torch.from_numpy(np.asarray(want)))
        check(err <= TOL, f"path 11 {what}: rel-L2 {err:.3e} > {TOL:.0e}")
        lines.append(f"{what} rel-L2 {err:.3e} launches {delta}")

    with sf.set_backend(sb, only=True):
        backend_call("scipy.fft.fft 64x4096", lambda: sf.fft(zc),
                     np.fft.fft(zc.astype(np.complex128)), "rows_fft")
        backend_call("scipy.fft.rfft 64x4096", lambda: sf.rfft(xn[0]),
                     np.fft.rfft(xn[0].astype(np.float64)), "r2c_fft")
        backend_call("scipy.fft.fft2 256x512", lambda: sf.fft2(z2),
                     np.fft.fft2(z2.astype(np.complex128)), "ax0_fft")
    zt, z2t = torch.from_numpy(zc).to(dev), torch.from_numpy(z2).to(dev)
    rt = torch.from_numpy(xn[0]).to(dev)
    with tb.accelerated():
        backend_call("torch.fft.fft 64x4096", lambda: torch.fft.fft(zt),
                     np.fft.fft(zc.astype(np.complex128)), "rows_fft")
        backend_call("torch.fft.rfft 64x4096", lambda: torch.fft.rfft(rt),
                     np.fft.rfft(xn[0].astype(np.float64)), "r2c_fft")
        backend_call("torch.fft.ifft2 256x512", lambda: torch.fft.ifft2(z2t),
                     np.fft.ifft2(z2.astype(np.complex128)), "ax0_fft")
        f64 = torch.fft.fft(zt.to(torch.complex128))  # 64-bit: stock torch.fft
        check(f64.dtype == torch.complex128, "path 11 torch_backend: float64 left stock")
    print(f"serving: {smi} | backends | " + "; ".join(lines), flush=True)

    # the CLI
    for cmd in (["info"], ["selftest", "--n", "4096"]):
        out = subprocess.run([sys.executable, "-m", "fft_wgpu_tpu_torch", *cmd], cwd=root,
                             capture_output=True, text=True, timeout=600)
        check(out.returncode == 0, f"path 11 CLI {cmd}: rc {out.returncode}\n{out.stdout}"
                                   f"\n{out.stderr}")
        if cmd == ["info"]:
            info = json.loads(out.stdout.strip().splitlines()[-1])
            check(info["device_kind"] == card and info["backend"] == "cuda",
                  f"path 11 CLI info: {info}")
        else:
            check("selftest: PASS" in out.stdout, f"path 11 CLI selftest:\n{out.stdout}")
        print(f"serving: CLI {' '.join(cmd)} | rc 0 | "
              + " | ".join(out.stdout.strip().splitlines()), flush=True)
    print(f"serving: path 11 done in {time.perf_counter() - t0:.1f} s", flush=True)
    return routes


# Path 12's calls: the JAX package's cached_call sites at the shapes of
# PERF.md §5 (the estimators at 2^22 with nperseg 4096 and hop 2048, stft and
# istft at 2^20, rfft, irfft and the DCT family at 4096^2, oaconvolve 2^20 x
# 129, fftconvolve 2048 x 4096, hilbert and the spectrograms as paths 5-7
# run them), each with the kernels the profiler names in it.  Replay must
# give eager's bits wherever two eager calls do; GRAPH_TOL is the bar where
# they do not (stated beside the call that needed it).  The calls in
# ONE_LAUNCH_CALLS take a route of one launch an axis and no other device
# work, which their sites run eagerly, uncached (a replay's copy in and
# clone out would cost more than the host work it saves); beside each, the
# same site at a composite length takes a route that is captured.
GRAPH_TOL = 1e-6
ONE_LAUNCH_CALLS = ("rfft 4096x4096", "irfft 4096x2049 complex64", "fft2 4096x4096 complex64",
                    "stft 2^20 n_fft 512 hop 128", "hilbert 4096x4096",
                    "spectrogram 2^22 complex")


def graph_sites(dev, gen) -> list:
    """(call, fn, inputs, other inputs of the same shapes, kernels) of path 12."""
    import torch

    import fft_wgpu_tpu_torch as ft

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def crand(*shape):
        return torch.complex(rand(*shape), rand(*shape))

    seg = {"nperseg": 4096, "noverlap": 2048}
    r, x, y = rand(4096, 4096), rand(1 << 22), rand(1 << 22)
    xc, x20, xm = torch.complex(x, y), rand(1 << 20), rand(16384)
    c2, sig, taps = crand(4096, 4096), rand(1 << 20), rand(129)
    a2, b2 = rand(2048, 4096), rand(2048, 4096)
    R, Z20 = torch.fft.rfft(r), torch.stft(x20, 512, 128, window=torch.hann_window(
        512, device=dev), return_complex=True)
    r4000, c4000 = r[:, :4000].contiguous(), c2[:, :4000].contiguous()
    R4000 = R[:, :2001].contiguous()
    tail = LONG_TAIL_KERNELS
    sites = [
        ("rfft 4096x4096", ft.rfft, (r,), ("r2c_fft",)),
        ("rfft 4096x4000", ft.rfft, (r4000,), tail),
        ("irfft 4096x2049 complex64", ft.irfft, (R,), ("c2r_fft",)),
        ("irfft 4096x2001 complex64 n 4000", lambda z: ft.irfft(z, n=4000), (R4000,), tail),
        ("fft2 4096x4096 complex64", ft.fft2, (c2,), ("rows_fft", "ax0_fft")),
        ("fft2 4096x4000 complex64", ft.fft2, (c4000,), tail),
        ("stft 2^20 n_fft 512 hop 128", lambda v: ft.stft(v, 512, 128), (x20,), ("spec_fft",)),
        ("stft 2^20 n_fft 2000 hop 500", lambda v: ft.stft(v, 2000, 500), (x20,), tail),
        ("istft 2^20 n_fft 512 hop 128", lambda z: ft.istft(z, 512, 128, length=1 << 20),
         (Z20,), ("c2r_fft",)),
        ("welch 2^22", lambda v: ft.welch(v, **seg), (x,), ("welch_acc",)),
        ("csd 2^22", lambda v, u: ft.csd(v, u, **seg), (x, y), ("welch_acc",)),
        ("welch 2^22 complex64 two-sided", lambda v: ft.welch(v, **seg), (xc,), ("welch_acc",)),
        ("welch 2^22 median", lambda v: ft.welch(v, average="median", **seg), (x,),
         ("psd_pairs",)),
        ("coherence 2^22", lambda v, u: ft.coherence(v, u, **seg), (x, y), ("welch_acc",)),
        ("multitaper 16384 K=7", lambda v: ft.multitaper(v, NW=4.0, K=7), (xm,),
         ("r2c_fft",)),
        ("spectrogram 2^22", lambda v: ft.spectrogram(v, nperseg=4096), (x,), ("psd_pairs",)),
        ("spectrogram 2^22 complex", lambda v: ft.spectrogram(v, mode="complex", **seg), (x,),
         ("spec_fft",)),
        ("oaconvolve 2^20 x 129", ft.oaconvolve, (sig, taps), ("r2c_fft", "c2r_prod")),
        ("oaconvolve complex64 2^20 x 129", ft.oaconvolve,
         (torch.complex(sig, x20), torch.complex(taps, taps.flip(0))), ("rows_fft",)),
        ("fftconvolve 2048x4096", lambda u, v: ft.fftconvolve(u, v, axes=-1), (a2, b2),
         ("r2c_fft", "c2r_prod")),
        ("fftconvolve complex64 2048x4096", lambda u, v: ft.fftconvolve(u, v, axes=-1),
         (torch.complex(a2, b2), torch.complex(b2, a2)), ("rows_fft",)),
        ("hilbert 4096x4096", ft.hilbert, (r,), ("r2c_fft", "filt_fft")),
        ("hilbert 4096x4000", ft.hilbert, (r4000,), tail),
        ("dct type 1 4096x4096", lambda v: ft.dct(v, type=1), (r,), tail),
        ("dct type 4 4096x4096", lambda v: ft.dct(v, type=4), (r,), tail),
        ("dct type 2 4096x4096", lambda v: ft.dct(v, type=2), (r,), tail),
        ("idct type 2 4096x4096", lambda v: ft.idct(v, type=2), (r,), tail),
        ("dst type 1 4096x4096", lambda v: ft.dst(v, type=1), (r,), tail),
        ("dctn type 2 4096x4096", lambda v: ft.dctn(v, type=2), (r,), tail),
    ]
    return [(call, fn, ins, tuple(v.roll(1, -1) for v in ins), names)
            for call, fn, ins, names in sites]


def _flat(out) -> list:
    """The tensors of a call's result (a tensor or a tuple of them)."""
    import torch

    return [out] if isinstance(out, torch.Tensor) else [t for t in out
                                                        if isinstance(t, torch.Tensor)]


def graph_site(call, fn, inputs, others, names, smi) -> dict:
    """Path 12 at one call: call 1 eager, call 2 captures, call 3 replays;
    calls 2 and 3 give call 1's bits where two eager calls agree bit for
    bit (else within GRAPH_TOL); a result held from a replay is unchanged by
    a replay on other inputs, which gives eager's result there; the
    counters rise, and the profiler sees the named kernels, per replay as
    per eager call; events ms and idle share eager (the cache cleared
    before each call) and replayed, and the host ms of an eager call, of
    the capturing call and of a replayed one.  A call of ONE_LAUNCH_CALLS
    instead makes no cache entry in three calls, each with the first's
    launches and bits, and is timed eager."""
    import torch

    from fft_wgpu_tpu_torch.utils import jit_cache

    def run(*args):
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = _flat(fn(*args))
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t)
        return out, {k: v - before[k] for k, v in counts().items() if v != before[k]}, host_ms

    def same_bits(a, b) -> bool:
        return all(torch.equal(u, v) for u, v in zip(a, b))

    def hold(what, got, want, exact):
        check(len(got) == len(want) and all(u.shape == v.shape for u, v in zip(got, want)),
              f"path 12 {call} {what}: shapes differ")
        if exact:
            check(same_bits(got, want), f"path 12 {call} {what}: not eager's bits")
            return 0.0
        err = max(rel_l2(u, v) for u, v in zip(got, want))
        check(err <= GRAPH_TOL, f"path 12 {call} {what}: rel-L2 {err:.3e} > {GRAPH_TOL:.0e}")
        return err

    jit_cache.clear()
    if call in ONE_LAUNCH_CALLS:
        eager, launched, _ = run(*inputs)
        check(bool(launched), f"path 12 {call}: no launch")
        for i in (2, 3):
            got, n, _ = run(*inputs)
            check(n == launched, f"path 12 {call} call {i}: launches {n}, call 1 {launched}")
            check(same_bits(got, eager), f"path 12 {call} call {i}: not call 1's bits")
        check(not jit_cache._CACHE, f"path 12 {call}: a one-launch route made a cache entry")
        got = {}
        e = breakdown(lambda: fn(*inputs), names, reps=20, counted=got)
        check(got == {k: 20 * v for k, v in launched.items()},
              f"path 12 {call}: counters {got} over 20 calls, {launched} a call")
        print(f"graphs: {smi} | {call} | eager by rule (one launch an axis, no cache entry in "
              f"three calls, call 1's bits) | launches {launched} | eager {e['events']:.4f} ms "
              f"idle {e['idle']:.2f}", flush=True)
        return {"exact": True, "eager": e, "replayed": None}

    eager_other, _, _ = run(*others)
    jit_cache.clear()
    eager, launched, _ = run(*inputs)
    jit_cache.clear()
    eager2, _, eager_host = run(*inputs)
    exact = same_bits(eager, eager2)
    captured, n2, capture_host = run(*inputs)
    entries = list(jit_cache._CACHE.values())
    check(len(entries) == 1 and isinstance(entries[0], jit_cache._Graph),
          f"path 12 {call}: {len(entries)} cache entries after the capture, not one graph")
    replayed, n3, replay_host = run(*inputs)
    check(n2 == launched and n3 == launched,
          f"path 12 {call}: launches eager {launched}, capture {n2}, replay {n3}")
    err = max(hold("capture", captured, eager, exact), hold("replay", replayed, eager, exact))
    held = [t.clone() for t in replayed]
    other, _, _ = run(*others)
    check(same_bits(replayed, held), f"path 12 {call}: a held result changed on replay")
    hold("replay on other inputs", other, eager_other, exact)
    nbytes = entries[0].nbytes

    def eager_call():
        jit_cache.clear()
        return fn(*inputs)

    # a window that misses a launch or two is taken again (at most five
    # times, every other one without the profiler's schedule), as phase 5's
    for attempt in range(5):
        prof, others = {}, {}
        for how, f in (("eager", eager_call), ("replayed", lambda: fn(*inputs))):
            got = {}
            prof[how] = breakdown(f, names, reps=20, counted=got, scheduled=attempt % 2 == 0,
                                  others=others.setdefault(how, {}))
            check(got == {k: 20 * v for k, v in launched.items()},
                  f"path 12 {call} {how}: counters {got} over 20 calls, {launched} a call")
        seen = {k: (prof["eager"][f"{k} launches"], prof["replayed"][f"{k} launches"])
                for k in names}
        if all(e == r and e == int(e) for e, r in seen.values()):
            break
    else:
        check(False, f"path 12 {call}: the profiler's launches a call, eager and replayed: "
                     f"{seen}")
    e, r = prof["eager"], prof["replayed"]
    added = sorted(set(others["replayed"]) - set(others["eager"]))
    print(f"graphs: {smi} | {call} | {'bits' if exact else f'rel-L2 {err:.2e}'} | launches "
          f"{launched} | eager {e['events']:.4f} ms idle {e['idle']:.2f} | replayed "
          f"{r['events']:.4f} ms idle {r['idle']:.2f} | host ms a call: eager {eager_host:.2f}, "
          f"capturing {capture_host:.2f}, replayed {replay_host:.2f} | graph "
          f"{nbytes / 2**20:.1f} MiB | other launches {e['other launches']:g} "
          f"-> {r['other launches']:g} (new: {', '.join(added) or 'none'})", flush=True)
    return {"exact": exact, "eager": e, "replayed": r, "capture_host_ms": capture_host,
            "eager_host_ms": eager_host, "nbytes": nbytes}


# path 12's child process: the graph cache's path on a fresh torch.profiler
# (late in a long run the profiler's windows miss launches, PERF.md §7, and
# path 12 holds eager and replayed windows to the same launches); the
# libraries are built already and load with no build
GRAPH_CHILD = """
import sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
chip_smoke.graph_cache_path(dev, torch.Generator(device=dev).manual_seed(chip_smoke.SEED),
                            sys.argv[2])
"""


def graph_cache_child(smi) -> None:
    """Run path 12 (:func:`graph_cache_path`) in a child process and pass its
    lines on; it fails if the child does."""
    root = os.path.dirname(os.path.abspath(__file__))
    child = subprocess.run([sys.executable, "-c", GRAPH_CHILD, root, smi],
                           capture_output=True, text=True, timeout=900)
    print(child.stdout, end="", flush=True)
    check(child.returncode == 0,
          f"path 12 child: rc {child.returncode}\n{child.stderr[-4000:]}")


def graph_cache_path(dev, gen, smi) -> dict:
    """Path 12: the CUDA-graph cache (``utils.jit_cache``) at each of its
    call sites (:func:`graph_site`), the memory its graphs hold, LRU
    eviction past 256 keys, eviction past its byte bound handing the
    memory back, and an impl that cannot be captured raising through it."""
    import torch

    from fft_wgpu_tpu_torch.utils import jit_cache

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    jit_cache.clear()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(dev)
    sites = graph_sites(dev, gen)
    inputs = torch.cuda.memory_reserved(dev)
    results = {call: graph_site(call, fn, ins, others, names, smi)
               for call, fn, ins, others, names in sites}
    # every captured call's graph at once: the memory the cache holds (each
    # graph's pool is its own), as the device reserves it and as the cache
    # counts it against its bound
    jit_cache.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    captured = [site for site in sites if site[0] not in ONE_LAUNCH_CALLS]
    for _call, fn, ins, _others, _names in captured:
        fn(*ins)
        fn(*ins)
    torch.cuda.synchronize()
    held = torch.cuda.memory_reserved(dev)
    peak = torch.cuda.max_memory_reserved(dev)
    counted = jit_cache._BYTES[dev.index]
    kept = sum(isinstance(e, jit_cache._Graph) for e in jit_cache._CACHE.values())
    limit = jit_cache.MAX_BYTES or torch.cuda.get_device_properties(dev).total_memory // 8
    check(counted <= limit, f"path 12: the graphs hold {counted} bytes, past the bound")
    check(kept == len(captured) or counted + max(
        r["nbytes"] for r in results.values() if r["replayed"] is not None) > limit,
        f"path 12: {kept} of {len(captured)} graphs kept under the bound")
    print(f"graphs: {smi} | memory_reserved: the inputs {(inputs - base) / 2**20:.1f} MiB; "
          f"with the captured calls' graphs ({kept} of {len(captured)} kept under the bound of "
          f"{limit / 2**20:.1f} MiB) {(held - inputs) / 2**20:.1f} MiB more, peak "
          f"{(peak - inputs) / 2**20:.1f} MiB; the cache counts {counted / 2**20:.1f} MiB",
          flush=True)
    del sites, captured
    jit_cache.clear()
    torch.cuda.empty_cache()

    # LRU: 256 keys captured, the first used again, then two more keys: the
    # second and third keys go, the first and the newest stay; rfft of a
    # composite length, whose route is captured
    import fft_wgpu_tpu_torch as ft

    def key_of(rows):  # rfft's key of [rows, 240] float32
        return "rfft", ((rows, 240), "float32"), 240, -1, None

    def use(rows, n=240):
        v = torch.ones(rows, n, device=dev)
        ft.rfft(v)
        ft.rfft(v)

    empty = torch.cuda.memory_reserved(dev)
    for rows in range(1, jit_cache.MAX_ENTRIES + 1):
        use(rows)
    full = torch.cuda.memory_reserved(dev)
    use(1)
    use(jit_cache.MAX_ENTRIES + 1)
    use(jit_cache.MAX_ENTRIES + 2)
    torch.cuda.synchronize()
    kept = {k[0] for k in jit_cache._CACHE}
    check(len(jit_cache._CACHE) == jit_cache.MAX_ENTRIES,
          f"path 12 LRU: {len(jit_cache._CACHE)} entries")
    check(key_of(2) not in kept and key_of(3) not in kept,
          "path 12 LRU: the least recently used keys were kept")
    check(all(key_of(r) in kept for r in (1, 4, jit_cache.MAX_ENTRIES + 2)),
          "path 12 LRU: a recently used key was evicted")
    evicted = torch.cuda.memory_reserved(dev)
    torch.cuda.empty_cache()
    evicted_emptied = torch.cuda.memory_reserved(dev)
    jit_cache.clear()
    torch.cuda.empty_cache()
    print(f"graphs: {smi} | LRU: {jit_cache.MAX_ENTRIES + 2} keys of rfft [rows, 240], "
          f"the least recently used two evicted | memory_reserved {empty / 2**20:.1f} MiB "
          f"before, {full / 2**20:.1f} MiB with 256 graphs, {evicted / 2**20:.1f} MiB after "
          f"evicting two, {evicted_emptied / 2**20:.1f} MiB after empty_cache, "
          f"{torch.cuda.memory_reserved(dev) / 2**20:.1f} MiB after clear()", flush=True)

    # the byte bound: graphs of rfft [4096, 4000] under a bound of two and a
    # half such graphs; the third capture evicts the least recently used,
    # whose pool the allocator then hands back to the device
    bound = jit_cache.MAX_BYTES
    try:
        use(4096, 4000)
        one = jit_cache._BYTES[dev.index]
        jit_cache.MAX_BYTES = int(2.5 * one)
        use(4097, 4000)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        two = torch.cuda.memory_reserved(dev)
        use(4098, 4000)
        torch.cuda.synchronize()
        graphs = [k[-1][0][0][0] for k, e in jit_cache._CACHE.items() if e is not None]
        check(graphs == [4097, 4098], f"path 12 byte bound: graphs of rows {graphs} kept")
        check(jit_cache._BYTES[dev.index] <= jit_cache.MAX_BYTES,
              "path 12 byte bound: the graphs hold more than the bound")
        torch.cuda.empty_cache()
        after = torch.cuda.memory_reserved(dev)
        check(after <= two + one // 4, f"path 12 byte bound: memory_reserved {after} after "
                                       f"evicting one of three graphs, {two} with two")
    finally:
        jit_cache.MAX_BYTES = bound
    print(f"graphs: {smi} | byte bound: one graph of rfft [4096, 4000] {one / 2**20:.1f} MiB; "
          f"bound {2.5 * one / 2**20:.1f} MiB; memory_reserved {two / 2**20:.1f} MiB with two, "
          f"{after / 2**20:.1f} MiB after the third evicted the first (empty_cache)",
          flush=True)
    jit_cache.clear()
    torch.cuda.empty_cache()

    # an impl that reads the host: eager at the first call, raising at the
    # capture, never an eager result
    v = torch.randn(4096, device=dev, generator=gen)
    key = ("path 12 uncapturable",)
    impl = lambda u: u * float(u.sum().item())  # noqa: E731
    jit_cache.cached_call(key, impl, v)
    try:
        jit_cache.cached_call(key, impl, v)
    except RuntimeError as err:
        print(f"graphs: {smi} | an impl calling .item() raised at its capture: "
              f"{str(err).splitlines()[0][:160]}", flush=True)
    else:
        check(False, "path 12: an impl calling .item() returned from its capture")
    check(key not in {k[0] for k in jit_cache._CACHE if jit_cache._CACHE[k] is not None},
          "path 12: the uncapturable impl was cached")
    jit_cache.clear()
    print(f"graphs: path 12 done in {time.perf_counter() - t0:.1f} s", flush=True)
    return results


def examples_path(dev, smi) -> dict:
    """Path 13: the port's examples (``fft_wgpu_tpu_torch.examples``) on the
    card at the JAX examples' own sizes, each asserting its own check: in
    this process, but for ``serving``, which points the build cache at
    ``~/.cache`` and so runs as ``python -m`` in a child process whose home
    holds that cache as a link to this checkout's build directory (a warm
    cache: the libraries load with no build).  Returns each one's
    seconds."""
    import importlib
    import tempfile

    from fft_wgpu_tpu_torch.examples import NAMES
    from fft_wgpu_tpu_torch.utils import build

    t0 = time.perf_counter()
    seconds = {}
    for name in NAMES:
        t1 = time.perf_counter()
        if name == "serving":
            home = tempfile.mkdtemp(prefix="chip_smoke_home_")
            os.makedirs(os.path.join(home, ".cache"))
            os.symlink(build.BUILD_DIR, os.path.join(home, ".cache",
                                                     "fft_wgpu_tpu_torch_build"))
            out = subprocess.run(
                [sys.executable, "-m", "fft_wgpu_tpu_torch.examples.serving"],
                cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                timeout=300, env={**os.environ, "HOME": home})
            print(out.stdout, end="", flush=True)
            check(out.returncode == 0,
                  f"path 13 serving: rc {out.returncode}\n{out.stdout}\n{out.stderr[-3000:]}")
        else:
            importlib.import_module(f"fft_wgpu_tpu_torch.examples.{name}").main(device=dev)
        seconds[name] = time.perf_counter() - t1
        print(f"examples: {smi} | {name} | ok | {seconds[name]:.1f} s", flush=True)
    print(f"examples: path 13, {len(NAMES)} examples done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return seconds


# ---------------------------------------------------------------------- #
# path 14: the distributed layer (parallel/, models/ns3d, the distributed
# Poisson solve), one process a rank
# ---------------------------------------------------------------------- #
DIST_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.distributed_rank(*sys.argv[2:])
"""
NS3D_TOL = 1e-4      # examples/ns3d_dns.py's bar for the ABC decay
NS3D_REF_TOL = 2e-5  # tests/test_ns3d.py's bar against an independent scheme
BF16_TOL = 2e-2      # tests/test_distributed.py's bar for bf16 corner turns


def rel_l2_big(got, want, what: str, tol: float = TOL) -> float:
    """:func:`check_close` for tensors too large for a float64 copy: the
    sums accumulate in float64 over flat runs of 2^24 elements."""
    import torch

    check(tuple(got.shape) == tuple(want.shape),
          f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = got.reshape(-1), want.reshape(-1)
    num = den = 0.0
    for s in range(0, g.numel(), 1 << 24):
        a, b = g[s:s + (1 << 24)], w[s:s + (1 << 24)]
        check(bool(a.isfinite().all()), f"{what}: non-finite output")
        num += float((a - b).abs().to(torch.float64).square().sum())
        den += float(b.abs().to(torch.float64).square().sum())
    err = math.sqrt(num / den)
    check(err <= tol, f"{what}: rel-L2 {err:.3e} > {tol:.0e}")
    return err


def ns3d_reference(u0, nu: float, dt: float, steps: int):
    """tests/test_ns3d.py's independent scheme (rotational form, Leray
    projection, integrating-factor Heun) in torch.fft, complex64, on u0's
    device: the distributed rollout's oracle."""
    import torch

    n = u0.shape[-1]
    k = torch.fft.fftfreq(n, 1.0 / n, device=u0.device)
    kx, ky = k[:, None, None], k[None, :, None]
    kz = torch.fft.rfftfreq(n, 1.0 / n, device=u0.device)[None, None, :]
    ksq = kx * kx + ky * ky + kz * kz
    ksq_safe = torch.where(ksq == 0.0, 1.0, ksq)
    cut = n / 3.0
    mask = ((kx.abs() <= cut) & (ky.abs() <= cut) & (kz <= cut)).float()
    E = torch.exp(-nu * ksq * dt)

    def rfft3(x):
        return torch.fft.rfftn(x, dim=(-3, -2, -1))

    def irfft3(X):
        return torch.fft.irfftn(X, s=(n, n, n), dim=(-3, -2, -1))

    def project(F):
        div = (kx * F[0] + ky * F[1] + kz * F[2]) / ksq_safe
        return torch.stack([F[0] - kx * div, F[1] - ky * div, F[2] - kz * div])

    def nonlinear(U):
        W = torch.stack([1j * (ky * U[2] - kz * U[1]), 1j * (kz * U[0] - kx * U[2]),
                         1j * (kx * U[1] - ky * U[0])])
        u, w = irfft3(U), irfft3(W)
        lamb = torch.stack([u[1] * w[2] - u[2] * w[1], u[2] * w[0] - u[0] * w[2],
                            u[0] * w[1] - u[1] * w[0]])
        return project(rfft3(lamb) * mask)

    U = project(rfft3(u0) * mask)
    for _ in range(steps):
        N1 = nonlinear(U)
        P = (U + dt * N1) * E
        N2 = nonlinear(P)
        U = U * E + 0.5 * dt * (N1 * E + N2)
    return irfft3(U)


def dist_window(fn, names, reps: int = 5) -> tuple:
    """Device ms per call of each part of ``names`` (kernels as
    ``<name>_kernel``, or a prefix such as "nccl") and of the rest, events
    ms per call and the idle share, from one torch.profiler window of
    ``reps`` calls after a traced warm-up call, and the kernel events of
    the window in time order (name, ms).  Every rank makes the same calls
    (no retried window: a rank that called more would hang its peers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    event_ms = time_ms(fn, reps, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
    parts = dict.fromkeys(tuple(names) + ("other",), 0.0)
    seq = []
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name.startswith("ProfilerStep")):
            continue
        part = kernel_part(e.name, names)
        ms = e.time_range.elapsed_us() / 1e3
        parts[part] += ms / reps
        seq.append((e.time_range.start, part, ms))
    busy = sum(parts.values())
    check(busy > 0, "path 14: the profiler saw no device time")
    return ({"events": event_ms, **parts, "idle": 1.0 - busy / event_ms},
            [(p, ms) for _, p, ms in sorted(seq)])


def _pipelined(axis_size: int, extent: int, chunks: int) -> int:
    """Launches of one FFT -> turn pair: one a chunk where it pipelines."""
    return 1 if axis_size == 1 or chunks <= 1 or extent < chunks else chunks


def _kernels(**k) -> dict:
    """Launch counts by kernel with each complex64 entry counted twice, as
    its own counter and its kernel's (``counts``)."""
    out = {}
    for name, v in k.items():
        if v:
            out[name] = v
            out[f"{name}_c64"] = v
    return out


# path 10's FNO3d train_step: forward and backward of 2 blocks, each fftn
# (B5 planar, B3 planar) and ifftn (B5, B3 complex64) and their adjoints
FNO_TP_STEP = {"fft2f_fft": 8, "fft2f_fft_c64": 4, "ax3_fft": 8, "ax3_fft_c64": 4}


def fno_tp_path(rank: int, world: int, say, reps: int) -> None:
    """Path 14's FNO-3D dp x tp training step (``parallel.fno``) at path
    10's full width (modes 8^3, width 16, depth 2, 128^3 fields) on the
    pencil mesh of every rank named ("dp", "tp"), global x and y
    [2 dp, 128^3, 1]: one step with each rank's launches exact (path 10's
    FNO3d step, on its shard), its loss and every gathered parameter
    against ``spectral.train_step`` of the global batch on a copy (rank
    0) at 1e-5, the replicated parameters and the loss bit-identical
    across the ranks (at world 1, no collective ran); then events ms a
    step, the device ms of B5, B3, the collectives' kernels and copies and
    the rest, and the collectives' bytes and host seconds a step."""
    import copy

    import torch
    import torch.distributed as dist

    from fft_wgpu_tpu_torch.models import spectral
    from fft_wgpu_tpu_torch.parallel import fno
    from fft_wgpu_tpu_torch.parallel.mesh import make_pencil_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_pencil_mesh(axis_names=("dp", "tp"))
    dp, tp = mesh.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    model = spectral.init_fno3d(gen, modes=(8, 8, 8), width=16, depth=2, device=dev)
    shape = (2 * dp, 128, 128, 128, 1)
    x = torch.randn(shape, device=dev, generator=gen)
    y = torch.randn(shape, device=dev, generator=gen)
    ref = copy.deepcopy(model) if rank == 0 else None
    sh = fno.shard_params(model, mesh)
    del model
    what = f"path 14 FNO3d dp x tp step {dp}x{tp}"
    reset_counts()
    fno.reset_stats()
    _, loss = through(what, lambda: fno.train_step(sh, x, y, lr=1e-3), **FNO_TP_STEP)
    moved = dict(fno.STATS)
    if world == 1:
        check(all(v == 0 for v in moved.values()), f"{what}: collectives ran alone: {moved}")
    full = fno.gather_params(sh)
    rep = torch.cat([p.detach().reshape(-1) for n, p in sh.named_parameters()
                     if not n.endswith(("wr", "wi"))] + [loss.reshape(1)]).cpu()
    if world > 1:
        every = [None] * world
        dist.all_gather_object(every, rep)
        check(all(torch.equal(every[0], r) for r in every),
              f"{what}: the replicated parameters or the loss differ across the ranks")
    if rank == 0:
        _, want = spectral.train_step(ref, x, y, lr=1e-3)
        el = rel_l2_big(loss, want, f"{what} loss")
        ep = max(rel_l2_big(p.detach(), q.detach(), f"{what} {n}")
                 for (n, p), q in zip(full.named_parameters(), ref.parameters()))
        say(f"FNO3d dp x tp step, x {list(shape)}, width 16, modes 8^3: rel-L2 vs "
            f"spectral.train_step of the global batch: loss {el:.2e}, worst parameter "
            f"{ep:.2e}; launches a rank {FNO_TP_STEP}; replicated parameters and loss "
            f"bit-identical across {world} rank(s); a step's collectives: all-gathers "
            f"{moved['all_gathers']} ({moved['gather_bytes'] / 2**20:.2f} MiB), "
            f"reduce-scatters {moved['reduce_scatters']} "
            f"({moved['scatter_bytes'] / 2**20:.3f} MiB), all-reduces "
            f"{moved['all_reduces']} ({moved['reduce_bytes'] / 2**20:.3f} MiB)")
    del full, ref

    def step():
        fno.train_step(sh, x, y, lr=1e-3)

    names = ("fft2f_fft", "ax0_fft", "nccl", "Memcpy")
    fno.reset_stats()
    wire = ("gather_bytes", "scatter_bytes", "reduce_bytes")
    parts, _ = dist_window(step, names, reps=reps)
    calls = 2 * reps + 2  # time_ms's warm-up and reps, the traced warm-up, the window
    if world == 1:
        check(parts["nccl"] == 0 and fno.STATS["all_gathers"] == 0,
              f"{what}: collectives' device work at world 1: {parts}")
    say(f"FNO3d dp x tp step a step: events ms {parts['events']:.3f}, device ms fft2f_fft "
        f"(B5) {parts['fft2f_fft']:.3f}, ax0_fft (B3) {parts['ax0_fft']:.3f}, nccl "
        f"{parts['nccl']:.3f}, memcpy {parts['Memcpy']:.3f}, other {parts['other']:.3f}, idle "
        f"{parts['idle']:.3f}; host staging s {fno.STATS['host_stage_s'] / calls:.4f} for "
        f"{fno.STATS['host_stage_bytes'] / calls / 2**20:.1f} MiB, gloo exchange s "
        f"{fno.STATS['host_exchange_s'] / calls:.4f}, collective bytes "
        f"{sum(fno.STATS[k] for k in wire) / calls / 2**20:.2f} MiB")
    if world == 1:
        unsharded = spectral.init_fno3d(gen, modes=(8, 8, 8), width=16, depth=2, device=dev)
        t = time_in_turns({"sharded": step, "unsharded": lambda: spectral.train_step(
            unsharded, x, y, lr=1e-3)}, reps=reps)
        say(f"events ms a step in turns: fno.train_step {t['sharded']:.3f}, "
            f"spectral.train_step {t['unsharded']:.3f}")


def _path14_nccl(rank: int, world: int, backend: str, smi: str) -> None:
    """Path 14 (a): every card of the machine, one rank each, on NCCL, at
    full width (BASELINE config 5's 1024^3 cube), then the FNO-3D dp x tp
    step at path 10's width."""
    import torch
    import torch.distributed as dist

    from fft_wgpu_tpu_torch import models
    from fft_wgpu_tpu_torch.models import ns3d
    from fft_wgpu_tpu_torch.parallel import batched, pencil
    from fft_wgpu_tpu_torch.parallel.mesh import make_mesh, make_pencil_mesh
    from fft_wgpu_tpu_torch.utils.roofline import pencil_fft3d_model

    dev = torch.device("cuda", torch.cuda.current_device())
    pm, fm = make_pencil_mesh(), make_mesh()
    px, py = pm.shape
    chunks = pencil._chunks(pm, None)
    tag = f"dist: {smi} | {backend} x{world} mesh {px}x{py}"

    def say(msg):
        if rank == 0:
            print(f"{tag} | {msg}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = 1024
    nat, tr = (0, 1), (1, 2)

    # ---- fft3d / ifft3d of the 1024^3 complex64 cube (8 GiB) ------------
    x = torch.randn((n, n, n), dtype=torch.complex64, device=dev, generator=gen)
    zc = _pipelined(py, n // px, chunks)
    yc = _pipelined(px, n // py, chunks)
    want3 = _kernels(rows_fft=zc, ax0_fft=yc, ax3_fft=1)
    errs = {}
    for what, fn, ref in (("fft3d", pencil.fft3d, torch.fft.fftn),
                          ("ifft3d", pencil.ifft3d, torch.fft.ifftn)):
        reset_counts()
        pencil.reset_stats()
        y = through(f"path 14 {what} 1024^3", lambda: fn(x, pm), **want3)
        if world == 1:
            check(all(v == 0 for v in pencil.STATS.values()),
                  f"path 14 {what}: the turns did device work alone: {pencil.STATS}")
        want = pencil._local(ref(x), pm, nat, torch.complex64)
        errs[what] = rel_l2_big(y.to_local(), want, f"path 14 {what} 1024^3")
        del y, want
    # the transposed round trip: 2 + 2 turns, the mirror schedule back
    reset_counts()
    X = through("path 14 fft3d 1024^3 transposed out", lambda: pencil.fft3d(
        x, pm, transposed_output=True), **want3)
    back = through("path 14 ifft3d 1024^3 transposed in", lambda: pencil.ifft3d(
        X, pm, transposed_input=True), **_kernels(
            ax3_fft=_pipelined(px, n // py, chunks), ax0_fft=_pipelined(py, n // px, chunks),
            rows_fft=1))
    errs["round trip"] = rel_l2_big(back.to_local(), pencil._local(x, pm, nat, torch.complex64),
                                    "path 14 transposed round trip 1024^3")
    del X, back
    say("1024^3 complex64 rel-L2 vs torch.fft: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()) + f"; launches a call {want3}")

    names = ("rows_fft", "ax0_fft", "nccl")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pencil.fft3d(x, pm)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    parts, seq = dist_window(lambda: pencil.fft3d(x, pm), names, reps=5)
    kern = [(p, ms) for p, ms in seq if p in ("rows_fft", "ax0_fft")]
    per = len(kern) // 5
    by_pos = [statistics.mean(ms for _, ms in kern[i::per]) for i in range(per)] if per else []
    lib_ms = time_ms(lambda: torch.fft.fftn(x), reps=5, warmup=1)
    floor = pencil_fft3d_model(n, (px, py), hbm_bw=HBM_BYTES_PER_S)
    say(f"fft3d 1024^3: events ms {parts['events']:.3f}, device ms " + ", ".join(
        f"{k} {parts[k]:.3f}" for k in names + ("other",)) + f", idle {parts['idle']:.3f}; "
        f"kernels in call order (ms): {', '.join(f'{v:.3f}' for v in by_pos)}; "
        f"torch.fft.fftn ms {lib_ms:.3f}; model floor ms {1e3 * floor['overlapped_s']:.2f} "
        f"(compute {1e3 * floor['compute_s']:.2f}, turns {1e3 * floor['ici_s']:.2f}); "
        f"peak GiB {peak / 2**30:.2f} with the input's {base / 2**30:.2f}")
    if world == 1:
        check(parts["nccl"] == 0 and parts["other"] == 0,
              f"path 14: at world 1 fft3d ran device work besides its kernels: {parts}")
    del x

    # ---- rfft3d / irfft3d of a 1024^3 float32 cube --------------------
    r = torch.randn((n, n, n), device=dev, generator=gen)
    nb = n // 2 + 1
    kp = pencil._kp(nb, py)
    reset_counts()
    R = through("path 14 rfft3d 1024^3", lambda: pencil.rfft3d(r, pm), **_kernels(
        r2c_fft=1, ax0_fft=_pipelined(px, kp // py, chunks), ax3_fft=1))
    spec = torch.fft.rfftn(r)
    e_r = rel_l2_big(R.to_local(), pencil._local(spec, pm, nat, torch.complex64),
                     "path 14 rfft3d 1024^3")
    t_r = time_ms(lambda: pencil.rfft3d(r, pm), reps=5, warmup=1)
    t_rl = time_ms(lambda: torch.fft.rfftn(r), reps=5, warmup=1)
    y = through("path 14 irfft3d 1024^3", lambda: pencil.irfft3d(R, n, pm), **_kernels(
        ax0_fft=_pipelined(px, kp // py, chunks), ax3_fft=1, c2r_fft=1))
    e_i = rel_l2_big(y.to_local(), pencil._local(torch.fft.irfftn(spec, s=(n, n, n)), pm, nat,
                                                 torch.float32), "path 14 irfft3d 1024^3")
    del spec, y
    t_i = time_ms(lambda: pencil.irfft3d(R, n, pm), reps=5, warmup=1)
    say(f"rfft3d/irfft3d 1024^3 float32: rel-L2 {e_r:.2e} / {e_i:.2e}; events ms "
        f"{t_r:.3f} / {t_i:.3f}; torch.fft.rfftn ms {t_rl:.3f}")
    del R, r

    # ---- fft1d_distributed of 2^26 points, fft_batch_sharded 4096^2 ----
    v = torch.randn(1 << 26, dtype=torch.complex64, device=dev, generator=gen)
    y = through("path 14 fft1d_distributed 2^26", lambda: pencil.fft1d_distributed(v, fm),
                **_kernels(ax0_fft=1, rows_fft=1))
    e1 = rel_l2_big(y.to_local(), pencil._local(torch.fft.fft(v), fm, (0,), torch.complex64),
                    "path 14 fft1d_distributed 2^26")
    t1 = time_ms(lambda: pencil.fft1d_distributed(v, fm), reps=10)
    t1l = time_ms(lambda: torch.fft.fft(v), reps=10)
    b = torch.randn((4096, 4096), dtype=torch.complex64, device=dev, generator=gen)
    y = through("path 14 fft_batch_sharded 4096^2", lambda: batched.fft_batch_sharded(b, fm),
                **_kernels(rows_fft=1))
    eb = rel_l2_big(y.to_local(), pencil._local(torch.fft.fft(b), fm, (0,), torch.complex64),
                    "path 14 fft_batch_sharded 4096^2")
    say(f"fft1d_distributed 2^26: rel-L2 {e1:.2e}, events ms {t1:.3f}, torch.fft.fft ms "
        f"{t1l:.3f}; fft_batch_sharded 4096^2: rel-L2 {eb:.2e}")
    del v, b, y

    # ---- the distributed Poisson solve at 512^3 ------------------------
    f = torch.randn((512, 512, 512), device=dev, generator=gen)
    kp5 = pencil._kp(257, py)
    u = through("path 14 solve_poisson_distributed 512^3", lambda: models.solve_poisson_distributed(
        f, pm), **_kernels(r2c_fft=1, c2r_fft=1,
                           ax0_fft=_pipelined(px, kp5 // py, chunks) + _pipelined(py, 512 // px,
                                                                                  chunks),
                           ax3_fft=1 + _pipelined(px, kp5 // py, chunks)))
    ep = rel_l2_big(u.to_local(), pencil._local(models.solve_poisson(f), pm, nat, torch.float32),
                    "path 14 solve_poisson_distributed 512^3 vs solve_poisson")
    tp = time_ms(lambda: models.solve_poisson_distributed(f, pm), reps=5, warmup=1)
    say(f"solve_poisson_distributed 512^3: rel-L2 vs solve_poisson {ep:.2e}, events ms {tp:.3f}")
    del f, u

    # ---- ns3d: the ABC decay at 256^3 over 20 steps, a random field's
    # step against the independent scheme, one timed RK2 step at 512^3 --
    nu, dt, steps = 0.05, 0.05, 20
    c = models.ns3d_init(256, nu, dt, pm)
    u0 = models.abc_flow(256, device=dev)
    # a step is 2 nonlinear terms, each 1 batched inverse (the X pair, the
    # Y pair, C2R) and 1 batched forward (R2C, the Y pair, X); the
    # rollout's first forward and last inverse besides
    k = 2 * steps + 1
    kl = pencil._kp(129, py) // py
    pair_x, pair_y = _pipelined(px, kl, chunks), _pipelined(py, 256 // px, chunks)
    t0 = time.perf_counter()
    u = through("path 14 ns3d ABC 256^3 x 20 steps", lambda: models.ns3d_rollout(c, u0, steps),
                **_kernels(r2c_fft=k, c2r_fft=k, ax3_fft=k + k * pair_x,
                           ax0_fft=k * pair_x + k * pair_y))
    t_abc = time.perf_counter() - t0
    e_abc = rel_l2_big(u.to_local(), pencil._local(u0 * math.exp(-nu * dt * steps), pm,
                                                   (1, 2), torch.float32),
                       "path 14 ns3d ABC decay 256^3", NS3D_TOL)
    ur = torch.randn((3, 256, 256, 256), device=dev, generator=gen)
    c1 = models.ns3d_init(256, 0.02, 0.05, pm)
    got = models.ns3d_rollout(c1, ur, 1)
    e_ref = rel_l2_big(got.to_local(), pencil._local(ns3d_reference(ur, 0.02, 0.05, 1), pm,
                                                     (1, 2), torch.float32),
                       "path 14 ns3d step 256^3 vs the torch.fft scheme", NS3D_REF_TOL)
    del got, ur
    c5 = models.ns3d_init(512, 1e-3, 1e-3, pm)
    u5 = pencil._local(torch.randn((3, 512, 512, 512), device=dev, generator=gen), pm, (1, 2),
                       torch.float32)
    t5 = c5.tables(dev)
    U5 = ns3d._project(t5, ns3d._rfft3(c5, u5) * t5["mask"])
    check(bool(ns3d._step(c5, t5, U5).isfinite().all()), "path 14 ns3d step 512^3: non-finite")
    t_step = time_ms(lambda: ns3d._step(c5, t5, U5), reps=3, warmup=1)
    say(f"ns3d: ABC 256^3 x {steps} steps rel-L2 vs u0 exp(-nu t) {e_abc:.2e} "
        f"({t_abc:.2f} s with the tables' build), random 256^3 step vs torch.fft scheme "
        f"{e_ref:.2e}; one RK2 step at 512^3 events ms {t_step:.3f}")
    del U5, u5, c5, t5

    # ---- the gradient of sum(w |fft3d(x)|^2) at 256^3 -------------------
    xg = torch.randn((256, 256, 256), dtype=torch.complex64, device=dev, generator=gen)
    w = torch.rand((256, 256, 256), device=dev, generator=gen)
    xv = xg.clone().requires_grad_(True)
    reset_counts()

    def loss_grad():
        y = pencil.fft3d(xv, pm).to_local()
        (pencil._local(w, pm, nat, torch.float32) * (y.real ** 2 + y.imag ** 2)).sum().backward()

    through("path 14 fft3d gradient 256^3", loss_grad,
            **{k2: 2 * v2 for k2, v2 in _kernels(rows_fft=_pipelined(py, 256 // px, chunks),
                                                 ax0_fft=_pipelined(px, 256 // py, chunks),
                                                 ax3_fft=1).items()})
    g = xv.grad.clone()
    dist.all_reduce(g)
    adj = 2 * xg.numel() * torch.fft.ifftn(w * torch.fft.fftn(xg))
    eg = rel_l2_big(g, adj, "path 14 fft3d gradient 256^3 vs its adjoint")
    say(f"fft3d gradient 256^3: rel-L2 vs 2 N ifftn(w fftn(x)) {eg:.2e}")
    del xg, w, xv, g, adj

    # ---- the FNO-3D dp x tp training step at path 10's width -----------
    fno_tp_path(rank, world, say, reps=5)


def _path14_gloo(rank: int, world: int, backend: str, smi: str) -> None:
    """Path 14 (b): a 2 x 2 mesh of 4 processes sharing one card on a gloo
    group at 256^3: real corner turns, staged through the host, around the
    card's kernels; then the FNO-3D dp x tp step, dp = tp = 2, at path 10's
    width."""
    import torch
    import torch.distributed as dist

    from fft_wgpu_tpu_torch import models
    from fft_wgpu_tpu_torch.parallel import pencil
    from fft_wgpu_tpu_torch.parallel.mesh import make_pencil_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    pm = make_pencil_mesh()
    px, py = pm.shape
    chunks = pencil._chunks(pm, None)
    tag = f"dist: {smi} | {backend} x{world} mesh {px}x{py} on one card"

    def say(msg):
        if rank == 0:
            print(f"{tag} | {msg}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = 256
    nat = (0, 1)
    x = torch.randn((n, n, n), dtype=torch.complex64, device=dev, generator=gen)
    want3 = _kernels(rows_fft=_pipelined(py, n // px, chunks),
                     ax0_fft=_pipelined(px, n // py, chunks), ax3_fft=1)
    reset_counts()
    pencil.reset_stats()
    y = through("path 14 (b) fft3d 256^3", lambda: pencil.fft3d(x, pm), **want3)
    stats = dict(pencil.STATS)
    e3 = rel_l2_big(y.to_local(), pencil._local(torch.fft.fftn(x), pm, nat, torch.complex64),
                    "path 14 (b) fft3d 256^3")
    X = pencil.fft3d(x, pm, transposed_output=True)
    back = pencil.ifft3d(X, pm, transposed_input=True)
    et = rel_l2_big(back.to_local(), pencil._local(x, pm, nat, torch.complex64),
                    "path 14 (b) transposed round trip 256^3")
    yb = pencil.fft3d(x, pm, comm_dtype=torch.bfloat16)
    eb = rel_l2_big(yb.to_local(), y.to_local(), "path 14 (b) fft3d bf16 turns", BF16_TOL)
    r = torch.randn((n, n, n), device=dev, generator=gen)
    R = pencil.rfft3d(r, pm, transposed_output=True)
    er = rel_l2_big(pencil.irfft3d(R, n, pm, transposed_input=True).to_local(),
                    pencil._local(r, pm, nat, torch.float32), "path 14 (b) rfft3d/irfft3d 256^3")
    Rn = pencil.rfft3d(r, pm)
    ern = rel_l2_big(Rn.to_local(), pencil._local(torch.fft.rfftn(r), pm, nat, torch.complex64),
                     "path 14 (b) rfft3d 256^3")
    say(f"fft3d 256^3 rel-L2 vs torch.fft {e3:.2e} (launches {want3}; turns "
        f"{stats['turns']}, pack copies {stats['pack_copies']}, unpack copies "
        f"{stats['unpack_copies']}, chunk copies {stats['chunk_copies']}); transposed round "
        f"trip {et:.2e}; bf16 turns vs float32 {eb:.2e}; rfft3d {ern:.2e}, R2C round trip "
        f"{er:.2e}")

    pencil.reset_stats()
    parts, _ = dist_window(lambda: pencil.fft3d(x, pm), ("rows_fft", "ax0_fft"), reps=5)
    calls = 5 + 1 + 1 + 5  # time_ms's warm-up and reps, the traced warm-up, the window
    say(f"fft3d 256^3 a call: events ms {parts['events']:.3f}, device ms rows_fft "
        f"{parts['rows_fft']:.3f}, ax0_fft {parts['ax0_fft']:.3f}, other (packs, unpacks, "
        f"host copies) {parts['other']:.3f}, idle {parts['idle']:.3f}; host staging ms "
        f"{1e3 * pencil.STATS['host_stage_s'] / calls:.3f} for "
        f"{pencil.STATS['host_stage_bytes'] / calls / 2**20:.1f} MiB (device to host and back), "
        f"the gloo exchanges' host ms {1e3 * pencil.STATS['host_exchange_s'] / calls:.3f}")

    ur = torch.randn((3, n, n, n), device=dev, generator=gen)
    c = models.ns3d_init(n, 0.02, 0.05, pm)
    got = models.ns3d_rollout(c, ur, 1)
    en = rel_l2_big(got.to_local(), pencil._local(ns3d_reference(ur, 0.02, 0.05, 1), pm, (1, 2),
                                                  torch.float32),
                    "path 14 (b) ns3d step 256^3 vs the torch.fft scheme", NS3D_REF_TOL)
    w = torch.rand((n, n, n), device=dev, generator=gen)
    xv = x.clone().requires_grad_(True)
    yv = pencil.fft3d(xv, pm).to_local()
    (pencil._local(w, pm, nat, torch.float32) * (yv.real ** 2 + yv.imag ** 2)).sum().backward()
    g = xv.grad.cpu()
    dist.all_reduce(g)
    eg = rel_l2_big(g.to(dev), 2 * x.numel() * torch.fft.ifftn(w * torch.fft.fftn(x)),
                    "path 14 (b) fft3d gradient 256^3 vs its adjoint")
    say(f"ns3d step 256^3 vs torch.fft scheme {en:.2e}; fft3d gradient across the processes "
        f"vs 2 N ifftn(w fftn(x)) {eg:.2e}")
    del x, y, yb, X, back, r, R, Rn, ur, got, w, xv, yv, g
    fno_tp_path(rank, world, say, reps=2)


def distributed_rank(part: str, rank: str, world: str, address: str, backend: str,
                     smi: str) -> None:
    """One rank of path 14: join the group, run part "a" or "b", leave."""
    import torch
    import torch.distributed as dist

    from fft_wgpu_tpu_torch.parallel.multihost import initialize

    torch.backends.cuda.matmul.allow_tf32 = False
    initialize(address, int(world), int(rank), backend=backend)
    try:
        (_path14_nccl if part == "a" else _path14_gloo)(int(rank), int(world), backend, smi)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _run_ranks(part: str, world: int, backend: str, smi: str, timeout: float,
               env=None) -> None:
    """Path 14's ranks as child processes (a ``file://`` store in a fresh
    directory), their output passed on; it fails if one fails or hangs."""
    import shutil
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    store = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    logs = [open(os.path.join(store, f"rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", DIST_CHILD, root, part, str(r), str(world),
                               f"file://{store}/store", backend, smi],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env={**os.environ, **(env or {})})
             for r in range(world)]
    try:
        t0 = time.perf_counter()
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad or time.perf_counter() - t0 > timeout:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    shutil.rmtree(store, ignore_errors=True)
    print(outs[0], end="", flush=True)
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"path 14 ({part}) rank {r}: rc {p.returncode}\n{outs[r][-4000:]}")


def distributed_path(smi) -> None:
    """Path 14: the distributed layer, in child processes.  (a) NCCL across
    every card of the machine, one process a card (one card: a 1 x 1 mesh,
    every turn the identity); (b) a 2 x 2 mesh of 4 processes sharing
    cuda:0 on a gloo group, the turns staged through the host."""
    import gc

    import torch

    from fft_wgpu_tpu_torch.utils import jit_cache

    jit_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()  # the children need the card's memory
    t0 = time.perf_counter()
    _run_ranks("a", torch.cuda.device_count(), "nccl", smi, 900)
    t1 = time.perf_counter()
    _run_ranks("b", 4, "gloo", smi, 600, env={"CUDA_VISIBLE_DEVICES": "0"})
    print(f"dist: path 14 done in {time.perf_counter() - t0:.1f} s ((a) {t1 - t0:.1f} s)",
          flush=True)


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

    def rows_t_c64(re, im, s, sc, o):
        y = cuda_fft._rows_t_launch_c64(torch.complex(re, im), s, sc, o)
        return y.real, y.imag

    sweep("rows_t_fft_c64",
          [((rows, n), outer) for n in pow2 for rows in (1, 200)
           for outer in (None, (rows, rows * n), (rows, 3 << 12))]
          + [((1024, 4096), (1024, 1 << 22))],
          rows_t_c64,
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
    big_checks(bigfft, dev, gen, sweep, c64, oracle)
    sweep("ax3_fft",
          [((2, n, 7, 130), None) for n in (128, 1000, 1024, 16384)]
          + [((256, 256, 256), None), ((1080, 8, 24), None)],
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
        for rows, n in [(rows, 1 << e) for e in range(7, 15) for rows in (1, 3, 1000)] \
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
    for n in (646, 1004, 1080, 2047, 16383):  # B2c in place: the output over its input
        re, im = planes(crand(2, n, 1925))
        want = cuda_fft._ax0_launch(re, im, 1, 0.5)
        check(cuda_fft._ax0_launch(re, im, 1, 0.5, out=(re, im))[0] is re
              and torch.equal(re, want[0]) and torch.equal(im, want[1]),
              f"ax0_gen in place {n} x 1925: not the bits of the out-of-place call")
    print("kernel ax0_gen in place: 5 lengths ok, the same bits as out of place", flush=True)

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

    # a complex64 tensor along its last axis: the complex64 entry (the
    # four-step: both passes' complex64 entries), no split
    two_pass = {"ax0_fft": 1, "ax0_fft_c64": 1, "rows_t_fft": 1, "rows_t_fft_c64": 1}
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
    # the round trip's power gain, Re <y, x> / <x, x> - 1, of the complex64
    # pair (held to no worse than the split route it replaced)
    x64 = x.to(torch.complex128)
    y = p.inverse(p.forward(x)).to(torch.complex128)
    gain = float((y * x64.conj()).sum().real / x64.abs().square().sum()) - 1.0
    check(abs(gain) <= max(ROUND_TRIP_TOL, FOURSTEP_ROUND_TRIP_TOL),
          f"plan(2^22) complex64 round trip: gain - 1 {gain:+.3e}")
    print(f"main: plan(2^22) complex64 round trip power gain - 1 {gain:+.3e} (held within "
          f"{FOURSTEP_ROUND_TRIP_TOL:.3e}, the split route's; ROUND_TRIP_TOL "
          f"{ROUND_TRIP_TOL:.0e})", flush=True)
    # planes through the same two kernels' planar entries
    re, im = planes(x)
    Xr, Xi = through("plan(2^22).forward_split", lambda: p.forward_split(re, im),
                     ax0_fft=1, rows_t_fft=1)
    errs["plan2^22_fwd_split"] = check_close(torch.complex(Xr, Xi), torch.fft.fft(x),
                                             "plan(2^22).forward_split")
    del x, X, xu, x64, y, re, im, Xr, Xi
    # each side of the static route's crossover (bigfft.TWO_PASS_FROM) too
    for rows, e, kernels in ((4, 22, two_pass), (1, 20, two_pass),
                             (256, 16, whole), (1, 17, whole), (64, 17, whole),
                             (256, 17, two_pass), (16, 18, whole), (64, 18, two_pass)):
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
    for name in ("rows_fft", "rows_fft_c64", "ax0_fft", "ax0_fft_c64", "rows_t_fft",
                 "rows_t_fft_c64", "big_fft", "big_fft_c64"):
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
    edges(ft, dev)
    long_tail(ft, dev, gen, smi)  # path 8
    # The kernels line gives each kernel the launches of the path it was
    # ported for (the 1-D path for B1, B2, B4 and B15, the non-pow2 path for
    # B11-B14 and chirp_full, the fused-epilogue path for B8-B10 and
    # B2-composite, the estimators' path for B16-B19 and B21, the
    # per-segment path for B20 and B22, config 4 for the rest); each path's
    # counts are on its line.
    path_of = {"rows_fft": path1, "rows_fft_c64": path1, "ax0_fft": path1, "rows_t_fft": path1,
               "rows_t_fft_c64": path1,
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
            ("", (2, 1 << 20), via_fft, {"ax0_fft": 2, "ax0_fft_c64": 2, "rows_t_fft": 2,
                                         "rows_t_fft_c64": 2}),
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
        "kernel_c64": lambda: cuda_fft._rows_t_launch_c64(x, -1, None, outer),
        "plain": lambda: cuda_fft.fft_rows_transposed_split_reference(
            re, im, -1, outer=outer),
        "plain_c64": lambda: cuda_fft.fft_rows_transposed_c64_reference(x, -1, outer=outer),
        "torch.fft": lambda: torch.fft.fft(x),
        "copy": plane_copy(re, im),
    }, reps=20)
    del x, re, im
    x = crand(1, 1 << 22)  # config 3 whole: the four-step's two passes
    re, im = planes(x)
    pn, a, b = ft.plan(1 << 22), torch.empty_like(x), torch.empty_like(x)
    times["fourstep 2^22"] = time_in_turns({
        "planar pair": lambda: pn.forward_split(re, im),
        "complex64 pair": lambda: pn.forward(x),
        "torch.fft": lambda: torch.fft.fft(x),
        "copy floor": lambda: (a.copy_(x), b.copy_(a)),  # two passes of 32 MiB each way
    }, reps=20)
    del x, re, im, a, b

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

    big_times(dev, gen, smi)
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
    # the complex64 four-step at 2^22: its two kernels alone, no split or merge
    x = crand(1, 1 << 22)
    pn = ft.plan(1 << 22)
    alone("plan(4194304).forward 1x4194304", lambda: pn.forward(x), ("ax0_fft", "rows_t_fft"),
          two_pass)
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

    models_path(dev, gen, smi)  # path 10, before path 9 (below)
    serving_path(dev, gen, smi)  # path 11, before path 9 (below)
    graph_cache_child(smi)  # path 12, before path 9 (below), in a process of its own
    examples_path(dev, smi)  # path 13
    distributed_path(smi)  # path 14, before path 9, in processes of its own
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
        entry("rows_t_fft_c64", "rows_t_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:1494",
              "rows_t_fft 1024x4096", c2c * 1024 * 4096, fft_flops(4096, 1024),
              ms="kernel_c64", plain="plain_c64"),
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
