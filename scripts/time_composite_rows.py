#!/usr/bin/env python3
"""Time the redesigned kernels of the torch port on one CUDA card, beside
torch.fft in the same process: the composite-row kernels (gen_fft, C2C;
r2c_gen_fft, R2C; set "rows"), and the composite axis(-2) kernel
(ax0_gen_fft, on axis -2 and on axis -3 through its free view) and the
four-step's transposed-rows pass (rows_t_fft, with and without the outer
twiddle, at n = 4096 and 1024), with the calls that run them:
plan.forward_split at 1 x 2^20, 1 x 2^22 and 4 x 2^22, and fft2 of
16 x 1080 x 1920 frames (set "columns"); the chirp kernels (chirp_fft) in
Bluestein at 1024 x 4093 and 1024 x 4097 and the ZoomFFT of 1024 x 4096
to 1024 bins through the public calls (whichever chirp kernels a tree
launches there), and the two passes B11 and B12 alone at 1024 x 4093
(set "chirp"); the pow2 row kernel (rows_fft, B1) at 4096 x 4096, 1 x
1024, 2500 x 512, 1000 x 128 and 1024 x 16384, and the whole-row kernel
(big_fft, B15) at 256 x 2^16, 64 x 2^15 and 16 x 2^18, each through its
planar entry and, where the tree has one, its complex64 entry, with
plan(n).forward of complex64 there (all of its device work, split and
merge included, and its events), and fft2 of 4096 x 4096 (B1 then B2;
set "pow2"); the pow2 column kernel (ax0_fft, B2) at 1024 x 4096 and 4096
x 4096 and on the axis(-3) view of 256^3 (B3), the R2C kernel (r2c_fft,
B6) at 4096 x 4096, each through its planar entry and, where the tree has
one, its complex64 entry, fft2 and rfft of 4096 x 4096 through the public
calls (events, all of their device work, and each kernel's), the 2^22
four-step (config 3, plan.forward_split: B2 then B4), and B2 and B6 at
every pow2 n of 128..16384 over 2^24 points (set "cols"); the fused-plane
kernel (fft2f_fft, B5) at 256^3 and at 16 planes of each plane of its
envelope through each of its entries, fftn of 256^3 complex64 (events,
all of its device work and each kernel's), and the plane-route table:
the fused plane's complex64 entry against the row kernel then the
axis(-2) kernel, both complex64, at 1, 2, 4, 8, 16 and 256 planes of each
plane (set "plane"); the per-segment R2C kernel (B20) at a 2^22 signal
with nperseg 4096, hop 2048, through each of its sinks, beside torch.fft's
composition of the same function, and at every pow2 nfft of 128..16384 at
half overlap over 2^22 points, stft of 2^20 samples (events, all of its
device work, the kernel's) beside torch.stft, the per-segment powers
(B19) at a 2^22 signal with nperseg 4096, hop 3584 (the psd spectrogram's
shape) and at every pow2 nfft of 128..16384 at half overlap over 2^22
points, spectrogram's psd mode and welch's median of that signal (events,
all of their device work, the kernel's), and the output bits of csd's
and the two-sided welch's segment sums, to compare two trees (set
"spec"); the C2R (B7) at 4096 x 4096 and at every pow2 n of 128..16384
over 2^24 points from planes and, where the tree has it, from complex64,
irfft and irfft2 of complex64 4096 x 2049 (events, all of their device
work, the kernel's), the product C2R (B8) at
2048 x 8192 with B of A's shape, padded and not, and broadcast, and at
every pow2 n of 128..16384 over 2^24 points, fftconvolve of two 2048 x
4096 signals and oaconvolve of 2^20 samples with 129 taps (events, all of
their device work, the kernel's), beside torch.fft's composition (set
"c2r"); the
filtered rows (B9) at 4096 x 4096 and at every pow2 n at 1000 rows in both
layouts beside B1's complex64 entry, SpectralFilter and hilbert at 4096 x
4096, the filter bank (B10) at every pow2 n for banks of 1, 7 and 128 rows
and the CWT plan of 8192 samples over widths 1..128 (set "filt"); the
per-segment two-sided spectra (B22) at 2^22 in both
sources and sinks and at every pow2 nfft, the complex spectrogram and csd
of complex 2^22 signals (set "c2c"); welch's and coherence's segment sums
(B16, B18) at a 2^22 signal with nperseg 4096, hop 2048, at 64 x 2^20
with nperseg 256, hop 128 (scipy's defaults) and at every pow2 nfft of
128..16384 at half overlap over 2^22 points, each kernel alone and with
all of its device work, beside torch.fft's composition, and the welch and
coherence calls at those shapes; csd's segment sums and the two-sided
welch's of a complex signal (B17, B21: through both of its sources where
the tree has them) at the same shapes, and csd of two 2^22 signals and the
two-sided welch of a complex64 and a real one (set "welch"); the
four-step's transposed-rows kernel (B4) at 1024 x 4096 with and without
the outer twiddle through each of its entries, and at every pow2 n over
2^22 points with the twiddle, torch.fft of the same rows beside, the 2^22
four-step (config 3) of planes (plan.forward_split: B2 then B4) and of
complex64 (plan.forward: where the tree has the entries, B2's and B4's
complex64 ones), torch.fft.fft and a copy floor (two device copies of the
32 MiB tensor), and the complex64 plan(2^22) round trip's power gain (set
"rows_t"); and the output bits of the kernels kept as they were,
chip_smoke.kept_bits (set "bits").

    python3 scripts/time_composite_rows.py [--tree DIR] [--label NAME] [--out FILE]
                                           [--set rows|columns|chirp|pow2|cols|plane|spec|
                                                  filt|c2c|welch|c2r|rows_t|bits|all]

``--tree`` imports ``fft_wgpu_tpu_torch`` from another checkout (for
example a parent commit unpacked with ``git archive``), so that two
versions of the kernels can be timed in turns on one card, one process
each.  Each shape is first checked against torch.fft (relative L2 <=
1e-5), then timed: CUDA-event medians of 30 calls, two rounds in turns
(the wrapper's time, host launch included), and the kernel's device time
from a torch.profiler window of 20 calls.
The card's name and power limit (nvidia-smi) head the output; one JSON
line per run ends it and, with ``--out``, is appended to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

# (kernel, rows, n): the shapes of the non-pow2 path, the 1080p frames' rows,
# the envelope's largest odd length (3 * 43 * 127: two generic passes)
SHAPES = (("gen_fft", 1024, 4095), ("gen_fft", 2048, 1000), ("gen_fft", 1024, 4097),
          ("gen_fft", 17280, 1920), ("gen_fft", 1024, 16383), ("r2c_gen_fft", 1024, 4095),
          ("r2c_gen_fft", 1024, 1000))
TOL = 1e-5


def time_ms(fn, reps=30, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def in_turns(fns, reps=30):
    samples = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            samples[k].append(time_ms(fns[k], reps))
    return {k: statistics.median(v) for k, v in samples.items()}


def device_ms(fn, name, reps=20):
    """Device ms per call of the kernels named ``name`` (a whole word of
    the demangled name) from a torch.profiler window of ``reps`` calls:
    free of the host's launch time, which CUDA events around a short call
    include.  The window's time is divided by the launches it holds and
    multiplied by the launches a call makes (their count over the calls,
    rounded), so a launch the profiler missed does not read as a faster
    call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a window now and then comes back without device events: take another
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and re.search(rf"\b{name}\b", e.name)]
        if times:
            per_call = max(1, round(len(times) / reps))
            return sum(times) / len(times) * per_call / 1e3
    raise RuntimeError(f"the profiler saw no {name} kernel in 5 windows")


def rel_l2(got, want):
    import torch

    got, want = got.to(torch.complex128), want.to(torch.complex128)
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import the port from")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="append the JSON line here")
    ap.add_argument("--set", default="all",
                    choices=("rows", "columns", "chirp", "pow2", "cols", "plane", "spec",
                             "filt", "c2c", "welch", "c2r", "rows_t", "bits", "all"),
                    help="which kernels to time")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_composite_rows: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    import fft_wgpu_tpu_torch as ft
    from fft_wgpu_tpu_torch.ops import cuda_fft

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"label": args.label, "device": smi, "times": {}, "rel_l2": {}}
    if args.set in ("columns", "all"):
        time_columns(ft, cuda_fft, dev, gen, args.label, result)
    if args.set in ("chirp", "all"):
        time_chirp(ft, cuda_fft, dev, gen, args.label, result)
    if args.set in ("pow2", "all"):
        time_pow2(ft, cuda_fft, dev, gen, args.label, result)
    if args.set in ("cols", "all"):
        time_cols(ft, cuda_fft, dev, gen, args.label, result)
    if args.set in ("plane", "all"):
        time_plane(ft, cuda_fft, dev, gen, args.label, result)
    if args.set in ("spec", "all"):
        time_spec(ft, dev, gen, args.label, result)
    if args.set in ("filt", "all"):
        time_filt(ft, cuda_fft, dev, gen, args.label, result)
    if args.set in ("c2c", "all"):
        time_c2c(ft, dev, gen, args.label, result)
    if args.set in ("welch", "all"):
        time_welch(ft, dev, gen, args.label, result)
    if args.set in ("c2r", "all"):
        time_c2r(ft, cuda_fft, dev, gen, args.label, result)
    if args.set in ("rows_t", "all"):
        time_rows_t(ft, cuda_fft, dev, gen, args.label, result)
    if args.set == "bits":
        # the kept kernels' output bits (chip_smoke.kept_bits on this tree's modules)
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        import chip_smoke

        result["bits"] = chip_smoke.kept_bits(cuda_fft, dev)
        print(f"{args.label} | kept bits | {result['bits']}", flush=True)
    for kernel, rows, n in SHAPES if args.set in ("rows", "all") else ():
        key = f"{kernel} {rows}x{n}"
        if kernel == "gen_fft":
            x = torch.complex(torch.randn(rows, n, device=dev, generator=gen),
                              torch.randn(rows, n, device=dev, generator=gen))
            re, im = x.real.contiguous(), x.imag.contiguous()
            err = rel_l2(torch.complex(*cuda_fft._gen_launch(re, im, -1, None)),
                         torch.fft.fft(x))
            fns = {"kernel": lambda: cuda_fft._gen_launch(re, im, -1, None),
                   "torch.fft": lambda: torch.fft.fft(x)}
        else:
            r = torch.randn(rows, n, device=dev, generator=gen)
            err = rel_l2(torch.complex(*cuda_fft._r2c_gen_launch(r, None, False)),
                         torch.fft.rfft(r))
            fns = {"kernel": lambda: cuda_fft._r2c_gen_launch(r, None, False),
                   "torch.fft": lambda: torch.fft.rfft(r)}
        if err > TOL:
            raise RuntimeError(f"{args.label} {key}: rel-L2 {err:.3e} > {TOL}")
        result["rel_l2"][key] = err
        result["times"][key] = in_turns(fns)
        result["times"][key]["device"] = device_ms(fns["kernel"], f"{kernel}_kernel")
        print(f"{args.label} | {key} | rel-L2 {err:.3e} | " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in result["times"][key].items()), flush=True)
    if args.set in ("columns", "chirp", "pow2", "cols", "plane", "spec", "filt", "c2c", "welch",
                    "c2r", "rows_t", "bits"):
        return finish(result, args)
    fr = torch.complex(torch.randn(16, 1080, 1920, device=dev, generator=gen),
                       torch.randn(16, 1080, 1920, device=dev, generator=gen))
    err = rel_l2(ft.fft2(fr), torch.fft.fft2(fr))
    if err > TOL:
        raise RuntimeError(f"{args.label} fft2 16x1080x1920: rel-L2 {err:.3e} > {TOL}")
    key = "fft2 16x1080x1920"
    result["rel_l2"][key] = err
    result["times"][key] = in_turns({"fft2": lambda: ft.fft2(fr),
                                     "torch.fft": lambda: torch.fft.fft2(fr)}, reps=10)
    for part in ("gen_fft_kernel", "ax0_gen_fft_kernel"):
        result["times"][key][f"device {part}"] = device_ms(lambda: ft.fft2(fr), part, reps=5)
    print(f"{args.label} | {key} | rel-L2 {err:.3e} | " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in result["times"][key].items()), flush=True)
    return finish(result, args)


def time_columns(ft, cuda_fft, dev, gen, label, result):
    """ax0_gen_fft at 16 x 1080 x 1920, 16 x 4095 x 512 and 16 x 1920 x
    1080, and on axis -3 at 2 x 1000 x 7 x 130 and 1080 x 64 x 64;
    rows_t_fft at the 2^22 and 2^20 four-steps' 1024 x 4096 and 1024 x
    1024, with and without the outer twiddle; plan.forward_split at 1 x
    2^20, 1 x 2^22 and 4 x 2^22, and fft2 of 16 x 1080 x 1920: events and
    device ms of each, torch.fft beside them."""
    import torch

    crand = randn_complex(dev, gen)
    record = recorder(label, result)
    ax0 = "ax0_gen_fft_kernel"
    # 1920 columns: 8 a block in one tile, a cluster of one block
    for shape in ((16, 1080, 1920), (16, 4095, 512), (16, 1920, 1080)):
        x = crand(*shape)
        re_, im_ = x.real.contiguous(), x.imag.contiguous()
        err = rel_l2(torch.complex(*cuda_fft._ax0_launch(re_, im_, -1, None)),
                     torch.fft.fft(x, dim=-2))
        fns = {"kernel": lambda: cuda_fft._ax0_launch(re_, im_, -1, None),
               "torch.fft": lambda: torch.fft.fft(x, dim=-2)}
        record("ax0_gen " + "x".join(map(str, shape)), err, fns,
               {"device": (fns["kernel"], ax0)})
        del x, re_, im_
    # composite axis -3: the same kernel on the free view [..., n, Y*Z]
    for shape in ((2, 1000, 7, 130), (1080, 64, 64)):
        x = crand(*shape)
        re_, im_ = x.real.contiguous(), x.imag.contiguous()
        err = rel_l2(torch.complex(*cuda_fft._ax3_launch(re_, im_, -1, None)),
                     torch.fft.fft(x, dim=-3))
        fns = {"kernel": lambda: cuda_fft._ax3_launch(re_, im_, -1, None),
               "torch.fft": lambda: torch.fft.fft(x, dim=-3)}
        record("ax3 " + "x".join(map(str, shape)), err, fns,
               {"device": (fns["kernel"], ax0)})
        del x, re_, im_
    # the second passes of the 2^22 and 2^20 four-steps
    for rows, n in ((1024, 4096), (1024, 1024)):
        x = crand(rows, n)
        re_, im_ = x.real.contiguous(), x.imag.contiguous()
        outer = (rows, rows * n)
        got = torch.complex(*cuda_fft._rows_t_launch(re_, im_, -1, None, outer))
        want = torch.complex(*cuda_fft.fft_rows_transposed_split_reference(
            re_, im_, -1, outer=outer))
        fns = {"kernel": lambda: cuda_fft._rows_t_launch(re_, im_, -1, None, outer),
               "kernel_no_outer": lambda: cuda_fft._rows_t_launch(re_, im_, -1, None, None),
               "torch.fft": lambda: torch.fft.fft(x)}
        record(f"rows_t_fft {rows}x{n}", rel_l2(got, want), fns,
               {"device": (fns["kernel"], "rows_t_fft_kernel"),
                "device_no_outer": (fns["kernel_no_outer"], "rows_t_fft_kernel")})
        del x, re_, im_
    for rows, e in ((1, 22), (4, 22), (1, 20)):
        x = crand(rows, 1 << e)
        re_, im_ = x.real.contiguous(), x.imag.contiguous()
        pn = ft.plan(1 << e)
        fns = {"forward_split": lambda: pn.forward_split(re_, im_),
               "torch.fft": lambda: torch.fft.fft(x)}
        # a short call: its events carry the host's time, which swings
        # between runs, so more calls
        record(f"plan {rows}x2^{e}",
               rel_l2(torch.complex(*fns["forward_split"]()), torch.fft.fft(x)), fns,
               {"device ax0_fft": (fns["forward_split"], "ax0_fft_kernel"),
                "device rows_t_fft": (fns["forward_split"], "rows_t_fft_kernel")},
               reps=200 if rows == 1 else 50)
        del x, re_, im_
    fr = crand(16, 1080, 1920)
    fns = {"fft2": lambda: ft.fft2(fr), "torch.fft": lambda: torch.fft.fft2(fr)}
    record("fft2 16x1080x1920", rel_l2(ft.fft2(fr), torch.fft.fft2(fr)), fns,
           {"device gen_fft": (fns["fft2"], "gen_fft_kernel"),
            "device ax0_gen_fft": (fns["fft2"], ax0)})


def time_chirp(ft, cuda_fft, dev, gen, label, result):
    """Bluestein at 1024 x 4093 (m = 8192) and 1024 x 4097 (m = 16384) and
    the ZoomFFT of 1024 x 4096 to 1024 bins (L = 8192) through the public
    calls, with the device ms of every chirp kernel they launch (one
    chirp_full, or B11 then B12 in a tree without it); B11 (chirp_fwd) and
    B12 (chirp_inv) alone at 1024 x 4093; torch.fft beside each."""
    import cmath

    import torch
    from fft_wgpu_tpu_torch.ops import bluestein

    crand = randn_complex(dev, gen)
    record = recorder(label, result)
    chirp = "chirp_(?:fwd|inv|full)_kernel"
    for n in (4093, 4097):
        x = crand(1024, n)
        re_, im_ = x.real.contiguous(), x.imag.contiguous()
        fns = {"bluestein": lambda: bluestein.fft_bluestein_split(re_, im_, -1),
               "torch.fft": lambda: torch.fft.fft(x)}
        if n == 4093:  # prime: ft.fft's route is Bluestein (4097 = 17 * 241 is not)
            fns["fft"] = lambda: ft.fft(x)
        want = torch.fft.fft(x.to(torch.complex128))
        record(f"bluestein 1024x{n}", rel_l2(torch.complex(*fns["bluestein"]()), want), fns,
               {"device": (fns["bluestein"], chirp)}, reps=30)
    x = crand(1024, 4096)
    zf = ft.ZoomFFT(4096, [0.1, 0.35], m=1024)
    j = torch.arange(4096, device=dev, dtype=torch.float64)[:, None]
    k = torch.arange(1024, device=dev, dtype=torch.float64)[None, :]
    # the direct sum in float64: X[k] = sum_j x[j] a^-j w^(jk)
    want = x.to(torch.complex128) @ torch.exp(-j * cmath.log(zf.a) + j * k * cmath.log(zf.w))
    fns = {"ZoomFFT": lambda: zf(x)}
    record("ZoomFFT 1024x4096 m=1024", rel_l2(zf(x), want), fns,
           {"device": (fns["ZoomFFT"], chirp)}, reps=30)
    x = crand(1024, 4093)
    re_, im_ = x.real.contiguous(), x.imag.contiguous()
    (cr, ci, bfr, bfi), m = bluestein._chirp_tables(4093, -1, dev)
    A = cuda_fft._chirp_fwd_launch(re_, im_, cr, ci, m, -1)
    fns = {"chirp_fwd": lambda: cuda_fft._chirp_fwd_launch(re_, im_, cr, ci, m, -1),
           "chirp_inv": lambda: cuda_fft._chirp_inv_launch(*A, bfr, bfi, cr, ci, 4093, 1,
                                                           1.0 / m),
           "torch.fft": lambda: torch.fft.fft(x)}
    err = rel_l2(torch.complex(*fns["chirp_inv"]()), torch.fft.fft(x.to(torch.complex128)))
    record("chirp_fwd, chirp_inv 1024x4093", err, fns,
           {"device chirp_fwd": (fns["chirp_fwd"], "chirp_fwd_kernel"),
            "device chirp_inv": (fns["chirp_inv"], "chirp_inv_kernel")}, reps=30)


def time_pow2(ft, cuda_fft, dev, gen, label, result):
    """rows_fft (B1) and big_fft (B15) at the 1-D main path's shapes through
    the planar entry (``_launch``) and, where the tree has it, the complex64
    one (``_launch_c64``); plan(n).forward of complex64 at each shape (its
    events, the device ms of all of its device work and of the kernel);
    fft2 of 4096 x 4096 (rows_fft then ax0_fft); torch.fft beside each."""
    import torch
    from fft_wgpu_tpu_torch.ops import bigfft

    crand = randn_complex(dev, gen)
    record = recorder(label, result)
    every = r"\w+"  # all device work of a call
    for mod, kernel, shapes in (
            (cuda_fft, "rows_fft_kernel",
             ((4096, 4096), (1, 1024), (2500, 512), (1000, 128), (1024, 16384))),
            (bigfft, "big_fft_kernel", ((256, 1 << 16), (64, 1 << 15), (16, 1 << 18)))):
        for rows, n in shapes:
            x = crand(rows, n)
            re_, im_ = x.real.contiguous(), x.imag.contiguous()
            pn = ft.plan(n)
            fns = {"kernel": lambda: mod._launch(re_, im_, -1, None),
                   "plan.forward": lambda: pn.forward(x),
                   "torch.fft": lambda: torch.fft.fft(x)}
            device = {"device kernel": (fns["kernel"], kernel),
                      "device plan.forward": (fns["plan.forward"], every)}
            if hasattr(mod, "_launch_c64"):
                fns["kernel_c64"] = lambda: mod._launch_c64(x, -1, None)
                device["device kernel_c64"] = (fns["kernel_c64"], kernel)
            want = torch.fft.fft(x.to(torch.complex128))
            err = max(rel_l2(torch.complex(*fns["kernel"]()), want),
                      rel_l2(fns["plan.forward"](), want))
            record(f"{kernel[:-7]} {rows}x{n}", err, fns, device, reps=30)
            del x, re_, im_
    x = crand(4096, 4096)
    fns = {"fft2": lambda: ft.fft2(x), "torch.fft": lambda: torch.fft.fft2(x)}
    record("fft2 4096x4096", rel_l2(ft.fft2(x), torch.fft.fft2(x.to(torch.complex128))), fns,
           {"device rows_fft": (fns["fft2"], "rows_fft_kernel"),
            "device ax0_fft": (fns["fft2"], "ax0_fft_kernel"),
            "device all": (fns["fft2"], every)}, reps=20)


def time_cols(ft, cuda_fft, dev, gen, label, result):
    """ax0_fft (B2) at 1024 x 4096 (config 3's pass 1) and 4096 x 4096
    (fft2's), and on the axis(-3) view of 256^3 (B3); r2c_fft (B6) at 4096
    x 4096; each through its planar entry and, where the tree has it, its
    complex64 one; fft2 and rfft of 4096 x 4096 (events, all of their
    device work, each kernel); plan(2^22).forward_split; B2 and B6 at every
    pow2 n over 2^24 points; torch.fft beside each."""
    import torch

    crand = randn_complex(dev, gen)
    record = recorder(label, result)
    every = r"\w+"
    has_c64 = hasattr(cuda_fft, "_ax0_launch_c64")
    shapes = [((1024, 4096), "ax0"), ((4096, 4096), "ax0"), ((256, 256, 256), "ax3")]
    shapes += [((1 << e, 1 << 24 >> e), "ax0") for e in range(7, 15)]
    for shape, kind in dict.fromkeys(shapes):  # 4096 x 4096 once
        x = crand(*shape)
        re_, im_ = x.real.contiguous(), x.imag.contiguous()
        dim = -2 if kind == "ax0" else -3
        planar = getattr(cuda_fft, f"_{kind}_launch")
        fns = {"kernel": lambda: planar(re_, im_, -1, None),
               "torch.fft": lambda: torch.fft.fft(x, dim=dim)}
        device = {"device kernel": (fns["kernel"], "ax0_fft_kernel")}
        if has_c64:
            c64 = getattr(cuda_fft, f"_{kind}_launch_c64")
            fns["kernel_c64"] = lambda: c64(x, -1, None)
            device["device kernel_c64"] = (fns["kernel_c64"], "ax0_fft_kernel")
        want = torch.fft.fft(x.to(torch.complex128), dim=dim)
        err = rel_l2(torch.complex(*fns["kernel"]()), want)
        if has_c64:
            err = max(err, rel_l2(fns["kernel_c64"](), want))
        record(f"{kind} " + "x".join(map(str, shape)), err, fns, device, reps=20)
        del x, re_, im_
    for rows, n in [(4096, 4096)] + [(1 << 24 >> e, 1 << e) for e in range(7, 15)]:
        r = torch.randn(rows, n, device=dev, generator=gen)
        fns = {"kernel": lambda: cuda_fft._r2c_launch(r, None, False),
               "torch.fft": lambda: torch.fft.rfft(r)}
        device = {"device kernel": (fns["kernel"], "r2c_fft_kernel")}
        if hasattr(cuda_fft, "_r2c_launch_c64"):
            fns["kernel_c64"] = lambda: cuda_fft._r2c_launch_c64(r, None)
            device["device kernel_c64"] = (fns["kernel_c64"], "r2c_fft_kernel")
        if (rows, n) == (4096, 4096):
            fns["rfft"] = lambda: ft.rfft(r)
            device["device rfft all"] = (fns["rfft"], every)
        want = torch.fft.rfft(r.double())
        err = rel_l2(torch.complex(*fns["kernel"]()), want)
        if "kernel_c64" in fns:
            err = max(err, rel_l2(fns["kernel_c64"](), want))
        record(f"r2c {rows}x{n}", max(err, rel_l2(ft.rfft(r), want)), fns, device, reps=20)
        del r
    x = crand(4096, 4096)
    fns = {"fft2": lambda: ft.fft2(x), "torch.fft": lambda: torch.fft.fft2(x)}
    record("fft2 4096x4096", rel_l2(ft.fft2(x), torch.fft.fft2(x.to(torch.complex128))), fns,
           {"device rows_fft": (fns["fft2"], "rows_fft_kernel"),
            "device ax0_fft": (fns["fft2"], "ax0_fft_kernel"),
            "device all": (fns["fft2"], every)}, reps=20)
    del x
    x = crand(1, 1 << 22)
    re_, im_ = x.real.contiguous(), x.imag.contiguous()
    pn = ft.plan(1 << 22)
    fns = {"forward_split": lambda: pn.forward_split(re_, im_),
           "torch.fft": lambda: torch.fft.fft(x)}
    record("plan 1x2^22", rel_l2(torch.complex(*fns["forward_split"]()), torch.fft.fft(x)),
           fns, {"device ax0_fft": (fns["forward_split"], "ax0_fft_kernel"),
                 "device rows_t_fft": (fns["forward_split"], "rows_t_fft_kernel"),
                 "device all": (fns["forward_split"], every)}, reps=50)


PLANES = ((128, 128), (128, 256), (256, 128), (128, 512), (512, 128), (256, 256))


def time_plane(ft, cuda_fft, dev, gen, label, result):
    """fft2f_fft (B5) at 256^3 and at 16 planes of each plane of its
    envelope, through its planar entry and, where the tree has one, its
    complex64 entry, torch.fft's fft2 beside it; fftn of 256^3 complex64
    (events, all of its device work and each kernel's) beside torch.fft;
    the plane-route table: the fused plane's complex64 entry (planar,
    split and merge included, where the tree has no complex64 entry)
    against the row kernel then the axis(-2) kernel through their complex64
    entries, and the two routes' planar entries, at 1, 2, 4, 8, 16 and 256
    planes of each plane."""
    import torch

    crand = randn_complex(dev, gen)
    record = recorder(label, result)
    every = r"\w+"
    has_c64 = hasattr(cuda_fft, "_fft2f_launch_c64")
    for planes, (a, b) in [(256, (256, 256))] + [(16, p) for p in PLANES]:
        x = crand(planes, a, b)
        re_, im_ = x.real.contiguous(), x.imag.contiguous()
        fns = {"kernel": lambda: cuda_fft._fft2f_launch(re_, im_, -1, None),
               "torch.fft": lambda: torch.fft.fft2(x)}
        device = {"device kernel": (fns["kernel"], "fft2f_fft_kernel")}
        want = torch.fft.fft2(x.to(torch.complex128))
        err = rel_l2(torch.complex(*fns["kernel"]()), want)
        if has_c64:
            fns["kernel_c64"] = lambda: cuda_fft._fft2f_launch_c64(x, -1, None)
            device["device kernel_c64"] = (fns["kernel_c64"], "fft2f_fft_kernel")
            err = max(err, rel_l2(fns["kernel_c64"](), want))
        record(f"fft2f {planes}x{a}x{b}", err, fns, device, reps=20)
        del x, re_, im_
    x = crand(256, 256, 256)
    fns = {"fftn": lambda: ft.fftn(x), "torch.fft": lambda: torch.fft.fftn(x)}
    record("fftn 256^3", rel_l2(ft.fftn(x), torch.fft.fftn(x.to(torch.complex128))), fns,
           {"device fft2f_fft": (fns["fftn"], "fft2f_fft_kernel"),
            "device ax0_fft": (fns["fftn"], "ax0_fft_kernel"),
            "device all": (fns["fftn"], every)}, reps=20)
    del x
    for a, b in PLANES:
        for planes in (1, 2, 4, 8, 16, 256):
            x = crand(planes, a, b)
            if has_c64:
                def fused():
                    return cuda_fft._fft2f_launch_c64(x, -1, None)
            else:
                def fused():
                    return torch.complex(*cuda_fft._fft2f_launch(x.real.contiguous(),
                                                                 x.imag.contiguous(), -1, None))

            def per_axis():
                return cuda_fft._ax0_launch_c64(cuda_fft._launch_c64(x, -1, None), -1, None)

            re_, im_ = x.real.contiguous(), x.imag.contiguous()

            def fused_planar():
                return cuda_fft._fft2f_launch(re_, im_, -1, None)

            def per_axis_planar():
                return cuda_fft._ax0_launch(*cuda_fft._launch(re_, im_, -1, None), -1, None)

            fns = {"fused": fused, "rows + ax0": per_axis, "fused planar": fused_planar,
                   "rows + ax0 planar": per_axis_planar, "torch.fft": lambda: torch.fft.fft2(x)}
            want = torch.fft.fft2(x.to(torch.complex128))
            err = max(rel_l2(fused(), want), rel_l2(per_axis(), want),
                      rel_l2(torch.complex(*fused_planar()), want),
                      rel_l2(torch.complex(*per_axis_planar()), want))
            record(f"plane route {planes}x{a}x{b}", err, fns,
                   {f"device {k}": (fn, every) for k, fn in fns.items() if k != "torch.fft"},
                   reps=20)
            del x, re_, im_


def _bits(outs):
    """A checksum of the bits of a kernel's outputs: the sum of their
    float32 words read as int32, in int64."""
    import torch

    return int(sum(o.contiguous().view(torch.int32).to(torch.int64).sum() for o in outs))


def time_spec(ft, dev, gen, label, result):
    """B20 at a 2^22 signal with nperseg 4096, hop 2048 (a tukey window,
    constant detrend: the complex spectrogram's shape) through its planar
    sink and, where the tree has one, its complex64 sink, beside torch.fft's
    composition (unfold, detrend, window, rfft); B20 at every pow2 nfft of
    128..16384 at half overlap over 2^22 points; stft of 2^20 samples at
    n_fft 512, hop 128 beside torch.stft; B19 (``cuda_welch._launch("psd",
    ...)``, spec_fft.cu's kernel)
    at a 2^22 signal with nperseg 4096, hop 3584 (a tukey window, constant
    detrend: the psd spectrogram's shape) and at every pow2 nfft at half
    overlap over 2^22 points, beside torch.fft's composition (unfold,
    detrend, window, rfft, |X|^2), spectrogram's psd mode and welch's
    median of that signal against scipy.signal; and the bits of csd's and
    the two-sided welch's segment sums (B17, B21; welch_fft.cu's kinds in
    trees before they moved to welch_acc_fft.cu) at a 2^20 signal (``bits``
    in the JSON line)."""
    import torch

    from fft_wgpu_tpu_torch.ops import cuda_welch

    record = recorder(label, result)
    every = r"\w+"
    b20 = r"(welch|spec_fft)_kernel"  # the parent's welch_kernel<., 5>, or spec_fft_kernel
    has_c64 = hasattr(cuda_welch, "spec_rfft_c64")
    x = torch.randn(1 << 22, device=dev, generator=gen)
    tukey = ft.get_window(("tukey", 0.25), 4096, device=dev)

    def composed(v, w, nperseg, hop, nfft, detrend):
        fr = v.unfold(-1, nperseg, hop)
        if detrend == "constant":
            fr = fr - fr.mean(-1, keepdim=True)
        return torch.fft.rfft(fr * w, n=nfft)

    shapes = [(tukey, (4096, 2048, 4096, "constant"))]
    shapes += [(ft.hann_window(1 << e, device=dev), (1 << e, 1 << e - 1, 1 << e, False))
               for e in range(7, 15)]
    for w, args in shapes:
        want = composed(x.double(), w.double(), *args)
        fns = {"kernel": lambda: cuda_welch.spec_rfft_split(x, w, *args),
               "torch.fft": lambda: composed(x, w, *args)}
        device = {"device kernel": (fns["kernel"], b20)}
        err = rel_l2(torch.complex(*fns["kernel"]()), want)
        if has_c64:
            fns["kernel_c64"] = lambda: cuda_welch.spec_rfft_c64(x, w, *args)
            device["device kernel_c64"] = (fns["kernel_c64"], b20)
            err = max(err, rel_l2(fns["kernel_c64"](), want))
        record("spec 2^22 nperseg {} hop {} nfft {} {}".format(*args), err, fns, device,
               reps=20)
    del x
    x20 = torch.randn(1 << 20, device=dev, generator=gen)
    hann = torch.hann_window(512, device=dev)
    fns = {"stft": lambda: ft.stft(x20, 512, 128),
           "torch.stft": lambda: torch.stft(x20, 512, 128, window=hann, center=True,
                                            pad_mode="reflect", return_complex=True)}
    record("stft 2^20 n_fft 512 hop 128", rel_l2(ft.stft(x20, 512, 128),
                                                 fns["torch.stft"]().to(torch.complex128)),
           fns, {"device kernel": (fns["stft"], b20), "device all": (fns["stft"], every)},
           reps=50)
    b19 = r"(welch|psd_pairs)_kernel"  # the parent's welch_kernel<., 1>, or spec_fft's B19
    x = torch.randn(1 << 22, device=dev, generator=gen)
    shapes = [(tukey, (4096, 3584, 4096, "constant"))]
    shapes += [(ft.hann_window(1 << e, device=dev), (1 << e, 1 << e - 1, 1 << e, "constant"))
               for e in range(7, 15)]
    for w, args in shapes:
        fns = {"kernel": lambda: cuda_welch._launch("psd", x, None, w, *args),
               "torch.fft": lambda: composed(x, w, *args).abs() ** 2}
        err = rel_l2(fns["kernel"]()[0], composed(x.double(), w.double(), *args).abs() ** 2)
        record("psd 2^22 nperseg {} hop {} nfft {} {}".format(*args), err, fns,
               {"device kernel": (fns["kernel"], b19)}, reps=20)
    # B19's calls: spectrogram's psd mode (nperseg 4096, hop 3584) and welch's
    # median (nperseg 4096, hop 2048), against scipy.signal in float64
    import scipy.signal as ss

    x64 = x.double().cpu().numpy()
    spectrogram = lambda: ft.spectrogram(x, nperseg=4096)[2]  # noqa: E731
    want = torch.from_numpy(ss.spectrogram(x64, nperseg=4096)[2]).to(dev)
    record("spectrogram psd 2^22 nperseg 4096", rel_l2(spectrogram(), want),
           {"call": spectrogram}, {"device all": (spectrogram, every),
                                   "device kernel": (spectrogram, b19)}, reps=20)
    median = lambda: ft.welch(x, nperseg=4096, noverlap=2048, average="median")[1]  # noqa: E731
    want = torch.from_numpy(ss.welch(x64, nperseg=4096, noverlap=2048, average="median")[1])
    record("welch median 2^22 nperseg 4096", rel_l2(median(), want.to(dev)), {"call": median},
           {"device all": (median, every), "device kernel": (median, b19)}, reps=20)
    del x, x64, want
    y20 = torch.randn(1 << 20, device=dev, generator=gen)
    w = torch.hann_window(4096, device=dev)
    # B17 and B21, whichever library the tree runs them in
    result["bits"] = {kind: _bits(cuda_welch._launch(kind, x20, y20, w, 4096, 2048, 4096,
                                                     "constant"))
                      for kind in ("csd", "c2c")}
    print(f"{label} | bits of B17 and B21 | {result['bits']}", flush=True)


def time_filt(ft, cuda_fft, dev, gen, label, result):
    """B9 (the filtered rows) at 4096 x 4096 and at every pow2 n of
    128..16384 at 1000 rows, through its planar entry and, where the tree
    has one, its complex64 entry, beside B1's complex64 entry on the same
    rows and torch.fft's multiply and ifft; SpectralFilter of complex64
    4096 x 4096 and hilbert of real 4096 x 4096 through the public calls
    (events, all of their device work, and each kernel's), with hilbert's
    other route where the tree has the complex64 entry: the full C2C
    through B1's complex64 entry, then B9's."""
    import torch

    record = recorder(label, result)
    crand = randn_complex(dev, gen)
    has_c64 = hasattr(cuda_fft, "fft_filtered_c64")
    every = r"\w+"
    for rows, n in [(4096, 4096)] + [(1000, 1 << e) for e in range(7, 15)]:
        x, H = crand(rows, n), crand(n)
        re, im = x.real.contiguous(), x.imag.contiguous()
        hr, hi = H.real.contiguous(), H.imag.contiguous()
        want = torch.fft.ifft(x.to(torch.complex128) * H)
        fns = {"kernel": lambda: cuda_fft._filt(re, im, hr, hi, 1, 1.0 / n),
               "B1 c64": lambda: cuda_fft._launch_c64(x, 1, 1.0 / n),
               "torch.fft": lambda: torch.fft.ifft(x * H)}
        device = {"device kernel": (fns["kernel"], "filt_fft_kernel"),
                  "device B1 c64": (fns["B1 c64"], "rows_fft_kernel")}
        err = rel_l2(torch.complex(*fns["kernel"]()), want)
        if has_c64:
            fns["kernel_c64"] = lambda: cuda_fft._filt_launch_c64(x, H, 1, 1.0 / n)
            device["device kernel_c64"] = (fns["kernel_c64"], "filt_fft_kernel")
            err = max(err, rel_l2(fns["kernel_c64"](), want))
        record(f"filt {rows}x{n}", err, fns, device, reps=20)
        del x, re, im
    x, H = crand(4096, 4096), crand(4096)
    sf = ft.SpectralFilter(H)
    fns = {"SpectralFilter": lambda: sf(x),
           "torch.fft": lambda: torch.fft.ifft(torch.fft.fft(x) * H)}
    record("SpectralFilter 4096x4096 complex64",
           rel_l2(sf(x), torch.fft.ifft(torch.fft.fft(x.to(torch.complex128)) * H)), fns,
           {"device all": (fns["SpectralFilter"], every),
            "device filt": (fns["SpectralFilter"], "filt_fft_kernel"),
            "device B1": (fns["SpectralFilter"], "rows_fft_kernel")}, reps=20)
    del x
    r = torch.randn(4096, 4096, device=dev, generator=gen)
    hw = torch.zeros(4096, device=dev)
    hw[0] = hw[2048] = 1.0
    hw[1:2048] = 2.0
    fns = {"hilbert": lambda: ft.hilbert(r),
           "torch.fft": lambda: torch.fft.ifft(torch.fft.fft(r) * hw)}
    device = {"device all": (fns["hilbert"], every),
              "device filt": (fns["hilbert"], "filt_fft_kernel")}
    want = torch.fft.ifft(torch.fft.fft(r.double()) * hw)
    err = rel_l2(ft.hilbert(r), want)
    if has_c64:
        hc = hw.to(torch.complex64)

        def full_c2c():
            X = cuda_fft.fft_batched_c64(r.to(torch.complex64), -1)
            return cuda_fft.fft_filtered_c64(X, hc, 1, 1.0 / 4096)

        fns["full C2C route"] = full_c2c
        device["device full C2C route"] = (full_c2c, every)
        err = max(err, rel_l2(full_c2c(), want))
    record("hilbert 4096x4096", err, fns, device, reps=20)
    # B10: the parent's bank_fft_kernel, or the filtered rows' kernel
    bank = r"(bank|filt)_fft_kernel"
    for rows, n in [(rows, 1 << e) for e in range(7, 15) for rows in (1, 7, 128)]:
        x, h = crand(n), crand(rows, n)
        re, im = x.real.contiguous(), x.imag.contiguous()
        hr, hi = h.real.contiguous(), h.imag.contiguous()
        fns = {"kernel": lambda: cuda_fft._bank(re, im, hr, hi, 1, 1.0 / n),
               "torch.fft": lambda: torch.fft.ifft(x * h)}
        err = rel_l2(torch.complex(*fns["kernel"]()), torch.fft.ifft(x.to(torch.complex128) * h))
        record(f"bank {rows}x{n}", err, fns, {"device kernel": (fns["kernel"], bank)}, reps=20)
    import numpy as np

    widths = np.arange(1, 129)
    cw = ft.CWT(8192, widths, device=dev)
    sig = torch.randn(8192, device=dev, generator=gen)
    want = ft.CWT(8192, widths, device="cpu")(sig.cpu())
    record("CWT 8192 x 128 widths", rel_l2(cw(sig).cpu(), want), {"CWT": lambda: cw(sig)},
           {"device all": (lambda: cw(sig), every), "device bank": (lambda: cw(sig), bank)},
           reps=20)


def time_c2c(ft, dev, gen, label, result):
    """B22 at a 2^22 complex signal with nperseg 4096, hop 2048 (a tukey
    window, constant detrend: the complex spectrogram's shape) through its
    planar source and sink and, where the tree has them, its complex64
    source and sink, beside torch.fft's composition (unfold, detrend,
    window, fft); B22 at every pow2 nfft of 128..16384 at half overlap over
    2^22 points; the complex spectrogram of a complex64 2^22 signal and csd
    of two, through the public calls (events, all of their device work, the
    kernel's)."""
    import torch

    from fft_wgpu_tpu_torch.ops import cuda_welch

    record = recorder(label, result)
    crand = randn_complex(dev, gen)
    every = r"\w+"
    b22 = r"(welch|spec_c2c)_kernel"  # the parent's welch_kernel<., 6>, or spec_c2c_kernel
    has_c64 = hasattr(cuda_welch, "spec_c2c_c64")
    x = crand(1 << 22)
    re, im = x.real.contiguous(), x.imag.contiguous()
    tukey = ft.get_window(("tukey", 0.25), 4096, device=dev)

    def composed(v, w, nperseg, hop, nfft, detrend):
        fr = v.unfold(-1, nperseg, hop)
        if detrend == "constant":
            fr = fr - fr.mean(-1, keepdim=True)
        return torch.fft.fft(fr * w, n=nfft)

    shapes = [(tukey, (4096, 2048, 4096, "constant"))]
    shapes += [(ft.hann_window(1 << e, device=dev), (1 << e, 1 << e - 1, 1 << e, False))
               for e in range(7, 15)]
    for w, args in shapes:
        want = composed(x.to(torch.complex128), w.double(), *args)
        fns = {"kernel": lambda: cuda_welch.spec_c2c_split(re, im, w, *args),
               "torch.fft": lambda: composed(x, w, *args)}
        device = {"device kernel": (fns["kernel"], b22)}
        err = rel_l2(torch.complex(*fns["kernel"]()), want)
        if has_c64:
            fns["kernel_c64"] = lambda: cuda_welch.spec_c2c_c64(x, w, *args)
            device["device kernel_c64"] = (fns["kernel_c64"], b22)
            err = max(err, rel_l2(fns["kernel_c64"](), want))
        record("spec_c2c 2^22 nperseg {} hop {} nfft {} {}".format(*args), err, fns, device,
               reps=20)
    y = crand(1 << 22)
    seg = {"nperseg": 4096, "noverlap": 2048}
    spec = lambda: ft.spectrogram(x, mode="complex", **seg)[2]  # noqa: E731
    cs = lambda: ft.csd(x, y, **seg)[1]  # noqa: E731
    want = composed(x.to(torch.complex128), tukey.double(), 4096, 2048, 4096,
                    "constant").transpose(-1, -2)
    norm = 1.0 / float((tukey.double() ** 2).sum())
    record("spectrogram 2^22 complex64 mode complex", rel_l2(spec(), want * norm ** 0.5),
           {"spectrogram": spec}, {"device all": (spec, every), "device kernel": (spec, b22)},
           reps=20)
    hann = ft.hann_window(4096, device=dev)
    X = composed(x.to(torch.complex128), hann.double(), 4096, 2048, 4096, "constant")
    Y = composed(y.to(torch.complex128), hann.double(), 4096, 2048, 4096, "constant")
    want = (X.conj() * Y).mean(-2) / float((hann.double() ** 2).sum())
    record("csd 2^22 complex64", rel_l2(cs(), want), {"csd": cs},
           {"device all": (cs, every), "device kernel": (cs, b22)}, reps=20)


def time_welch(ft, dev, gen, label, result):
    """B16 (welch), B18 (coh), B17 (csd) and B21 (c2c: the planes of a
    complex signal; c2c_c64: the complex64 signal as it lies, where the tree
    has that entry) through ``cuda_welch._launch`` at a 2^22 signal with
    nperseg 4096, hop 2048 (a hann window, constant detrend: the estimators'
    defaults at path 6's shape), B16 at 64 x 2^20 with nperseg 256, hop 128
    (scipy's defaults), and each at every pow2 nfft of 128..16384 at half
    overlap over 2^22 points: the events of the call, the kernel's device
    time and all of the call's device work (the kernel and the sum over its
    partial rows), beside torch.fft's composition (unfold, detrend, window,
    rfft or fft, the products summed); then ft.welch, ft.coherence and
    ft.csd at the first two shapes, and the two-sided ft.welch of a
    complex64 and of a real 2^22 signal (events, all of their device work,
    the kernel's)."""
    import torch

    from fft_wgpu_tpu_torch.ops import cuda_welch

    record = recorder(label, result)
    every = r"\w+"
    kernel = r"welch(_acc)?_kernel"  # the parent's welch_kernel<., .>, or welch_acc_kernel
    x, y = (torch.randn(1 << 22, device=dev, generator=gen) for _ in range(2))
    xb = torch.randn(64, 1 << 20, device=dev, generator=gen)
    xc = torch.complex(x, y)
    kinds = ("welch", "coh", "csd", "c2c") + (
        ("c2c_c64",) if hasattr(cuda_welch, "welch_accum_c2c_c64") else ())

    def composed(kind, v, u, w, nperseg, hop, nfft, detrend):
        def spectra(a):
            fr = a.unfold(-1, nperseg, hop)
            if detrend == "constant":
                fr = fr - fr.mean(-1, keepdim=True)
            fr = fr * w.to(fr.real.dtype)
            return (torch.fft.fft if a.is_complex() else torch.fft.rfft)(fr, n=nfft)

        if kind in ("c2c", "c2c_c64"):
            X = spectra(v if v.is_complex() else torch.complex(v, u))
            return ((X.real ** 2 + X.imag ** 2).sum(-2),)
        X = spectra(v)
        if kind == "welch":
            return ((X.real ** 2 + X.imag ** 2).sum(-2),)
        Y = spectra(u)
        P = (X.conj() * Y).sum(-2)
        if kind == "csd":
            return P.real, P.imag
        return (P.real, P.imag, (X.real ** 2 + X.imag ** 2).sum(-2),
                (Y.real ** 2 + Y.imag ** 2).sum(-2))

    def flat(outs):
        return torch.cat([o.reshape(-1) for o in outs])

    def operands(kind, v):
        # (x, y) of a kind: one real signal, two, the planes or the complex64 signal
        if kind == "c2c_c64":
            return xc, None
        return v, (y if kind in ("coh", "csd", "c2c") else None)

    shapes = [(kind, x, ft.hann_window(4096, device=dev), (4096, 2048, 4096, "constant"))
              for kind in kinds]
    shapes.insert(1, ("welch", xb, ft.hann_window(256, device=dev), (256, 128, 256, "constant")))
    shapes += [(kind, x, ft.hann_window(1 << e, device=dev),
                (1 << e, 1 << e - 1, 1 << e, "constant"))
               for kind in kinds for e in range(7, 15)]
    for kind, v, w, args in shapes:
        v, u = operands(kind, v)
        fns = {"kernel": lambda: cuda_welch._launch(kind, v, u, w, *args),
               "torch.fft": lambda: composed(kind, v, u, w, *args)}
        want = composed(kind, v.to(torch.complex128 if v.is_complex() else torch.float64),
                        None if u is None else u.double(), w, *args)
        err = rel_l2(flat(fns["kernel"]()), flat(want))
        record("{} {} nperseg {} hop {} nfft {} {}".format(
            kind, "x".join(map(str, v.shape)), *args), err, fns,
            {"device kernel": (fns["kernel"], kernel), "device all": (fns["kernel"], every)},
            reps=20)
    seg = {"nperseg": 4096, "noverlap": 2048}
    zero = torch.zeros_like(x)
    calls = {  # key -> (the call, the kind of its oracle, its operands)
        "welch 2^22 nperseg 4096": (lambda: ft.welch(x, **seg)[1], "welch", x, None),
        "welch 64x2^20 scipy defaults": (lambda: ft.welch(xb)[1], "welch", xb, None),
        "coherence 2^22 nperseg 4096": (lambda: ft.coherence(x, y, **seg)[1], "coh", x, y),
        "csd 2^22 nperseg 4096": (lambda: ft.csd(x, y, **seg)[1], "csd", x, y),
        "welch 2^22 complex64 two-sided": (lambda: ft.welch(xc, **seg)[1], "c2c", xc, None),
        "welch 2^22 real two-sided": (lambda: ft.welch(x, return_onesided=False, **seg)[1],
                                      "c2c", x, zero)}
    for key, (call, kind, v, u) in calls.items():
        args = (256, 128, 256) if "64x" in key else (4096, 2048, 4096)
        w = ft.hann_window(args[0], device=dev)
        P = composed(kind, v.to(torch.complex128 if v.is_complex() else torch.float64),
                     None if u is None else u.double(), w, *args, "constant")
        num = 1 + (v.shape[-1] - args[0]) // args[1]
        norm = num * float((w.double() ** 2).sum())
        mult = torch.full((args[2] // 2 + 1,), 2.0, dtype=torch.float64, device=dev)
        mult[0] = mult[-1] = 1.0
        if kind == "welch":  # the density: the mean over segments, one-sided
            want = P[0] * mult / norm
        elif kind == "csd":
            want = torch.complex(P[0], P[1]) * mult / norm
        elif kind == "c2c":  # two-sided
            want = P[0] / norm
        else:
            want = (P[0] ** 2 + P[1] ** 2) / (P[2] * P[3])
        record(key, rel_l2(call(), want), {"call": call},
               {"device all": (call, every), "device kernel": (call, kernel)}, reps=20)


def time_c2r(ft, cuda_fft, dev, gen, label, result):
    """B8 (``cuda_fft._c2r_prod_launch``) at 2048 x 8192 with B of A's shape,
    in the padded serving form (fftconvolve's) and not, and with one
    broadcast B row, and at every pow2 n of 128..16384 over 2^24 points
    (padded, equal shapes); beside torch.fft's composition (the product,
    irfft); then fftconvolve of two 2048 x 4096 signals and oaconvolve of
    2^20 samples with 129 taps (events, all of their device work, the
    kernel's), beside torch.fft's."""
    import torch

    crand = randn_complex(dev, gen)
    record = recorder(label, result)
    every = r"\w+"
    has_c64 = hasattr(cuda_fft, "irfft_rows_c64")
    b7 = "c2r_fft_kernel"
    for rows, n in [(4096, 4096)] + [(1 << 24 >> e, 1 << e) for e in range(7, 15)]:
        X = crand(rows, n // 2 + 1)
        Xr, Xi = X.real.contiguous(), X.imag.contiguous()
        Xh = X.clone()
        Xh.imag[:, 0] = Xh.imag[:, -1] = 0
        want = torch.fft.irfft(Xh.to(torch.complex128), n=n)
        fns = {"kernel": lambda: cuda_fft._c2r_launch(Xr, Xi, n, 1.0 / n),
               "torch.fft": lambda: torch.fft.irfft(X, n=n)}
        device = {"device kernel": (fns["kernel"], b7)}
        err = rel_l2(fns["kernel"](), want)
        if has_c64:
            fns["kernel_c64"] = lambda: cuda_fft._c2r_launch_c64(X, n, 1.0 / n)
            device["device kernel_c64"] = (fns["kernel_c64"], b7)
            err = max(err, rel_l2(fns["kernel_c64"](), want))
        record(f"c2r {rows}x{n}", err, fns, device, reps=20)
        del X, Xr, Xi, Xh, want
    X = torch.fft.rfft(torch.randn(4096, 4096, device=dev, generator=gen))
    X128 = X.to(torch.complex128)
    for key, call, torch_call, want in (
            ("irfft 4096x2049 complex64", lambda: ft.irfft(X), lambda: torch.fft.irfft(X),
             torch.fft.irfft(X128)),
            ("irfft2 4096x2049 complex64", lambda: ft.irfft2(X, s=(4096, 4096)),
             lambda: torch.fft.irfft2(X, s=(4096, 4096)),
             torch.fft.irfft2(X128, s=(4096, 4096)))):
        record(key, rel_l2(call(), want), {"call": call, "torch.fft": torch_call},
               {"device all": (call, every), "device c2r": (call, b7)}, reps=20)
    del X, X128
    b8 = "c2r_prod_kernel"
    shapes = [(2048, 8192, True, False), (2048, 8192, False, False), (2048, 8192, True, True)]
    shapes += [(1 << 24 >> e, 1 << e, True, False) for e in range(7, 15)]
    for rows, n, pad, bcast in shapes:
        mp = n // 2 + 1
        bins = cuda_fft.pad_bins(n) if pad else mp
        A, B = crand(rows, bins), crand(1 if bcast else rows, bins)
        A[:, mp:], B[:, mp:] = 0, 0
        Ar, Ai = A.real.contiguous(), A.imag.contiguous()
        Br, Bi = B.real.contiguous(), B.imag.contiguous()
        if bcast:
            Br, Bi = Br[0], Bi[0]
        fns = {"kernel": lambda: cuda_fft._c2r_prod_launch(Ar, Ai, Br, Bi, n, 1.0 / n),
               "torch.fft": lambda: torch.fft.irfft((A * B)[:, :mp], n=n)}
        P = (A.to(torch.complex128) * B)[:, :mp]
        P.imag[:, 0] = P.imag[:, -1] = 0
        err = rel_l2(fns["kernel"](), torch.fft.irfft(P, n=n))
        record(f"c2r_prod {rows}x{n} {'padded' if pad else 'ragged'}"
               f"{' broadcast' if bcast else ''}", err, fns,
               {"device kernel": (fns["kernel"], b8)}, reps=20)
        del A, B, Ar, Ai, Br, Bi, P
    a2, b2 = (torch.randn(2048, 4096, device=dev, generator=gen) for _ in range(2))
    sig, taps = (torch.randn(n, device=dev, generator=gen) for n in (1 << 20, 129))
    calls = {"fftconvolve 2048x4096": (
                 lambda: ft.fftconvolve(a2, b2, axes=-1),
                 lambda: torch.fft.irfft(torch.fft.rfft(a2, n=8192) * torch.fft.rfft(b2, n=8192),
                                         n=8192)[:, :8191], 8192, (a2, b2)),
             "oaconvolve 2^20x129": (
                 lambda: ft.oaconvolve(sig, taps),
                 lambda: torch.fft.irfft(torch.fft.rfft(sig, n=1 << 21)
                                         * torch.fft.rfft(taps, n=1 << 21),
                                         n=1 << 21)[:(1 << 20) + 128], 1 << 21, (sig, taps))}
    for key, (call, torch_call, L, (u, v)) in calls.items():
        want = torch.fft.irfft(torch.fft.rfft(u.double(), n=L) * torch.fft.rfft(v.double(), n=L),
                               n=L)[..., :u.shape[-1] + v.shape[-1] - 1]
        record(key, rel_l2(call(), want), {"call": call, "torch.fft": torch_call},
               {"device all": (call, every), "device kernel": (call, b8)}, reps=20)


def time_rows_t(ft, cuda_fft, dev, gen, label, result):
    """rows_t_fft (B4) at 1024 x 4096, with and without the four-step's
    outer twiddle, through its planar entry and, where the tree has it, its
    complex64 one, torch.fft of the rows beside; B4 at every pow2 n over
    2^22 points with the twiddle; the 2^22 four-step of planes and of
    complex64 (events, all of their device work, each kernel's), beside
    torch.fft.fft and a copy floor; the complex64 plan(2^22) round trip's
    power gain, Re <y, x> / <x, x> - 1."""
    import torch

    crand = randn_complex(dev, gen)
    record = recorder(label, result)
    every = r"\w+"
    has_c64 = hasattr(cuda_fft, "_rows_t_launch_c64")
    kern = "rows_t_fft_kernel"
    for rows, n in [((1 << 22) >> e, 1 << e) for e in range(7, 15)]:
        x = crand(rows, n)
        re_, im_ = x.real.contiguous(), x.imag.contiguous()
        outer = (rows, rows * n)
        fns = {"kernel": lambda: cuda_fft._rows_t_launch(re_, im_, -1, None, outer),
               "torch.fft": lambda: torch.fft.fft(x)}
        device = {"device kernel": (fns["kernel"], kern),
                  "device torch.fft": (fns["torch.fft"], every)}
        want = torch.complex(*cuda_fft.fft_rows_transposed_split_reference(
            re_, im_, -1, outer=outer))
        err = rel_l2(torch.complex(*fns["kernel"]()), want)
        if has_c64:
            fns["kernel_c64"] = lambda: cuda_fft._rows_t_launch_c64(x, -1, None, outer)
            device["device kernel_c64"] = (fns["kernel_c64"], kern)
            err = max(err, rel_l2(fns["kernel_c64"](), want))
        if (rows, n) == (1024, 4096):  # config 3's pass 2
            fns["kernel_no_outer"] = lambda: cuda_fft._rows_t_launch(re_, im_, -1, None, None)
            device["device kernel_no_outer"] = (fns["kernel_no_outer"], kern)
            if has_c64:
                fns["kernel_c64_no_outer"] = lambda: cuda_fft._rows_t_launch_c64(
                    x, -1, None, None)
                device["device kernel_c64_no_outer"] = (fns["kernel_c64_no_outer"], kern)
        record(f"rows_t_fft {rows}x{n}", err, fns, device, reps=20)
        del x, re_, im_
    x = crand(1, 1 << 22)
    re_, im_ = x.real.contiguous(), x.imag.contiguous()
    pn = ft.plan(1 << 22)
    a, b = torch.empty_like(x), torch.empty_like(x)
    fns = {"forward_split": lambda: pn.forward_split(re_, im_),
           "forward_c64": lambda: pn.forward(x),
           "torch.fft": lambda: torch.fft.fft(x),
           "copy floor": lambda: (a.copy_(x), b.copy_(a))}
    want = torch.fft.fft(x.to(torch.complex128))
    err = max(rel_l2(torch.complex(*fns["forward_split"]()), want),
              rel_l2(fns["forward_c64"](), want))
    record("plan 1x2^22", err, fns,
           {"device forward_split": (fns["forward_split"], every),
            "device forward_split rows_t_fft": (fns["forward_split"], kern),
            "device forward_split ax0_fft": (fns["forward_split"], "ax0_fft_kernel"),
            "device forward_c64": (fns["forward_c64"], every),
            "device forward_c64 rows_t_fft": (fns["forward_c64"], kern),
            "device forward_c64 ax0_fft": (fns["forward_c64"], "ax0_fft_kernel"),
            "device torch.fft": (fns["torch.fft"], every),
            "device copy floor": (fns["copy floor"], every)}, reps=50)
    x64 = x.to(torch.complex128)
    y = pn.inverse(pn.forward(x)).to(torch.complex128)
    gain = float((y * x64.conj()).sum().real / x64.abs().square().sum()) - 1.0
    result["gain plan 1x2^22 complex64"] = gain
    print(f"{label} | plan 1x2^22 complex64 round trip | power gain - 1 {gain:+.3e}", flush=True)


def randn_complex(dev, gen):
    """crand(*shape): a complex64 tensor of normal parts on ``dev``."""
    import torch

    def crand(*shape):
        return torch.complex(torch.randn(shape, device=dev, generator=gen),
                             torch.randn(shape, device=dev, generator=gen))
    return crand


def recorder(label, result):
    """record(key, err, fns, device, reps): check err against TOL, then time
    ``fns`` in turns and the device ms of each ``device`` entry (part ->
    (fn, kernel name)) into ``result``, and print the row."""
    def record(key, err, fns, device, reps=10):
        if err > TOL:
            raise RuntimeError(f"{label} {key}: rel-L2 {err:.3e} > {TOL}")
        result["rel_l2"][key] = err
        result["times"][key] = in_turns(fns, reps=reps)
        for part, (fn, name) in device.items():
            result["times"][key][part] = device_ms(fn, name, reps=10)
        print(f"{label} | {key} | rel-L2 {err:.3e} | " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in result["times"][key].items()), flush=True)
    return record


def finish(result, args) -> int:
    line = json.dumps(result)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
