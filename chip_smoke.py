#!/usr/bin/env python3
"""Drive the torch port's paths once on one CUDA card: the batched 1-D
main path (n = 128..16384), the large-N path (four-step and whole-row), and
BASELINE config 4 (2-D 4096 x 4096, R2C/C2R, 3-D 256^3).

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit.  It builds the seven kernel libraries from
``fft_wgpu_tpu_torch/csrc`` (one nvcc each, all at once) and runs five
phases, one line each or more; any failure raises and the script exits
non-zero without a result line:

1. device  — the card's name and power limit (nvidia-smi's line as it
             prints it, then the versions), TF32 off, the kernel builds;
2. kernel  — each kernel against its plain torch version and torch.fft,
             both signs, scale None and 1/n (rel-L2 <= 1e-5 each):
             rows_fft for every n in 128..16384 at rows 1 and 1000 and at
             4096 x 4096 and 2500 x 512; ax0_fft for every n at m = 7 and
             m = 1000 (a leading batch of 2), at the 2^22 pass-1 shape
             1024 x 4096 and at config 4's 4096 x 4096 and ragged
             4096 x 2049; rows_t_fft for every n at R = 1 and 200, without
             and with the outer twiddle, and at the 2^22 pass-2 shape;
             big_fft for every n of its envelope at rows 1 and 3, and at
             256 x 2^16; the axis(-3) pass (ax0_fft on a free view) at
             [2, n, 7, 130] and 256^3; fft2f_fft at every plane of its
             envelope, single and batched; r2c_fft and c2r_fft for every n
             at rows 3 and 1000, ragged and padded, and at 4096 x 4096;
3. main    — two paths, the launch counts set to 0 just before each and
             read just after: plan / fft / ifft / Forward at the 1-D sizes
             users call (row kernel; axis(-2) then transposed rows; whole
             row), then config 4: fft2 / ifft2 and the rfft2 / irfft2 round
             trip at 4096 x 4096, fftn / ifftn at 256^3 (fused plane, then
             axis(-3)); each call's launches are checked; small N-D and
             real inputs against float64 numpy after config 4's window;
4. grad    — gradients against the plain versions' (CPU for the N-D and
             real ones): fft (row kernel; the four-step at 2 x 2^20; the
             whole row at 4 x 2^16), rfft2 and batched fft2;
5. times   — CUDA-event medians of each kernel, its plain version,
             torch.fft and plan.forward at the main shapes, beside a plane
             copy of the same bytes; fft2 at 4096 x 4096 by both routes
             (transposed rows twice, row then axis(-2)) and the fused plane
             at 256^3 against row then axis(-2); fftn at 512^3.

torch.fft is an oracle and a baseline here, never the implementation.  The
last two lines are a JSON object describing the kernels, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

TOL = 1e-5  # relative L2, the JAX package's oracle bar
SEED = 0
LIBS = ("rows_fft", "ax0_fft", "rows_t_fft", "big_fft", "fft2f_fft", "r2c_fft",
        "c2r_fft")
# Kernels as the launch counters name them: the axis(-3) pass is ax0_fft's
# library on a free view, with its own entry point and counter.
KERNELS = ("rows_fft", "ax0_fft", "ax3_fft", "rows_t_fft", "fft2f_fft", "r2c_fft",
           "c2r_fft", "big_fft")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import fft_wgpu_tpu_torch as ft
    from fft_wgpu_tpu_torch.ops import bigfft, cuda_fft, stockham
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
    sweep("ax0_fft",
          [((2, n, m), None) for n in pow2 for m in (7, 1000)]
          + [((1024, 4096), None), ((4096, 4096), None), ((4096, 2049), None)],
          lambda re, im, s, sc, _: cuda_fft._ax0_launch(re, im, s, sc),
          lambda re, im, s, sc, _: cuda_fft.fft_axis0_split_reference(re, im, s, sc),
          lambda x, s, sc, _: oracle(x, s, sc, dim=-2), dim=-2)
    sweep("rows_t_fft",
          [((rows, n), outer) for n in pow2 for rows in (1, 200)
           for outer in (None, (rows, rows * n))]
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
    sweep("ax3_fft",
          [((2, n, 7, 130), None) for n in (128, 1024, 16384)] + [((256, 256, 256), None)],
          lambda re, im, s, sc, _: cuda_fft._ax3_launch(re, im, s, sc),
          lambda re, im, s, sc, _: cuda_fft.fft_axis3_split_reference(re, im, s, sc),
          lambda x, s, sc, _: oracle(x, s, sc, dim=-3), dim=-3)

    def oracle2(x, sign, scale):
        y = torch.fft.fft2(x) if sign < 0 else torch.fft.ifft2(x, norm="forward")
        return y * (1.0 if scale is None else scale)

    sweep("fft2f_fft",
          [((*lead, a, b), None) for a, b in ((128, 128), (128, 256), (256, 128),
                                              (128, 512), (512, 128), (256, 256))
           for lead in ((), (5,))] + [((256, 256, 256), None)],
          lambda re, im, s, sc, _: cuda_fft._fft2f_launch(re, im, s, sc),
          lambda re, im, s, sc, _: cuda_fft.fft2_fused_split_reference(re, im, s, sc),
          lambda x, s, sc, _: oracle2(x, s, sc), dim=None)

    def real_sweep():
        """R2C and C2R against their plain versions and torch.fft: ragged and
        padded, scale None and 1/n; C2R also gets nonzero imaginary DC and
        Nyquist parts and, padded, garbage pad columns, which it must not read."""
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
                    check(not kr[:, mp:].any() and not ki[:, mp:].any(),
                          f"r2c_fft pad columns not zero {what}")
                    max_abs["r2c_fft"] = max(max_abs["r2c_fft"], float(
                        (got - torch.complex(pr, pi)).abs().max()))
                    Xr, Xi = kr.clone(), ki.clone()
                    Xi[:, 0] += 3.0
                    Xi[:, mp - 1] -= 2.0
                    Xr[:, mp:], Xi[:, mp:] = 1e6, -1e6
                    y = cuda_fft._c2r_launch(Xr, Xi, n, scale)
                    yp = cuda_fft.irfft_rows_split_reference(Xr, Xi, n, scale, padded_in=pad)
                    err = max(err, check_close(y, yp, f"c2r_fft vs plain {what}"))
                    err = max(err, check_close(
                        y, torch.fft.irfft(X, n=n, norm="forward") * s * s,
                        f"c2r_fft vs torch.fft {what}"))
                    max_abs["c2r_fft"] = max(max_abs["c2r_fft"], float((y - yp).abs().max()))
                    worst = max(worst, err)
                    cases += 2
        torch.cuda.synchronize()
        print(f"kernel r2c_fft, c2r_fft: {cases} cases ok | worst rel-L2 {worst:.3e} | "
              f"max abs err vs plain {max_abs['r2c_fft']:.3e}, {max_abs['c2r_fft']:.3e}",
              flush=True)

    real_sweep()

    # ---- 3. main path at users' sizes ------------------------------------
    errs = {}

    def counts():
        return {"rows_fft": cuda_fft.launches, "ax0_fft": cuda_fft.ax0_launches,
                "ax3_fft": cuda_fft.ax3_launches, "rows_t_fft": cuda_fft.rows_t_launches,
                "fft2f_fft": cuda_fft.fft2f_launches, "r2c_fft": cuda_fft.r2c_launches,
                "c2r_fft": cuda_fft.c2r_launches, "big_fft": bigfft.launches}

    def reset_counts():
        cuda_fft.launches = cuda_fft.ax0_launches = cuda_fft.ax3_launches = 0
        cuda_fft.rows_t_launches = cuda_fft.fft2f_launches = 0
        cuda_fft.r2c_launches = cuda_fft.c2r_launches = bigfft.launches = 0

    def through(what, fn, **want):
        """Run fn(); the launch counts must rise by exactly ``want``
        (kernel name -> launches), and no other kernel may launch."""
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in counts().items()}
        expect = {k: want.get(k, 0) for k in delta}
        check(delta == expect, f"{what}: launches {delta}, expected {expect}")
        return out

    two_pass = {"ax0_fft": 1, "rows_t_fft": 1}
    reset_counts()  # path 1: the 1-D main path and large N

    x = crand(4096, 4096)  # BASELINE config 2: 128 MiB of complex64
    p = ft.plan(4096)
    X = through("plan(4096).forward", lambda: p.forward(x), rows_fft=1)
    errs["plan4096_fwd"] = check_close(X, torch.fft.fft(x), "plan(4096).forward")
    xi = through("plan(4096).inverse", lambda: p.inverse(X), rows_fft=1)
    errs["plan4096_roundtrip"] = check_close(xi, x, "plan(4096) inverse round trip")
    xu = through("plan(4096).inverse_unnormalized",
                 lambda: p.inverse_unnormalized(X), rows_fft=1)
    errs["plan4096_onlyinv_norm"] = check_close(
        p.normalize(xu), x, "plan(4096) inverse_unnormalized + normalize")
    X0 = through("plan(4096).forward axis=0", lambda: p.forward(x, axis=0), ax0_fft=1)
    errs["plan4096_axis0"] = check_close(X0, torch.fft.fft(x, dim=0),
                                         "plan(4096).forward(axis=0)")
    del x, X, xi, xu, X0

    x = crand(2500, 512)  # the README quick-start shape
    X = through("fft 2500x512", lambda: ft.fft(x), rows_fft=1)
    errs["fft_2500x512"] = check_close(X, torch.fft.fft(x), "fft 2500x512")
    errs["ifft_2500x512"] = check_close(
        through("ifft 2500x512", lambda: ft.ifft(X), rows_fft=1), x, "ifft 2500x512")
    Xf = through("Forward(512).proc", lambda: ft.Forward(512).proc(x), rows_fft=1)
    errs["Forward512"] = check_close(Xf, torch.fft.fft(x), "Forward(512).proc")

    x1 = crand(1, 1024)  # BASELINE config 1, against the f64 naive DFT
    X1 = through("fft 1x1024", lambda: ft.fft(x1), rows_fft=1)
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
                             (256, 16, {"big_fft": 1}), (1, 17, {"big_fft": 1})):
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
    for name in ("rows_fft", "ax0_fft", "rows_t_fft", "big_fft"):
        check(path1[name] > 0, f"1-D main path launched no {name} kernel")
    print(f"main: 1-D path, {len(errs)} checks ok, launches {path1} | "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)

    # path 2: BASELINE config 4, 2-D 4096 x 4096 + R2C/C2R, and 3-D 256^3
    errs = {}
    reset_counts()
    x = crand(4096, 4096)  # 128 MiB of complex64
    X = through("fft2 4096^2", lambda: ft.fft2(x), rows_fft=1, ax0_fft=1)
    errs["fft2_4096"] = check_close(X, torch.fft.fft2(x), "fft2 4096^2")
    errs["ifft2_4096"] = check_close(
        through("ifft2 4096^2", lambda: ft.ifft2(X), rows_fft=1, ax0_fft=1), x,
        "ifft2 4096^2 round trip")
    del x, X
    r = torch.randn(4096, 4096, device=dev, generator=gen)
    R = through("rfft2 4096^2", lambda: ft.rfft2(r), r2c_fft=1, ax0_fft=1)
    errs["rfft2_4096"] = check_close(R, torch.fft.rfft2(r), "rfft2 4096^2")
    back = through("irfft2 4096^2", lambda: ft.irfft2(R, s=r.shape), ax0_fft=1, c2r_fft=1)
    errs["irfft2_4096"] = check_close(back, r, "irfft2(rfft2) 4096^2 round trip")
    del r, R, back
    x = crand(256, 256, 256)  # 128 MiB: fused plane over axes 1-2, then axis 0
    X = through("fftn 256^3", lambda: ft.fftn(x), fft2f_fft=1, ax3_fft=1)
    errs["fftn_256^3"] = check_close(X, torch.fft.fftn(x), "fftn 256^3")
    errs["ifftn_256^3"] = check_close(
        through("ifftn 256^3", lambda: ft.ifftn(X), fft2f_fft=1, ax3_fft=1), x,
        "ifftn 256^3 round trip")
    del x, X
    path2 = counts()
    for name in ("rows_fft", "ax0_fft", "ax3_fft", "fft2f_fft", "r2c_fft", "c2r_fft"):
        check(path2[name] > 0, f"config 4 path launched no {name} kernel")
    # small inputs against float64 numpy on the host, through the same
    # kernels, outside config 4's count window
    xs = crand(8, 128, 256)
    want = np.fft.fftn(xs.cpu().numpy().astype(np.complex128), axes=(1, 2))
    got = through("fftn 8x128x256", lambda: ft.fftn(xs, axes=(1, 2)), fft2f_fft=1)
    errs["fftn_small_np"] = check_close(got.cpu(), torch.from_numpy(want), "fftn vs numpy")
    rs = torch.randn(128, 128, 256, device=dev, generator=gen)
    want = np.fft.rfftn(rs.cpu().numpy().astype(np.float64))
    got = through("rfftn 128x128x256", lambda: ft.rfftn(rs), r2c_fft=1, ax3_fft=1,
                  ax0_fft=1)
    errs["rfftn_small_np"] = check_close(got.cpu(), torch.from_numpy(want), "rfftn vs numpy")
    print(f"main: config 4 path, {len(errs)} checks ok, launches {path2} | "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    # The kernels line gives each kernel the launches of the path it was
    # ported for (the 1-D path for B1, B2, B4 and B15, config 4 for the
    # rest); both paths' counts are on the two lines above.
    main_launches = {k: (path1 if k in ("rows_fft", "ax0_fft", "rows_t_fft", "big_fft")
                         else path2)[k] for k in KERNELS}

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
    for shape, kernels in (((64, 4096), {"rows_fft": 2}),
                           ((2, 1 << 20), {"ax0_fft": 2, "rows_t_fft": 1, "rows_fft": 1}),
                           ((4, 1 << 16), {"big_fft": 2})):
        gk = through(f"grad {shape}", lambda: grads(via_fft, shape, SEED + 1), **kernels)
        gp = grads(plain, shape, SEED + 1)
        gerrs[f"{shape[0]}x{shape[1]}"] = check_close(
            gk, gp, f"grad of sum(w*|fft(x)|^2) {shape} kernels vs plain")

    def grads_nd(fn, shape, seed, device):
        """d/dx of sum(w*|fn(x)|^2) for a real (rfft2) or complex input x."""
        g = torch.Generator().manual_seed(seed)
        a = torch.randn(shape, generator=g).to(device).requires_grad_()
        b = torch.randn(shape, generator=g).to(device).requires_grad_()
        y = fn(a) if fn is ft.rfft2 else fn(torch.complex(a, b))
        w = torch.rand(y.shape, generator=g).to(device)
        (w * y.abs() ** 2).sum().backward()
        return a.grad if b.grad is None else torch.complex(a.grad, b.grad)

    # rfft2: R2C, axis(-2); back: axis(-2), the row kernel.  Batched fft2
    # (16 planes): the fused plane forward and back.
    for fn, shape, kernels in ((ft.rfft2, (256, 1024), {"r2c_fft": 1, "ax0_fft": 2,
                                                       "rows_fft": 1}),
                               (ft.fft2, (16, 256, 256), {"fft2f_fft": 2})):
        gk = through(f"grad {fn.__name__} {shape}",
                     lambda: grads_nd(fn, shape, SEED + 2, dev), **kernels)
        gp = grads_nd(fn, shape, SEED + 2, torch.device("cpu"))  # the plain path
        gerrs[f"{fn.__name__} {shape}"] = check_close(
            gk.cpu(), gp, f"grad of sum(w*|{fn.__name__}(x)|^2) {shape} kernels vs plain")
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
            "plain": lambda: cuda_fft.fft_batched_split_reference(re, im, -1),
            "torch.fft": lambda: torch.fft.fft(x),
            "plan.forward": lambda: pn.forward(x),
        })
        del x, re, im

    x = crand(1024, 4096)  # the 2^22 four-step's pass shapes
    re, im = planes(x)
    outer = (1024, 1 << 22)
    times["ax0_fft 1024x4096"] = time_in_turns({
        "kernel": lambda: cuda_fft._ax0_launch(re, im, -1, None),
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
        "plain": lambda: bigfft.fft_big_split_reference(re, im, -1),
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
        "rows_fft + ax0_fft": lambda: cuda_fft._ax0_launch(
            *cuda_fft._launch(re, im, -1, None), -1, None),
        "plain": lambda: cuda_fft.fft2_fused_split_reference(re, im, -1),
        "torch.fft": lambda: torch.fft.fft2(x),
        "copy": plane_copy(re, im),
    }, reps=10)
    times["ax3_fft 256^3"] = time_in_turns({
        "kernel": lambda: cuda_fft._ax3_launch(re, im, -1, None),
        "plain": lambda: cuda_fft.fft_axis3_split_reference(re, im, -1),
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
        "plain": lambda: cuda_fft.rfft_rows_split_reference(r),
        "torch.fft": lambda: torch.fft.rfft(r),
        "copy": lambda: out.copy_(r),
    }, reps=20)
    times["c2r_fft 4096x4096"] = time_in_turns({
        "kernel": lambda: cuda_fft._c2r_launch(Rr, Ri, 4096, 1.0 / 4096),
        "plain": lambda: cuda_fft.irfft_rows_split_reference(Rr, Ri, 4096, 1.0 / 4096),
        "torch.fft": lambda: torch.fft.irfft(R, n=4096),
        "copy": lambda: out.copy_(r),
    }, reps=20)
    del r, Rr, Ri, R, out

    x = crand(4096, 4096)  # config 4's plane by both routes
    re, im = planes(x)
    times["fft2 4096x4096"] = time_in_turns({
        "rows_t_fft x2": lambda: cuda_fft._rows_t_launch(
            *cuda_fft._rows_t_launch(re, im, -1, None, None), -1, None, None),
        "rows_fft + ax0_fft": lambda: cuda_fft._ax0_launch(
            *cuda_fft._launch(re, im, -1, None), -1, None),
        "fft2": lambda: ft.fft2(x),
        "torch.fft": lambda: torch.fft.fft2(x),
        "copy": plane_copy(re, im),
    }, reps=20)
    del x, re, im

    x = crand(512, 512, 512)  # 1 GiB: axis(-3), axis(-2), row kernel
    times["fftn 512^3"] = {"fftn": time_ms(lambda: ft.fftn(x), reps=5, warmup=1),
                           "torch.fft": time_ms(lambda: torch.fft.fftn(x), reps=5,
                                                warmup=1)}
    del x
    for shape, t in times.items():
        rounds = "1 round" if shape == "fftn 512^3" else "2 rounds"
        print(f"times: {smi} | {shape} | median ms (CUDA events, {rounds}) | "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)

    def entry(name, source, replaces, shape):
        return {"name": name, "route": "cuda",
                "source": f"fft_wgpu_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": main_launches[name],
                "max_abs_err": max_abs[name], "ms": times[shape]["kernel"],
                "plain_ms": times[shape]["plain"]}

    print(json.dumps({"kernels": [
        entry("rows_fft", "rows_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:946",
              "rows_fft 4096x4096"),
        entry("ax0_fft", "ax0_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:1180",
              "ax0_fft 1024x4096"),
        entry("ax3_fft", "ax0_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:1342",
              "ax3_fft 256^3"),
        entry("rows_t_fft", "rows_t_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:1494",
              "rows_t_fft 1024x4096"),
        entry("fft2f_fft", "fft2f_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:2274",
              "fft2f_fft 256x256x256"),
        entry("r2c_fft", "r2c_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:1801",
              "r2c_fft 4096x4096"),
        entry("c2r_fft", "c2r_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:2076",
              "c2r_fft 4096x4096"),
        entry("big_fft", "big_fft.cu", "fft_wgpu_tpu/ops/bigfft.py:139",
              "big_fft 256x2^16"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
