#!/usr/bin/env python3
"""Drive the torch port's C2C paths once on one CUDA card: the batched 1-D
main path (n = 128..16384) and the large-N path (four-step and whole-row).

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit.  It builds the four kernels from
``fft_wgpu_tpu_torch/csrc`` (one nvcc each, all at once) and runs five
phases, one line each or more; any failure raises and the script exits
non-zero without a result line:

1. device  — the card's name and power limit (nvidia-smi's line as it
             prints it, then the versions), TF32 off, the kernel builds;
2. kernel  — each kernel against its plain torch version and torch.fft,
             both signs, scale None and 1/n (rel-L2 <= 1e-5 each):
             rows_fft for every n in 128..16384 at rows 1 and 1000 and at
             4096 x 4096 and 2500 x 512; ax0_fft for every n at m = 7 and
             m = 1000 (a leading batch of 2) and at the 2^22 pass-1 shape
             1024 x 4096; rows_t_fft for every n at R = 1 and 200, without
             and with the outer twiddle, and at the 2^22 pass-2 shape;
             big_fft for every n of its envelope at rows 1 and 3, and at
             256 x 2^16;
3. main    — plan / fft / ifft / Forward at the sizes users call, with the
             launch counts showing each call went through its kernels
             (row kernel; axis(-2) then transposed rows; whole row);
4. grad    — gradients through fft against the plain versions' (row
             kernel; the four-step at 2 x 2^20; the whole row at 4 x 2^16);
5. times   — CUDA-event medians of each kernel, its plain version,
             torch.fft and plan.forward at the main shapes, beside a plane
             copy of the same bytes.

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

TOL = 1e-5  # relative L2, the JAX package's oracle bar
SEED = 0
LIBS = ("rows_fft", "ax0_fft", "rows_t_fft", "big_fft")


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
    max_abs = dict.fromkeys(LIBS, 0.0)

    def compare(name, got, plain, want, what):
        err_p = check_close(got, plain, f"{name} vs plain {what}")
        err_o = check_close(got, want, f"{name} vs torch.fft {what}")
        max_abs[name] = max(max_abs[name], float((got - plain).abs().max()))
        return max(err_p, err_o)

    def sweep(name, shapes, run, plain, want):
        worst, cases = 0.0, 0
        for shape, extra in shapes:
            x = crand(*shape)
            re, im = planes(x)
            n = shape[-1] if name != "ax0_fft" else shape[-2]
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
          + [((1024, 4096), None)],
          lambda re, im, s, sc, _: cuda_fft._ax0_launch(re, im, s, sc),
          lambda re, im, s, sc, _: cuda_fft.fft_axis0_split_reference(re, im, s, sc),
          lambda x, s, sc, _: oracle(x, s, sc, dim=-2))
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

    # ---- 3. main path at users' sizes ------------------------------------
    errs = {}

    def counts():
        return {"rows_fft": cuda_fft.launches, "ax0_fft": cuda_fft.ax0_launches,
                "rows_t_fft": cuda_fft.rows_t_launches, "big_fft": bigfft.launches}

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
    cuda_fft.launches = cuda_fft.ax0_launches = cuda_fft.rows_t_launches = 0
    bigfft.launches = 0

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
    main_launches = counts()
    for name, k in main_launches.items():
        check(k > 0, f"main path launched no {name} kernel")
    print(f"main: {len(errs)} checks ok, launches {main_launches} | "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)

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
    for shape, t in times.items():
        print(f"times: {smi} | {shape} | median ms (CUDA events, 2 rounds) | "
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
        entry("rows_t_fft", "rows_t_fft.cu", "fft_wgpu_tpu/ops/pallas_fft.py:1494",
              "rows_t_fft 1024x4096"),
        entry("big_fft", "big_fft.cu", "fft_wgpu_tpu/ops/bigfft.py:139",
              "big_fft 256x2^16"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
