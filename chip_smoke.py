#!/usr/bin/env python3
"""Drive the torch port's batched 1-D C2C main path once on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit.  It builds the row kernel from ``fft_wgpu_tpu_torch/csrc``
and runs five phases, one line each; any failure raises and the script
exits non-zero without a result line:

1. device  — the card's name and power limit (nvidia-smi's line as it
             prints it, then the versions), TF32 off, the kernel build;
2. kernel  — the rows_fft kernel against its plain torch version and
             torch.fft for every n in 128..16384 at rows 1 and 1000, and at
             the main path's 4096 x 4096 and 2500 x 512, both signs, scale
             None and 1/n (rel-L2 <= 1e-5 each);
3. main    — plan / fft / ifft / Forward at the sizes users call, with the
             kernel's launch count showing each call went through it;
4. grad    — a gradient through fft against the plain version's;
5. times   — CUDA-event medians of the kernel, the plain version and
             torch.fft at 4096 x 4096 and 2500 x 512.

torch.fft is an oracle and a baseline here, never the implementation.  The
last two lines are a JSON object describing the kernel, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

TOL = 1e-5  # relative L2, the JAX package's oracle bar
SEED = 0


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import fft_wgpu_tpu_torch as ft
    from fft_wgpu_tpu_torch.ops import cuda_fft
    from fft_wgpu_tpu_torch.utils import build

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def crand(*shape):
        return torch.complex(torch.randn(shape, device=dev, generator=gen),
                             torch.randn(shape, device=dev, generator=gen))

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = build.build("rows_fft")
    build_s = time.perf_counter() - t0
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda}"
          f" | rows_fft built in {build_s:.1f} s -> {lib.name}", flush=True)

    # ---- 2. kernel vs plain version vs torch.fft --------------------------
    worst_plain = worst_oracle = max_abs = 0.0
    cases = 0
    # every n of the envelope, plus the shapes the main path below gives it
    shapes = [(rows, 1 << e) for e in range(7, 15) for rows in (1, 1000)]
    for rows, n in shapes + [(4096, 4096), (2500, 512)]:
        x = crand(rows, n)
        re, im = x.real.contiguous(), x.imag.contiguous()
        for sign in (-1, 1):
            for scale in (None, 1.0 / n):
                k = torch.complex(*cuda_fft._launch(re, im, sign, scale))
                p = torch.complex(*cuda_fft.fft_batched_split_reference(
                    re, im, sign, scale))
                o = (torch.fft.fft(x) if sign < 0
                     else torch.fft.ifft(x, norm="forward"))
                o = o * (1.0 if scale is None else scale)
                what = f"{rows}x{n} sign={sign} scale={scale}"
                worst_plain = max(worst_plain,
                                  check_close(k, p, f"kernel vs plain {what}"))
                worst_oracle = max(worst_oracle,
                                   check_close(k, o, f"kernel vs torch.fft {what}"))
                max_abs = max(max_abs, float((k - p).abs().max()))
                cases += 1
    torch.cuda.synchronize()
    print(f"kernel: {cases} cases (n=128..16384, main-path shapes) ok | worst rel-L2 vs plain "
          f"{worst_plain:.3e}, vs torch.fft {worst_oracle:.3e} | max abs "
          f"err vs plain {max_abs:.3e}", flush=True)

    # ---- 3. main path at users' sizes ------------------------------------
    errs = {}
    cuda_fft.launches = 0

    def through_kernel(what, fn):
        before = cuda_fft.launches
        out = fn()
        torch.cuda.synchronize()
        check(cuda_fft.launches > before, f"{what}: row kernel not launched")
        return out

    x = crand(4096, 4096)  # BASELINE config 2: 128 MiB of complex64
    p = ft.plan(4096)
    X = through_kernel("plan(4096).forward", lambda: p.forward(x))
    errs["plan4096_fwd"] = check_close(X, torch.fft.fft(x), "plan(4096).forward")
    xi = through_kernel("plan(4096).inverse", lambda: p.inverse(X))
    errs["plan4096_roundtrip"] = check_close(xi, x, "plan(4096) inverse round trip")
    xu = through_kernel("plan(4096).inverse_unnormalized",
                        lambda: p.inverse_unnormalized(X))
    errs["plan4096_onlyinv_norm"] = check_close(
        p.normalize(xu), x, "plan(4096) inverse_unnormalized + normalize")
    del x, X, xi, xu

    x = crand(2500, 512)  # the README quick-start shape
    X = through_kernel("fft 2500x512", lambda: ft.fft(x))
    errs["fft_2500x512"] = check_close(X, torch.fft.fft(x), "fft 2500x512")
    errs["ifft_2500x512"] = check_close(
        through_kernel("ifft 2500x512", lambda: ft.ifft(X)), x, "ifft 2500x512")
    Xf = through_kernel("Forward(512).proc", lambda: ft.Forward(512).proc(x))
    errs["Forward512"] = check_close(Xf, torch.fft.fft(x), "Forward(512).proc")

    x1 = crand(1, 1024)  # BASELINE config 1, against the f64 naive DFT
    X1 = through_kernel("fft 1x1024", lambda: ft.fft(x1))
    want = torch.from_numpy(ft.naive_dft(x1.cpu().numpy()))
    errs["fft_1x1024_naive"] = check_close(X1.cpu(), want, "fft 1x1024 vs naive_dft")
    main_launches = cuda_fft.launches
    check(main_launches > 0, "main path launched no row kernel")
    print(f"main: {len(errs)} checks ok, rows_fft launches {main_launches} | "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)

    # ---- 4. autograd on the card -----------------------------------------
    def grads(transform):
        re = torch.randn(64, 4096, device=dev, generator=g2).requires_grad_()
        im = torch.randn(64, 4096, device=dev, generator=g2).requires_grad_()
        w = torch.rand(64, 4096, device=dev, generator=g2)
        yr, yi = transform(re, im)
        (w * (yr * yr + yi * yi)).sum().backward()
        return torch.complex(re.grad, im.grad)

    g2 = torch.Generator(device=dev).manual_seed(SEED + 1)
    before = cuda_fft.launches
    gk = grads(lambda a, b: (lambda y: (y.real, y.imag))(ft.fft(torch.complex(a, b))))
    check(cuda_fft.launches >= before + 2, "grad: forward+backward kernels not launched")
    g2 = torch.Generator(device=dev).manual_seed(SEED + 1)
    gp = grads(lambda a, b: cuda_fft.fft_batched_split_reference(a, b, -1))
    gerr = check_close(gk, gp, "grad of sum(w*|fft(x)|^2) kernel vs plain")
    print(f"grad: 64x4096 rel-L2 vs plain {gerr:.3e}", flush=True)

    # ---- 5. times ----------------------------------------------------------
    times = {}
    for rows, n in ((4096, 4096), (2500, 512)):
        x = crand(rows, n)
        re, im = x.real.contiguous(), x.imag.contiguous()
        pn = ft.plan(n)
        fns = {
            "kernel": lambda: cuda_fft._launch(re, im, -1, None),
            "plain": lambda: cuda_fft.fft_batched_split_reference(re, im, -1),
            "torch.fft": lambda: torch.fft.fft(x),
            "plan.forward": lambda: pn.forward(x),
        }
        # two rounds in turns, so drift on the card hits every version alike
        samples = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                samples[k].append(time_ms(fns[k]))
        times[f"{rows}x{n}"] = {k: statistics.median(v) for k, v in samples.items()}
        del x, re, im
    print(f"times: {smi} | median ms (CUDA events, 30 reps x 2 rounds) | "
          + " | ".join(f"{shape}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
                       for shape, t in times.items()), flush=True)

    head = times["4096x4096"]
    print(json.dumps({"kernels": [{
        "name": "rows_fft",
        "route": "cuda",
        "source": "fft_wgpu_tpu_torch/csrc/rows_fft.cu",
        "replaces": "fft_wgpu_tpu/ops/pallas_fft.py:946",
        "launches": main_launches,
        "max_abs_err": max_abs,
        "ms": head["kernel"],
        "plain_ms": head["plain"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
