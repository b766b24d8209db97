#!/usr/bin/env python3
"""Time the composite-row kernels (gen_fft, C2C; r2c_gen_fft, R2C) of the
torch port on one CUDA card, beside torch.fft in the same process.

    python3 scripts/time_composite_rows.py [--tree DIR] [--label NAME] [--out FILE]

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
    include."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and re.search(rf"\b{name}\b", e.name))
    if total <= 0:
        raise RuntimeError(f"the profiler saw no {name} kernel")
    return total / 1e3 / reps


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
    for kernel, rows, n in SHAPES:
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
    line = json.dumps(result)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
