#!/usr/bin/env python3
"""Time the two routes a tuned plan measures above 16384 points, across row
counts, on one CUDA card: the whole-row kernel (``"bigfft"``, B15) against
the axis(-2) kernel then the transposed-rows kernel (``"fourstep:two-pass"``,
B2 + B4).

Each (rows, n) is timed with ``plan/autotune.py``'s own timer (CUDA-event
slopes between two burst lengths, on the functions ``measure_executor``
times) after each route is held against the other (relative L2 <= 1e-5),
so a row of the output is what the tuner would see for that shape.  The
tuner keeps one decision per rows bucket (rows < 16, < 128, and above),
so the rows here span the buckets and the top one.

    python3 scripts/tune_large_rows.py [--rows 16,64,256,1024] [--n 131072,262144]

The card's name and power limit head the output; one JSON line ends it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="16,64,256,1024")
    ap.add_argument("--n", default="65536,131072,262144")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("tune_large_rows: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import fft_wgpu_tpu_torch as ft
    from fft_wgpu_tpu_torch.core.twiddle import FORWARD
    from fft_wgpu_tpu_torch.plan import autotune

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    out = {}
    for n in (int(v) for v in args.n.split(",")):
        p = ft.plan(n)
        for rows in (int(v) for v in args.rows.split(",")):
            fns = {ex: (lambda a, b, _ex=ex: p._execute_split_axis(a, b, FORWARD, None, -1,
                                                                     ex=_ex))
                   for ex in ("bigfft", "fourstep:two-pass")}
            gen = torch.Generator(device=dev).manual_seed(0)
            re = torch.randn(rows, n, generator=gen, device=dev)
            im = torch.randn(rows, n, generator=gen, device=dev)
            a, b = (torch.complex(*fn(re, im)).to(torch.complex128) for fn in fns.values())
            err = float((a - b).abs().norm() / b.abs().norm())
            if not err <= 1e-5:
                raise RuntimeError(f"{rows}x{n}: the routes differ by {err:.3e}")
            del re, im, a, b
            ms = {ex: autotune._slope_time(fn, (rows, n), dev) * 1e3 for ex, fn in fns.items()}
            out[f"{rows}x{n}"] = dict(ms, bucket=autotune.rows_bucket((rows, n), n))
            win = min(ms, key=ms.get)
            print(f"{rows}x{n} (bucket {out[f'{rows}x{n}']['bucket']}) | " + ", ".join(
                f"{ex} {t:.4f} ms" for ex, t in ms.items()) + f" | faster: {win}", flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
