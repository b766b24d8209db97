#!/usr/bin/env python3
"""Time the two routes a tuned plan measures above 16384 points, across row
counts, on one CUDA card: the whole-row kernel (``"bigfft"``, B15) against
the axis(-2) kernel then the transposed-rows kernel (``"fourstep:two-pass"``,
B2 + B4), each through its planar entries and through its complex64 ones
(``bigfft.fft_big_c64``; ``fourstep.fft_last_axis_c64``).

Each (rows, n) is timed with ``plan/autotune.py``'s own timer (CUDA-event
slopes between two burst lengths, on the functions ``measure_executor``
times) after each route is held against the other (relative L2 <= 1e-5),
so a row of the output is what the tuner would see for that shape.  The
tuner keeps one decision per rows bucket (rows < 16, < 128, and above),
so the rows here span the buckets and the top one.  ``--rounds`` repeats
the whole table, the routes in the reverse order every other round, so
that the spread between rounds can be read beside each difference.

    python3 scripts/tune_large_rows.py [--rows 1,4,16,64,256,1024]
                                       [--n 32768,65536,131072,262144] [--rounds 2]

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
    ap.add_argument("--rows", default="1,4,16,64,256,1024")
    ap.add_argument("--n", default="32768,65536,131072,262144")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("tune_large_rows: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import fft_wgpu_tpu_torch as ft
    from fft_wgpu_tpu_torch.core.twiddle import FORWARD
    from fft_wgpu_tpu_torch.ops import bigfft, fourstep
    from fft_wgpu_tpu_torch.plan import autotune

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    out = {}
    for rnd in range(args.rounds):
        for n in (int(v) for v in args.n.split(",")):
            p = ft.plan(n)
            for rows in (int(v) for v in args.rows.split(",")):
                gen = torch.Generator(device=dev).manual_seed(0)
                x = torch.complex(torch.randn(rows, n, generator=gen, device=dev),
                                  torch.randn(rows, n, generator=gen, device=dev))
                fns = {ex: (lambda a, b, _ex=ex: p._execute_split_axis(a, b, FORWARD, None, -1,
                                                                         ex=_ex))
                       for ex in ("bigfft", "fourstep:two-pass")}
                fns["bigfft c64"] = lambda a, b: bigfft.fft_big_c64(x, FORWARD)
                fns["fourstep:two-pass c64"] = lambda a, b: fourstep.fft_last_axis_c64(x, FORWARD)
                re, im = x.real.contiguous(), x.imag.contiguous()
                got = [torch.complex(*fn(re, im)) if ex in ("bigfft", "fourstep:two-pass")
                       else fn(re, im) for ex, fn in fns.items()]
                want = got[1].to(torch.complex128)
                for ex, y in zip(fns, got):
                    err = float((y.to(torch.complex128) - want).abs().norm() / want.abs().norm())
                    if not err <= 1e-5:
                        raise RuntimeError(f"{rows}x{n}: {ex} differs by {err:.3e}")
                del re, im, got, want
                order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
                ms = {ex: autotune._slope_time(fns[ex], (rows, n), dev) * 1e3 for ex in order}
                key = f"{rows}x{n}"
                entry = out.setdefault(key, {"bucket": autotune.rows_bucket((rows, n), n)})
                for ex in fns:
                    entry.setdefault(ex, []).append(ms[ex])
                print(f"round {rnd} {key} (bucket {entry['bucket']}) | " + ", ".join(
                    f"{ex} {ms[ex]:.4f} ms" for ex in fns) + " | faster: planar "
                    + min(("bigfft", "fourstep:two-pass"), key=ms.get) + ", complex64 "
                    + min(("bigfft c64", "fourstep:two-pass c64"), key=ms.get), flush=True)
                del x
                torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
