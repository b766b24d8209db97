#!/usr/bin/env python3
"""Repeat ``chip_smoke.py`` phase 4's nufft1d1 gradient check on one CUDA
card, to look for a rare reading far above its usual one.

The check: d/dc of sum(w * |nufft1d1(x, c, 4096)|^2) for 4096 points made
from the smoke's seed, on the card (the spread by ``index_add_``, the row
kernel at the fine grid's 8192 points, and back the row kernel and a
gather) against the same gradient on the CPU's plain path, as relative L2
(the smoke's bar is 1e-5).  Each repeat also reads the forward values'
relative L2 and the card's gradient against the card's first, which shows
how far the spread's atomics move it.  Half the repeats run alone; the
other half run between other work on the card (transforms of other shapes
through the port, and tensors of random sizes made and freed, so that the
caching allocator hands the check other blocks).  A reading above
``--flag`` prints the elements of the gradient that moved most.

    python3 scripts/nufft_grad_repeat.py [--tree DIR] [--repeats N]

The card's name and power limit head the output; one JSON line ends it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

SEED = 0  # chip_smoke.SEED


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import the port from")
    ap.add_argument("--repeats", type=int, default=200)
    ap.add_argument("--flag", type=float, default=2e-6,
                    help="print the moved elements of a reading above this")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("nufft_grad_repeat: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    import fft_wgpu_tpu_torch as ft

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    xs = torch.from_numpy(np.random.default_rng(SEED + 6).uniform(
        0, 2 * np.pi, 4096).astype(np.float32))

    def grads(device):
        # chip_smoke.py's grads_of for this one check
        g = torch.Generator().manual_seed(SEED + 6)
        c = torch.complex(torch.randn(4096, generator=g), torch.randn(4096, generator=g))
        c = c.to(device).requires_grad_()
        y = ft.nufft1d1(xs.to(device), c, 4096)
        w = torch.rand(y.shape, generator=g).to(device)
        (w * y.abs() ** 2).sum().backward()
        return c.grad.detach().cpu(), y.detach().cpu()

    def rel(a, b):
        a, b = a.to(torch.complex128), b.to(torch.complex128)
        return float((a - b).abs().norm() / b.abs().norm())

    gp, yp = grads(torch.device("cpu"))
    first = None
    rng = np.random.default_rng(SEED)
    readings = {"alone": [], "between other work": []}
    worst = {}
    for i in range(args.repeats):
        mode = "alone" if i < args.repeats // 2 else "between other work"
        if mode != "alone":
            for _ in range(int(rng.integers(1, 4))):
                rows, n = int(rng.choice([1, 64, 1000])), int(rng.choice([256, 4096, 8192]))
                x = torch.randn(rows, n, dtype=torch.complex64, device=dev)
                ft.ifft(ft.fft(x))
            junk = [torch.empty(int(rng.integers(1, 1 << 22)), device=dev).fill_(float("nan"))
                    for _ in range(int(rng.integers(1, 6)))]
            del junk
            if i % 10 == 0:
                torch.cuda.empty_cache()
        gk, yk = grads(dev)
        first = gk if first is None else first
        r = {"grad": rel(gk, gp), "y": rel(yk, yp), "grad vs first card": rel(gk, first)}
        readings[mode].append(r)
        if r["grad"] > worst.get("grad", -1.0):
            worst = dict(r, repeat=i, mode=mode)
        if r["grad"] > args.flag:
            d = (gk.to(torch.complex128) - gp.to(torch.complex128)).abs()
            top = torch.topk(d, 8)
            print(f"repeat {i} ({mode}) | grad rel-L2 {r['grad']:.3e}, y {r['y']:.3e} | "
                  "most moved: " + ", ".join(f"[{int(k)}] {float(v):.3e} of "
                                             f"{float(gp[k].abs()):.3e}"
                                             for v, k in zip(top.values, top.indices)),
                  flush=True)
    summary = {}
    for mode, rs in readings.items():
        g = np.array([r["grad"] for r in rs])
        if not len(g):
            continue
        summary[mode] = {"repeats": len(g), "grad max": float(g.max()),
                         "grad median": float(np.median(g)),
                         "above 1e-5": int((g > 1e-5).sum()),
                         "y max": max(r["y"] for r in rs),
                         "grad vs first card max": max(r["grad vs first card"] for r in rs)}
        print(f"nufft1d1 grad | {mode} | " + ", ".join(
            f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in summary[mode].items()), flush=True)
    print(json.dumps({"device": smi, "summary": summary, "worst": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
