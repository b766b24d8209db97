#!/usr/bin/env python3
"""The power gain of a forward-then-inverse round trip through the port's
kernels on one CUDA card, and the magnitudes of the roots the passes of
``csrc/mixed_fft.cuh`` apply (ROADMAP §C, C5).

For one checkout (``--tree``; run it once for each of two trees, or for
copies with part of a change, to compare them on one card):

* gains: Re <y, x> / <x, x> - 1 in float64, y = inverse(forward(x)) with
  the 1/n scale, on random rows made with numpy from a seed: the row
  kernel (B1) through its planar and complex64 entries at n = 256 and
  4096 (1000 rows), the whole-row kernel (B15) through its planar and
  complex64 entries at 2^16 and 2^18 (64 rows; a tree with no complex64
  entry skips it), the
  composite-row kernel (B13) at 4095 (1000 rows), and the plain path
  (``stockham``) at 256 and 4096 beside them;
* the bright soliton of the NLSE at n = 4096 after 1000 Strang steps
  (dt 1e-3, L 640; one round trip a step): its relative L2 from the
  analytic solution at t = 1 and its mass drift, on the card and on the
  plain path;
* magnitudes (host arithmetic, the same float32 values the card reads):
  mean |w|^2 - 1 over the roots each pass of B1's plans at 256 and 4096
  applies, as the tree's tables hold them (its pass table, gathered as
  ``small_pass`` does; a tree whose passes form w^k as k - 1 products of
  one root has the chain emulated with one rounding a part, each part's
  two products exact, as an FMA gives), and over the butterfly constants
  (``kRoot``) each radix-16 and radix-8 butterfly multiplies by.

    python3 scripts/round_trip_gains.py [--tree DIR] [--label NAME] [--chain]

``--chain`` says the tree's passes chain (the parent of the repair); by
default each w^k is read from the tree's table.  The card's name and power
limit head the output; one JSON line ends it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

SEED = 0


def gain(x, y) -> float:
    import torch

    x, y = x.to(torch.complex128), y.to(torch.complex128)
    return float((y * x.conj()).sum().real / x.abs().square().sum()) - 1.0


def kroot(tree) -> dict:
    """The tree's butterfly constants, radix -> [(cos, sin)] (float64 of
    the float32 values in mixed_fft.cuh)."""
    src = open(os.path.join(tree, "fft_wgpu_tpu_torch", "csrc", "mixed_fft.cuh")).read()
    body = re.search(r"kRoot\[76\] = \{(.*?)\n\};", src, re.S)[1]
    out, radix = {}, None
    for line in body.splitlines():
        m = re.match(r"\s*// R = (\d+)", line)
        if m:
            radix = int(m[1])
            out[radix] = []
            continue
        pairs = re.findall(r"\{([-\d.e+]+)f, ([-\d.e+]+)f\}", line)
        if pairs:
            out[radix] += [(float(np.float32(a)), float(np.float32(b))) for a, b in pairs]
    return out


def mul32(a, b):
    """float32 complex product with one rounding a part (an FMA's)."""
    ar, ai = a.real.astype(np.float64), a.imag.astype(np.float64)
    br, bi = b.real.astype(np.float64), b.imag.astype(np.float64)
    return (ar * br - ai * bi).astype(np.float32) + 1j * (ar * bi + ai * br).astype(np.float32)


def magnitudes(cuda_fft, tree, chain: bool) -> dict:
    out = {}
    for n in (256, 4096):
        plan = cuda_fft._mixed_radix_plan(n)
        c, s = cuda_fft._pass_roots_np(n, -1)
        tab = c.astype(np.float32) + 1j * s.astype(np.float32)
        ns, off = plan[0], 0
        for r in plan[1:]:
            j = np.arange(n // r) % ns
            if chain:  # the tree's table holds one root a butterfly
                w = tab[off + j]
                wk, ws = w, []
                for k in range(1, r):
                    ws.append(wk)
                    wk = mul32(wk, w)
                off += ns
            else:  # the tree's table holds every power, [k - 1][e]
                ws = [tab[off + (k - 1) * ns + j] for k in range(1, r)]
                off += ns * (r - 1)
            w = np.stack(ws).astype(np.complex128)
            out[f"n {n} pass NS={ns} R={r} root"] = float(np.mean(np.abs(w[0]) ** 2 - 1))
            out[f"n {n} pass NS={ns} R={r} w^k"] = float(np.mean(np.abs(w) ** 2 - 1))
            ns *= r
    consts = kroot(tree)
    for r, (r1, r2) in ((16, (4, 4)), (8, (2, 4))):
        # dft_split<R1, R2>'s twiddles w_R^(n2*k1), n2 < R2, k1 < R1, over
        # the R points of a butterfly (1 where n2*k1 = 0)
        e = [consts[r][(n2 * k1) % r] for n2 in range(r2) for k1 in range(r1)]
        out[f"kRoot radix {r} butterfly"] = float(np.mean([a * a + b * b - 1 for a, b in e]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--chain", action="store_true",
                    help="the tree's passes form w^k as products of one root")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("round_trip_gains: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from fft_wgpu_tpu_torch import models
    from fft_wgpu_tpu_torch.ops import bigfft, cuda_fft

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    rng = np.random.default_rng(SEED)
    result = {"label": args.label, "device": smi, "gains": {}, "soliton": {}}

    def rows(r, n):
        x = rng.standard_normal((2, r, n)).astype(np.float32)
        return torch.complex(torch.from_numpy(x[0]), torch.from_numpy(x[1])).to(dev)

    def planar(fwd):
        def run(x, sign, scale):
            return torch.complex(*fwd(x.real.contiguous(), x.imag.contiguous(), sign, scale))
        return run

    kernels = {
        "rows_fft": planar(cuda_fft._launch),
        "rows_fft_c64": lambda x, s, sc: cuda_fft._launch_c64(x.contiguous(), s, sc),
        "plain": planar(cuda_fft.fft_batched_split_reference),
        "big_fft": planar(bigfft._launch),
        "big_fft_c64": lambda x, s, sc: bigfft._launch_c64(x.contiguous(), s, sc),
        "gen_fft": planar(cuda_fft._gen_launch),
    }
    cases = [("rows_fft", 1000, 256), ("rows_fft", 1000, 4096), ("rows_fft_c64", 1000, 256),
             ("rows_fft_c64", 1000, 4096), ("plain", 1000, 256), ("plain", 1000, 4096),
             ("big_fft", 64, 1 << 16), ("big_fft_c64", 64, 1 << 16), ("big_fft", 64, 1 << 18),
             ("big_fft_c64", 64, 1 << 18), ("gen_fft", 1000, 4095)]
    for name, r, n in cases:
        if name == "big_fft_c64" and not hasattr(bigfft, "_launch_c64"):
            continue
        x = rows(r, n)
        y = kernels[name](kernels[name](x, -1, None), 1, 1.0 / n)
        torch.cuda.synchronize()
        result["gains"][f"{name} {r}x{n}"] = gain(x, y)
    print(f"{args.label} | round-trip gain - 1 | " + ", ".join(
        f"{k} {v:+.3e}" for k, v in result["gains"].items()), flush=True)

    for where, d in (("card", dev), ("plain", cpu)):
        plan = models.nlse_init((4096,), 640.0, 1e-3, g=1.0, device=d)
        psi0 = models.bright_soliton(4096, 640.0, device=d)
        want = models.bright_soliton(4096, 640.0, t=1.0, device=cpu)
        got = models.nlse_rollout(plan, psi0, 1000)
        got = tuple(v.cpu().double() for v in got)
        mass = [float((a.double() ** 2 + b.double() ** 2).sum()) for a, b in
                (got, tuple(v.cpu() for v in psi0))]
        want = torch.complex(*want).to(torch.complex128)
        err = float(torch.linalg.vector_norm(torch.complex(*got) - want)
                    / torch.linalg.vector_norm(want))
        result["soliton"][where] = {"rel_l2": err, "mass": mass[0] / mass[1] - 1.0}
    print(f"{args.label} | bright soliton 4096 after 1000 steps | " + ", ".join(
        f"{k}: rel-L2 {v['rel_l2']:.3e}, mass {v['mass']:+.3e}"
        for k, v in result["soliton"].items()), flush=True)

    result["magnitudes"] = magnitudes(cuda_fft, tree, args.chain)
    print(f"{args.label} | mean |w|^2 - 1 | " + ", ".join(
        f"{k} {v:+.2e}" for k, v in result["magnitudes"].items()), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
