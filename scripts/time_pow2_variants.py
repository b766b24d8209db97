#!/usr/bin/env python3
"""Time launch-bound and cluster-size variants of the pow2 row kernels of
the torch port (rows_fft, B1; big_fft, B15) on one CUDA card, each beside
the kernel as it is.

    python3 scripts/time_pow2_variants.py [--out FILE]

Variants: rows_fft with every launch bound at 64 registers (1024 threads an
SM; the kernel keeps 80 for blocks of 128 and 256 threads); big_fft with
one 512-thread block an SM at 8192 points a block (128 registers; the
kernel asks for two, 64 registers); big_fft at 2^15 in clusters of 8 blocks
of 4096 points (the kernel: 4 of 8192) and at 2^17 in 16 blocks of 8192
(the kernel: 8 of 16384).  Each variant is the kernel's
source with one line rewritten, compiled with the port's nvcc flags into
``fft_wgpu_tpu_torch/_build/variants/`` (all at once), called through its
complex64 entry point, checked against torch.fft (relative L2 <= 1e-5) and
timed by its kernel's device time from a torch.profiler window of 20
calls.  The card's name and power limit (nvidia-smi) head the output; one
JSON line ends it and, with ``--out``, is appended to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from time_composite_rows import TOL, device_ms, rel_l2  # noqa: E402

ROWS_BOUND = ("  static constexpr int kMinBlocks = kBlock <= 128 ? 6 : kBlock == 256 ? 3 : "
              "1024 / kBlock;\n")
BIG_BOUND = "  static constexpr int kMinBlocks = kThreads == 256 ? 3 : kThreads == 512 ? 2 : 1;\n"
BIG_15 = "    case 15 * 8 + 2: return launch<15, 2, C64>(sign, g, rows, s);\n"
BIG_17 = "    case 17 * 8 + 3: return launch<17, 3, C64>(sign, g, rows, s);\n"
# (library, variant) -> (line of the source, its replacement); None: as is
VARIANTS = {
    ("rows_fft", "kernel"): None,
    ("rows_fft", "64 registers"): (
        ROWS_BOUND, "  static constexpr int kMinBlocks = 1024 / kBlock;\n"),
    ("big_fft", "kernel"): None,
    ("big_fft", "one block of 8192 an SM"): (
        BIG_BOUND, "  static constexpr int kMinBlocks = kThreads == 256 ? 3 : 1;\n"),
    ("big_fft", "8 blocks of 4096"): (
        BIG_15, BIG_15 + "    case 15 * 8 + 3: return launch<15, 3, C64>(sign, g, rows, s);\n"),
    ("big_fft", "16 blocks of 8192"): (
        BIG_17, BIG_17 + "    case 17 * 8 + 4: return launch<17, 4, C64>(sign, g, rows, s);\n"),
}
# the cluster sizes of the variants that change them
CLUSTER = {"8 blocks of 4096": (15, 8), "16 blocks of 8192": (17, 16)}
ROWS_SHAPES = ((4096, 4096), (2048, 2048), (2500, 512), (1000, 128), (1024, 16384))
BIG_SHAPES = ((64, 15), (256, 16), (32, 17))


def build_variants():
    from fft_wgpu_tpu_torch.utils import build

    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(item):
        i, ((lib_name, name), edit) = item
        src = (build.CSRC / f"{lib_name}.cu").read_text()
        if edit is not None:
            if src.count(edit[0]) != 1:
                raise RuntimeError(f"{lib_name}.cu: the line of variant {name!r} is not "
                                   "where this script expects it")
            src = src.replace(*edit)
        cu, lib = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(src)
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                               "-o", str(lib), str(cu)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{proc.stderr}")
        return (lib_name, name), str(lib)

    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        return dict(ex.map(one, enumerate(VARIANTS.items())))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="append the JSON line here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_pow2_variants: no CUDA device", file=sys.stderr)
        return 1
    from fft_wgpu_tpu_torch.ops import bigfft, cuda_fft

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fns = {}
    for (lib_name, name), lib in build_variants().items():
        f = getattr(ctypes.CDLL(lib), f"{lib_name}_c64")
        f.argtypes = ([P, P, P, LL, I, I, F, P] if lib_name == "rows_fft"
                      else [P, P, P, LL, I, I, I, F, P])
        f.restype = I
        fns[lib_name, name] = f
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"device": smi, "times": {}}

    def run(key, x, want, calls, kernel):
        result["times"][key] = {}
        for name, call in calls.items():
            err = rel_l2(call(), want)
            if err > TOL:
                raise RuntimeError(f"{name} at {key}: rel-L2 {err:.3e} > {TOL}")
            result["times"][key][name] = device_ms(call, kernel)
        print(f"{key} | " + ", ".join(f"{k} {v:.4f} ms"
                                      for k, v in result["times"][key].items()), flush=True)

    def rows_call(f, x, out, tw, n):
        def call():
            err = f(x.data_ptr(), out.data_ptr(), tw.data_ptr(), x.shape[0],
                    n.bit_length() - 1, -1, 1.0, stream)
            if err:
                raise RuntimeError(f"rows_fft variant: CUDA error {err}")
            return out
        return call

    for rows, n in ROWS_SHAPES:
        x = torch.complex(torch.randn(rows, n, device=dev, generator=gen),
                          torch.randn(rows, n, device=dev, generator=gen))
        out = torch.empty_like(x)
        tw = cuda_fft._twiddle_table(n, -1, dev, cuda_fft._pass_roots_np)
        run(f"rows_fft {rows}x{n}", x, torch.fft.fft(x),
            {name: rows_call(f, x, out, tw, n) for (lib, name), f in fns.items()
             if lib == "rows_fft"}, "rows_fft_kernel")
        del x, out

    cluster = bigfft._cluster

    def big_call(f, x, out, n, c):
        # the table of c blocks a row: _big_roots_np under that cluster rule
        bigfft._cluster = lambda m: c if m == n else cluster(m)
        try:
            tab = torch.from_numpy(np.stack(bigfft._big_roots_np(n, -1), axis=-1)).to(dev)
        finally:
            bigfft._cluster = cluster

        def call():
            err = f(x.data_ptr(), out.data_ptr(), tab.data_ptr(), x.shape[0],
                    n.bit_length() - 1, c.bit_length() - 1, -1, 1.0, stream)
            if err:
                raise RuntimeError(f"big_fft variant: CUDA error {err}")
            return out
        return call

    for rows, e in BIG_SHAPES:
        n = 1 << e
        x = torch.complex(torch.randn(rows, n, device=dev, generator=gen),
                          torch.randn(rows, n, device=dev, generator=gen))
        out = torch.empty_like(x)
        calls = {}
        for (lib, name), f in fns.items():
            if lib != "big_fft":
                continue
            if name not in CLUSTER:
                calls[name] = big_call(f, x, out, n, cluster(n))
            elif CLUSTER[name][0] == e:
                calls[name] = big_call(f, x, out, n, CLUSTER[name][1])
        run(f"big_fft {rows}x2^{e}", x, torch.fft.fft(x), calls, "big_fft_kernel")
        del x, out
    line = json.dumps(result)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
