#!/usr/bin/env python3
"""Time the launch shapes of the composite axis(-2) kernel (ax0_gen_fft)
where a block holds fewer than 8 columns, on one CUDA card: the kernel's
own rule (one column a block in a cluster of 4 blocks, 8 past 512 threads
a column) against one column a block in a cluster of 4, in a cluster of 8,
and the most columns that fit a block in no cluster.

    python3 scripts/time_ax0_gen_shapes.py [--out FILE]

Each variant is ``csrc/ax0_gen_fft.cu`` with its shape rule rewritten,
compiled with the port's nvcc flags into ``fft_wgpu_tpu_torch/_build/shapes/``
(all variants at once), checked against torch.fft (relative L2 <= 1e-5)
and timed by its kernel's device time from a torch.profiler window of 20
calls, at 16 x n x 512 for n = 2047, 4095 and 12288 (and 1080, where 8
columns fit and every variant is the same kernel).  The card's name and
power limit (nvidia-smi) head the output; one JSON line ends it and, with
``--out``, is appended to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from time_composite_rows import TOL, device_ms, rel_l2  # noqa: E402

RULE = "    tm = 1;\n    C = T > 512 ? 8 : 4;\n"
VARIANTS = {
    "kernel": RULE,
    "1 column, cluster 4": "    tm = 1;\n    C = 4;\n",
    "1 column, cluster 8": "    tm = 1;\n    C = 8;\n",
    "most columns, no cluster": "",
}
NS = (1080, 2047, 4095, 12288)


def build_variants():
    from fft_wgpu_tpu_torch.utils import build

    src_path = build.CSRC / "ax0_gen_fft.cu"
    src = src_path.read_text()
    if src.count(RULE) != 1:
        raise RuntimeError("ax0_gen_fft.cu's shape rule is not where this script expects it")
    out_dir = build.BUILD_DIR / "shapes"
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(item):
        i, (name, rule) = item
        cu, lib = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(src.replace(RULE, rule))
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                               "-o", str(lib), str(cu)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{proc.stderr}")
        return name, str(lib)

    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        return dict(ex.map(one, enumerate(VARIANTS.items())))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="append the JSON line here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_ax0_gen_shapes: no CUDA device", file=sys.stderr)
        return 1
    from fft_wgpu_tpu_torch.ops import cuda_fft

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fns = {}
    for name, lib in build_variants().items():
        f = ctypes.CDLL(lib).ax0_gen_fft_f32
        f.argtypes, f.restype = [P, P, P, P, P, LL, LL, I, P, I, I, F, P], I
        fns[name] = f
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"device": smi, "times": {}}
    for n in NS:
        shape = (16, n, 512)
        x = torch.complex(torch.randn(shape, device=dev, generator=gen),
                          torch.randn(shape, device=dev, generator=gen))
        re_, im_ = x.real.contiguous(), x.imag.contiguous()
        out = (torch.empty_like(re_), torch.empty_like(im_))
        plan = cuda_fft._mixed_radix_plan(n)
        radix = cuda_fft._radix_arg(plan)
        tw = cuda_fft._twiddle_table(n, -1, dev)
        want = torch.fft.fft(x, dim=-2)
        key = "x".join(map(str, shape))
        result["times"][key] = {}
        for name, f in fns.items():
            def call(f=f):
                err = f(re_.data_ptr(), im_.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                        tw.data_ptr(), shape[0], shape[2], n, ctypes.cast(radix, P), len(plan),
                        -1, 1.0, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} at {key}: CUDA error {err}")
            call()
            err = rel_l2(torch.complex(*out), want)
            if err > TOL:
                raise RuntimeError(f"{name} at {key}: rel-L2 {err:.3e} > {TOL}")
            result["times"][key][name] = device_ms(call, "ax0_gen_fft_kernel")
        print(f"{key} | " + ", ".join(f"{k} {v:.4f} ms"
                                      for k, v in result["times"][key].items()), flush=True)
        del x, re_, im_, out, want
    line = json.dumps(result)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
