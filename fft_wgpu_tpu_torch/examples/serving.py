"""Serving-deployment pattern (the port of ``examples/serving.py``): the
persistent build cache and plan warmup.  A process's first start builds
the kernels; every later start loads them from the on-disk cache
(``utils.io.enable_persistent_compilation_cache``), and ``Plan.warmup``
makes the serving path hot before traffic arrives.  Then three requests,
an AOT artifact (the plan's routes and built libraries) and its replay.

Run: python -m fft_wgpu_tpu_torch.examples.serving [--device cpu]
"""

import os
import tempfile
import time

import numpy as np
import torch

import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.examples._common import cli, device_of, host, on
from fft_wgpu_tpu_torch.utils.io import enable_persistent_compilation_cache


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(device=None, small=False):
    dev = device_of(device)
    batch = 16 if small else 1024
    cache = enable_persistent_compilation_cache()
    print(f"build cache: {cache}")

    t0 = time.perf_counter()
    plan = ft.plan(4096).warmup(batch_shape=(batch,), device=dev)
    z = on(np.zeros((1, 4096), np.complex64), dev)
    _ = host(plan.forward(z))
    print(f"warmup (build or cache hit): {time.perf_counter() - t0:.1f}s")

    rng = np.random.default_rng(0)  # serve "requests"
    for i in range(3):
        x = (rng.standard_normal((batch, 4096))
             + 1j * rng.standard_normal((batch, 4096))).astype(np.complex64)
        t0 = time.perf_counter()
        yh = host(plan.forward(on(x, dev)))
        print(f"request {i}: {time.perf_counter() - t0:.3f}s end-to-end "
              f"(incl. host transfers), |y|={np.linalg.norm(yh):.3e}")

    # AOT artifact: the routes and the built libraries; the serving process
    # loads them with no build (plan/aot.py)
    art = os.path.join(tempfile.mkdtemp(), "fft4096.ftta")
    ft.export_plan(plan, art, batch_shape=(batch,), device=dev)
    print(f"exported {os.path.getsize(art) / 1024:.0f} KiB artifact")
    sp = ft.load_plan(art)
    re = on(np.random.default_rng(1).standard_normal((batch, 4096)).astype("float32"), dev)
    t0 = time.perf_counter()
    fr, fi = sp.forward_split(re, torch.zeros_like(re))
    _sync(dev)
    print(f"AOT replay: {time.perf_counter() - t0:.3f}s, {sp!r}")


if __name__ == "__main__":
    cli(main)
