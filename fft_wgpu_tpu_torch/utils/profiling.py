"""Tracing / profiling hooks (torch port of
``fft_wgpu_tpu.utils.profiling``).

* ``trace(dir)`` — context manager around ``torch.profiler``: the enclosed
  block's host and device activity, written to ``dir`` as a Chrome trace
  (``trace.json``), with the profile yielded for ``key_averages()``.
* ``annotate(name)`` — a named region: ``record_function`` for the
  profiler, and an NVTX range on a card.
* ``op_stats(n, batch, seconds)`` — per-op GFLOP/s (5 N log2 N) and the
  memory roofline fraction (``utils/roofline.py``).
"""

from __future__ import annotations

import contextlib
import math
import os

import torch

from .roofline import fft_flops, hbm_bandwidth

__all__ = ["trace", "annotate", "op_stats"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (CPU activity, and the card's where there
    is one) and write ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region: shows in ``torch.profiler``'s trace, and as an NVTX
    range on a card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def op_stats(n: int, batch: int, seconds: float, *, passes: int = 1,
             device=None) -> dict:
    """GFLOP/s + roofline accounting for one batched-1D FFT execution."""
    bw = hbm_bandwidth(device)
    flops = fft_flops(n, batch)
    bytes_moved = 2.0 * batch * n * 8.0 * passes
    return {
        "n": n,
        "batch": batch,
        "seconds": seconds,
        "gflops": flops / seconds / 1e9,
        "gbps": bytes_moved / seconds / 1e9,
        "roofline_fraction": (bytes_moved / bw) / seconds,
        "flops_per_element": 5.0 * math.log2(n),
    }
