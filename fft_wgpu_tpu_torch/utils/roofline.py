"""Roofline accounting for FFT timings (torch port of
``fft_wgpu_tpu.utils.roofline``, its single-device part).

A C2C FFT must read and write every complex element once, so
t_min = 2 * batch * n * 8 bytes / bandwidth, and the conventional rate is
5 N log2 N flops.  The bandwidths are data-sheet peaks: the H100 SXM's
3.35 TB/s of HBM3 (the rate ``chip_smoke.py``'s bounds use).
``ici_bandwidth`` and ``pencil_fft3d_model`` come with the distributed
layer.
"""

from __future__ import annotations

import math

import torch

__all__ = ["hbm_bandwidth", "fft_flops", "roofline"]

# Peak device-memory bandwidth by card name prefix (bytes/s).
_HBM_BW = {
    "NVIDIA H100": 3.35e12,
    "cpu": 0.1e12,
}


def _match_kind(table: dict, kind: str):
    """Longest-prefix match of ``kind`` among the table's keys."""
    best = None
    for key, bw in table.items():
        if kind.startswith(key) and (best is None or len(key) > best[0]):
            best = (len(key), bw)
    return best[1] if best else None


def hbm_bandwidth(device=None) -> float:
    """Peak memory bandwidth of ``device`` (default: the current CUDA
    device, else the CPU) in bytes/s; an unknown card counts as an H100."""
    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type != "cuda":
        return _HBM_BW["cpu"]
    bw = _match_kind(_HBM_BW, torch.cuda.get_device_name(device))
    return bw if bw is not None else _HBM_BW["NVIDIA H100"]


def fft_flops(n: int, batch: int = 1) -> float:
    """Conventional FFT flop count 5 N log2 N per transform."""
    return 5.0 * n * math.log2(n) * batch


def roofline(n: int, batch: int, seconds: float, *, passes: int = 1, device=None):
    """Return dict with achieved GFLOP/s, roofline GFLOP/s, and fraction.

    ``passes`` = device-memory round trips the algorithm needs (1 for a
    whole-row kernel, 2 for the four-step's two passes)."""
    bw = hbm_bandwidth(device)
    flops = fft_flops(n, batch)
    bytes_min = 2.0 * batch * n * 8.0 * passes  # read + write, complex64
    t_min = bytes_min / bw
    achieved = flops / seconds
    roof = flops / t_min
    return {
        "gflops": achieved / 1e9,
        "roofline_gflops": roof / 1e9,
        "fraction": achieved / roof,
        "t_min_s": t_min,
        "bandwidth": bw,
    }
