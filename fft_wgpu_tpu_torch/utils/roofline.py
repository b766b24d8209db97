"""Roofline accounting for FFT timings (torch port of
``fft_wgpu_tpu.utils.roofline``, its single-device part).

A C2C FFT must read and write every complex element once, so
t_min = 2 * batch * n * 8 bytes / bandwidth, and the conventional rate is
5 N log2 N flops.  The bandwidths are data-sheet peaks: the H100 SXM's
3.35 TB/s of HBM3 (the rate ``chip_smoke.py``'s bounds use).  The
distributed layer's model (``ici_bandwidth``, ``pencil_fft3d_model``)
puts the card's NVLink where the JAX module puts the TPU's ICI.
"""

from __future__ import annotations

import math

import torch

__all__ = ["hbm_bandwidth", "fft_flops", "roofline", "ici_bandwidth",
           "pencil_fft3d_model"]

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


# Interconnect bandwidth per card (bytes/s, both directions summed), the
# name kept from the JAX module's ICI table: the H100 SXM's NVLink 4,
# 900 GB/s to the other cards of its host through NVSwitch (450 GB/s each
# way; NVIDIA's data sheet).  A scaling MODEL's constant, for the ranks of
# one node; across nodes the network is slower.
_ICI_BW = {
    "NVIDIA H100": 9.0e11,
}


def ici_bandwidth(device=None) -> float:
    """Per-card interconnect bandwidth in bytes/s, both directions summed
    (model constant; an unknown card counts as an H100 SXM)."""
    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else ""
    bw = _match_kind(_ICI_BW, kind)
    return bw if bw is not None else _ICI_BW["NVIDIA H100"]


def pencil_fft3d_model(n: int, mesh_shape: tuple[int, int], *, device=None,
                       transposed_output: bool = False,
                       hbm_bw: float | None = None,
                       ici_bw: float | None = None,
                       comm_bytes: float = 8.0) -> dict:
    """Lower-bound cost model of the pencil-decomposed 3-D C2C FFT of an
    n^3 cube over a px x py mesh of cards (``parallel.pencil.fft3d``).

    Floors, per card, complex64 (8 B a point):
      - compute: 3 local pencil-FFT passes, each one read and one write of
        the card's whole slice in device memory (the row, axis(-2) and
        axis(-3) kernels are one pass each);
      - interconnect: an all-to-all along a mesh axis of size m sends
        (m-1)/m of the slice off the card.  The card's egress is half the
        aggregate (one direction) and, the cards of a node being joined
        all to all by NVSwitch, every turn has all of it whichever mesh
        axis it runs on (the JAX model splits a TPU's egress between the
        two axes of its torus): a turn takes
        wire_bytes * (m-1)/m / (ici_bw / 2).  2 turns for transposed
        output, 4 for natural order.  ``comm_bytes`` is the wire size of a
        complex point (8 for float32, 4 for the ``comm_dtype=bfloat16``
        turns).
    With the chunked overlap schedule the floor is max(compute,
    interconnect); a mesh of one card has no turns.

    Returns times in seconds and the modelled per-card byte counts."""
    px, py = mesh_shape
    p = px * py
    hbm = hbm_bw or hbm_bandwidth(device)
    ici = ici_bw or ici_bandwidth(device)

    local_bytes = 8.0 * n**3 / p
    compute_s = 3.0 * 2.0 * local_bytes / hbm

    egress = ici / 2.0
    turns = [py, px] + ([] if transposed_output else [px, py])
    wire_bytes = local_bytes * comm_bytes / 8.0
    ici_bytes = sum(wire_bytes * (m - 1) / m for m in turns)
    ici_s = ici_bytes / egress

    overlapped_s = max(compute_s, ici_s)
    return {
        "chips": p,
        "local_bytes": local_bytes,
        "compute_s": compute_s,
        "ici_s": ici_s,
        "ici_bytes_per_chip": ici_bytes,
        "overlapped_s": overlapped_s,
        "serial_s": compute_s + ici_s,
        # 3 axes x (n^2 rows x 5 n log2 n) = 5 n^3 log2(n^3)
        "gflops": 15.0 * n**3 * math.log2(n) / overlapped_s / 1e9,
    }
