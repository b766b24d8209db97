"""Helpers shared by the examples: the device an example runs on, moving
numpy data there and back, and the command line."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.complex_utils import default_device


def device_of(device) -> torch.device:
    """``device`` (``"cpu"`` for the CPU), else the current CUDA device,
    which raises where there is none."""
    return torch.device(device) if device is not None else default_device()


def on(a, dev) -> torch.Tensor:
    """The numpy array ``a`` as a tensor on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def host(t) -> np.ndarray:
    """A tensor (or an (re, im) pair of tensors) as a host numpy array."""
    if isinstance(t, tuple):
        return host(t[0]) + 1j * host(t[1])
    return t.detach().cpu().numpy()


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got) - want) / np.linalg.norm(want))


def cli(main) -> None:
    """Run ``main`` with ``--device`` and ``--small`` from the command line."""
    parser = argparse.ArgumentParser(description=main.__module__)
    parser.add_argument("--device", default=None,
                        help="cpu, cuda or cuda:N (default: the current CUDA device)")
    parser.add_argument("--small", action="store_true", help="a cut-down problem size")
    args = parser.parse_args()
    main(device=args.device, small=args.small)
