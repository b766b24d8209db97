"""Host <-> device transfer helpers (torch port of
``fft_wgpu_tpu.utils.io``).

The JAX package moves complex data as planar float32 because some TPU
runtimes cannot transfer complex64.  torch moves complex tensors directly,
so each helper is one copy: numpy to a complex64 tensor on the device, a
tensor back to numpy.  ``enable_persistent_compilation_cache`` is the
counterpart of the JAX package's on-disk XLA cache: it sets the directory
where the kernel libraries are built and found (``utils/build.py``), so a
later process on the same sources loads them with no nvcc run.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.complex_utils import default_device
from . import build

__all__ = ["device_get_complex", "device_put_complex", "enable_persistent_compilation_cache"]


def device_get_complex(z) -> np.ndarray:
    """A tensor (complex or real, on any device) as host numpy, in one
    copy; non-tensor input goes through ``np.asarray``."""
    if isinstance(z, torch.Tensor):
        return z.detach().resolve_conj().cpu().numpy()
    return np.asarray(z)


def device_put_complex(x, device=None) -> torch.Tensor:
    """Host numpy -> a tensor on ``device`` (the current CUDA device by
    default, which raises if there is none): complex input as complex64,
    real input as it is."""
    x = np.asarray(x)
    device = torch.device(device) if device is not None else default_device()
    if np.iscomplexobj(x):
        x = np.ascontiguousarray(x, np.complex64)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def enable_persistent_compilation_cache(path: str = "~/.cache/fft_wgpu_tpu_torch_build"):
    """Build and load the kernel libraries in ``path`` (created if missing)
    from now on, and return it: libraries built there by an earlier
    process on the same sources, headers and flags load with no nvcc run."""
    return str(build.set_build_dir(os.path.expanduser(path)))
