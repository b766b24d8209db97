"""Split real/imag complex representation helpers (torch).

Complex data is carried as a planar pair of float32 tensors ``(re, im)``
through the compute path; ``complex64`` is the public facade.  A tensor
stays on the device it lies on: a CPU tensor is how a caller asks for the
CPU.  Any other input (numpy arrays, lists, scalars) goes to ``device`` if
one is given, else to the current CUDA device, as the JAX package puts
numpy input on its default device; with no CUDA device that raises rather
than computing on the CPU unasked.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["split", "merge", "is_pair", "promote_to_split", "default_device", "to_device",
           "host_table", "real_part", "as_args", "from_args"]


def default_device() -> torch.device:
    """The current CUDA device; raises if there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: non-tensor input runs on the current CUDA device; "
            "pass a CPU tensor (torch.from_numpy) to compute on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def to_device(x, device=None) -> torch.Tensor:
    """``x`` as a float32 tensor: a tensor on its own device (or on
    ``device`` if given), anything else on ``device`` or the current CUDA
    device."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32, device=device)
    arr = np.ascontiguousarray(x, dtype=np.float32)
    return torch.from_numpy(arr).to(device or default_device())


def host_table(arr, device, dtype=np.float32) -> torch.Tensor:
    """A host table (built in float64 or complex128 with numpy) cast once to
    ``dtype`` and copied to ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr).astype(dtype)).to(device)


def real_part(x, device=None) -> torch.Tensor:
    """The real part of ``x`` (a tensor, an array or an (re, im) pair) as a
    float32 tensor, as ``promote_to_split(x)[0]`` but with no zero plane."""
    if is_pair(x):
        return to_device(x[0], device=device)
    if isinstance(x, torch.Tensor):
        return (x.real if x.is_complex() else x).to(dtype=torch.float32, device=device)
    return to_device(np.real(np.asarray(x)), device=device)


def split(x, device=None):
    """complex (or real) array/tensor -> (re, im) pair of float32 tensors."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if np.iscomplexobj(x):
            return to_device(x.real, device=device), to_device(x.imag, device=device)
        x = to_device(x, device=device)
    elif device is not None:
        x = x.to(device)
    if x.is_complex():
        return (x.real.to(torch.float32).contiguous(),
                x.imag.to(torch.float32).contiguous())
    x = x.to(torch.float32)
    return x, torch.zeros_like(x)


def merge(re, im):
    """(re, im) float32 pair -> complex64 tensor."""
    return torch.complex(re.to(torch.float32), im.to(torch.float32))


def is_pair(x) -> bool:
    """True for an explicit (re, im) pair: a tuple of two tensors or
    ndarrays.  Anything else, a list of two rows included, is data."""
    return (isinstance(x, tuple) and len(x) == 2
            and all(isinstance(v, (torch.Tensor, np.ndarray)) for v in x))


def promote_to_split(x, device=None):
    """Accept complex/real tensor or numpy input (lists are data, as numpy
    reads them), or an (re, im) pair (:func:`is_pair`), and return an
    (re, im) float32 tensor pair."""
    if is_pair(x):
        re, im = x
        return to_device(re, device=device), to_device(im, device=device)
    return split(x, device)


def as_args(x, device=None) -> tuple:
    """``x`` as the tensor arguments of a cached call (``utils.jit_cache``):
    a tensor as itself (moved to ``device`` if given), anything else as the
    planes of :func:`promote_to_split`, so that the call's device work,
    a split included, is inside the call.  :func:`from_args` undoes it."""
    if isinstance(x, torch.Tensor):
        return (x if device is None else x.to(device),)
    return promote_to_split(x, device)


def from_args(args):
    """The planar pair (re, im) of what :func:`as_args` gave."""
    return promote_to_split(args[0] if len(args) == 1 else tuple(args))
