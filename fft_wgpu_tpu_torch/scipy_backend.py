"""scipy.fft backend: route scipy.fft calls through fft_wgpu_tpu_torch
(torch port of ``fft_wgpu_tpu.scipy_backend``).

scipy.fft dispatches through uarray, so any object exposing
``__ua_domain__``/``__ua_function__`` can serve as a backend.  Usage::

    import scipy.fft as sf
    import fft_wgpu_tpu_torch.scipy_backend as cuda_fft

    with sf.set_backend(cuda_fft):          # scoped, the current CUDA device
        X = sf.fft(x)
    with sf.set_backend(cuda_fft.on("cuda:1")):   # another device
        X = sf.fft(x)
    cuda_fft.install()                      # or process-global

The module computes on the current CUDA device; ``on(device)`` is the same
backend on another device (``on("cpu")`` runs the plain path on the CPU).
Array arguments move to that device, and outputs come back as host numpy.
This is the interop path: performance-critical code calls the package on
device tensors and keeps them there.

Dispatch rules, as in the JAX package:
- ``workers``/``plan``/``overwrite_x`` are advisory in scipy and ignored.
- A call the package cannot express (a scipy function it lacks, or a
  keyword such as ``orthogonalize=``) returns ``NotImplemented``, so scipy
  falls back to pocketfft (unless the user passed ``only=True``); errors
  of a call it can express propagate.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

__ua_domain__ = "numpy.scipy.fft"

__all__ = ["on", "install"]

_ADVISORY_KWARGS = ("overwrite_x", "workers", "plan")


def _to_host(out):
    """Output -> host numpy (tuples element by element)."""
    from .utils.io import device_get_complex

    if isinstance(out, tuple):
        return tuple(_to_host(o) for o in out)
    return device_get_complex(out)


def _to_device(a, device):
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return a


def _call(device, method, args, kwargs):
    import fft_wgpu_tpu_torch as ft

    fn = getattr(ft, method.__name__, None)
    if fn is None:
        return NotImplemented
    kw = {k: v for k, v in kwargs.items() if k not in _ADVISORY_KWARGS}
    try:
        # the signature is checked before the call: a scipy keyword the
        # package does not express falls back to pocketfft, while errors
        # of a call it can express propagate
        inspect.signature(fn).bind(*args, **kw)
    except TypeError:
        return NotImplemented
    if device is None:
        from .core.complex_utils import default_device

        device = default_device()
    args = [_to_device(a, device) for a in args]
    kw = {k: _to_device(v, device) for k, v in kw.items()}
    return _to_host(fn(*args, **kw))


def __ua_function__(method, args, kwargs):
    return _call(None, method, args, kwargs)


class _Backend:
    """The backend on one device (see :func:`on`)."""

    __ua_domain__ = __ua_domain__

    def __init__(self, device):
        self.device = torch.device(device)

    def __ua_function__(self, method, args, kwargs):
        return _call(self.device, method, args, kwargs)

    def __repr__(self):
        return f"scipy_backend.on({str(self.device)!r})"


def on(device):
    """This backend computing on ``device`` (a ``torch.device`` or its
    name) instead of the current CUDA device."""
    return _Backend(device)


def install() -> None:
    """Register this module as scipy.fft's global backend (with pocketfft
    fallback for anything returning NotImplemented)."""
    import scipy.fft as sf

    import fft_wgpu_tpu_torch.scipy_backend as me

    sf.register_backend(me)
    sf.set_global_backend(me, only=False, try_last=False)
