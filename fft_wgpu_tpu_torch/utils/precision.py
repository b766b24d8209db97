"""Dot-precision control for the port's matmul stages (torch port of
``fft_wgpu_tpu.utils.precision``).

The JAX package runs every DFT stage as a matmul on the TPU's MXU, and
``"fast"`` trades those dots from six bf16 passes to one.  On the card
the kernels are float32 FMAs on the CUDA cores and read no mode.  The
port's only matmul stages are those that run under
``ops/stockham.full_float32``: the plain path's DFT matmuls (CUDA tensors
of lengths no kernel takes), ``dfrft``'s (``ops/frft.py``), the
``convolve2d`` direct sums (``ops/conv2d.py``) and ``lombscargle``'s
(``ops/spectral_est.py``).  ``"accurate"`` (the default) runs them in full
float32 with TF32 off; ``"fast"`` lets them run TF32 (about 1e-3 relative
error).  The mode is read by each guard when it is entered and applies
inside it only: the process's TF32 setting is restored when the guard
exits, so no mode is ever left set in ``torch.backends``.
"""

from __future__ import annotations

from contextlib import contextmanager

__all__ = ["set_dot_precision", "get_dot_precision", "dot_precision"]

_MODES = ("accurate", "fast")
_current = "accurate"


def set_dot_precision(mode: str) -> None:
    """Set the matmul precision of every later transform: ``"accurate"``
    (default; full float32) or ``"fast"`` (TF32 in the matmul stages).  A
    change of mode drops the captured calls (``jit_cache.clear``), whose
    graphs hold the matmuls of the mode they were captured in, as the JAX
    package flushes its compiled executables."""
    global _current
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}, got {mode!r}")
    if mode != _current:
        from . import jit_cache

        jit_cache.clear()
    _current = mode


def get_dot_precision() -> str:
    """Current mode name (``"accurate"`` | ``"fast"``)."""
    return _current


@contextmanager
def dot_precision(mode: str):
    """Context manager form of :func:`set_dot_precision` (restores on
    exit)."""
    prev = _current
    set_dot_precision(mode)
    try:
        yield
    finally:
        set_dot_precision(prev)
