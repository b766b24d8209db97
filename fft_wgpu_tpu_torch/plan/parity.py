"""Reference-shaped plan classes (API parity layer, torch port of
``fft_wgpu_tpu.plan.parity``).

Users of the reference construct `Forward`/`Inverse`/`Onlyinverse`/
`Normalize` objects bound to a buffer + fft_len and call `.proc(encoder)`.
These classes keep the construct-once / call-many shape:

    fwd = Forward(512)          # Forward::new(device, queue, src, 512)
    y   = fwd.proc(x)           # encoder.proc(...) + submit

There is no output-buffer parity game: `proc` returns the result tensor.
"""

from __future__ import annotations

from .plan import Plan

__all__ = ["Forward", "Inverse", "Onlyinverse", "Normalize"]


class _Proc:
    _method: str

    def __init__(self, fft_len: int, **plan_kwargs):
        self.fft_len = int(fft_len)
        self._plan = Plan(fft_len, **plan_kwargs)

    def proc(self, x, axis: int = -1):
        return getattr(self._plan, self._method)(x, axis=axis)

    __call__ = proc

    def __repr__(self):
        return f"{type(self).__name__}(fft_len={self.fft_len})"


class Forward(_Proc):
    """Forward C2C FFT plan (reference Forward, processor.rs:7-159)."""

    _method = "forward"


class Inverse(_Proc):
    """Inverse C2C FFT with fused 1/N (reference Inverse, processor.rs:231-341;
    the in-kernel last-stage divide of ifft.wgsl:65-74 becomes a fused
    epilogue scale here)."""

    _method = "inverse"


class Onlyinverse(_Proc):
    """Unnormalized inverse FFT (reference Onlyinverse, processor.rs:566-670)."""

    _method = "inverse_unnormalized"


class Normalize(_Proc):
    """Standalone 1/N scaling pass (reference Normalize, processor.rs:409-505)."""

    _method = "normalize"
