"""Kernel validation (torch port of ``fft_wgpu_tpu.utils.debug``).

* ``validate_kernel(n)`` — the row kernel (B1, ``csrc/rows_fft.cu``) on
  the card against the float64 naive-DFT oracle; on the CPU the plain
  version of the kernel's own passes (``cuda_fft._rows_passes``), the
  counterpart of the JAX package's interpret mode.
* ``check_finite`` — a NaN/Inf guard around any executor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.complex_utils import default_device
from ..core.reference import naive_dft

__all__ = ["validate_kernel", "check_finite"]


def validate_kernel(n: int, batch: int = 4, sign: int = -1, seed: int = 0,
                    tol: float = 1e-5, device=None) -> float:
    """The row kernel on ``device`` (the current CUDA device by default;
    ``"cpu"``: the plain version of its passes) against the f64 naive DFT;
    returns the relative L2 error.  Raises AssertionError above ``tol``."""
    from ..ops import cuda_fft

    device = torch.device(device) if device is not None else default_device()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    re = torch.from_numpy(x.real.astype(np.float32)).to(device)
    im = torch.from_numpy(x.imag.astype(np.float32)).to(device)
    if device.type == "cuda":
        rr, ii = cuda_fft.fft_batched_split(re, im, sign)
    else:
        rr, ii = cuda_fft._rows_passes(re, im, sign)
    got = rr.cpu().double().numpy() + 1j * ii.cpu().double().numpy()
    want = naive_dft(x) if sign == -1 else naive_dft(x.conj()).conj()
    err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert err < tol, f"kernel validation failed at n={n}: rel-L2 {err:.3e}"
    return err


def check_finite(re, im, what: str = "fft"):
    """Raise :class:`FloatingPointError` naming ``what`` if the pair holds
    a NaN or Inf (one read back to the host).  Returns the inputs for
    chaining."""
    if not bool(torch.isfinite(re).all() & torch.isfinite(im).all()):
        raise FloatingPointError(f"non-finite values in {what}")
    return re, im
