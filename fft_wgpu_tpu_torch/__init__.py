"""fft_wgpu_tpu_torch — the PyTorch + CUDA port of fft_wgpu_tpu.

Batched 1-D complex-to-complex FFTs along the last axis through the same
plan API as the JAX package.  On a CUDA tensor, power-of-two lengths run
hand-written Hopper kernels built with nvcc at first use: 128..16384 the
row kernel (``csrc/rows_fft.cu``); above that the four-step, as the
whole-row cluster kernel (``csrc/big_fft.cu``, 2^15..2^18) or the axis(-2)
and transposed-rows kernels (``csrc/ax0_fft.cu``, ``csrc/rows_t_fft.cu``).
Other lengths, and every CPU tensor, run the plain torch mixed-radix path.
This package imports torch and never jax.
"""

from .core.reference import naive_dft, naive_idft
from .core.twiddle import FORWARD, INVERSE
from .ops.transforms import fft, ifft, ifft_unnormalized, normalize
from .plan.parity import Forward, Inverse, Normalize, Onlyinverse
from .plan.plan import Plan, get_plan, plan

__version__ = "0.1.0"

__all__ = [
    "fft",
    "ifft",
    "ifft_unnormalized",
    "normalize",
    "Plan",
    "plan",
    "get_plan",
    "Forward",
    "Inverse",
    "Onlyinverse",
    "Normalize",
    "FORWARD",
    "INVERSE",
    "naive_dft",
    "naive_idft",
]
