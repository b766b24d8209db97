"""Large-N 1-D FFT via the four-step (Bailey) decomposition: the port's
counterpart of ``ops/fourstep.py``.

    view x as A[n1, n2]
    1. B  = FFT_n1 over axis -2
    2. C  = B * tw[k1, n2]             (f64-generated twiddle)
    3. D  = FFT_n2 over axis -1        (output scale folded here)
    4. X[k1 + n1*k2] = D[k1, k2]       (transpose-flatten)

On a CUDA tensor the route is chosen by rule, never by catching an
error: a shape the whole-row kernel takes on the static route
(``bigfft.takes``: its envelope, below the measured crossover to the two
passes) runs it in one pass (a complex64 tensor reaches that kernel's
complex64 entry straight from the plan, ``Plan._execute_c64``, with no
split); otherwise pass 1 is the axis(-2) kernel (through the plan's axis -2 route)
and pass 2 the transposed-rows kernel with the outer twiddle applied at
load, so the whole transform is two passes over device memory and the
final reshape is free.  A complex64 tensor takes the same two kernels
through their complex64 entries (:func:`fft_last_axis_c64`, from
``Plan._execute_c64`` where :func:`c64_supported` holds): two launches, no
split and no merge.  A CPU tensor, or a factor outside the kernels'
envelopes, takes the JAX package's route off the TPU: an explicit twiddle
plane, a row FFT and a corner turn.
"""

from __future__ import annotations

from ..core import factor as _factor
from . import bigfft, cuda_fft, stockham

__all__ = ["fft_last_axis", "fft_last_axis_c64", "c64_supported", "choose_factors"]


def choose_factors(n: int) -> tuple[int, int]:
    """Split n = n1 * n2, both factors as close to sqrt(n) as possible.

    For powers of two from 2^21 on, n2 is pinned to 4096, as in the JAX
    package, where that pin was measured on a TPU v5e; it is still to be
    re-derived on the card (ROADMAP, open items)."""
    if n & (n - 1) == 0:  # power of two
        e = n.bit_length() - 1
        if e >= 21:
            return n >> 12, 4096
        e1 = e // 2
        return 1 << e1, 1 << (e - e1)
    return _factor.balanced_split(n)


def fft_last_axis(re, im, sign, scale=None, *, whole_row=True):
    """Four-step FFT over the last axis of a split (re, im) pair.  With
    ``whole_row=False`` a CUDA tensor takes the two passes even where the
    whole-row kernel would serve (a tuned plan measures both routes)."""
    from ..plan.plan import get_plan

    n = re.shape[-1]
    lead = re.shape[:-1]
    on_card = re.device.type == "cuda"
    if whole_row and on_card and bigfft.takes(n, re.numel() // n if n else 0):
        return bigfft.fft_big_split(re, im, sign, scale)

    n1, n2 = choose_factors(n)
    if n1 == 1:  # prime / unsplittable: delegate to the general executor
        re, im = stockham.fft_last_axis(re, im, sign)
        return stockham.apply_scale(re, im, scale)

    re = re.reshape(*lead, n1, n2)
    im = im.reshape(*lead, n1, n2)

    # 1. FFT over n1 on axis -2: the axis(-2) kernel on the card
    br, bi = get_plan(n1, "auto")._execute_split_axis(re, im, sign, None, -2)

    # 2+3+4. on the card, one pass: rows FFT over n2 with the outer twiddle
    # at load and a transposed store
    if on_card and cuda_fft._supported(n2):
        dr, di = cuda_fft.fft_rows_transposed_split(br, bi, sign, scale,
                                                    outer=(n1, n))
        return dr.reshape(*lead, n), di.reshape(*lead, n)

    # off the card: explicit twiddle + row FFT + corner-turn flatten
    twr, twi = stockham._const("twiddle_np", (n1, n2, sign), re.device)
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr
    dr, di = get_plan(n2, "auto")._execute_split(cr, ci, sign, scale)
    dr = dr.transpose(-1, -2).reshape(*lead, n)
    di = di.transpose(-1, -2).reshape(*lead, n)
    return dr, di


def c64_supported(n: int) -> bool:
    """Whether :func:`fft_last_axis_c64` takes n: both factors of
    :func:`choose_factors` in the complex64 entries' envelope (pow2
    128..16384: the axis(-2) kernel's complex64 entry is pow2 only)."""
    n1, n2 = choose_factors(n)
    return n1 > 1 and cuda_fft._supported(n1) and cuda_fft._supported(n2)


def _c64(x, sign, scale):
    n = x.shape[-1]
    n1, n2 = choose_factors(n)
    lead = x.shape[:-1]
    b = cuda_fft._ax0_c64(x.reshape(*lead, n1, n2), sign, None)  # FFT_n1 over axis -2
    d = cuda_fft._rows_t_c64(b, sign, scale, (n1, n))  # twiddle, FFT_n2, transpose
    return d.reshape(*lead, n)


def fft_last_axis_c64(x, sign, scale=None):
    """The four-step FFT over the last axis of a complex64 ``[..., n]``
    tensor as it lies, with no split and no merge: the axis(-2) kernel's
    complex64 entry on the free view ``[..., n1, n2]``, then the
    transposed-rows kernel's with the outer twiddle, whose ``[..., n2, n1]``
    output is the natural-order transform viewed flat; on the card two
    launches, on the CPU their plain versions.  Differentiable as one
    linear map: the backward is the same transform with the sign flipped."""
    cuda_fft._check_c64(x)
    n = x.shape[-1]
    if not c64_supported(n):
        raise cuda_fft.Unsupported(f"n={n} outside the complex64 four-step's envelope "
                                   f"(factors {choose_factors(n)})")
    cuda_fft._check_sign(sign)
    return cuda_fft._SignFlipped.apply(_c64, sign, scale, x)
