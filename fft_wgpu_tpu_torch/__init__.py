"""fft_wgpu_tpu_torch — the PyTorch + CUDA port of fft_wgpu_tpu.

Batched 1-D complex-to-complex FFTs through the same plan API as the JAX
package, and the N-D and real transforms on top of them (``fft2``,
``fftn``, ``rfft``, ``irfft``, ``rfftn``, the Hermitian family).  On a CUDA
tensor, power-of-two lengths run hand-written Hopper kernels built with
nvcc at first use: 128..16384 the row kernel (``csrc/rows_fft.cu``), the
axis(-2) kernel (``csrc/ax0_fft.cu``, also axes before it through a free
view) and the R2C / C2R kernels (``csrc/r2c_fft.cu``, ``csrc/c2r_fft.cu``);
2-D planes the fused-plane kernel (``csrc/fft2f_fft.cu``) or the
transposed-rows kernel twice (``csrc/rows_t_fft.cu``); above 16384 the
four-step, as the whole-row cluster kernel (``csrc/big_fft.cu``,
2^15..2^18) or the axis(-2) and transposed-rows kernels.  Composite
non-pow2 lengths of 512..16384 (factors <= 256) run the composite-row
kernels (``csrc/gen_fft.cu``, ``csrc/r2c_gen_fft.cu``); lengths with a
large prime factor, and the chirp-z transform (``czt``, ``zoom_fft``,
``CZT``, ``ZoomFFT``), run Bluestein's two chirp passes
(``csrc/chirp_fft.cu``) up to a padded length of 16384; composite axes
before the last run the composite axis(-2) kernel (``csrc/ax0_gen_fft.cu``).
The fused epilogues run their own kernels: ``SpectralFilter`` and
``hilbert`` the filtered row kernel (``csrc/filt_fft.cu``), the ``CWT``
plan its filter-bank kernel, and ``fftconvolve`` / ``oaconvolve`` of real
input the product C2R kernel (``csrc/c2r_fft.cu``).  The spectral
estimators (``welch``, ``periodogram``, ``csd``, ``coherence``,
``spectrogram``) run the fused segment-spectrum kernels (the segment
sums of ``csrc/welch_acc_fft.cu``, the per-segment powers of
``csrc/spec_fft.cu``), and so do the per-segment spectra of ``stft``,
``ShortTimeFFT`` and the complex spectrogram modes (the framed R2C and C2C
kernels, ``csrc/spec_fft.cu`` and ``csrc/spec_c2c_fft.cu``); ``istft`` and ``resample`` compose the transforms above, and
the window functions are host tables.  The scipy.fft long tail and the
transform-domain solvers compose those transforms and launch no kernel of
their own: the DCT/DST types I-IV and their N-D forms (a C2C along each
axis through the plan, with no transpose; types I through the R2C route),
the Chebyshev transforms, the MDCT, the fast Hankel transform, spectral
derivatives, scipy.ndimage's Fourier filters, circulant, Toeplitz and
BCCB solvers and Gaussian random fields, the cepstra and minimum phase,
``envelope``, the WOLA channelizer and the Wigner-Ville distribution.  So
does the signal-processing and non-uniform long tail: the waveforms and
the FIR designs (host float64 numpy, as in the JAX package; a waveform of
a tensor ``t`` is computed on ``t``'s device), ``upfirdn``,
``resample_poly`` and ``decimate`` (R2C, a spectrum product and C2R at a
pow2 length), ``convolve2d``, ``correlate2d``, ``wiener`` and
``savgol_filter``, the fractional Fourier transforms (``frft``,
``frft2``; ``dfrft`` is two matmuls) and the NUFFTs of types 1-3 in 1-D,
2-D and 3-D (``index_add_`` spreading, a gather, the fine grid's
transform through the plan).
Other lengths,
and every CPU tensor, run the plain torch mixed-radix path.  A tensor is
transformed on the device it lies on; other input (numpy arrays) goes to
the current CUDA device, and raises if there is none.  This package
imports torch and never jax.
"""

from .core.reference import naive_dft, naive_idft
from .core.twiddle import FORWARD, INVERSE
from .ops.cepstrum import (complex_cepstrum, inverse_complex_cepstrum, minimum_phase,
                           real_cepstrum)
from .ops.channelizer import channelize, prototype_lowpass
from .ops.conv2d import (convolve2d, correlate2d, deconvolve, morlet, savgol_coeffs,
                         savgol_filter, wiener)
from .ops.chebyshev import (cheb_coeffs, cheb_derivative, cheb_integrate, cheb_points,
                            cheb_values, clenshaw_curtis_weights)
from .ops.cwt import CWT, cwt, morlet2, ricker
from .ops.czt import CZT, ZoomFFT, czt, czt_points, zoom_fft
from .ops.dct import dct, dctn, dst, dstn, idct, idctn, idst, idstn
from .ops.envelope import envelope
from .ops.fastconv import SpectralFilter, spectral_filter
from .ops.fftlog import fht, fhtoffset, ifht
from .ops.fourier_filters import (fourier_ellipsoid, fourier_gaussian, fourier_shift,
                                  fourier_uniform)
from .ops.frft import dfrft, frft, frft2
from .ops.helpers import (choose_conv_method, convolve, correlate, correlation_lags,
                          detrend, dht, fft_convolve, fftconvolve, fftcorrelate, fftfreq,
                          fftshift, get_workers, hilbert, hilbert2, idht, ifftshift,
                          next_fast_len, oaconvolve, prev_fast_len, resample, rfftfreq,
                          set_workers)
from .ops.mdct import imdct, imdct_frame, mdct, mdct_frame, sine_window
from .ops.multirate import (decimate, firls, firwin, firwin2, freqz, group_delay, kaiser_atten,
                            kaiser_beta, kaiserord, remez, resample_poly, upfirdn)
from .ops.nd import fft2, fftn, ifft2, ifftn
from .ops.nufft import (nufft1d1, nufft1d2, nufft1d3, nufft2d1, nufft2d2, nufft2d3, nufft3d1,
                        nufft3d2, nufft3d3)
from .ops.rfft import (hfft, hfft2, hfftn, ihfft, ihfft2, ihfftn, irfft, irfft2,
                       irfftn, rfft, rfft2, rfftn)
from .ops.spectral_est import (check_COLA, check_NOLA, coherence, csd, dpss, flattop_window,
                               get_window, kaiser_window, lombscargle, multitaper,
                               periodogram, spectrogram, tukey_window, welch)
from .ops.short_time_fft import ShortTimeFFT
from .ops.spectral import spectral_derivative, spectral_gradient, spectral_laplacian
from .ops.stft import (bartlett_window, blackman_window, hamming_window, hann_window, istft,
                       stft)
from .ops.structured import (bccb_matvec, bccb_solve, circulant_matvec, circulant_solve,
                             grf_sample, toeplitz_matvec, toeplitz_solve)
from .ops.transforms import fft, ifft, ifft_unnormalized, normalize
from .ops.waveforms import (chirp, gausspulse, max_len_seq, sawtooth, square, sweep_poly,
                            unit_impulse, vectorstrength)
from .ops.wigner import wigner_ville, wigner_ville_frequencies
from .ops.windows import (barthann_window, blackmanharris_window, bohman_window,
                          boxcar_window, chebwin_window, cosine_window, exponential_window,
                          gaussian_window, general_cosine_window, general_gaussian_window,
                          general_hamming_window, kaiser_bessel_derived_window,
                          lanczos_window, nuttall_window, parzen_window, taylor_window,
                          triang_window)
from .plan.parity import Forward, Inverse, Normalize, Onlyinverse
from .plan.plan import Plan, get_plan, plan

__version__ = "0.1.0"

__all__ = [
    "fft",
    "ifft",
    "ifft_unnormalized",
    "normalize",
    "fft2",
    "ifft2",
    "fftn",
    "ifftn",
    "rfft",
    "irfft",
    "rfft2",
    "irfft2",
    "rfftn",
    "irfftn",
    "hfft",
    "ihfft",
    "hfft2",
    "ihfft2",
    "hfftn",
    "ihfftn",
    "czt",
    "zoom_fft",
    "czt_points",
    "CZT",
    "ZoomFFT",
    "cwt",
    "CWT",
    "ricker",
    "morlet2",
    "SpectralFilter",
    "spectral_filter",
    "choose_conv_method",
    "convolve",
    "correlate",
    "correlation_lags",
    "detrend",
    "dht",
    "idht",
    "fft_convolve",
    "fftconvolve",
    "fftcorrelate",
    "hilbert",
    "hilbert2",
    "resample",
    "fftfreq",
    "fftshift",
    "ifftshift",
    "next_fast_len",
    "prev_fast_len",
    "get_workers",
    "set_workers",
    "oaconvolve",
    "rfftfreq",
    "get_window",
    "check_COLA",
    "check_NOLA",
    "tukey_window",
    "kaiser_window",
    "flattop_window",
    "dpss",
    "periodogram",
    "welch",
    "csd",
    "coherence",
    "multitaper",
    "spectrogram",
    "lombscargle",
    "stft",
    "istft",
    "ShortTimeFFT",
    "hann_window",
    "hamming_window",
    "blackman_window",
    "bartlett_window",
    "boxcar_window",
    "triang_window",
    "parzen_window",
    "bohman_window",
    "nuttall_window",
    "blackmanharris_window",
    "cosine_window",
    "exponential_window",
    "barthann_window",
    "lanczos_window",
    "gaussian_window",
    "general_gaussian_window",
    "general_cosine_window",
    "general_hamming_window",
    "chebwin_window",
    "taylor_window",
    "kaiser_bessel_derived_window",
    "dct",
    "idct",
    "dst",
    "idst",
    "dctn",
    "idctn",
    "dstn",
    "idstn",
    "cheb_points",
    "cheb_coeffs",
    "cheb_values",
    "cheb_derivative",
    "cheb_integrate",
    "clenshaw_curtis_weights",
    "mdct",
    "imdct",
    "mdct_frame",
    "imdct_frame",
    "sine_window",
    "fht",
    "ifht",
    "fhtoffset",
    "spectral_derivative",
    "spectral_gradient",
    "spectral_laplacian",
    "fourier_gaussian",
    "fourier_uniform",
    "fourier_shift",
    "fourier_ellipsoid",
    "circulant_matvec",
    "circulant_solve",
    "toeplitz_matvec",
    "toeplitz_solve",
    "bccb_matvec",
    "bccb_solve",
    "grf_sample",
    "real_cepstrum",
    "complex_cepstrum",
    "inverse_complex_cepstrum",
    "minimum_phase",
    "envelope",
    "channelize",
    "prototype_lowpass",
    "wigner_ville",
    "wigner_ville_frequencies",
    "chirp",
    "sweep_poly",
    "gausspulse",
    "sawtooth",
    "square",
    "unit_impulse",
    "max_len_seq",
    "vectorstrength",
    "kaiser_atten",
    "kaiser_beta",
    "kaiserord",
    "firwin",
    "firwin2",
    "firls",
    "remez",
    "upfirdn",
    "resample_poly",
    "decimate",
    "freqz",
    "group_delay",
    "convolve2d",
    "correlate2d",
    "deconvolve",
    "wiener",
    "savgol_coeffs",
    "savgol_filter",
    "morlet",
    "frft",
    "frft2",
    "dfrft",
    "nufft1d1",
    "nufft1d2",
    "nufft1d3",
    "nufft2d1",
    "nufft2d2",
    "nufft2d3",
    "nufft3d1",
    "nufft3d2",
    "nufft3d3",
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
