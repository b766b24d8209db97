"""ctypes bridge to the port's native C++ host core (torch port of
``fft_wgpu_tpu.utils.native``).

The reference keeps its host layer in native code (Rust: plan construction
and the f64 twiddle precompute, fft_wgpu src/processor.rs:43-49 and
161-229).  The port keeps its own copy of the JAX package's C++ core,
``csrc/fftcore.cpp``: f64 DFT matrices, twiddle and root tables, the
mixed-radix factorization, the plan decision, and a threaded host codec
between interleaved complex and planar float32.  It is built with g++ at
first use into the package's ``_build/`` directory, named by the hash of
its source and flags (``utils/build.py``), so a stale library is never
loaded.

Where the JAX module returns None without a toolchain so that its callers
fall back to numpy, a failed build here raises ``build.CompileError``.  The
tables the kernels read are built by ``core/twiddle.py`` as they were; the
tests hold them bit-equal to this core's f64 tables cast once.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import build

__all__ = ["get_lib", "dft_matrix_f64", "twiddle_f64", "roots_f64", "PLAN_EXECUTORS",
           "plan_choice", "factorize", "host_split_complex", "host_merge_complex"]

_lock = threading.Lock()
_lib = None

_I64 = ctypes.c_int64
_DP = ctypes.POINTER(ctypes.c_double)
_FP = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {  # C function -> (argtypes, restype)
    "fftcore_dft_matrix": ([_I64, ctypes.c_int, _DP, _DP], None),
    "fftcore_twiddle": ([_I64, _I64, ctypes.c_int, _DP, _DP], None),
    "fftcore_roots": ([_I64, ctypes.c_int, _DP, _DP], None),
    "fftcore_factorize": ([_I64, _I64, ctypes.POINTER(_I64), _I64], _I64),
    "fftcore_plan": ([_I64] * 5 + [ctypes.POINTER(_I64)] * 2, _I64),
    "fftcore_split_c64": ([_FP, _FP, _FP, _I64, ctypes.c_int], None),
    "fftcore_split_c128": ([_DP, _FP, _FP, _I64, ctypes.c_int], None),
    "fftcore_merge_c64": ([_FP, _FP, _FP, _I64, ctypes.c_int], None),
}


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native core, its functions typed;
    raises ``build.CompileError`` if g++ is missing or refuses it."""
    global _lib
    with _lock:
        if _lib is None:
            lib = build.load("fftcore")
            for fn, (argtypes, restype) in _SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes, f.restype = argtypes, restype
            _lib = lib
        return _lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(_DP)


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(_FP)


def dft_matrix_f64(n: int, sign: int):
    """f64 (cos, sin) [n, n] tables: W[k, m] = exp(sign*2pi*i*k*m/n), the
    angle reduced as (k*m) mod n in integers."""
    wr = np.empty((n, n), dtype=np.float64)
    wi = np.empty((n, n), dtype=np.float64)
    get_lib().fftcore_dft_matrix(n, sign, _dptr(wr), _dptr(wi))
    return wr, wi


def twiddle_f64(n1: int, n2: int, sign: int):
    """f64 (cos, sin) [n1, n2] four-step twiddles
    tw[k1, m2] = exp(sign*2pi*i*k1*m2/(n1*n2))."""
    wr = np.empty((n1, n2), dtype=np.float64)
    wi = np.empty((n1, n2), dtype=np.float64)
    get_lib().fftcore_twiddle(n1, n2, sign, _dptr(wr), _dptr(wi))
    return wr, wi


def roots_f64(n: int, sign: int):
    """f64 (cos, sin) of the n-th roots of unity exp(sign*2pi*i*m/n), m <
    n: row 1 of :func:`dft_matrix_f64` without the matrix."""
    wr = np.empty(n, dtype=np.float64)
    wi = np.empty(n, dtype=np.float64)
    get_lib().fftcore_roots(n, sign, _dptr(wr), _dptr(wi))
    return wr, wi


PLAN_EXECUTORS = {0: "direct", 1: "pallas", 2: "fourstep", 3: "xla", 4: "xla"}


def plan_choice(n: int, max_direct: int, fused_min: int, fused_max: int,
                bluestein_min: int):
    """The native plan decision, (executor_name, n1, n2), as the JAX
    package's: code 4 (Bluestein) is named ``"xla"``, the path that sends
    non-smooth lengths to the chirp-z module."""
    n1, n2 = _I64(0), _I64(0)
    code = get_lib().fftcore_plan(n, max_direct, fused_min, fused_max, bluestein_min,
                                  ctypes.byref(n1), ctypes.byref(n2))
    return PLAN_EXECUTORS[int(code)], int(n1.value), int(n2.value)


def factorize(n: int, max_radix: int):
    """Mixed-radix factor schedule of n (largest first, each <= max_radix),
    or None where n has a prime factor above max_radix (or n <= 1)."""
    out = np.zeros(64, dtype=np.int64)
    cnt = get_lib().fftcore_factorize(n, max_radix, out.ctypes.data_as(ctypes.POINTER(_I64)),
                                      64)
    return [int(v) for v in out[:cnt]] if cnt > 0 else None


def _codec_threads(n: int) -> int:
    return 1 if n < (1 << 20) else min(8, os.cpu_count() or 1)


def host_split_complex(x: np.ndarray):
    """One threaded pass from a host complex64 or complex128 array to its
    (re, im) float32 planes."""
    x = np.ascontiguousarray(x)
    split = {np.dtype(np.complex64): ("fftcore_split_c64", _FP),
             np.dtype(np.complex128): ("fftcore_split_c128", _DP)}.get(x.dtype)
    if split is None:
        raise TypeError(f"host_split_complex takes complex64 or complex128, not {x.dtype}")
    fn, ptr = split
    re = np.empty(x.shape, np.float32)
    im = np.empty(x.shape, np.float32)
    getattr(get_lib(), fn)(x.ctypes.data_as(ptr), _f32ptr(re), _f32ptr(im), x.size,
                           _codec_threads(x.size))
    return re, im


def host_merge_complex(re: np.ndarray, im: np.ndarray):
    """One threaded pass from float32 planes to a host complex64 array."""
    re = np.ascontiguousarray(re, np.float32)
    im = np.ascontiguousarray(im, np.float32)
    if re.shape != im.shape:
        raise ValueError(f"planes of different shapes: {re.shape} and {im.shape}")
    z = np.empty(re.shape, np.complex64)
    get_lib().fftcore_merge_c64(_f32ptr(re), _f32ptr(im), z.ctypes.data_as(_FP), z.size,
                                _codec_threads(z.size))
    return z
