"""Torch port, ``utils/native``: the port's own copy of the C++ host core,
built with g++ at first use, against the JAX package's
``fft_wgpu_tpu.utils.native`` (its copy built by g++ too) and numpy, as
``tests/test_native.py`` holds the JAX module: the f64 DFT, twiddle and
root tables, the factorization, the plan decision and the host codec.

The tables the kernels read are built by ``core/twiddle.py`` in numpy, not
by the native core; they are held here bit-equal to the native f64 tables
cast once to float32, at every length the kernels take: the roots of unity
of every pow2 n in 2..2^18 and of every composite n of the composite
kernels' envelope (512..16384, the roots each pass's table is gathered
from), the four-step's inter-factor twiddles at its splits of 2^15..2^22,
and the DFT matrices of the plain path's direct lengths.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from fft_wgpu_tpu_torch.core import twiddle as tw
from fft_wgpu_tpu_torch.ops import cuda_fft, fourstep
from fft_wgpu_tpu_torch.utils import build
from fft_wgpu_tpu_torch.utils import native

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_jax_native as jnat  # noqa: E402
from torch_jax_native import jax_native  # noqa: E402,F401  (the fixture)

torch.set_num_threads(1)


@pytest.fixture
def jn(jax_native):
    """The JAX package's ``utils/native`` module with its library built for
    this process alone (``tests/torch_jax_native.py``): the shared
    ``fft_wgpu_tpu/native/libfftcore.so`` may be half written by another
    worker when this one loads it."""
    return jax_native


def _jax_lib(jn):
    jnat.require(jn)


@pytest.mark.parametrize("n", [1, 2, 16, 60, 97])
def test_dft_matrix_matches_jax_and_numpy(n, jn):
    _jax_lib(jn)
    k = np.arange(n)
    for sign in (-1, 1):
        wr, wi = native.dft_matrix_f64(n, sign)
        jr, ji = jn.dft_matrix_f64(n, sign)
        np.testing.assert_array_equal(wr, jr)
        np.testing.assert_array_equal(wi, ji)
        ref = np.exp(sign * 2j * np.pi * (np.outer(k, k) % n) / n)
        assert np.abs(wr + 1j * wi - ref).max() < 1e-14


@pytest.mark.parametrize("n1,n2", [(4, 8), (16, 64), (1, 7), (32, 1024)])
def test_twiddle_matches_jax_and_numpy(n1, n2, jn):
    _jax_lib(jn)
    for sign in (-1, 1):
        wr, wi = native.twiddle_f64(n1, n2, sign)
        jr, ji = jn.twiddle_f64(n1, n2, sign)
        np.testing.assert_array_equal(wr, jr)
        np.testing.assert_array_equal(wi, ji)
        ref = np.exp(sign * 2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / (n1 * n2))
        assert np.abs(wr + 1j * wi - ref).max() < 1e-14


def test_roots_are_row_one_of_the_dft_matrix(jn):
    _jax_lib(jn)
    for n in (1, 8, 12, 97, 256):
        for sign in (-1, 1):
            rr, ri = native.roots_f64(n, sign)
            jr, ji = jn.dft_matrix_f64(n, sign)
            np.testing.assert_array_equal(rr, jr[min(1, n - 1)] if n > 1 else jr[0])
            np.testing.assert_array_equal(ri, ji[min(1, n - 1)] if n > 1 else ji[0])


def test_factorize_matches_jax(jn):
    _jax_lib(jn)
    assert native.factorize(4096, 128) == [128, 32]
    assert native.factorize(262, 128) is None  # 2 * 131
    assert native.factorize(1, 128) is None
    for n in list(range(2, 400)) + [1000, 4095, 4097, 1 << 20, 3 * 5 * 7 * 11 * 13]:
        for radix in (16, 128, 256):
            assert native.factorize(n, radix) == jn.factorize(n, radix), (n, radix)


def test_plan_choice_matches_jax(jn):
    _jax_lib(jn)
    # the JAX test's decisions
    assert native.plan_choice(64, 128, 128, 8192, 512) == ("direct", 1, 64)
    assert native.plan_choice(4096, 128, 128, 8192, 512) == ("pallas", 32, 128)
    assert native.plan_choice(1 << 20, 128, 128, 8192, 512) == ("fourstep", 1024, 1024)
    assert native.plan_choice(1000, 128, 128, 8192, 512)[0] == "xla"
    assert native.plan_choice(4099, 128, 128, 8192, 512)[0] == "xla"
    for n in [2, 100, 127, 128, 129, 257, 1000, 4093, 4096, 8192, 16384, 1 << 22, 6000, 9973]:
        args = (n, 128, 128, 8192, 512)
        assert native.plan_choice(*args) == jn.plan_choice(*args), n


@pytest.mark.parametrize("shape", [(37, 129), (1 << 21,)], ids=["one pass", "threaded"])
def test_host_codec_matches_jax_and_numpy(shape, jn):
    _jax_lib(jn)
    rng = np.random.default_rng(0)
    for dtype in (np.complex64, np.complex128):
        z = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
        re, im = native.host_split_complex(z)
        assert re.dtype == np.float32 and re.shape == z.shape
        np.testing.assert_array_equal(re, z.real.astype(np.float32))
        np.testing.assert_array_equal(im, z.imag.astype(np.float32))
        jre, jim = jn.host_split_complex(z)
        np.testing.assert_array_equal(re, jre)
        np.testing.assert_array_equal(im, jim)
        back = native.host_merge_complex(re, im)
        assert back.dtype == np.complex64
        np.testing.assert_array_equal(back, z.astype(np.complex64))
        np.testing.assert_array_equal(back, jn.host_merge_complex(re, im))


def test_host_codec_raises_where_the_jax_module_returns_none():
    with pytest.raises(TypeError, match="complex64"):
        native.host_split_complex(np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="shapes"):
        native.host_merge_complex(np.zeros(4, np.float32), np.zeros(5, np.float32))


def test_failed_build_raises(monkeypatch, tmp_path):
    # no silent None: without g++ the first use raises
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(build.CompileError, match="g\\+\\+"):
        native.get_lib()


def test_library_is_named_by_its_source(monkeypatch, tmp_path):
    # the library's file name carries the source's hash: an edited source
    # is rebuilt, never loaded stale
    name = build.library_path("fftcore").name
    assert name.startswith("libfftcore-") and name.endswith(".so")
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "fftcore.cpp").write_bytes((build.CSRC / "fftcore.cpp").read_bytes() + b"\n// edit\n")
    monkeypatch.setattr(build, "CSRC", src)
    assert build.library_path("fftcore").name != name


def _f32(pair):
    return tuple(np.asarray(v, np.float64).astype(np.float32) for v in pair)


def _kernel_lengths():
    pow2 = [1 << e for e in range(1, 19)]
    composite = [n for n in range(cuda_fft.GEN_MIN_N, cuda_fft.FUSED_MAX_N + 1)
                 if cuda_fft._gen_supported(n)]
    return pow2, composite


def test_kernel_tables_bit_equal_native_cast_once():
    pow2, composite = _kernel_lengths()
    roots = tw.roots_np.__wrapped__  # uncached: these tables are not kept
    for n in pow2 + composite:
        for sign in ((-1, 1) if n in pow2 else (-1,)):
            got = roots(n, sign)
            want = _f32(native.roots_f64(n, sign))
            assert all(np.array_equal(g, w) for g, w in zip(got, want)), (n, sign)
    for e in range(15, 23):  # the four-step's splits
        n1, n2 = fourstep.choose_factors(1 << e)
        for sign in (-1, 1):
            for transposed in (False, True):
                got = tw.twiddle_np.__wrapped__(n1, n2, sign, transposed)
                want = _f32(native.twiddle_f64(n1, n2, sign))
                if transposed:
                    want = tuple(np.ascontiguousarray(w.T) for w in want)
                assert all(np.array_equal(g, w) for g, w in zip(got, want)), (n1, n2, sign)
    for n in list(range(1, 129)) + [256, 512]:  # the plain path's direct DFTs
        for sign in (-1, 1):
            got = tw.dft_matrix_np.__wrapped__(n, sign)
            want = _f32(native.dft_matrix_f64(n, sign))
            assert all(np.array_equal(g, w) for g, w in zip(got, want)), (n, sign)
