"""Torch port, host core: tables, factorization, split/merge, naive oracle.

Each test feeds the same numpy inputs to ``fft_wgpu_tpu`` and to
``fft_wgpu_tpu_torch``.  The f64-generated tables must be bit-identical,
since both packages compute the same transform from the same constants.
"""

import os
import sys

import numpy as np
import pytest
import torch

from fft_wgpu_tpu.core import complex_utils as j_cu
from fft_wgpu_tpu.core import factor as j_factor
from fft_wgpu_tpu.core import reference as j_ref
from fft_wgpu_tpu.core import twiddle as j_tw
from fft_wgpu_tpu_torch.core import complex_utils as t_cu
from fft_wgpu_tpu_torch.core import factor as t_factor
from fft_wgpu_tpu_torch.core import reference as t_ref
from fft_wgpu_tpu_torch.core import twiddle as t_tw

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_jax_native as jnat  # noqa: E402
from torch_jax_native import jax_native  # noqa: E402,F401  (the fixture)

torch.set_num_threads(1)


def _same(a, b):
    return (a[0].dtype == b[0].dtype and np.array_equal(a[0], b[0])
            and np.array_equal(a[1], b[1]))


@pytest.mark.parametrize("n", [1, 2, 3, 8, 100, 120, 128, 255, 1000])
@pytest.mark.parametrize("sign", [-1, 1])
def test_dft_matrix_equals_jax(n, sign, jax_native):
    # the JAX package's table with its native core loaded (built for this
    # process alone: tests/torch_jax_native.py), not whatever its module
    # holds after a race with another worker's build of the shared library
    assert _same(t_tw.dft_matrix_np(n, sign), jnat.dft_matrix_np(jax_native, n, sign))


@pytest.mark.parametrize("n1,n2", [(2, 4), (8, 16), (25, 40), (64, 64),
                                   (128, 128), (3, 343)])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("transposed", [False, True])
def test_twiddle_equals_jax(n1, n2, sign, transposed):
    assert _same(t_tw.twiddle_np(n1, n2, sign, transposed),
                 j_tw.twiddle_np(n1, n2, sign, transposed))


@pytest.mark.parametrize("n", [2, 128, 1000, 2048, 4096, 16384])
@pytest.mark.parametrize("sign", [-1, 1])
def test_roots_equal_jax_tables(n, sign):
    # the row kernel's per-(n, sign) table w[m] = exp(sign*2pi*i*m/n)
    wr, wi = t_tw.roots_np(n, sign)
    assert wr.dtype == wi.dtype == np.float32 and wr.shape == (n,)
    if n <= 2048:  # row 1 of the JAX DFT matrix
        dr, di = j_tw.dft_matrix_np(n, sign)
        assert np.array_equal(wr, dr[1]) and np.array_equal(wi, di[1])
    # first half: row 1 of the JAX four-step twiddle for n = 2 * (n/2)
    jr, ji = j_tw.twiddle_np(2, n // 2, sign)
    assert np.array_equal(wr[: n // 2], jr[1]) and np.array_equal(wi[: n // 2], ji[1])
    theta = sign * 2 * np.pi * np.arange(n) / n
    np.testing.assert_allclose(wr, np.cos(theta), rtol=0, atol=6e-8)
    np.testing.assert_allclose(wi, np.sin(theta), rtol=0, atol=6e-8)


def test_constants_equal_jax():
    assert (t_tw.FORWARD, t_tw.INVERSE) == (j_tw.FORWARD, j_tw.INVERSE)
    assert t_factor.MAX_DIRECT == j_factor.MAX_DIRECT


@pytest.mark.parametrize("lo", [1, 1000, 4000])
def test_factor_functions_agree(lo):
    for n in range(lo, lo + 1000):
        assert t_factor.balanced_split(n) == j_factor.balanced_split(n), n
        assert t_factor.radix_schedule(n) == j_factor.radix_schedule(n), n
        assert t_factor.is_smooth(n) == j_factor.is_smooth(n), n
    for n, r in [(4096, 16), (1000, 10), (131 * 2, 128), (7 ** 5, 7)]:
        assert t_factor.radix_schedule(n, r) == j_factor.radix_schedule(n, r)


@pytest.mark.parametrize("shape", [(7,), (3, 16), (2, 3, 5)])
def test_naive_dft_equals_jax(shape, rng):
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    for axis in range(-len(shape), 0):
        np.testing.assert_array_equal(t_ref.naive_dft(x, axis),
                                      j_ref.naive_dft(x, axis))
        for norm in (True, False):
            np.testing.assert_array_equal(t_ref.naive_idft(x, axis, norm),
                                          j_ref.naive_idft(x, axis, norm))


def test_split_matches_jax_and_merge_round_trips(rng):
    x = (rng.standard_normal((3, 8)) + 1j * rng.standard_normal((3, 8))
         ).astype(np.complex64)
    tre, tim = t_cu.split(torch.from_numpy(x))
    jre, jim = j_cu.split(x)
    assert tre.dtype == tim.dtype == torch.float32 and tre.device.type == "cpu"
    np.testing.assert_array_equal(tre.numpy(), np.asarray(jre))
    np.testing.assert_array_equal(tim.numpy(), np.asarray(jim))
    z = t_cu.merge(tre, tim)
    assert z.dtype == torch.complex64
    np.testing.assert_array_equal(z.numpy(), x)
    np.testing.assert_array_equal(t_cu.merge(*t_cu.split(z)).numpy(), x)


def test_promote_to_split_inputs(rng):
    xr = rng.standard_normal((4, 6))
    for x in (xr, torch.from_numpy(xr), xr.tolist()):
        re, im = t_cu.promote_to_split(x, device="cpu")
        jre, jim = j_cu.promote_to_split(np.asarray(xr))
        assert re.dtype == torch.float32
        np.testing.assert_array_equal(re.numpy(), np.asarray(jre))
        np.testing.assert_array_equal(im.numpy(), np.asarray(jim))
    re, im = t_cu.promote_to_split((torch.from_numpy(xr), 2 * xr), device="cpu")
    np.testing.assert_array_equal(im.numpy(), (2 * xr).astype(np.float32))
    # numpy goes to the device asked for; a tensor stays where it lies
    z = torch.zeros(3, dtype=torch.complex64)
    assert t_cu.split(xr, device="cpu")[0].device.type == "cpu"
    assert t_cu.split(z)[0].device == z.device
    c128 = torch.from_numpy(xr + 1j * xr)
    assert t_cu.split(c128)[0].dtype == torch.float32


def test_promote_to_split_reads_lists_as_data(rng):
    # a pair is a tuple of two tensors or arrays; a list of two rows is data
    # (numpy's reading), so fft([[1, 2, 3, 4], [5, 6, 7, 8]]) is two rows
    import fft_wgpu_tpu_torch as ft

    rows = [[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]]
    re, im = t_cu.promote_to_split(rows, device="cpu")
    assert re.shape == (2, 4) and not im.any()
    np.testing.assert_array_equal(re.numpy(), np.asarray(rows, np.float32))
    x = rng.standard_normal((2, 6))
    for data in (x.tolist(), [x[0], x[1]], [torch.from_numpy(x[0]), torch.from_numpy(x[1])]):
        re, im = t_cu.promote_to_split(data, device="cpu")
        np.testing.assert_array_equal(re.numpy(), x.astype(np.float32))
        assert not im.any()
    for pair in ((x[0], x[1]), (torch.from_numpy(x[0]), x[1])):
        assert t_cu.is_pair(pair)
        re, im = t_cu.promote_to_split(pair, device="cpu")
        np.testing.assert_array_equal(im.numpy(), x[1].astype(np.float32))
    assert not t_cu.is_pair((x[0], 1.0)) and not t_cu.is_pair([x[0], x[1]])
    y = ft.fft(torch.from_numpy(np.asarray(rows, np.float32)))
    np.testing.assert_allclose(y.numpy(), np.fft.fft(rows), rtol=1e-6, atol=1e-5)
    re, im = t_cu.promote_to_split(rows, device="cpu")
    np.testing.assert_allclose(ft.fft((re, im)).numpy(), np.fft.fft(rows), rtol=1e-6, atol=1e-5)



def test_numpy_input_needs_a_card(rng, monkeypatch):
    """Non-tensor input goes to the current CUDA device, as the JAX package
    puts numpy input on its default device; with no card it raises and
    never computes on the CPU by itself.  A CPU tensor still runs the plain
    path on the CPU."""
    import fft_wgpu_tpu_torch as ft
    from fft_wgpu_tpu_torch.ops import cuda_fft

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = (rng.standard_normal((4, 1024)) + 1j * rng.standard_normal((4, 1024))
         ).astype(np.complex64)
    for call in (lambda v: ft.fft(v), lambda v: ft.plan(1024).forward(v),
                 lambda v: ft.rfft(v.real), lambda v: ft.fft2(v),
                 lambda v: t_cu.promote_to_split((v.real, v.imag))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(x)
    before = cuda_fft.launches
    y = ft.fft(torch.from_numpy(x))
    assert y.device.type == "cpu" and cuda_fft.launches == before
    np.testing.assert_allclose(y.numpy(), np.fft.fft(x), rtol=0,
                               atol=1e-5 * np.abs(np.fft.fft(x)).max())
