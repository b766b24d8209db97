"""Torch port, Bluestein and the chirp-z transform: the chirp passes'
entry points (``fft_chirp_forward_split``, B11; ``fft_chirp_inverse_split``,
B12; ``fft_chirp_full_split``, the two in one kernel), ``ops/bluestein.py``
and ``ops/czt.py`` against the JAX package.

The same numpy inputs go through ``fft_wgpu_tpu`` on the CPU (its Pallas
chirp kernels in interpret mode) and through the port on CPU tensors,
where each entry point runs its kernel's plain version; the chirp-z
transforms also against ``scipy.signal``.  The host tables must be
bit-identical.  Tolerance: 1e-5 relative L2 (the ``assert_close`` fixture).
"""

import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu.ops import bluestein as j_bs
from fft_wgpu_tpu.ops import czt as j_czt
from fft_wgpu_tpu.ops import pallas_fft as j_pf
from fft_wgpu_tpu_torch.ops import bluestein, cuda_fft
from fft_wgpu_tpu_torch.ops import czt as t_czt

torch.set_num_threads(1)


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def cplx(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _t(x):
    # a CPU tensor asks the port for the CPU
    return torch.from_numpy(np.array(x))


def _np(z):
    return z.detach().numpy() if isinstance(z, torch.Tensor) else np.asarray(z)


def assert_no_launches():
    assert (cuda_fft.chirp_fwd_launches, cuda_fft.chirp_inv_launches,
            cuda_fft.chirp_full_launches, cuda_fft.launches) == (0, 0, 0, 0)


# ---------------------------------------------------------------------- #
# host tables, bit for bit
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [1, 2, 17, 526, 1031, 4093, 4097])
@pytest.mark.parametrize("sign", [-1, 1])
def test_chirp_np_equals_jax(n, sign):
    got, want = bluestein._chirp_np(n, sign), j_bs._chirp_np(n, sign)
    assert got[4] == want[4] == bluestein._pad_length(n)
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert bluestein.BLUESTEIN_MIN == j_bs.BLUESTEIN_MIN


@pytest.mark.parametrize("n,m,w,a", [
    (100, 100, np.exp(-2j * np.pi / 100), 1 + 0j),
    (1000, 300, np.exp(-0.01j), np.exp(0.3j)),
    (4096, 1024, np.exp(-2j * np.pi * 0.25 / 1024), np.exp(0.1j)),
    (300, 200, 0.9999 * np.exp(-0.004j), 1.01 * np.exp(0.1j)),  # a spiral
])
def test_czt_tables_equal_jax(n, m, w, a):
    got, want = t_czt._czt_tables(n, m, complex(w), complex(a)), \
        j_czt._czt_tables(n, m, complex(w), complex(a))
    assert got[3] == want[3]
    for g, j in zip(got[:3], want[:3]):
        assert np.array_equal(g[0], j[0]) and np.array_equal(g[1], j[1])


# ---------------------------------------------------------------------- #
# chirp-pass entry points against the JAX kernels in interpret mode
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("m,sign", [(512, -1), (1024, 1), (2048, -1)])
def test_chirp_forward_matches_jax_kernel(m, sign, rng, assert_close):
    n_in = 384  # the JAX kernel takes multiples of 128
    x, h = crand(rng, 2, 3, n_in), crand(rng, n_in)
    want = cplx(j_pf.fft_chirp_forward_split(
        jnp.asarray(x.real), jnp.asarray(x.imag), h.real, h.imag, m, sign,
        interpret=True))
    got = cuda_fft.fft_chirp_forward_split(_t(x.real), _t(x.imag), h.real, h.imag, m, sign)
    assert got[0].shape == (2, 3, m)
    assert_close(cplx(got), want)
    # tables as tensors, and the plain version
    ref = cuda_fft.fft_chirp_forward_split_reference(_t(x.real), _t(x.imag), _t(h.real),
                                                     _t(h.imag), m, sign)
    assert_close(cplx(ref), want)
    assert_no_launches()


@pytest.mark.parametrize("m,n_out,sign,scale", [(512, 512, 1, 1 / 512), (1024, 384, -1, None),
                                               (2048, 384, 1, 1 / 2048)])
def test_chirp_inverse_matches_jax_kernel(m, n_out, sign, scale, rng, assert_close):
    x, H, g = crand(rng, 3, m), crand(rng, m), crand(rng, n_out)
    want = cplx(j_pf.fft_chirp_inverse_split(
        jnp.asarray(x.real), jnp.asarray(x.imag), H.real, H.imag, g.real, g.imag,
        n_out, sign, scale, interpret=True))
    got = cuda_fft.fft_chirp_inverse_split(_t(x.real), _t(x.imag), H.real, H.imag,
                                           g.real, g.imag, n_out, sign, scale)
    assert got[0].shape == (3, n_out)
    assert_close(cplx(got), want)
    assert_no_launches()


@pytest.mark.parametrize("m,n", [(128, 1), (128, 67), (1024, 1000), (4096, 2049),
                                 (16384, 8191)])
def test_chirp_passes_any_length(m, n, rng, assert_close):
    # unlike the TPU kernels, n_in and n_out need not be multiples of 128
    x, h = crand(rng, 2, n), crand(rng, n)
    got = cuda_fft.fft_chirp_forward_split(_t(x.real), _t(x.imag), h.real, h.imag, m, -1)
    assert_close(cplx(got), np.fft.fft(x * h, n=m))
    X, H = crand(rng, 2, m), crand(rng, m)
    got = cuda_fft.fft_chirp_inverse_split(_t(X.real), _t(X.imag), H.real, H.imag,
                                           h.real, h.imag, n, 1, 1.0 / m)
    assert_close(cplx(got), h * np.fft.ifft(X * H)[:, :n])


def test_chirp_envelope_raises():
    z = torch.zeros(2, 100)
    for m in (64, 200, 32768):  # below, not pow2, above
        assert not cuda_fft._chirp_supported(m, 50)
        with pytest.raises(cuda_fft.Unsupported):
            cuda_fft.fft_chirp_forward_split(z, z, np.ones(100), np.ones(100), m, -1)
    with pytest.raises(cuda_fft.Unsupported):  # n_in > m
        cuda_fft.fft_chirp_forward_split(torch.zeros(2, 200), torch.zeros(2, 200),
                                         np.ones(200), np.ones(200), 128, -1)
    Z = torch.zeros(2, 256)
    with pytest.raises(cuda_fft.Unsupported):  # n_out > m
        cuda_fft.fft_chirp_inverse_split(Z, Z, np.ones(256), np.ones(256), np.ones(300),
                                         np.ones(300), 300, 1)
    with pytest.raises(ValueError, match="shape"):  # a table of the wrong length
        cuda_fft.fft_chirp_forward_split(z, z, np.ones(99), np.ones(99), 128, -1)
    with pytest.raises(ValueError, match="sign"):
        cuda_fft.fft_chirp_forward_split(z, z, np.ones(100), np.ones(100), 128, 0)
    e = torch.zeros(0, 100)
    assert cuda_fft.fft_chirp_forward_split(e, e, np.ones(100), np.ones(100), 128,
                                            -1)[0].shape == (0, 128)


def _grads(loss, *planes):
    ts = [_t(p).requires_grad_() for p in planes]
    loss(*ts).backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("sign", [-1, 1])
def test_chirp_forward_grad_matches_jax(sign, rng, assert_close):
    m, n_in = 512, 256
    x, h, w = crand(rng, 4, n_in), crand(rng, n_in), crand(rng, 4, m)

    def jloss(a, b):
        yr, yi = j_pf.fft_chirp_forward_split(a, b, h.real, h.imag, m, sign,
                                              interpret=True)
        return jnp.sum(w.real * yr + w.imag * yi)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x.real), jnp.asarray(x.imag))

    def tloss(a, b):
        yr, yi = cuda_fft.fft_chirp_forward_split(a, b, h.real, h.imag, m, sign)
        return (_t(w.real) * yr + _t(w.imag) * yi).sum()

    assert_close(cplx(_grads(tloss, x.real, x.imag)), cplx(jg))


@pytest.mark.parametrize("n_out", [512, 256])
def test_chirp_inverse_grad_matches_jax(n_out, rng, assert_close):
    m = 512
    x, H, g, w = crand(rng, 4, m), crand(rng, m), crand(rng, n_out), crand(rng, 4, n_out)

    def jloss(a, b):
        yr, yi = j_pf.fft_chirp_inverse_split(a, b, H.real, H.imag, g.real, g.imag,
                                              n_out, 1, 1.0 / m, interpret=True)
        return jnp.sum(w.real * yr + w.imag * yi)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x.real), jnp.asarray(x.imag))

    def tloss(a, b):
        yr, yi = cuda_fft.fft_chirp_inverse_split(a, b, H.real, H.imag, g.real, g.imag,
                                                  n_out, 1, 1.0 / m)
        return (_t(w.real) * yr + _t(w.imag) * yi).sum()

    assert_close(cplx(_grads(tloss, x.real, x.imag)), cplx(jg))


# ---------------------------------------------------------------------- #
# the fused pair, fft_chirp_full_split: the JAX package's B11 -> B12
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("m", [1 << e for e in range(6, 15)])
def test_chirp_plans_are_pow2_radices(m):
    # the pow2 kernels' passes (chirp_fft, rows_fft, big_fft's blocks,
    # ax0_fft's columns, r2c_fft's half-length rows from m = 64, filt_fft's
    # filtered rows, spec_c2c_fft's segments): radices 16 and 8 with product
    # m, and the one plan table compiled into csrc/mixed_fft.cuh, which they
    # all include, is the planner's
    plan = cuda_fft._mixed_radix_plan(m)
    assert math.prod(plan) == m and set(plan) <= {16, 8}
    csrc = pathlib.Path(cuda_fft.__file__).parent.parent / "csrc"
    src = (csrc / "mixed_fft.cuh").read_text()
    table = re.search(r"plans\[9\]\[kPlanMax\] = \{(.*?)\};", src, re.S)[1]
    compiled = [tuple(map(int, r.split(","))) for r in re.findall(r"\{([\d, ]+)\}", table)]
    assert len(compiled) == 9 and compiled[m.bit_length() - 7] == plan
    for name in ("chirp_fft.cu", "rows_fft.cu", "big_fft.cu", "r2c_fft.cu", "ax0_fft.cu",
                 "filt_fft.cu", "spec_c2c_fft.cu"):
        text = (csrc / name).read_text()
        assert '#include "mixed_fft.cuh"' in text and "plans[" not in text, name
    for name in ("filt_fft.cu", "spec_c2c_fft.cu"):  # the two kernels of the compiled plan
        assert "plan_fft<" in (csrc / name).read_text(), name
    # each pass's twiddle table: the powers w_(NS*R)^(k*e), [k - 1][e] for
    # 0 < k < R and e < NS, for every pass after the first, in the plan's
    # order and in reverse
    for table_fn, order in ((cuda_fft._pass_roots_np, plan),
                            (cuda_fft._pass_roots_reversed_np, plan[::-1])):
        c, s = table_fn(m, -1)
        ns, off = order[0], 0
        for r in order[1:]:
            k, e = np.arange(1, r)[:, None], np.arange(ns)[None, :]
            size = ns * (r - 1)
            np.testing.assert_allclose((c[off:off + size] + 1j * s[off:off + size]).reshape(r - 1, ns),
                                       np.exp(-2j * np.pi * k * e / (ns * r)), atol=1e-7)
            off, ns = off + size, ns * r
        assert off == len(c)


FULL_CASES = [(512, 384, 256, None), (512, 256, 384, 1 / 512), (1024, 384, 640, 1 / 1024),
              (1024, 640, 384, None), (2048, 1024, 384, 0.5), (2048, 384, 1024, 1 / 2048)]


@pytest.mark.parametrize("m,n_in,n_out,scale", FULL_CASES)
def test_chirp_full_matches_jax_kernels(m, n_in, n_out, scale, rng, assert_close):
    # the JAX package's pair as Bluestein and CZT run it: B11 of sign -1,
    # then B12 of sign +1, both in interpret mode
    x, h, H, g = crand(rng, 2, 3, n_in), crand(rng, n_in), crand(rng, m), crand(rng, n_out)
    Yr, Yi = j_pf.fft_chirp_forward_split(jnp.asarray(x.real), jnp.asarray(x.imag), h.real,
                                          h.imag, m, -1, interpret=True)
    want = cplx(j_pf.fft_chirp_inverse_split(Yr, Yi, H.real, H.imag, g.real, g.imag, n_out,
                                             1, scale, interpret=True))
    tabs = (h.real, h.imag, H.real, H.imag, g.real, g.imag)
    got = cuda_fft.fft_chirp_full_split(_t(x.real), _t(x.imag), *tabs, m, n_out, scale)
    assert got[0].shape == (2, 3, n_out)
    assert_close(cplx(got), want)
    ttabs = [_t(t) for t in tabs]
    assert_close(cplx(cuda_fft.fft_chirp_full_split_reference(
        _t(x.real), _t(x.imag), *ttabs, m, n_out, scale)), want)
    # the plain version of the kernel's own passes (its tables, reversed plan)
    assert_close(cplx(cuda_fft._chirp_full_passes(
        _t(x.real), _t(x.imag), *ttabs, m, n_out, scale)), want)
    assert_no_launches()


@pytest.mark.parametrize("n", [526, 1031])
@pytest.mark.parametrize("sign", [-1, 1])
def test_chirp_full_bluestein_tables_both_directions(n, sign, rng, assert_close):
    # one (-1, +1) pass pair serves the DFT and its inverse: Bluestein's
    # tables of sign s carry the direction
    x = crand(rng, 3, n)
    cr, ci, bfr, bfi, m = bluestein._chirp_np(n, sign)
    got = cuda_fft.fft_chirp_full_split(_t(x.real), _t(x.imag), cr, ci, bfr, bfi, cr, ci, m,
                                        n, 1.0 / m)
    want = np.fft.fft(x.astype(np.complex128)) if sign < 0 else \
        np.fft.ifft(x.astype(np.complex128)) * n
    assert_close(cplx(got), want)
    assert_no_launches()


@pytest.mark.parametrize("m,n_in,n_out", [(128, 1, 67), (1024, 1000, 7), (4096, 2049, 4096),
                                          (16384, 8191, 8191)])
def test_chirp_full_any_length(m, n_in, n_out, rng, assert_close):
    x, h, H, g = crand(rng, 2, n_in), crand(rng, n_in), crand(rng, m), crand(rng, n_out)
    got = cuda_fft.fft_chirp_full_split(_t(x.real), _t(x.imag), h.real, h.imag, H.real,
                                        H.imag, g.real, g.imag, m, n_out, 1.0 / m)
    want = g * np.fft.ifft(np.fft.fft(x * h, n=m) * H)[:, :n_out]
    assert_close(cplx(got), want)


def test_chirp_full_envelope_raises():
    z, o = torch.zeros(2, 100), np.ones(100)
    tabs = lambda m, n_out: (o, o, np.ones(m), np.ones(m), np.ones(n_out), np.ones(n_out))  # noqa: E731
    for m in (64, 200, 32768):  # below, not pow2, above
        with pytest.raises(cuda_fft.Unsupported):
            cuda_fft.fft_chirp_full_split(z, z, *tabs(m, 50), m, 50)
    with pytest.raises(cuda_fft.Unsupported):  # n_out > m
        cuda_fft.fft_chirp_full_split(z, z, *tabs(128, 200), 128, 200)
    with pytest.raises(cuda_fft.Unsupported):  # n_in > m
        cuda_fft.fft_chirp_full_split(torch.zeros(2, 200), torch.zeros(2, 200),
                                      np.ones(200), np.ones(200), *tabs(128, 50)[2:], 128, 50)
    with pytest.raises(ValueError, match="shape"):  # an H of the wrong length
        cuda_fft.fft_chirp_full_split(z, z, o, o, np.ones(100), np.ones(100), o[:50], o[:50],
                                      128, 50)
    e = torch.zeros(0, 100)
    assert cuda_fft.fft_chirp_full_split(e, e, *tabs(128, 50), 128, 50)[0].shape == (0, 50)
    assert_no_launches()


@pytest.mark.parametrize("n_in,n_out", [(384, 256), (256, 384)])
def test_chirp_full_grad_matches_jax(n_in, n_out, rng, assert_close):
    # the backward is the same map with the tables conjugated, h <-> g and
    # n_in <-> n_out
    m = 512
    x, h, H, g = crand(rng, 4, n_in), crand(rng, n_in), crand(rng, m), crand(rng, n_out)
    w = crand(rng, 4, n_out)

    def jloss(a, b):
        Yr, Yi = j_pf.fft_chirp_forward_split(a, b, h.real, h.imag, m, -1, interpret=True)
        yr, yi = j_pf.fft_chirp_inverse_split(Yr, Yi, H.real, H.imag, g.real, g.imag, n_out,
                                              1, 1.0 / m, interpret=True)
        return jnp.sum(w.real * yr + w.imag * yi)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x.real), jnp.asarray(x.imag))

    def tloss(a, b):
        yr, yi = cuda_fft.fft_chirp_full_split(a, b, h.real, h.imag, H.real, H.imag, g.real,
                                               g.imag, m, n_out, 1.0 / m)
        return (_t(w.real) * yr + _t(w.imag) * yi).sum()

    assert_close(cplx(_grads(tloss, x.real, x.imag)), cplx(jg))
    assert_no_launches()


# ---------------------------------------------------------------------- #
# Bluestein and the chirp-z transforms against the JAX package's
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [526, 1031, 4093])
@pytest.mark.parametrize("sign,scale", [(-1, None), (1, "1/n"), (-1, 0.5)])
def test_bluestein_matches_jax(n, sign, scale, rng, assert_close):
    scale = 1.0 / n if scale == "1/n" else scale
    x = crand(rng, 3, n)
    want = j_bs.fft_bluestein_split(jnp.asarray(x.real), jnp.asarray(x.imag), sign, scale)
    got = bluestein.fft_bluestein_split(_t(x.real), _t(x.imag), sign, scale)
    assert_close(cplx(got), cplx(want))
    # a CUDA tensor of this length takes the chirp passes; 16411 does not
    # (its m is 32768)
    assert cuda_fft._chirp_supported(bluestein._pad_length(n), n)
    assert not cuda_fft._chirp_supported(bluestein._pad_length(16411), 16411)
    assert_no_launches()


@pytest.mark.parametrize("n,to_bluestein", [(526, True), (1031, True), (4093, True),
                                            (2 * 131 * 3, True), (509, False), (525, False),
                                            (1024, False)])
def test_mixed_radix_sends_large_primes_to_bluestein(n, to_bluestein, rng, assert_close,
                                                     monkeypatch):
    # the one route to the chirp passes: the mixed-radix path's Bluestein
    # branch (a prime factor above 128, n >= 512), which hands the plan's
    # ifft scale on, to be folded into the second pass
    calls, run = [], bluestein.fft_bluestein_split
    monkeypatch.setattr(bluestein, "fft_bluestein_split",
                        lambda re, im, sign, scale=None: calls.append(scale)
                        or run(re, im, sign, scale))
    x = crand(rng, 2, n)
    got = ft.ifft(_t(x))
    assert calls == pytest.approx([1.0 / n] if to_bluestein else [])
    assert_close(_np(got), np.fft.ifft(x))
    assert_no_launches()


def test_bluestein_grad_matches_jax(rng, assert_close):
    n = 521  # prime: the Bluestein route
    x, w = crand(rng, 3, n), crand(rng, 3, n)

    def jloss(a, b):
        yr, yi = j_bs.fft_bluestein_split(a, b, -1)
        return jnp.sum(w.real * yr + w.imag * yi)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x.real), jnp.asarray(x.imag))

    def tloss(a, b):
        yr, yi = bluestein.fft_bluestein_split(a, b, -1)
        return (_t(w.real) * yr + _t(w.imag) * yi).sum()

    assert_close(cplx(_grads(tloss, x.real, x.imag)), cplx(jg))


CZT_CASES = [
    (256, None, None, 1 + 0j),                                    # the DFT
    (1000, 300, np.exp(-0.01j), np.exp(0.3j)),
    (777, 1200, np.exp(-0.004j), 1.001 * np.exp(0.2j)),  # off the unit circle, m > n
    (4096, 1024, np.exp(-2j * np.pi * 0.25 / 1024), 1 + 0j),
]


@pytest.mark.parametrize("n,m,w,a", CZT_CASES)
def test_czt_matches_jax_and_scipy(n, m, w, a, rng, assert_close):
    x = crand(rng, 2, n)
    got = ft.czt(_t(x), m=m, w=w, a=a)
    want = ftt.czt(x, m=m, w=w, a=a)
    assert got.dtype == torch.complex64 and tuple(got.shape) == np.shape(want)
    assert_close(_np(got), _np(want))
    assert_close(_np(got), ss.czt(x.astype(np.complex128), m=m, w=w, a=a))
    assert_no_launches()


def test_czt_along_an_axis_and_points(rng, assert_close):
    x = crand(rng, 300, 3)
    got = ft.czt(_t(x), m=100, w=np.exp(-0.02j), a=np.exp(0.1j), axis=0)
    assert_close(_np(got), _np(ftt.czt(x, m=100, w=np.exp(-0.02j), a=np.exp(0.1j), axis=0)))
    assert_close(_np(got), ss.czt(x, m=100, w=np.exp(-0.02j), a=np.exp(0.1j), axis=0))
    for m, w, a in ((16, None, 1 + 0j), (50, np.exp(-0.05j), 0.5 + 0.5j)):
        np.testing.assert_allclose(ft.czt_points(m, w, a), ss.czt_points(m, w, a),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(ft.czt_points(m, w, a), ftt.czt_points(m, w, a))


@pytest.mark.parametrize("fn,m,endpoint", [([0.1, 0.4], 200, False), (0.5, None, False),
                                           ([0.2, 0.3], 64, True)])
def test_zoom_fft_matches_jax_and_scipy(fn, m, endpoint, rng, assert_close):
    x = rng.standard_normal((2, 1000))
    got = ft.zoom_fft(_t(x), fn, m=m, endpoint=endpoint)
    assert_close(_np(got), _np(ftt.zoom_fft(x, fn, m=m, endpoint=endpoint)))
    assert_close(_np(got), ss.zoom_fft(x, fn, m=m, endpoint=endpoint))


def test_plan_classes_match_jax_and_scipy(rng, assert_close):
    x = rng.standard_normal((3, 512))
    tz, jz, sz = (mod.ZoomFFT(512, [0.05, 0.3], m=128, fs=2.0) for mod in (ft, ftt, ss))
    got = tz(_t(x))
    assert_close(_np(got), _np(jz(x)))
    assert_close(_np(got), sz(x))
    assert (tz.f1, tz.f2, tz.fs) == (jz.f1, jz.f2, jz.fs)
    np.testing.assert_array_equal(tz.points(), jz.points())
    tc, jc = ft.CZT(512, 200, np.exp(-0.01j)), ftt.CZT(512, 200, np.exp(-0.01j))
    assert_close(_np(tc(_t(x))), _np(jc(x)))
    assert_close(_np(tc(_t(x))), ss.CZT(512, 200, np.exp(-0.01j))(x))
    for pkg, arr in ((ft, _t), (ftt, np.asarray)):
        with pytest.raises(ValueError, match="length 512"):
            pkg.CZT(512)(arr(np.zeros((2, 500))))


def test_grad_through_czt_matches_jax(rng, assert_close):
    n, m = 300, 100
    re, im = (rng.standard_normal((2, n)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal((2, m)).astype(np.float32)
    kw = dict(m=m, w=np.exp(-0.02j), a=np.exp(0.1j))

    def jloss(a, b):
        return jnp.sum(w * jnp.abs(ftt.czt(jax.lax.complex(a, b), **kw)) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    tre, tim = _t(re).requires_grad_(), _t(im).requires_grad_()
    (_t(w) * ft.czt(torch.complex(tre, tim), **kw).abs() ** 2).sum().backward()
    assert_close(tre.grad.numpy() + 1j * tim.grad.numpy(), cplx(jg))


@pytest.mark.parametrize("call", [
    lambda m, x: m.czt(x, m=0), lambda m, x: m.zoom_fft(x, 0.5, m=0),
    lambda m, x: m.CZT(x.shape[-1], m=0)(x), lambda m, x: m.ZoomFFT(x.shape[-1], 0.5, m=0)(x),
    lambda m, x: m.czt(x[:, :0]), lambda m, x: m.CZT(0)(x[:, :0]),
    lambda m, x: m.czt_points(0)],
    ids=["czt", "zoom_fft", "CZT", "ZoomFFT", "czt-empty", "CZT-n0", "czt_points"])
def test_zero_points_raise_as_scipy(call, rng):
    # C7 (ROADMAP §C): m=0 was read as "the default m" and gave an n-point
    # result; C10: an empty signal divided by zero.  scipy raises ValueError
    x = crand(rng, 3, 64)
    with pytest.raises(ValueError):
        call(ss, x)
    with pytest.raises(ValueError, match="Invalid number of CZT"):
        call(ft, _t(x))


def test_default_m_keeps_its_bits(rng, assert_close):
    # m=None is m = n, bit for bit, and scipy's default
    x = crand(rng, 3, 64)
    for got, want in ((ft.czt(_t(x)), ft.czt(_t(x), m=64)),
                      (ft.zoom_fft(_t(x), 0.5), ft.zoom_fft(_t(x), 0.5, m=64)),
                      (ft.CZT(64)(_t(x)), ft.CZT(64, m=64)(_t(x))),
                      (ft.ZoomFFT(64, 0.5)(_t(x)), ft.ZoomFFT(64, 0.5, m=64)(_t(x)))):
        np.testing.assert_array_equal(_np(got), _np(want))
    assert_close(_np(ft.czt(_t(x))), ss.czt(x))
    assert_close(_np(ft.zoom_fft(_t(x), 0.5)), ss.zoom_fft(x, 0.5))
