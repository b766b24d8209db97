"""Torch port, composite non-pow2 lengths: the composite-row kernels' entry
points (C2C ``fft_rows_general_split``, B13; R2C
``rfft_rows_general_split``, B14), their routes, and the slice's whole path
(``fft``/``ifft``/plan and ``rfft``/``irfft`` at non-pow2 n) against the
JAX package.

The same numpy inputs go through ``fft_wgpu_tpu`` on the CPU (its Pallas
kernels in interpret mode) and through the port on CPU tensors, where each
entry point runs its kernel's plain version.  Tolerance: 1e-5 relative L2
(the ``assert_close`` fixture).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu.ops import pallas_fft as j_pf
from fft_wgpu_tpu_torch.ops import cuda_fft, rfft

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
    assert (cuda_fft.gen_launches, cuda_fft.r2c_gen_launches,
            cuda_fft.chirp_fwd_launches, cuda_fft.chirp_inv_launches) == (0, 0, 0, 0)


def _j_gen_envelope(n):
    """The JAX kernel's envelope, as _fft_rows_gen_core tests it."""
    return (512 <= n <= j_pf.FUSED_MAX_N and n & (n - 1) != 0
            and j_pf._choose_general_split(n) is not None)


@pytest.mark.parametrize("lo", [2, 512, 4000, 16000])
def test_split_and_envelope_match_jax(lo):
    for n in range(lo, lo + 600):
        assert cuda_fft._choose_general_split(n) == j_pf._choose_general_split(n), n
        assert cuda_fft._gen_supported(n) == _j_gen_envelope(n), n


# ---------------------------------------------------------------------- #
# kernel entry points against the JAX kernels in interpret mode
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [640, 1000, 1005, 4095])
def test_gen_matches_jax_kernel(n, rng, assert_close):
    x = crand(rng, 5, n)
    re, im = x.real.copy(), x.imag.copy()
    for sign, scale in ((-1, None), (1, 1.0 / n), (-1, n ** -0.5)):
        want = cplx(j_pf.fft_rows_general_split(jnp.asarray(re), jnp.asarray(im), sign,
                                                scale, interpret=True))
        got = cuda_fft.fft_rows_general_split(_t(re), _t(im), sign, scale)
        assert got[0].shape == (5, n) and got[0].dtype == torch.float32
        assert_close(cplx(got), want, what=f"sign={sign} scale={scale}")
        ref = cuda_fft.fft_rows_general_split_reference(_t(re), _t(im), sign, scale)
        assert_close(cplx(ref), want)
    assert_no_launches()


@pytest.mark.parametrize("pad_out", [False, True])
@pytest.mark.parametrize("n", [640, 1000, 1005, 4095])
def test_r2c_gen_matches_jax_kernel(n, pad_out, rng, assert_close):
    x = rng.standard_normal((3, 2, n)).astype(np.float32)
    mp = n // 2 + 1
    for scale in (None, n ** -0.5):
        want = j_pf.rfft_rows_general_split(jnp.asarray(x), scale, pad_out=pad_out,
                                            interpret=True)
        got = cuda_fft.rfft_rows_general_split(_t(x), scale, pad_out=pad_out)
        assert got[0].shape == np.shape(want[0])
        assert got[0].shape[-1] == (cuda_fft.pad_bins(n) if pad_out else mp)
        assert_close(cplx(got), cplx(want), what=f"scale={scale}")
        assert not got[0][..., mp:].any() and not got[1][..., mp:].any()  # exact zeros
        ref = cuda_fft.rfft_rows_general_split_reference(_t(x), scale, pad_out=pad_out)
        assert_close(cplx(ref), cplx(want))
    assert_no_launches()


@pytest.mark.parametrize("n", [4093, 1031, 1538, 4096, 500, 16385])
def test_gen_envelope_raises(n):
    # prime, prime > 256, 2*769 (a factor > 256), pow2, below 512, above 16384:
    # outside the JAX kernel's envelope and the port's alike
    z = torch.zeros(2, n)
    for fn in (lambda: cuda_fft.fft_rows_general_split(z, z, -1),
               lambda: cuda_fft.fft_rows_general_split_reference(z, z, -1),
               lambda: cuda_fft.rfft_rows_general_split(z),
               lambda: cuda_fft.rfft_rows_general_split_reference(z)):
        with pytest.raises(cuda_fft.Unsupported):
            fn()
    if n in (4093, 1031, 1538, 4096):
        r = jnp.zeros((4, n), jnp.float32)
        with pytest.raises(j_pf.Unsupported):
            j_pf._fft_rows_gen_core(r, r, -1, interpret=True)


def test_gen_envelope_edges():
    # 4097 = 17 * 241 is inside (the 256 bound), as in the JAX package
    z = torch.zeros(4, 4097)
    assert cuda_fft.fft_rows_general_split(z, z, -1)[0].shape == (4, 4097)
    assert cuda_fft._choose_general_split(4097) == (17, 241)
    with pytest.raises(ValueError, match="sign"):
        cuda_fft.fft_rows_general_split(torch.zeros(2, 1000), torch.zeros(2, 1000), 2)
    with pytest.raises(ValueError):
        cuda_fft.fft_rows_general_split(torch.zeros(2, 1000),
                                        torch.zeros(2, 1000, dtype=torch.float64), -1)
    with pytest.raises(ValueError, match="float32"):
        cuda_fft.rfft_rows_general_split(torch.zeros(2, 1000, dtype=torch.float64))
    e = torch.zeros(0, 1000)
    assert cuda_fft.fft_rows_general_split(e, e, -1)[0].shape == (0, 1000)
    assert cuda_fft.rfft_rows_general_split(e, pad_out=True)[0].shape == (0, 512)


@pytest.mark.parametrize("sign", [-1, 1])
def test_gen_grad_matches_jax(sign, rng, assert_close):
    n = 1000
    re, im = (rng.standard_normal((3, n)).astype(np.float32) for _ in range(2))
    w = rng.random((3, n)).astype(np.float32)

    def jloss(a, b):
        yr, yi = j_pf.fft_rows_general_split(a, b, sign, 0.5, interpret=True)
        return jnp.sum(w * (yr * yr + yi * yi))

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(re), jnp.asarray(im))
    tre, tim = _t(re).requires_grad_(), _t(im).requires_grad_()
    yr, yi = cuda_fft.fft_rows_general_split(tre, tim, sign, 0.5)
    (_t(w) * (yr * yr + yi * yi)).sum().backward()
    assert_close(tre.grad.numpy() + 1j * tim.grad.numpy(), cplx(jg))


@pytest.mark.parametrize("pad_out", [False, True])
def test_r2c_gen_grad_matches_jax(pad_out, rng, assert_close):
    n = 1005
    x = rng.standard_normal((3, n)).astype(np.float32)
    bins = cuda_fft.pad_bins(n) if pad_out else n // 2 + 1
    w = rng.random((3, bins)).astype(np.float32)

    def jloss(v):
        Xr, Xi = j_pf.rfft_rows_general_split(v, n ** -0.5, pad_out=pad_out,
                                              interpret=True)
        return jnp.sum(w * (Xr * Xr + Xi * Xi))

    jg = jax.grad(jloss)(jnp.asarray(x))
    t = _t(x).requires_grad_()
    Xr, Xi = cuda_fft.rfft_rows_general_split(t, n ** -0.5, pad_out=pad_out)
    (_t(w) * (Xr * Xr + Xi * Xi)).sum().backward()
    assert_close(t.grad.numpy(), np.asarray(jg))


# ---------------------------------------------------------------------- #
# routes: the plan's "general" and "xla" routes, the composite R2C route
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("route,n", [("general", 1000), ("general", 4097),
                                     ("xla", 4093), ("xla", 1538)])
def test_plan_routes_run_their_entry_points(route, n, rng, assert_close, monkeypatch):
    # a CUDA tensor's route, taken by a CPU tensor: each entry point then
    # runs its plain version, and the plan's plumbing (scale, out=) is the same
    x = crand(rng, 3, n)
    p = ft.plan(n)
    monkeypatch.setattr(p, "_resolve_executor", lambda device: route)
    jp = ftt.plan(n)
    for mode in ("forward", "inverse", "inverse_unnormalized"):
        assert_close(_np(getattr(p, mode)(_t(x))), _np(getattr(jp, mode)(x)), what=mode)
    re, im = _t(x.real.copy()), _t(x.imag.copy())
    pd = ft.plan(n, donate=True)
    monkeypatch.setattr(pd, "_resolve_executor", lambda device: route)
    out = pd.inverse_split(re, im)
    assert out[0] is re and out[1] is im
    assert_close(cplx((re, im)), np.fft.ifft(x))


@pytest.mark.parametrize("n,on_kernel", [(1000, True), (1005, True), (4095, True),
                                         (16383, True), (4096, False), (4093, False),
                                         (500, False)])
def test_r2c_general_route(n, on_kernel, rng, assert_close):
    # a CUDA tensor of composite n in the envelope takes the composite R2C
    # kernel, odd or even; pow2, prime and short n do not; a CPU tensor never
    # (the predicate reads only the device and the shape: a stand-in serves)
    cuda = types.SimpleNamespace(device=torch.device("cuda", 0), shape=(2, n))
    assert rfft._r2c_general(cuda) == on_kernel
    x = rng.standard_normal((2, n)).astype(np.float32)
    assert not rfft._r2c_general(_t(x))
    assert_close(_np(ft.rfft(_t(x))), np.fft.rfft(x))
    assert_no_launches()


# ---------------------------------------------------------------------- #
# the slice as a whole: public functions against the JAX package's
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [526, 1000, 1031, 4093, 4097])
def test_fft_ifft_match_jax(n, rng, assert_close):
    x = crand(rng, 3, n)
    for fn in ("fft", "ifft"):
        got = getattr(ft, fn)(_t(x))
        assert got.dtype == torch.complex64 and got.shape == x.shape
        assert_close(_np(got), _np(getattr(ftt, fn)(x)), what=fn)
        assert_close(_np(got), getattr(np.fft, fn)(x), what=fn)
    jp, tp = ftt.plan(n), ft.plan(n)
    for mode in ("forward", "inverse", "inverse_unnormalized"):
        assert_close(_np(getattr(tp, mode)(_t(x))), _np(getattr(jp, mode)(x)), what=mode)
    assert_close(_np(ft.Forward(n).proc(_t(x))), _np(ftt.Forward(n).proc(x)))
    assert_no_launches()


@pytest.mark.parametrize("n", [1000, 4095])
def test_composite_axis0_matches_jax(n, rng, assert_close):
    x = crand(rng, n, 3)
    assert_close(_np(ft.fft(_t(x), axis=0)), _np(ftt.fft(x, axis=0)))
    assert_close(_np(ft.ifft(_t(x), axis=0)), np.fft.ifft(x, axis=0))


@pytest.mark.parametrize("norm", [None, "ortho"])
@pytest.mark.parametrize("n", [1000, 1005, 4095])
def test_rfft_irfft_match_jax(n, norm, rng, assert_close):
    x = rng.standard_normal((3, n)).astype(np.float32)
    got = ft.rfft(_t(x), norm=norm)
    want = ftt.rfft(x, norm=norm)
    assert tuple(got.shape) == np.shape(want)
    assert_close(_np(got), _np(want), what="rfft")
    X = np.asarray(want)
    back = ft.irfft(_t(X), n=n, norm=norm)
    assert_close(_np(back), _np(ftt.irfft(X, n=n, norm=norm)), what="irfft")
    assert_close(_np(back), x)
    assert_no_launches()


@pytest.mark.parametrize("n", [1000, 4097])
def test_grad_through_fft_matches_jax(n, rng, assert_close):
    re, im, w = (rng.standard_normal((2, n)).astype(np.float32) for _ in range(3))

    def jloss(a, b):
        return jnp.sum(w * jnp.abs(ftt.fft(jax.lax.complex(a, b))) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    tre, tim = _t(re).requires_grad_(), _t(im).requires_grad_()
    (_t(w) * ft.fft(torch.complex(tre, tim)).abs() ** 2).sum().backward()
    assert_close(tre.grad.numpy() + 1j * tim.grad.numpy(), cplx(jg))


def test_grad_through_rfft_matches_jax(rng, assert_close):
    n = 1005
    x = rng.standard_normal((2, n)).astype(np.float32)
    w = rng.standard_normal((2, n // 2 + 1)).astype(np.float32)

    def jloss(v):
        return jnp.sum(w * jnp.abs(ftt.rfft(v)) ** 2)

    jg = jax.grad(jloss)(x)
    t = _t(x).requires_grad_()
    (_t(w) * ft.rfft(t).abs() ** 2).sum().backward()
    assert_close(t.grad.numpy(), np.asarray(jg))
