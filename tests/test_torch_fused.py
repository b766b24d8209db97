"""Torch port, the fused-epilogue kernels' entry points on the CPU: the
composite axis(-2) FFT (B2's composite range, ``fft_axis0_split``, and
B3's through it), the filtered FFT (B9, ``fft_filtered_split`` and its
complex64 entry ``fft_filtered_c64``, with the plain version of its
kernel's passes, ``_filt_passes``), the
filter-bank FFT (B10, ``fft_bank_split``, with the plain version of its
passes on that kernel, ``_bank_passes``) and the product C2R (B8,
``irfft_prod_rows_split``, with ``rfft.irfft_prod_last_split`` around it).

On a CPU tensor each entry point runs its kernel's plain version.  The
same numpy inputs go through the JAX package's Pallas kernels in
interpret mode, as ``tests/test_fastconv.py`` and ``tests/test_pallas.py``
run them, values and gradients (``jax.grad``; for the product C2R, whose
JAX kernel has no rule of its own, of the JAX package's
``irfft_prod_last_split``).  The kernels themselves need the card:
``tests/test_torch_cuda.py``.  Tolerance: 1e-5 relative L2.
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
from fft_wgpu_tpu.ops import rfft as j_rfft
from fft_wgpu_tpu_torch.ops import cuda_fft, rfft

torch.set_num_threads(1)

CUDA = types.SimpleNamespace(type="cuda")


def planes(rng, *shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def cplx(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _t(x):
    # a CPU tensor asks the port for the CPU
    return torch.from_numpy(np.array(x))


def assert_no_launches():
    assert (cuda_fft.ax0_gen_launches, cuda_fft.filt_launches, cuda_fft.filt_c64_launches,
            cuda_fft.bank_launches, cuda_fft.c2r_prod_launches) == (0, 0, 0, 0, 0)


# ---------------------------------------------------------------------- #
# B2 / B3, composite n
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("lo", [2, 500, 4000, 16000])
def test_ax0_envelope_matches_jax(lo):
    for n in range(lo, lo + 500):
        assert cuda_fft._ax0_supported(n) == j_pf._ax0_supported(n), n


@pytest.mark.parametrize("shape", [(2, 640, 7), (1000, 130), (1, 1005, 3), (4095, 2)])
def test_axis0_composite_matches_jax_kernel(shape, rng, assert_close):
    re, im = planes(rng, *shape)
    n = shape[-2]
    for sign, scale in ((-1, None), (1, 1.0 / n)):
        want = cplx(j_pf.fft_axis0_split(re, im, sign, scale, interpret=True))
        got = cuda_fft.fft_axis0_split(_t(re), _t(im), sign, scale)
        assert got[0].shape == shape and got[0].dtype == torch.float32
        assert_close(cplx(got), want, what=f"sign={sign}")
        assert_close(cplx(got), (np.fft.fft if sign < 0 else np.fft.ifft)(
            re + 1j * im, axis=-2))
    assert_no_launches()


def test_axis3_composite_matches_jax_kernel(rng, assert_close):
    re, im = planes(rng, 1, 640, 8, 128)  # the JAX kernel's tiling: Y % 8, Z % 128
    want = cplx(j_pf.fft_axis3_split(re, im, -1, 0.5, interpret=True))
    got = cuda_fft.fft_axis3_split(_t(re), _t(im), -1, 0.5)
    assert_close(cplx(got), want)
    re, im = planes(rng, 2, 1000, 7, 13)  # any trailing shape here
    got = cuda_fft.fft_axis3_split(_t(re), _t(im), 1, None)
    assert_close(cplx(got), np.fft.ifft(re + 1j * im, axis=-3) * 1000)


@pytest.mark.parametrize("n", [1000, 4097])
def test_axis0_plain_is_the_two_factor_math(n, rng):
    re, im = (_t(v) for v in planes(rng, n, 5))
    got = cuda_fft.fft_axis0_split_reference(re, im, -1, 0.25)
    want = cuda_fft.fft_rows_general_split_reference(re.T, im.T, -1, 0.25)
    torch.testing.assert_close(got, (want[0].T, want[1].T), rtol=0, atol=0)


def test_grad_axis0_composite_matches_jax(rng, assert_close):
    re, im, wr, wi = (rng.standard_normal((2, 1000, 5)).astype(np.float32)
                      for _ in range(4))

    def jloss(a, b):
        xr, xi = j_pf.fft_axis0_split(a, b, 1, 1e-3, interpret=True)
        return jnp.sum(xr * wr + xi * wi)

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    tre, tim = _t(re).requires_grad_(), _t(im).requires_grad_()
    xr, xi = cuda_fft.fft_axis0_split(tre, tim, 1, 1e-3)
    (xr * _t(wr) + xi * _t(wi)).sum().backward()
    assert_close(tre.grad.numpy() + 1j * tim.grad.numpy(), cplx(jg))


@pytest.mark.parametrize("n", [1000, 1080, 4095])
def test_composite_nd_matches_jax(n, rng, assert_close):
    # fft2 over a composite axis -2 (on the card: B2-composite, no transpose)
    x = (rng.standard_normal((2, n, 6)) + 1j * rng.standard_normal((2, n, 6))
         ).astype(np.complex64)
    assert_close(ft.fft2(_t(x)).numpy(), np.asarray(ftt.fft2(x)))
    assert_close(ft.ifftn(_t(x), axes=(0, 1)).numpy(), np.fft.ifftn(x, axes=(0, 1)))
    r = x.real.copy()
    assert_close(ft.rfft2(_t(r)).numpy(), np.asarray(ftt.rfft2(r)))


# ---------------------------------------------------------------------- #
# B9, the filtered FFT, and B10, the filter bank
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [128, 512, 1024])
def test_filtered_matches_jax_kernel(n, rng, assert_close):
    re, im = planes(rng, 3, n)
    hr, hi = planes(rng, n)
    for sign, scale in ((-1, None), (1, 1.0 / n), (-1, 1.0 / n)):
        want = cplx(j_pf.fft_filtered_split(re, im, hr, hi, sign, scale, interpret=True))
        got = cuda_fft.fft_filtered_split(_t(re), _t(im), hr, hi, sign, scale)
        assert got[0].shape == (3, n)
        assert_close(cplx(got), want, what=f"sign={sign} scale={scale}")
        ref = cuda_fft.fft_filtered_split_reference(_t(re), _t(im), _t(hr), _t(hi), sign,
                                                    scale)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert_no_launches()


@pytest.mark.parametrize("n,S", [(128, 1), (512, 7), (1024, 3)])
def test_bank_matches_jax_kernel(n, S, rng, assert_close):
    re, im = planes(rng, n)
    hr, hi = planes(rng, S, n)
    for sign, scale in ((-1, None), (1, 1.0 / n)):
        want = cplx(j_pf.fft_bank_split(re, im, hr, hi, sign, scale, interpret=True))
        got = cuda_fft.fft_bank_split(_t(re), _t(im), hr, hi, sign, scale)
        assert got[0].shape == (S, n)
        assert_close(cplx(got), want, what=f"sign={sign} scale={scale}")
        ref = cuda_fft.fft_bank_split_reference(_t(re), _t(im), _t(hr), _t(hi), sign, scale)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert_no_launches()


@pytest.mark.parametrize("n,S", [(256, 4), (1024, 1), (4096, 3)])
def test_bank_passes_match_jax(n, S, rng, assert_close):
    # the plain version of the bank's own passes (the filtered rows' kernel
    # with x shared and h moving: the product, the compiled plan's passes on
    # their pass roots) against the JAX kernel in interpret mode (n <= 1024)
    # and float64 numpy
    re, im = planes(rng, n)
    hr, hi = planes(rng, S, n)
    for sign, scale in ((-1, None), (1, 1.0 / n)):
        got = cuda_fft._bank_passes(*(_t(v) for v in (re, im, hr, hi)), sign, scale)
        assert got.shape == (S, n) and got.dtype == torch.complex64
        if n <= 1024:
            want = cplx(j_pf.fft_bank_split(re, im, hr, hi, sign, scale, interpret=True))
            assert_close(got.numpy(), want, what=f"sign={sign} vs JAX")
        x = cplx((re, im)) * cplx((hr, hi))
        want = np.fft.fft(x) if sign < 0 else np.fft.ifft(x) * n
        assert_close(got.numpy(), want * (1.0 if scale is None else scale), what="vs numpy")
    assert_no_launches()


@pytest.mark.parametrize("entry", ["filt", "bank"])
def test_grad_filtered_and_bank_match_jax(entry, rng, assert_close):
    n, S = 256, 4
    re, im = planes(rng, *((3, n) if entry == "filt" else (n,)))
    hr, hi = planes(rng, *((n,) if entry == "filt" else (S, n)))
    w = rng.random((3 if entry == "filt" else S, n)).astype(np.float32)
    j_fn = j_pf.fft_filtered_split if entry == "filt" else j_pf.fft_bank_split
    t_fn = cuda_fft.fft_filtered_split if entry == "filt" else cuda_fft.fft_bank_split

    def jloss(a, b):
        yr, yi = j_fn(a, b, hr, hi, 1, 1.0 / n, interpret=True)
        return jnp.sum(w * (yr * yr + yi * yi))

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    tre, tim = _t(re).requires_grad_(), _t(im).requires_grad_()
    yr, yi = t_fn(tre, tim, hr, hi, 1, 1.0 / n)
    (_t(w) * (yr * yr + yi * yi)).sum().backward()
    assert_close(tre.grad.numpy() + 1j * tim.grad.numpy(), cplx(jg))


# the complex64 entry: rows of n points, and of n_in = n/2 + 1 (zero past
# them: hilbert's half spectrum), against the JAX kernel on the zero-padded
# rows, values and gradients
@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("half", [False, True], ids=["n_in=n", "n_in=n/2+1"])
def test_filtered_c64_matches_jax_kernel(n, half, rng, assert_close):
    n_in = n // 2 + 1 if half else n
    re, im = planes(rng, 3, n_in)
    hr, hi = planes(rng, n)
    pad = [(0, 0), (0, n - n_in)]
    x = _t(re + 1j * im)
    for sign, scale in ((-1, None), (1, 1.0 / n), (-1, 1.0 / n), (1, None)):
        want = cplx(j_pf._fft_filtered_core(np.pad(re, pad), np.pad(im, pad), hr, hi, sign,
                                            scale, interpret=True))
        got = cuda_fft.fft_filtered_c64(x, _t(hr + 1j * hi), sign, scale, n_in=n_in)
        assert got.dtype == torch.complex64 and got.shape == (3, n)
        assert_close(got.numpy(), want, what=f"sign={sign} scale={scale}")
        passes = cuda_fft._filt_passes(x, _t(hr + 1j * hi).to(torch.complex64), sign, scale)
        assert_close(passes.numpy(), want, what=f"the kernel's passes sign={sign}")
        ref = cuda_fft.fft_filtered_c64_reference(x, hr + 1j * hi, sign, scale)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert_no_launches()


@pytest.mark.parametrize("half", [False, True], ids=["n_in=n", "n_in=n/2+1"])
def test_grad_filtered_c64_matches_jax(half, rng, assert_close):
    n = 256
    n_in = n // 2 + 1 if half else n
    re, im = planes(rng, 3, n_in)
    hr, hi = planes(rng, n)
    w = rng.random((3, n)).astype(np.float32)
    pad = [(0, 0), (0, n - n_in)]

    def jloss(a, b):
        yr, yi = j_pf.fft_filtered_split(jnp.pad(a, pad), jnp.pad(b, pad), hr, hi, 1, 1.0 / n,
                                         interpret=True)
        return jnp.sum(w * (yr * yr + yi * yi))

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    x = _t(re + 1j * im).requires_grad_()
    y = cuda_fft.fft_filtered_c64(x, hr + 1j * hi, 1, 1.0 / n)
    (_t(w) * y.abs() ** 2).sum().backward()
    assert_close(x.grad.numpy(), cplx(jg))
    assert_no_launches()


def test_filtered_c64_envelope_raises():
    h = np.zeros(256, np.complex64)
    for fn in (cuda_fft.fft_filtered_c64, cuda_fft.fft_filtered_c64_reference):
        with pytest.raises(cuda_fft.Unsupported):  # n_in > n
            fn(torch.zeros(2, 257, dtype=torch.complex64), h, -1)
        with pytest.raises(cuda_fft.Unsupported):  # n outside the envelope
            fn(torch.zeros(2, 64, dtype=torch.complex64), h[:64], -1)
        with pytest.raises(ValueError, match="complex64"):
            fn(torch.zeros(2, 256), h, -1)
        with pytest.raises(ValueError, match="n_in"):
            fn(torch.zeros(2, 129, dtype=torch.complex64), h, -1, n_in=128)
        with pytest.raises(cuda_fft.Unsupported):  # one row of the filter only
            fn(torch.zeros(2, 256, dtype=torch.complex64), np.zeros((2, 256), np.complex64), -1)
    with pytest.raises(ValueError, match="sign"):
        cuda_fft.fft_filtered_c64(torch.zeros(2, 256, dtype=torch.complex64), h, 0)
    e = torch.zeros(0, 129, dtype=torch.complex64)
    assert cuda_fft.fft_filtered_c64(e, h, -1).shape == (0, 256)


def test_filtered_and_bank_envelopes_raise():
    for n in (64, 1000, 32768):
        z, h = torch.zeros(2, n), np.zeros(n, np.float32)
        for fn in (cuda_fft.fft_filtered_split, cuda_fft.fft_filtered_split_reference):
            with pytest.raises(cuda_fft.Unsupported):
                fn(z, z, h, h, -1)
    z, h = torch.zeros(2, 256), np.zeros((3, 256), np.float32)
    for fn in (cuda_fft.fft_bank_split, cuda_fft.fft_bank_split_reference):
        with pytest.raises(cuda_fft.Unsupported):  # x [n] only, h [S, n] only
            fn(z, z, h, h, -1)
        with pytest.raises(cuda_fft.Unsupported):
            fn(z[0], z[0], h[0], h[0], -1)
    with pytest.raises(j_pf.Unsupported):
        j_pf._fft_bank_core(jnp.zeros((2, 256)), jnp.zeros((2, 256)), h, h, -1,
                            interpret=True)
    with pytest.raises(ValueError, match="hr"):
        cuda_fft.fft_filtered_split(torch.zeros(2, 256), torch.zeros(2, 256),
                                    np.zeros(128), np.zeros(128), -1)
    with pytest.raises(ValueError, match="sign"):
        cuda_fft.fft_bank_split(torch.zeros(256), torch.zeros(256), h, h, 0)
    e = torch.zeros(0, 256)
    assert cuda_fft.fft_filtered_split(e, e, h[0], h[0], -1)[0].shape == (0, 256)


# ---------------------------------------------------------------------- #
# B8, the product C2R
# ---------------------------------------------------------------------- #
def _spectra(rng, rows, n, pad, bcast):
    mp = n // 2 + 1
    bins = cuda_fft.pad_bins(n) if pad else mp
    Ar, Ai = planes(rng, rows, bins)
    Br, Bi = planes(rng, *((bins,) if bcast else (rows, bins)))
    for v in (Ar, Ai, Br, Bi):  # the padded form's pad columns are zeros
        v[..., mp:] = 0.0
    return Ar, Ai, Br, Bi


@pytest.mark.parametrize("bcast", [False, True])
@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("n", [512, 1024])
def test_c2r_prod_matches_jax_kernel(n, pad, bcast, rng, assert_close):
    Ar, Ai, Br, Bi = _spectra(rng, 3, n, pad, bcast)
    for scale in (None, 1.0 / n):
        want = j_pf.irfft_prod_rows_split(Ar, Ai, Br, Bi, n, scale, padded_in=pad,
                                          interpret=True)
        got = cuda_fft.irfft_prod_rows_split(*(_t(v) for v in (Ar, Ai, Br, Bi)), n, scale,
                                             padded_in=pad)
        assert got.shape == (3, n) and got.dtype == torch.float32
        assert_close(got.numpy(), np.asarray(want), what=f"scale={scale}")
        ref = cuda_fft.irfft_prod_rows_split_reference(*(_t(v) for v in (Ar, Ai, Br, Bi)),
                                                       n, scale, padded_in=pad)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert_no_launches()


@pytest.mark.parametrize("n", [128, 256])
def test_c2r_prod_below_the_jax_envelope(n, rng, assert_close):
    # the port's C2R envelope starts at 128; the JAX product kernel at 512
    Ar, Ai, Br, Bi = _spectra(rng, 3, n, False, False)
    P = cplx((Ar, Ai)) * cplx((Br, Bi))
    got = cuda_fft.irfft_prod_rows_split(*(_t(v) for v in (Ar, Ai, Br, Bi)), n, 1.0 / n)
    assert_close(got.numpy(), np.fft.irfft(P, n=n))  # numpy ignores DC/Nyquist imag too


def test_c2r_prod_envelope_raises(rng):
    z = torch.zeros(3, 513)
    for fn in (cuda_fft.irfft_prod_rows_split, cuda_fft.irfft_prod_rows_split_reference):
        with pytest.raises(cuda_fft.Unsupported):  # B of another shape
            fn(z, z, z[:2], z[:2], 1024)
        with pytest.raises(cuda_fft.Unsupported):  # a batched-lead B
            fn(z, z, z[:1], z[:1], 1024)
        with pytest.raises(cuda_fft.Unsupported):  # n outside
            fn(torch.zeros(3, 501), torch.zeros(3, 501), torch.zeros(501),
               torch.zeros(501), 1000)
        with pytest.raises(ValueError, match="bins"):
            fn(z, z, z, z, 1024, padded_in=True)


# (n, padded, broadcast B) of the plain version of the kernel's passes: every
# layout at 256 and 1024, two at 8192 (the JAX kernel in interpret mode
# takes seconds a shape there)
PROD_PASSES = [(n, pad, bcast) for n in (256, 1024) for pad in (False, True)
               for bcast in (False, True)] + [(8192, True, False), (8192, False, True)]


@pytest.mark.parametrize("n,pad,bcast", PROD_PASSES)
def test_c2r_prod_passes_match_jax(n, pad, bcast, rng, assert_close):
    # the plain version of the c2r_prod kernel's own passes (the product, Z
    # packed from X[k] and X[m-k], the compiled plan's passes on its pass
    # roots) against the JAX kernel in interpret mode (n >= 512; at 256 the
    # JAX package's composed form) and float64 numpy
    Ar, Ai, Br, Bi = _spectra(rng, 2, n, pad, bcast)
    got = cuda_fft._c2r_prod_passes(*(_t(v) for v in (Ar, Ai, Br, Bi)), n, 1.0 / n)
    if n >= 512:
        want = j_pf.irfft_prod_rows_split(Ar, Ai, Br, Bi, n, 1.0 / n, padded_in=pad,
                                          interpret=True)
    else:
        want = j_rfft.irfft_prod_last_split(*(jnp.asarray(v) for v in (Ar, Ai, Br, Bi)), n,
                                            1.0 / n, padded_in=pad)
    assert got.shape == (2, n) and got.dtype == torch.float32
    assert_close(got.numpy(), np.asarray(want), what=f"n={n} pad={pad} bcast={bcast} vs JAX")
    mp = n // 2 + 1
    P = cplx((Ar, Ai))[..., :mp] * cplx((Br, Bi))[..., :mp]
    assert_close(got.numpy(), np.fft.irfft(P, n=n), what="vs numpy")


def test_c2r_prod_passes_ignore_dc_and_nyquist_imaginary_parts(rng, assert_close):
    # numpy's irfft of A * B drops the product's imaginary parts at DC and
    # Nyquist (slot 0 of the kernel's staged row holds both real parts): with
    # B real there, a change of Im A[0] and Im A[n/2] moves only those parts
    # of the product, and not one bit of the output
    n, m = 1024, 512
    Ar, Ai, Br, Bi = _spectra(rng, 3, n, False, False)
    Br[:, 0] = Br[:, m] = 1.5
    Bi[:, 0] = Bi[:, m] = 0.0
    Ai2 = Ai.copy()
    Ai2[:, 0] += 5.0
    Ai2[:, m] -= 5.0
    P = cplx((Ar, Ai2)) * cplx((Br, Bi))
    assert np.abs(P.imag[:, [0, m]]).min() > 0.1
    for fn in (cuda_fft._c2r_prod_passes, cuda_fft.irfft_prod_rows_split_reference):
        a = fn(*(_t(v) for v in (Ar, Ai, Br, Bi)), n, 1.0 / n)
        b = fn(*(_t(v) for v in (Ar, Ai2, Br, Bi)), n, 1.0 / n)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert_close(b.numpy(), np.fft.irfft(P, n=n), what=fn.__name__)


@pytest.mark.parametrize("bcast", [False, True])
@pytest.mark.parametrize("pad", [False, True])
def test_grad_c2r_prod_matches_jax(pad, bcast, rng, assert_close):
    n = 512
    Ar, Ai, Br, Bi = _spectra(rng, 3, n, pad, bcast)
    w = rng.random((3, n)).astype(np.float32)

    def jloss(ar, ai, br, bi):
        return jnp.sum(w * j_rfft.irfft_prod_last_split(ar, ai, br, bi, n, 1.0 / n,
                                                        padded_in=pad) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(Ar, Ai, Br, Bi)
    ts = [_t(v).requires_grad_() for v in (Ar, Ai, Br, Bi)]
    y = cuda_fft.irfft_prod_rows_split(*ts, n, 1.0 / n, padded_in=pad)
    (_t(w) * y * y).sum().backward()
    for t, g, what in zip(ts, jg, ("Ar", "Ai", "Br", "Bi")):
        assert t.grad.shape == t.shape
        assert_close(t.grad.numpy(), np.asarray(g), what=what)
        assert not t.grad[..., n // 2 + 1:].any()  # pad columns get zero


def test_irfft_prod_last_split_route(rng, assert_close):
    # equal shapes and a 1-D B take the kernel on the card; a batched-lead
    # B, other n and a CPU tensor compose (the predicate reads only the
    # device and the shapes: stand-ins serve)
    def fake(*shape):
        return types.SimpleNamespace(device=CUDA, ndim=len(shape), shape=shape)

    assert rfft._prod_on_kernel(fake(5, 513), fake(5, 513), 1024)
    assert rfft._prod_on_kernel(fake(5, 7, 640), fake(640), 1024)
    assert not rfft._prod_on_kernel(fake(5, 7, 513), fake(5, 1, 513), 1024)
    assert not rfft._prod_on_kernel(fake(5, 501), fake(5, 501), 1000)
    assert not rfft._prod_on_kernel(fake(5, 513), fake(5, 513), 32768)
    Ar, Ai, Br, Bi = _spectra(rng, 4, 512, True, False)
    Br, Bi = Br[:, None][:1], Bi[:, None][:1]  # [1, 1, bins]: composes
    Ar, Ai = Ar[:, None], Ai[:, None]
    want = j_rfft.irfft_prod_last_split(*(jnp.asarray(v) for v in (Ar, Ai, Br, Bi)), 512,
                                        1.0 / 512, padded_in=True)
    got = rfft.irfft_prod_last_split(*(_t(v) for v in (Ar, Ai, Br, Bi)), 512, 1.0 / 512,
                                     padded_in=True)
    assert got.shape == (4, 1, 512)
    assert_close(got.numpy(), np.asarray(want))
    assert_no_launches()
