"""Torch port, the real-transform slice (ops/rfft.py and the kernel entry
points rfft_rows_split, irfft_rows_split and irfft_rows_c64 of
ops/cuda_fft.py, with the plain version of the C2R kernel's own passes,
``_c2r_passes``) against the JAX package on the CPU.

On a CPU tensor the entry points run their plain versions; they are held
against the JAX package's Pallas R2C and C2R kernels run in interpret mode,
as ``tests/test_pallas.py`` and ``tests/test_rfft.py`` run them, values and
gradients.  The public functions get the same numpy inputs as the JAX
package's.  The kernels themselves need the card:
``tests/test_torch_cuda.py``.  Tolerance: 1e-5 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft as sfft
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu.ops import pallas_fft as j_pf
from fft_wgpu_tpu_torch.ops import cuda_fft, rfft

torch.set_num_threads(1)


def cplx(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _np(z):
    return z.detach().numpy() if isinstance(z, torch.Tensor) else np.asarray(z)


def _t(x):
    # a CPU tensor asks the port for the CPU; numpy input goes to the card
    return torch.from_numpy(np.ascontiguousarray(x))


def spectrum(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def assert_no_launches():
    # CPU tensors never reach a kernel
    assert (cuda_fft.launches, cuda_fft.r2c_launches, cuda_fft.c2r_launches,
            cuda_fft.c2r_c64_launches, cuda_fft.ax0_launches, cuda_fft.ax3_launches) == (
                0, 0, 0, 0, 0, 0)


# ---------------------------------------------------------------------- #
# kernel entry points against the JAX kernels in interpret mode
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("pad_out", [False, True])
@pytest.mark.parametrize("n,rows", [(512, 5), (1024, 3)])
def test_r2c_matches_jax_kernel(n, rows, pad_out, rng, assert_close):
    x = rng.standard_normal((rows, n)).astype(np.float32)
    for scale in (None, n ** -0.5):
        want = j_pf.rfft_rows_split(jnp.asarray(x), scale, pad_out=pad_out,
                                    interpret=True)
        got = cuda_fft.rfft_rows_split(torch.from_numpy(x), scale, pad_out=pad_out)
        assert got[0].shape == np.shape(want[0])
        assert got[0].shape[-1] == (cuda_fft.pad_bins(n) if pad_out else n // 2 + 1)
        assert_close(cplx(got), cplx(want), what=f"scale={scale}")
        if pad_out:  # exact zeros past bin n/2
            assert not got[0][:, n // 2 + 1:].any() and not got[1][:, n // 2 + 1:].any()
    assert_no_launches()


@pytest.mark.parametrize("padded_in", [False, True])
@pytest.mark.parametrize("n,rows", [(256, 4), (1024, 3)])
def test_c2r_matches_jax_kernel(n, rows, padded_in, rng, assert_close):
    m = n // 2
    bins = cuda_fft.pad_bins(n) if padded_in else m + 1
    X = spectrum(rng, rows, bins)
    # nonzero imaginary parts at DC and Nyquist, which C2R ignores; with
    # padded_in, garbage in the pad columns, which it never reads
    X[:, 0] += 3j
    X[:, m] -= 2j
    if padded_in:
        X[:, m + 1:] = 1e6 * (1 + 1j)
    Xr, Xi = np.ascontiguousarray(X.real), np.ascontiguousarray(X.imag)
    for scale in (None, 1.0 / n):
        want = j_pf.irfft_rows_split(jnp.asarray(Xr), jnp.asarray(Xi), n, scale,
                                     padded_in=padded_in, interpret=True)
        got = cuda_fft.irfft_rows_split(torch.from_numpy(Xr), torch.from_numpy(Xi),
                                        n, scale, padded_in=padded_in)
        assert got.shape == (rows, n) and got.dtype == torch.float32
        assert_close(_np(got), np.asarray(want), what=f"scale={scale}")
        full = np.fft.irfft(X[:, :m + 1], n=n, norm="forward")
        assert_close(_np(got), full * (1.0 if scale is None else scale))
    assert_no_launches()


def _half_spectrum(rng, rows, n, padded_in):
    """rows of a half spectrum as the C2R takes them: nonzero imaginary DC
    and Nyquist parts, which it ignores, and with padded_in garbage in the
    pad columns, which it never reads."""
    m = n // 2
    X = spectrum(rng, rows, cuda_fft.pad_bins(n) if padded_in else m + 1)
    X[:, 0] += 3j
    X[:, m] -= 2j
    if padded_in:
        X[:, m + 1:] = 1e6 * (1 + 1j)
    return X


@pytest.mark.parametrize("padded_in", [False, True])
@pytest.mark.parametrize("n,rows", [(256, 5), (1024, 3)])
def test_c2r_c64_matches_jax_kernel(n, rows, padded_in, rng, assert_close):
    # the complex64 source: the tensor as it lies, against the JAX kernel on
    # its planes; the plain version of the entry is the CPU route
    X = _half_spectrum(rng, rows, n, padded_in)
    Xr, Xi = np.ascontiguousarray(X.real), np.ascontiguousarray(X.imag)
    for scale in (None, 1.0 / n):
        want = j_pf.irfft_rows_split(jnp.asarray(Xr), jnp.asarray(Xi), n, scale,
                                     padded_in=padded_in, interpret=True)
        got = cuda_fft.irfft_rows_c64(torch.from_numpy(X), n, scale, padded_in=padded_in)
        assert got.shape == (rows, n) and got.dtype == torch.float32
        assert_close(_np(got), np.asarray(want), what=f"scale={scale}")
        ref = cuda_fft.irfft_rows_c64_reference(torch.from_numpy(X), n, scale,
                                                padded_in=padded_in)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert_no_launches()


# (n, rows, padded) of the plain version of the C2R kernel's own passes:
# each radix layout of the compiled plan at m = 64 .. 8192 (the JAX kernel
# in interpret mode at 256 .. 1024, where it takes a second or two a call;
# float64 numpy at every n)
C2R_PASSES = [(128, 3, False), (256, 5, True), (512, 3, False), (1024, 3, True),
              (4096, 1, False), (16384, 1, True)]


@pytest.mark.parametrize("n,rows,padded", C2R_PASSES)
def test_c2r_passes_match_jax(n, rows, padded, rng, assert_close):
    # Z packed from the staged X[k] and X[m-k], the compiled plan's passes
    # on their pass roots, z interleaved: the kernel's arithmetic for both
    # of its sources
    X = _half_spectrum(rng, rows, n, padded)
    Xr, Xi = np.ascontiguousarray(X.real), np.ascontiguousarray(X.imag)
    got = cuda_fft._c2r_passes(torch.from_numpy(Xr), torch.from_numpy(Xi), n, 1.0 / n)
    assert got.shape == (rows, n) and got.dtype == torch.float32
    if 256 <= n <= 1024:
        want = j_pf.irfft_rows_split(jnp.asarray(Xr), jnp.asarray(Xi), n, 1.0 / n,
                                     padded_in=padded, interpret=True)
        assert_close(_np(got), np.asarray(want), what="vs JAX")
    assert_close(_np(got), np.fft.irfft(X[:, :n // 2 + 1], n=n), what="vs numpy")


@pytest.mark.parametrize("padded", [False, True])
def test_c2r_c64_grad_matches_jax(padded, rng, assert_close):
    # torch's gradient of a complex input is d/dre + i d/dim; the JAX
    # kernel's custom rule gives the two planes'
    n = 512
    X = _half_spectrum(rng, 3, n, padded)
    if padded:
        X[:, n // 2 + 1:] = 0
    w = rng.standard_normal((3, n)).astype(np.float32)

    def jloss(a, b):
        y = j_pf.irfft_rows_split(a, b, n, 1.0 / n, padded_in=padded, interpret=True)
        return jnp.sum(y * w)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(X.real.copy()), jnp.asarray(X.imag.copy()))
    t = torch.from_numpy(X).requires_grad_()
    (cuda_fft.irfft_rows_c64(t, n, 1.0 / n, padded_in=padded) * torch.from_numpy(w)
     ).sum().backward()
    assert t.grad.dtype == torch.complex64 and t.grad.shape == X.shape
    assert_close(t.grad.real.numpy(), np.asarray(jg[0]), what="d/dre")
    assert_close(t.grad.imag.numpy(), np.asarray(jg[1]), what="d/dim")
    assert not t.grad[:, n // 2 + 1:].any()  # pad columns get zero
    assert_no_launches()


def test_c2r_c64_arguments_raise():
    z = torch.zeros(2, 129, dtype=torch.complex64)  # n = 256: 129 bins, or 256 padded
    for fn in (cuda_fft.irfft_rows_c64, cuda_fft.irfft_rows_c64_reference):
        with pytest.raises(ValueError, match="bins"):
            fn(z, 512)
        with pytest.raises(ValueError, match="bins"):
            fn(z, 256, padded_in=True)
        with pytest.raises(ValueError, match="complex64"):
            fn(z.to(torch.complex128), 256)
        with pytest.raises(ValueError, match="complex64"):
            fn(torch.zeros(2, 129), 256)
        with pytest.raises(cuda_fft.Unsupported):
            fn(torch.zeros(2, 16385, dtype=torch.complex64), 32768)
    assert cuda_fft.irfft_rows_c64(torch.zeros(0, 129, dtype=torch.complex64),
                                   256).shape == (0, 256)


def test_c2r_at_128_widens_the_jax_envelope(rng, assert_close):
    # the JAX C2R kernel starts at n = 256; the port's starts at 128
    X = spectrum(rng, 3, 65)
    with pytest.raises(j_pf.Unsupported):
        j_pf._irfft_rows_core(jnp.asarray(X.real), jnp.asarray(X.imag), 128,
                              interpret=True)
    got = cuda_fft.irfft_rows_split(torch.from_numpy(X.real.copy()),
                                    torch.from_numpy(X.imag.copy()), 128, 1.0 / 128)
    assert_close(_np(got), np.fft.irfft(X, n=128))
    x = rng.standard_normal((3, 128)).astype(np.float32)
    assert_close(cplx(cuda_fft.rfft_rows_split(torch.from_numpy(x))),
                 cplx(j_pf.rfft_rows_split(jnp.asarray(x), interpret=True)))


def test_pad_bins_and_envelope_match_jax():
    for e in range(1, 16):
        assert cuda_fft.pad_bins(1 << e) == j_pf.pad_bins(1 << e)
    for n in (100, 1000, 4095):
        assert cuda_fft.pad_bins(n) == j_pf.pad_bins(n)
    for e in range(20):
        n = 1 << e
        assert cuda_fft._supported(n) == j_pf._supported(n), n


@pytest.mark.parametrize("n", [64, 1000, 32768])
def test_envelopes_raise(n):
    with pytest.raises(cuda_fft.Unsupported):
        cuda_fft.rfft_rows_split(torch.zeros(2, n))
    with pytest.raises(cuda_fft.Unsupported):
        cuda_fft.rfft_rows_split_reference(torch.zeros(2, n))
    z = torch.zeros(2, n // 2 + 1)
    with pytest.raises(cuda_fft.Unsupported):
        cuda_fft.irfft_rows_split(z, z, n)
    with pytest.raises(cuda_fft.Unsupported):
        cuda_fft.irfft_rows_split_reference(z, z, n)


def test_bad_arguments_raise():
    z = torch.zeros(2, 129)  # n = 256: 129 bins, or 256 padded
    with pytest.raises(ValueError, match="bins"):
        cuda_fft.irfft_rows_split(z, z, 512)
    with pytest.raises(ValueError, match="bins"):
        cuda_fft.irfft_rows_split(z, z, 256, padded_in=True)
    with pytest.raises(ValueError, match="float32"):
        cuda_fft.irfft_rows_split(z, z.double(), 256)
    with pytest.raises(ValueError, match="float32"):
        cuda_fft.rfft_rows_split(torch.zeros(2, 256, dtype=torch.float64))


def test_reference_is_the_cpu_route(rng):
    x = torch.from_numpy(rng.standard_normal((3, 512)).astype(np.float32))
    a = cuda_fft.rfft_rows_split(x, 0.5, pad_out=True)
    b = cuda_fft.rfft_rows_split_reference(x, 0.5, pad_out=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    y = cuda_fft.irfft_rows_split(*a, 512, 0.25, padded_in=True)
    torch.testing.assert_close(
        y, cuda_fft.irfft_rows_split_reference(*b, 512, 0.25, padded_in=True),
        rtol=0, atol=0)


def test_empty_batch():
    assert cuda_fft.rfft_rows_split(torch.zeros(0, 256))[0].shape == (0, 129)
    z = torch.zeros(0, 256)
    assert cuda_fft.irfft_rows_split(z, z, 256, padded_in=True).shape == (0, 256)


@pytest.mark.parametrize("pad", [False, True])
def test_r2c_grad_matches_jax(pad, rng, assert_close):
    n = 512
    bins = cuda_fft.pad_bins(n) if pad else n // 2 + 1
    x = rng.standard_normal((2, n)).astype(np.float32)
    wr, wi = (rng.standard_normal((2, bins)).astype(np.float32) for _ in range(2))

    def jloss(v):
        xr, xi = j_pf.rfft_rows_split(v, n ** -0.5, pad_out=pad, interpret=True)
        return jnp.sum(xr * wr + xi * wi)

    jg = jax.grad(jloss)(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    xr, xi = cuda_fft.rfft_rows_split(t, n ** -0.5, pad_out=pad)
    (xr * torch.from_numpy(wr) + xi * torch.from_numpy(wi)).sum().backward()
    assert_close(t.grad.numpy(), np.asarray(jg))
    assert_no_launches()


@pytest.mark.parametrize("padded", [False, True])
def test_c2r_grad_matches_jax(padded, rng, assert_close):
    n = 512
    bins = cuda_fft.pad_bins(n) if padded else n // 2 + 1
    X = spectrum(rng, 2, bins)
    if padded:
        X[:, n // 2 + 1:] = 0
    Xr, Xi = np.ascontiguousarray(X.real), np.ascontiguousarray(X.imag)
    w = rng.standard_normal((2, n)).astype(np.float32)

    def jloss(a, b):
        y = j_pf.irfft_rows_split(a, b, n, 1.0 / n, padded_in=padded, interpret=True)
        return jnp.sum(y * w)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(Xr), jnp.asarray(Xi))
    ta = torch.from_numpy(Xr).requires_grad_()
    tb = torch.from_numpy(Xi).requires_grad_()
    y = cuda_fft.irfft_rows_split(ta, tb, n, 1.0 / n, padded_in=padded)
    (y * torch.from_numpy(w)).sum().backward()
    assert_close(ta.grad.numpy(), np.asarray(jg[0]), what="d/dre")
    # the imaginary DC and Nyquist bins do not reach the output: zero grad
    assert_close(tb.grad.numpy(), np.asarray(jg[1]), tol=1e-5, what="d/dim")
    assert float(tb.grad[:, 0].abs().max()) < 1e-6


# ---------------------------------------------------------------------- #
# the slice as a whole: public functions against the JAX package's
# ---------------------------------------------------------------------- #
NORMS = [None, "backward", "ortho", "forward"]


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("n", [None, 256, 200, 255, 300, 7])
def test_rfft_matches_jax(n, norm, rng, assert_close):
    x = rng.standard_normal((3, 256)).astype(np.float32)
    got = ft.rfft(_t(x), n=n, norm=norm)
    want = ftt.rfft(x, n=n, norm=norm)
    assert got.dtype == torch.complex64 and tuple(got.shape) == np.shape(want)
    assert_close(_np(got), _np(want), what=f"n={n} {norm}")
    assert_close(_np(got), np.fft.rfft(x, n=n, norm=norm))


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("n", [None, 256, 255, 100, 301])
def test_irfft_matches_jax(n, norm, rng, assert_close):
    X = spectrum(rng, 3, 129)
    X[:, 0] += 1j  # ignored imaginary DC part
    got = ft.irfft(_t(X), n=n, norm=norm)
    want = ftt.irfft(X, n=n, norm=norm)
    assert got.dtype == torch.float32 and tuple(got.shape) == np.shape(want)
    assert_close(_np(got), _np(want), what=f"n={n} {norm}")
    assert_close(_np(got), np.fft.irfft(X, n=n, norm=norm))


@pytest.mark.parametrize("axis", [0, 1, -3])
def test_rfft_irfft_along_an_axis(axis, rng, assert_close):
    x = rng.standard_normal((64, 10, 8)).astype(np.float32)
    got = ft.rfft(_t(x), axis=axis)
    assert_close(_np(got), _np(ftt.rfft(x, axis=axis)))
    assert_close(_np(ft.irfft(got, n=x.shape[axis], axis=axis)),
                 _np(ftt.irfft(np.asarray(_np(got)), n=x.shape[axis], axis=axis)))


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("s,axes", [
    (None, None),
    ((16, 128), None),             # trim and pad
    (None, (0, 2)),
    (None, (2, 0)),                # out of order: the real axis is axis 0
    (None, (-1, -3)),              # negative
    ((6, 8, 30), (0, 1, 2)),       # 3-D with s
    ((9,), (1,)),                  # a single odd axis
])
def test_rfftn_irfftn_match_jax(s, axes, norm, rng, assert_close):
    x = rng.standard_normal((6, 12, 64)).astype(np.float32)
    got = ft.rfftn(_t(x), s=s, axes=axes, norm=norm)
    want = ftt.rfftn(x, s=s, axes=axes, norm=norm)
    assert tuple(got.shape) == np.shape(want)
    assert_close(_np(got), _np(want), what=f"rfftn s={s} axes={axes}")
    X = np.asarray(want)
    back = ft.irfftn(_t(X), s=s, axes=axes, norm=norm)
    jback = ftt.irfftn(X, s=s, axes=axes, norm=norm)
    assert tuple(back.shape) == np.shape(jback)
    assert_close(_np(back), _np(jback), what=f"irfftn s={s} axes={axes}")


@pytest.mark.parametrize("norm", NORMS)
def test_rfft2_irfft2_match_jax(norm, rng, assert_close):
    x = rng.standard_normal((2, 128, 128)).astype(np.float32)
    X = ft.rfft2(_t(x), norm=norm)
    assert_close(_np(X), _np(ftt.rfft2(x, norm=norm)))
    assert_close(_np(X), np.fft.rfft2(x, norm=norm))
    back = ft.irfft2(X, s=(128, 128), norm=norm)
    assert_close(_np(back), _np(ftt.irfft2(_np(X), s=(128, 128), norm=norm)))
    assert_close(_np(back), x)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("n", [None, 256, 255])
def test_hfft_ihfft_match_jax(n, norm, rng, assert_close):
    X = spectrum(rng, 2, 129)
    assert_close(_np(ft.hfft(_t(X), n=n, norm=norm)), _np(ftt.hfft(X, n=n, norm=norm)))
    assert_close(_np(ft.hfft(_t(X), n=n, norm=norm)), np.fft.hfft(X, n=n, norm=norm))
    x = rng.standard_normal((2, 256)).astype(np.float32)
    assert_close(_np(ft.ihfft(_t(x), n=n, norm=norm)), _np(ftt.ihfft(x, n=n, norm=norm)))
    assert_close(_np(ft.ihfft(_t(x), n=n, norm=norm)), np.fft.ihfft(x, n=n, norm=norm))


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("fn", ["hfftn", "ihfftn", "hfft2", "ihfft2"])
def test_hermitian_nd_match_jax(fn, norm, rng, assert_close):
    if fn.startswith("i"):
        x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    else:
        x = spectrum(rng, 4, 16, 17)
    got = getattr(ft, fn)(_t(x), norm=norm)
    want = getattr(ftt, fn)(x, norm=norm)
    assert tuple(got.shape) == np.shape(want)
    assert_close(_np(got), _np(want), what=f"{fn} {norm}")
    assert_close(_np(got), getattr(sfft, fn)(x, norm=norm))


def test_tensor_input_and_round_trip(rng, assert_close):
    x = torch.from_numpy(rng.standard_normal((4, 1024)).astype(np.float32))
    X = ft.rfft(x)
    assert_close(_np(ft.irfft(X)), _np(x))
    assert_close(_np(ft.rfft(x.double())), np.fft.rfft(_np(x)))
    assert_no_launches()


def test_errors_match_jax():
    for pkg, arr in ((ft, _t), (ftt, np.asarray)):
        x = arr(np.zeros((4, 8), np.float32))
        with pytest.raises(TypeError):
            pkg.rfft(arr(np.zeros((4, 8), np.complex64)))
        with pytest.raises(ValueError):
            pkg.rfft(x, norm="bogus")
        with pytest.raises(ValueError):
            pkg.irfft(x, norm="bogus")
        with pytest.raises(ValueError):
            pkg.rfftn(x, axes=(0, 2))
        with pytest.raises(ValueError):
            pkg.irfftn(x, s=(4, 4), axes=(0,))
        with pytest.raises(ValueError):
            pkg.rfftn(x, s=(2, 2, 2))
        with pytest.raises(ValueError):
            pkg.hfftn(x, norm="bogus")
        with pytest.raises(ValueError):
            pkg.ihfft(x, norm="bogus")
    with pytest.raises(TypeError):
        ft.rfft(torch.zeros(4, 8, dtype=torch.complex64))


def test_grad_through_rfft2_matches_jax(rng, assert_close):
    x = rng.standard_normal((16, 32)).astype(np.float32)
    w = rng.standard_normal((16, 17)).astype(np.float32)

    def jloss(v):
        return jnp.sum(w * jnp.abs(ftt.rfft2(v, norm="ortho")) ** 2)

    jg = jax.grad(jloss)(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    (torch.from_numpy(w) * ft.rfft2(t, norm="ortho").abs() ** 2).sum().backward()
    assert_close(t.grad.numpy(), np.asarray(jg))


def test_grad_through_irfft_matches_jax(rng, assert_close):
    X = spectrum(rng, 3, 65)
    w = rng.standard_normal((3, 128)).astype(np.float32)

    def jloss(a, b):
        return jnp.sum(w * ftt.irfft(jax.lax.complex(a, b), n=128))

    jg = jax.grad(jloss, argnums=(0, 1))(X.real.copy(), X.imag.copy())
    ta = torch.from_numpy(X.real.copy()).requires_grad_()
    tb = torch.from_numpy(X.imag.copy()).requires_grad_()
    (torch.from_numpy(w) * ft.irfft(torch.complex(ta, tb), n=128)).sum().backward()
    assert_close(ta.grad.numpy(), np.asarray(jg[0]), what="d/dre")
    assert_close(tb.grad.numpy(), np.asarray(jg[1]), what="d/dim")


# the complex64 route of irfft / irfft2 / irfftn (rfft._irfftn_c64_run: the
# leading axes through nd.fftn_c64, then irfft_rows_c64, the whole scale
# folded into the C2R), run here on CPU tensors through the entries' plain
# versions, against the JAX package's functions
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("shape,s,axes", [
    ((3, 129), [None], [1]),                       # irfft
    ((129, 3), [256], [0]),                        # irfft along axis 0
    ((128, 65), [None, None], [0, 1]),             # irfft2
    ((128, 256, 65), [None, None, 128], [0, 1, 2]),  # irfftn, axis -3 first
    ((129, 3, 256), [None, None], [2, 0]),         # irfftn over (2, 0): real axis 0
])
def test_irfft_c64_route_matches_jax(shape, s, axes, norm, rng, assert_close):
    X = spectrum(rng, *shape)
    got = rfft._irfftn_c64_run(torch.from_numpy(X), s, axes, norm)
    want = ftt.irfftn(X, s=s, axes=axes, norm=norm)
    assert got.dtype == torch.float32 and tuple(got.shape) == np.shape(want)
    assert_close(_np(got), _np(want), what=f"{shape} s={s} axes={axes}")
    assert_close(_np(ft.irfftn(torch.from_numpy(X), s=s, axes=axes, norm=norm)), _np(want),
                 what="the CPU route")
    assert_no_launches()


def test_grad_through_irfft_c64_route_matches_jax(rng, assert_close):
    X = spectrum(rng, 128, 65)
    w = rng.standard_normal((128, 128)).astype(np.float32)

    def jloss(a, b):
        return jnp.sum(w * ftt.irfft2(jax.lax.complex(a, b), norm="ortho"))

    jg = jax.grad(jloss, argnums=(0, 1))(X.real.copy(), X.imag.copy())
    t = torch.from_numpy(X).requires_grad_()
    (torch.from_numpy(w) * rfft._irfftn_c64_run(t, [None, None], [0, 1], "ortho")
     ).sum().backward()
    assert_close(t.grad.real.numpy(), np.asarray(jg[0]), what="d/dre")
    assert_close(t.grad.imag.numpy(), np.asarray(jg[1]), what="d/dim")
    assert_no_launches()


def test_routes_on_the_card():
    # pure decisions for a CUDA tensor; no card needed: pow2 n in the
    # kernels' envelope take the one-pass kernels, including config 4's
    for n in (128, 256, 4096, 16384):
        assert cuda_fft._supported(n)
    # other even n the packed path (its half-length FFT on the row kernel
    # where the half is in its envelope), odd n the zero-imaginary C2C
    assert not cuda_fft._supported(32768) and cuda_fft._supported(16384)
    assert not cuda_fft._supported(1000) and not cuda_fft._supported(255)


# ---------------------------------------------------------------------- #
# C6 (ROADMAP §C): an output length below 1 raises ValueError before any
# scale, route or launch, as numpy.fft raises (the JAX package keeps the
# fault: the port is held to numpy here, not to it)
# ---------------------------------------------------------------------- #
ZERO_LENGTH = "fft length must be >= 1, got 0"


class _Norm:
    """The module's transforms with ``norm`` bound: m.irfft(...) calls
    module.irfft(..., norm=norm)."""

    def __init__(self, module, norm):
        self.module, self.norm = module, norm

    def __getattr__(self, name):
        fn = getattr(self.module, name)
        return lambda *a, **k: fn(*a, norm=self.norm, **k)


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
@pytest.mark.parametrize("call", [
    lambda m, x: m.irfft(x[:, :1]), lambda m, x: m.irfft(x, n=0),
    lambda m, x: m.hfft(x[:, :1]), lambda m, x: m.hfft(x, n=0),
    lambda m, x: m.irfft2(x[:, :1]), lambda m, x: m.irfftn(x, s=(3, 0)),
    lambda m, x: m.irfftn(x, s=(0, 4))],
    ids=["irfft-1bin", "irfft-n0", "hfft-1bin", "hfft-n0", "irfft2-1bin", "irfftn-s30",
         "irfftn-s04"])
def test_c2r_zero_length_raises_as_numpy(call, norm, rng):
    # irfft, hfft, irfft2 and irfftn of a [3, 1] or [3, 4] complex64 input:
    # ZeroDivisionError, or with norm="forward" a [3, 1] array, before
    x = spectrum(rng, 3, 4)
    with pytest.raises(ValueError):
        call(_Norm(np.fft, norm), x)
    with pytest.raises(ValueError, match=ZERO_LENGTH):
        call(_Norm(ft, norm), _t(x))


def test_irfft_forward_norm_of_one_bin_raises_as_numpy(rng):
    # it returned a [3, 1] array
    x = spectrum(rng, 3, 1)
    with pytest.raises(ValueError):
        np.fft.irfft(x, norm="forward")
    with pytest.raises(ValueError, match=ZERO_LENGTH):
        ft.irfft(_t(x), norm="forward")
    with pytest.raises(ValueError, match=ZERO_LENGTH):
        ft.irfft2(_t(x), norm="forward")


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_hfftn_zero_length_raises_as_scipy(norm, rng):
    # hfftn(s=(3, 0)) returned [3, 1]: it runs irfftn with the norm swapped
    x = spectrum(rng, 3, 4)
    for s in ((3, 0), (0, 4)):
        with pytest.raises(ValueError):
            sfft.hfftn(x, s=s, norm=norm)
        with pytest.raises(ValueError, match=ZERO_LENGTH):
            ft.hfftn(_t(x), s=s, norm=norm)
        with pytest.raises(ValueError, match=ZERO_LENGTH):
            ft.hfft2(_t(x), s=s, norm=norm)
        with pytest.raises(ValueError):
            sfft.ihfftn(x.real, s=s, norm=norm)
        with pytest.raises(ValueError, match=ZERO_LENGTH):
            ft.ihfftn(_t(x.real), s=s, norm=norm)


def test_zero_length_raises_before_any_route(monkeypatch, rng):
    # the check comes ahead of the CUDA routes' predicates: irfft picks its
    # complex64 route before its impl runs, so no predicate may be asked
    # (and no kernel launched) for a call that raises
    def no_route(*a, **k):
        raise AssertionError("a route was picked for a call that raises")

    from fft_wgpu_tpu_torch.plan.plan import Plan

    for mod, name in ((rfft, "_irfftn_c64"), (rfft, "_irfft_c64"), (rfft, "_rfft_c64"),
                      (rfft.nd, "_c64_plane"), (rfft.nd, "_c64_route"),
                      (rfft.nd, "_fused_plane"), (cuda_fft, "_supported"),
                      (Plan, "_execute_split"), (Plan, "_execute_split_axis"),
                      (Plan, "_execute_c64")):  # nor any axis transformed first
        monkeypatch.setattr(mod, name, no_route)
    x = _t(spectrum(rng, 3, 4))
    for call in (lambda: ft.irfft(x[:, :1]), lambda: ft.irfft(x[:, :1], norm="forward"),
                 lambda: ft.irfft(x, n=0), lambda: ft.hfft(x[:, :1]),
                 lambda: ft.irfft2(x[:, :1]), lambda: ft.irfftn(x, s=(3, 0)),
                 lambda: ft.hfftn(x, s=(3, 0)), lambda: ft.rfft(x.real, n=0),
                 lambda: ft.rfftn(x.real, s=(0, 4)), lambda: ft.ihfftn(x.real, s=(0, 4)),
                 lambda: ft.irfftn(x, s=(0, 4))):
        with pytest.raises(ValueError, match="fft length must be >= 1"):
            call()
