"""Torch port, the N-D slice (ops/nd.py, the plan's axis(-3) route and the
kernel entry points fft_axis3_split, fft2_fused_split and fft2_split of
ops/cuda_fft.py) against the JAX package on the CPU.

On a CPU tensor the entry points run their plain versions; they are held
against the JAX package's Pallas kernels run in interpret mode, as
``tests/test_pallas.py`` and ``tests/test_ad.py`` run them, values and
gradients.  The public functions get the same numpy inputs as the JAX
package's.  The routing on the card is checked without one, from the
envelope predicates the routes are chosen by.  The kernels themselves need
the card: ``tests/test_torch_cuda.py``.  Tolerance: 1e-5 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu.ops import pallas_fft as j_pf
from fft_wgpu_tpu_torch.ops import cuda_fft, nd

torch.set_num_threads(1)

CUDA = torch.device("cuda", 0)


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def planes(rng, *shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def cplx(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def torch_pair(re, im):
    return torch.from_numpy(re), torch.from_numpy(im)


def _np(z):
    return z.numpy() if isinstance(z, torch.Tensor) else np.asarray(z)


def _t(x):
    # a CPU tensor asks the port for the CPU; numpy input goes to the card
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_no_launches():
    # CPU tensors never reach a kernel
    assert (cuda_fft.launches, cuda_fft.ax0_launches, cuda_fft.ax3_launches,
            cuda_fft.rows_t_launches, cuda_fft.fft2f_launches) == (0, 0, 0, 0, 0)


# ---------------------------------------------------------------------- #
# kernel entry points against the JAX kernels in interpret mode
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(128, 8, 128), (2, 256, 8, 128)])
def test_axis3_matches_jax_kernel(shape, rng, assert_close):
    re, im = planes(rng, *shape)
    n = shape[-3]
    for sign, scale in ((-1, None), (1, 1.0 / n)):
        want = cplx(j_pf.fft_axis3_split(re, im, sign, scale, interpret=True))
        got = cuda_fft.fft_axis3_split(*torch_pair(re, im), sign, scale)
        assert got[0].shape == shape and got[0].dtype == torch.float32
        assert_close(cplx(got), want, what=f"sign={sign}")
    assert_no_launches()


@pytest.mark.parametrize("shape", [(2, 128, 7, 130), (256, 3, 5), (1, 512, 1, 1)])
def test_axis3_any_trailing_shape(shape, rng, assert_close):
    # Y and Z need no tiling on the card, unlike the JAX kernel's Y % 8, Z % 128
    x = crand(rng, *shape)
    for sign, scale, fn in ((-1, None, np.fft.fft), (1, 1.0 / shape[-3], np.fft.ifft)):
        got = cuda_fft.fft_axis3_split(*torch_pair(x.real.copy(), x.imag.copy()),
                                       sign, scale)
        assert_close(cplx(got), fn(x, axis=-3))


@pytest.mark.parametrize("shape", [(2, 128, 128), (128, 256), (1, 256, 128)])
def test_fft2_fused_matches_jax_kernel(shape, rng, assert_close):
    re, im = planes(rng, *shape)
    total = shape[-1] * shape[-2]
    for sign, scale in ((-1, None), (1, 1.0 / total)):
        want = cplx(j_pf.fft2_fused_split(re, im, sign, scale, interpret=True))
        got = cuda_fft.fft2_fused_split(*torch_pair(re, im), sign, scale)
        assert got[0].shape == shape
        assert_close(cplx(got), want, what=f"{shape} sign={sign}")
    assert_no_launches()


def test_fft2_split_matches_jax(rng, assert_close):
    re, im = planes(rng, 3, 128, 256)
    for sign, scale in ((-1, None), (1, 1.0 / (128 * 256))):
        want = cplx(j_pf.fft2_split(re, im, sign, scale, interpret=True))
        got = cuda_fft.fft2_split(*torch_pair(re, im), sign, scale)
        assert got[0].shape == (3, 128, 256)
        assert_close(cplx(got), want, what=f"sign={sign}")
    assert_no_launches()


def test_fused_envelope_matches_jax():
    for a in range(5, 11):
        for b in range(5, 11):
            A, B = 1 << a, 1 << b
            assert cuda_fft._fft2f_supported(A, B) == j_pf._fft2f_supported(A, B), (A, B)
    assert cuda_fft._fft2f_supported(256, 256) and not cuda_fft._fft2f_supported(512, 256)


@pytest.mark.parametrize("entry", ["axis3", "fused"])
def test_reference_is_the_cpu_route(entry, rng):
    re, im = torch_pair(*planes(rng, 2, 128, 128))
    if entry == "axis3":
        re, im = re.reshape(2, 128, 8, 16), im.reshape(2, 128, 8, 16)
        a = cuda_fft.fft_axis3_split(re, im, 1, 0.5)
        b = cuda_fft.fft_axis3_split_reference(re, im, 1, 0.5)
    else:
        a = cuda_fft.fft2_fused_split(re, im, 1, 0.5)
        b = cuda_fft.fft2_fused_split_reference(re, im, 1, 0.5)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_envelopes_raise():
    z = torch.zeros(64, 4, 4)
    with pytest.raises(cuda_fft.Unsupported):
        cuda_fft.fft_axis3_split(z, z, -1)
    with pytest.raises(cuda_fft.Unsupported):
        cuda_fft.fft_axis3_split_reference(z, z, -1)
    for shape in ((64, 256), (512, 256), (1000, 128)):
        z = torch.zeros(shape)
        with pytest.raises(cuda_fft.Unsupported):
            cuda_fft.fft2_fused_split(z, z, -1)
        with pytest.raises(cuda_fft.Unsupported):
            cuda_fft.fft2_fused_split_reference(z, z, -1)
    z = torch.zeros(128, 1000)
    with pytest.raises(cuda_fft.Unsupported):
        cuda_fft.fft2_split(z, z, -1)


def test_bad_arguments_raise():
    z = torch.zeros(256, 4)
    with pytest.raises(ValueError, match=r"\[\.\.\., n, Y, Z\]"):
        cuda_fft.fft_axis3_split(z, z, -1)
    with pytest.raises(ValueError, match="sign"):
        cuda_fft.fft_axis3_split(torch.zeros(128, 4, 4), torch.zeros(128, 4, 4), 0)
    z = torch.zeros(2, 128, 128)
    with pytest.raises(ValueError, match="sign"):
        cuda_fft.fft2_fused_split(z, z, 2)
    with pytest.raises(ValueError, match="float32"):
        cuda_fft.fft2_fused_split(z, z.double(), -1)
    with pytest.raises(ValueError, match=r"\[\.\.\., A, B\]"):
        cuda_fft.fft2_fused_split(torch.zeros(128), torch.zeros(128), -1)
    with pytest.raises(ValueError, match=r"\[\.\.\., A, B\]"):
        cuda_fft.fft2_split(torch.zeros(128), torch.zeros(128), -1)


def test_empty_batch():
    z = torch.zeros(0, 128, 4, 4)
    assert cuda_fft.fft_axis3_split(z, z, -1)[0].shape == (0, 128, 4, 4)
    z = torch.zeros(0, 128, 128)
    assert cuda_fft.fft2_fused_split(z, z, -1)[0].shape == (0, 128, 128)


def _jax_grad(fn, re, im, wr, wi):
    def loss(a, b):
        xr, xi = fn(a, b)
        return jnp.sum(xr * wr + xi * wi)

    return jax.grad(loss, argnums=(0, 1))(re, im)


def _torch_grad(fn, re, im, wr, wi):
    tre = torch.from_numpy(re).requires_grad_()
    tim = torch.from_numpy(im).requires_grad_()
    xr, xi = fn(tre, tim)
    (xr * torch.from_numpy(wr) + xi * torch.from_numpy(wi)).sum().backward()
    return tre.grad.numpy(), tim.grad.numpy()


@pytest.mark.parametrize("entry", ["axis3", "fused", "two_pass"])
def test_grad_matches_jax(entry, rng, assert_close):
    # tests/test_ad.py's loss: sum(Xr * wr + Xi * wi) through the kernel
    shape = (128, 8, 128) if entry == "axis3" else (2, 128, 128)
    re, im, wr, wi = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    jfn, tfn = {
        "axis3": (lambda a, b: j_pf.fft_axis3_split(a, b, -1, interpret=True),
                  lambda a, b: cuda_fft.fft_axis3_split(a, b, -1)),
        "fused": (lambda a, b: j_pf.fft2_fused_split(a, b, 1, 1.0 / 128 ** 2,
                                                      interpret=True),
                  lambda a, b: cuda_fft.fft2_fused_split(a, b, 1, 1.0 / 128 ** 2)),
        "two_pass": (lambda a, b: j_pf.fft2_split(a, b, -1, interpret=True),
                     lambda a, b: cuda_fft.fft2_split(a, b, -1)),
    }[entry]
    jg = _jax_grad(jfn, re, im, wr, wi)
    tg = _torch_grad(tfn, re, im, wr, wi)
    assert_close(tg[0], np.asarray(jg[0]), what="d/dre")
    assert_close(tg[1], np.asarray(jg[1]), what="d/dim")
    assert_no_launches()


# ---------------------------------------------------------------------- #
# the slice as a whole: public functions against the JAX package's
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
@pytest.mark.parametrize("fn", ["fft2", "ifft2", "fftn", "ifftn"])
def test_public_matches_jax(fn, norm, rng, assert_close):
    x = crand(rng, 3, 16, 128)
    got = getattr(ft, fn)(_t(x), norm=norm)
    assert got.dtype == torch.complex64 and got.shape == x.shape
    assert_close(_np(got), _np(getattr(ftt, fn)(x, norm=norm)), what=f"{fn} {norm}")
    assert_close(_np(got), getattr(np.fft, fn)(x, norm=norm))
    assert_no_launches()


@pytest.mark.parametrize("s,axes", [
    ((8, 200), None),              # trim one axis, pad the other
    ((16, 100), (0, 2)),           # s with explicit axes
    (None, (2, 0)),                # axes out of order
    (None, (-1, -3)),              # negative axes
    (None, (0, 1, 2)),             # 3-D
    ((4, 6, 130), (1, 0, 2)),      # 3-D, out of order, pad and trim
    (None, (1,)),                  # a single axis
])
@pytest.mark.parametrize("fn", ["fftn", "ifftn"])
def test_fftn_s_and_axes_match_jax(fn, s, axes, rng, assert_close):
    x = crand(rng, 6, 12, 128)
    got = getattr(ft, fn)(_t(x), s=s, axes=axes)
    want = getattr(ftt, fn)(x, s=s, axes=axes)
    assert tuple(got.shape) == np.shape(want)
    assert_close(_np(got), _np(want), what=f"{fn} s={s} axes={axes}")
    assert_close(_np(got), getattr(np.fft, fn)(x, s=s, axes=axes))


@pytest.mark.parametrize("shape", [(5, 7, 9), (3, 27, 15)])
def test_fftn_odd_sizes_match_jax(shape, rng, assert_close):
    x = crand(rng, *shape)
    assert_close(_np(ft.fftn(_t(x))), _np(ftt.fftn(x)))
    assert_close(_np(ft.ifft2(_t(x), axes=(0, 2))), _np(ftt.ifft2(x, axes=(0, 2))))


def test_fft2_of_a_tensor_and_executors(rng, assert_close):
    x = crand(rng, 2, 128, 128)
    t = torch.from_numpy(x)
    for executor in ("auto", "xla", "pallas"):
        got = ft.fft2(t, executor=executor)
        # the JAX package's "pallas" needs a TPU or interpret mode
        want = ftt.fft2(x, executor=executor if executor != "pallas" else "auto")
        assert_close(_np(got), _np(want), what=executor)
    assert_no_launches()


def test_nd_errors_match_jax():
    for pkg, arr in ((ft, _t), (ftt, np.asarray)):
        x = arr(np.zeros((4, 8, 8), np.complex64))
        with pytest.raises(ValueError):
            pkg.fftn(x, axes=(0, 3))
        with pytest.raises(ValueError):
            pkg.fftn(x, axes=(-4,))
        with pytest.raises(ValueError):
            pkg.fftn(x, s=(4, 4), axes=(0,))
        with pytest.raises(ValueError):
            pkg.fftn(x, s=(2, 2, 2, 2))
        with pytest.raises(ValueError):
            pkg.fft2(x, norm="bogus")


def test_grad_through_fftn_matches_jax(rng, assert_close):
    re, im, w = (rng.standard_normal((4, 16, 32)).astype(np.float32) for _ in range(3))

    def jloss(a, b):
        y = ftt.fftn(jax.lax.complex(a, b), axes=(0, 2), norm="ortho")
        return jnp.sum(w * jnp.abs(y) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    tre = torch.from_numpy(re).requires_grad_()
    tim = torch.from_numpy(im).requires_grad_()
    y = ft.fftn(torch.complex(tre, tim), axes=(0, 2), norm="ortho")
    (torch.from_numpy(w) * y.abs() ** 2).sum().backward()
    assert_close(tre.grad.numpy(), np.asarray(jg[0]), what="d/dre")
    assert_close(tim.grad.numpy(), np.asarray(jg[1]), what="d/dim")


# ---------------------------------------------------------------------- #
# routes on the card, from the predicates (no card needed)
# ---------------------------------------------------------------------- #
def test_plane_routes_on_the_card(assert_close):
    cpu = torch.device("cpu")
    assert nd._fused_plane((256, 256, 256), (0, 1, 2), CUDA)  # 3-D fftn
    assert nd._fused_plane((8, 256, 256), (1, 2), CUDA)
    assert nd._fused_plane((8, 256, 256), (2, 1), CUDA)  # any order
    assert nd._fused_plane((2, 128, 512), (0, 1, 2), CUDA)  # rest
    # a few planes: the fused plane too (one launch measured faster than two
    # from one plane on); config 4's plane: the per-axis loop (row kernel
    # and axis(-2) kernel), measured faster than two transposed-rows passes
    assert nd._fused_plane((2, 256, 256), (1, 2), CUDA)
    assert nd._fused_plane((128, 128), (0, 1), CUDA)
    assert not nd._fused_plane((4096, 4096), (-2, -1), CUDA)
    assert not nd._fused_plane((512, 512, 512), (0, 1, 2), CUDA)
    assert not nd._fused_plane((4096, 2049), (0,), CUDA)  # rfft2's C2C axis
    assert not nd._fused_plane((256, 256, 256), (0, 2), CUDA)  # not trailing
    assert not nd._fused_plane((256, 256, 256), (0, 1, 2), cpu)
    assert not nd._fused_plane((256, 256, 256), (0, 1, 2), CUDA, "xla")
    # the plan sends axis -2 and axes <= -3 of pow2 n in 128..16384 to the
    # axis(-2) and axis(-3) kernels and the last axis to the row kernel, so
    # config 4's planes and the 256^3 / 512^3 loops stay inside the kernels
    for n in (128, 256, 512, 4096, 16384):
        assert cuda_fft._ax0_supported(n)
        assert ft.plan(n)._resolve_executor(CUDA) == "pallas"
    # composite n too, as in the JAX package: the composite axis(-2) kernel,
    # with no transpose (the last axis: the composite-row kernel)
    for n in (1000, 1080, 4095):
        assert cuda_fft._ax0_supported(n) and j_pf._ax0_supported(n)
        assert ft.plan(n)._resolve_executor(CUDA) == "general"
    x = np.random.default_rng(0).standard_normal((1000, 2, 2)).astype(np.float32)
    got = cuda_fft.fft_axis3_split(torch.from_numpy(x), torch.zeros(1000, 2, 2), -1)
    assert_close(got[0].numpy() + 1j * got[1].numpy(), np.fft.fft(x, axis=0))
    with pytest.raises(cuda_fft.Unsupported):  # a prime: outside both envelopes
        cuda_fft.fft_axis3_split(torch.zeros(1031, 2, 2), torch.zeros(1031, 2, 2), -1)


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
@pytest.mark.parametrize("name", ["fft2", "ifft2", "fftn", "ifftn"])
def test_zero_length_raises_as_numpy(name, norm, monkeypatch):
    # C6 (ROADMAP §C): fftn(s=(3, 0), norm="forward") raised
    # ZeroDivisionError, and "ortho" too; numpy raises ValueError, and the
    # port does so before any route predicate is asked
    def no_route(*a, **k):
        raise AssertionError("a route was picked for a call that raises")

    for fn in ("_c64_plane", "_c64_route", "_fused_plane"):
        monkeypatch.setattr(nd, fn, no_route)
    x = np.ones((3, 4), np.complex64)
    for kw in ({"s": (3, 0)}, {"s": (0, 4)}, {"s": (3, -2)}):
        with pytest.raises(ValueError):
            getattr(np.fft, name)(x, axes=(0, 1), norm=norm, **kw)
        with pytest.raises(ValueError, match="fft length must be >= 1"):
            getattr(ft, name)(_t(x), norm=norm, **kw)
    with pytest.raises(ValueError, match="fft length must be >= 1, got 0"):
        getattr(ft, name)(_t(x[:, :0]), norm=norm)
