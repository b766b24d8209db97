"""Torch port, the complex64 entries of the axis(-2), axis(-3) and R2C
kernels (ops/cuda_fft.py: ``fft_axis0_c64``, ``fft_axis3_c64``,
``rfft_rows_c64``) and the complex64 routes through them (ops/nd.py's
``fftn_c64``, ``rfft``'s complex64 sink, and ``irfft``'s and ``irfftn``'s
complex64 source) against the JAX package on the CPU.

On a CPU tensor the entries run their plain versions; they are held
against the JAX package's Pallas kernels run in interpret mode, as
``tests/test_torch_nd.py`` and ``tests/test_torch_rfft.py`` run them,
values and gradients, at odd column counts.  The routes on the card are
checked without one, from the predicates that pick them.  The kernels
themselves need the card: ``tests/test_torch_cuda.py``.  Tolerance: 1e-5
relative L2.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_wgpu_tpu as ftt
from fft_wgpu_tpu.ops import pallas_fft as j_pf
from fft_wgpu_tpu_torch.ops import cuda_fft, nd, rfft

torch.set_num_threads(1)

CUDA = torch.device("cuda", 0)
CPU = torch.device("cpu")


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def cplx(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def cplx_dot(pair, wr, wi):
    return pair[0] * wr + pair[1] * wi


def assert_no_launches():
    # CPU tensors never reach a kernel
    assert (cuda_fft.launches, cuda_fft.ax0_launches, cuda_fft.ax3_launches,
            cuda_fft.r2c_launches, cuda_fft.c2r_launches, cuda_fft.fft2f_launches) == (
                0, 0, 0, 0, 0, 0)


# ---------------------------------------------------------------------- #
# the entries against the JAX kernels in interpret mode
# ---------------------------------------------------------------------- #
ENTRIES = {
    # name: (torch entry, JAX kernel on planes, shapes with odd columns)
    "axis0": (cuda_fft.fft_axis0_c64, j_pf.fft_axis0_split,
              [(128, 37), (3, 256, 130), (2, 512, 9)]),
    "axis3": (cuda_fft.fft_axis3_c64, j_pf.fft_axis3_split,
              [(128, 8, 128), (2, 256, 8, 128)]),
}


@pytest.mark.parametrize("entry", ["axis0", "axis3"])
def test_c64_entry_matches_jax_kernel(entry, rng, assert_close):
    fn, jfn, shapes = ENTRIES[entry]
    for shape in shapes:
        x = crand(rng, *shape)
        n = shape[-2 if entry == "axis0" else -3]
        for sign, scale in ((-1, None), (1, 1.0 / n), (-1, n ** -0.5)):
            want = cplx(jfn(np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag),
                            sign, scale, interpret=True))
            got = fn(torch.from_numpy(x), sign, scale)
            assert got.dtype == torch.complex64 and got.shape == shape
            assert_close(got.numpy(), want, what=f"{shape} sign={sign} scale={scale}")
    assert_no_launches()


@pytest.mark.parametrize("shape", [(2, 128, 7, 13), (256, 3, 5), (1, 512, 1, 1)])
def test_axis3_c64_any_trailing_shape(shape, rng, assert_close):
    # odd Y and Z: the free view [..., n, Y*Z] has an odd column count
    x = crand(rng, *shape)
    for sign, scale, ref in ((-1, None, np.fft.fft), (1, 1.0 / shape[-3], np.fft.ifft)):
        got = cuda_fft.fft_axis3_c64(torch.from_numpy(x), sign, scale)
        assert_close(got.numpy(), ref(x, axis=-3))


@pytest.mark.parametrize("n,rows", [(128, 5), (512, 3), (1024, 7)])
def test_rfft_c64_matches_jax_kernel(n, rows, rng, assert_close):
    x = rng.standard_normal((rows, n)).astype(np.float32)
    for scale in (None, n ** -0.5):
        want = cplx(j_pf.rfft_rows_split(jnp.asarray(x), scale, interpret=True))
        got = cuda_fft.rfft_rows_c64(torch.from_numpy(x), scale)
        assert got.dtype == torch.complex64 and got.shape == (rows, n // 2 + 1)
        assert_close(got.numpy(), want, what=f"scale={scale}")
    assert_no_launches()


def _jax_grad(fn, re, im, wr, wi):
    def loss(a, b):
        xr, xi = fn(a, b)
        return jnp.sum(xr * wr + xi * wi)

    return jax.grad(loss, argnums=(0, 1))(re, im)


@pytest.mark.parametrize("entry", ["axis0", "axis3", "r2c"])
def test_c64_entry_grad_matches_jax(entry, rng, assert_close):
    # tests/test_ad.py's loss, sum(Xr * wr + Xi * wi), through the entry
    if entry == "r2c":
        n = 512
        x = rng.standard_normal((3, n)).astype(np.float32)
        wr, wi = (rng.standard_normal((3, n // 2 + 1)).astype(np.float32) for _ in range(2))
        jg = jax.grad(lambda v: jnp.sum(cplx_dot(
            j_pf.rfft_rows_split(v, n ** -0.5, interpret=True), wr, wi)))(jnp.asarray(x))
        t = torch.from_numpy(x).requires_grad_()
        y = cuda_fft.rfft_rows_c64(t, n ** -0.5)
        (y.real * torch.from_numpy(wr) + y.imag * torch.from_numpy(wi)).sum().backward()
        assert_close(t.grad.numpy(), np.asarray(jg))
        assert_no_launches()
        return
    shape = (256, 37) if entry == "axis0" else (128, 8, 128)
    fn, jfn, _ = ENTRIES[entry]
    re, im, wr, wi = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    jg = _jax_grad(lambda a, b: jfn(a, b, 1, 0.5, interpret=True), re, im, wr, wi)
    tre, tim = torch.from_numpy(re).requires_grad_(), torch.from_numpy(im).requires_grad_()
    y = fn(torch.complex(tre, tim), 1, 0.5)
    (y.real * torch.from_numpy(wr) + y.imag * torch.from_numpy(wi)).sum().backward()
    assert_close(tre.grad.numpy(), np.asarray(jg[0]), what="d/dre")
    assert_close(tim.grad.numpy(), np.asarray(jg[1]), what="d/dim")
    assert_no_launches()


def test_reference_is_the_cpu_route(rng):
    x = torch.from_numpy(crand(rng, 2, 128, 6, 5))
    for fn, ref, v in ((cuda_fft.fft_axis0_c64, cuda_fft.fft_axis0_c64_reference,
                        x.reshape(256, 30)),
                       (cuda_fft.fft_axis3_c64, cuda_fft.fft_axis3_c64_reference, x)):
        torch.testing.assert_close(fn(v, 1, 0.5), ref(v, 1, 0.5), rtol=0, atol=0)
    r = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
    torch.testing.assert_close(cuda_fft.rfft_rows_c64(r, 0.5),
                               cuda_fft.rfft_rows_c64_reference(r, 0.5), rtol=0, atol=0)


def test_c64_entries_envelopes_and_arguments_raise():
    for n in (64, 1000, 32768):  # the pow2 kernel only: no composite n here
        with pytest.raises(cuda_fft.Unsupported):
            cuda_fft.fft_axis0_c64(torch.zeros(n, 4, dtype=torch.complex64), -1)
        with pytest.raises(cuda_fft.Unsupported):
            cuda_fft.fft_axis3_c64(torch.zeros(n, 2, 2, dtype=torch.complex64), -1)
        with pytest.raises(cuda_fft.Unsupported):
            cuda_fft.rfft_rows_c64(torch.zeros(2, n))
    with pytest.raises(ValueError, match="complex64"):
        cuda_fft.fft_axis0_c64(torch.zeros(128, 4), -1)
    with pytest.raises(ValueError, match="at least 3 axes"):
        cuda_fft.fft_axis3_c64(torch.zeros(128, 4, dtype=torch.complex64), -1)
    with pytest.raises(ValueError, match="sign"):
        cuda_fft.fft_axis0_c64(torch.zeros(128, 4, dtype=torch.complex64), 0)
    with pytest.raises(ValueError, match="float32"):
        cuda_fft.rfft_rows_c64(torch.zeros(2, 256, dtype=torch.float64))


def test_empty_batch():
    z = torch.zeros(0, 128, 4, dtype=torch.complex64)
    assert cuda_fft.fft_axis0_c64(z, -1).shape == (0, 128, 4)
    assert cuda_fft.rfft_rows_c64(torch.zeros(0, 256)).shape == (0, 129)


# ---------------------------------------------------------------------- #
# the routes: fftn_c64 and rfft's sink against the JAX package
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,axes", [((3, 128, 256), (1, 2)), ((128, 3, 256), (0, 2)),
                                        ((128, 2, 256), (2, 0)), ((128, 128, 3), (0, 1)),
                                        ((2, 128, 128, 128), (1, 2, 3))])
@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_fftn_c64_matches_jax(shape, axes, norm, rng, assert_close):
    # the complex64 route's arithmetic, axis by axis as fftn runs it on the
    # card (axes before -2 through the axis(-3) entry on the free view)
    x = crand(rng, *shape)
    for sign, jfn in ((-1, ftt.fftn), (1, ftt.ifftn)):
        total = int(np.prod([shape[a] for a in axes]))
        got = nd.fftn_c64(torch.from_numpy(x), list(axes), sign,
                          nd._nd_scale(total, sign, norm))
        assert got.dtype == torch.complex64 and got.shape == shape
        assert_close(got.numpy(), np.asarray(jfn(x, axes=axes, norm=norm)),
                     what=f"{axes} sign={sign}")
    assert_no_launches()


def test_grad_through_fftn_c64_matches_jax(rng, assert_close):
    re, im, w = (rng.standard_normal((2, 128, 3, 256)).astype(np.float32) for _ in range(3))

    def jloss(a, b):
        y = ftt.fftn(jax.lax.complex(a, b), axes=(1, 3), norm="ortho")
        return jnp.sum(w * jnp.abs(y) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    tre, tim = torch.from_numpy(re).requires_grad_(), torch.from_numpy(im).requires_grad_()
    y = nd.fftn_c64(torch.complex(tre, tim), [1, 3], -1, (128 * 256) ** -0.5)
    (torch.from_numpy(w) * y.abs() ** 2).sum().backward()
    assert_close(tre.grad.numpy(), np.asarray(jg[0]), what="d/dre")
    assert_close(tim.grad.numpy(), np.asarray(jg[1]), what="d/dim")


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_rfft_sink_matches_jax(norm, rng, assert_close):
    # rfft's complex64 route along an axis: the sink on the moved axis
    x = rng.standard_normal((3, 256, 5)).astype(np.float32)
    scale = rfft._scales(256, norm, inverse=False)
    got = cuda_fft.rfft_rows_c64(torch.from_numpy(x).movedim(1, -1), scale).movedim(-1, 1)
    assert_close(got.numpy(), np.asarray(ftt.rfft(x, axis=1, norm=norm)))


# ---------------------------------------------------------------------- #
# which inputs take the complex64 routes on the card (no card needed)
# ---------------------------------------------------------------------- #
C64 = torch.complex64


@pytest.mark.parametrize("shape,axes,s,dtype,device,executor,takes", [
    ((4096, 4096), [0, 1], None, C64, CUDA, "auto", True),     # fft2, config 4
    ((16384, 128), [1, 0], None, C64, CUDA, "auto", True),     # any order
    ((2, 256, 256), [1, 2], None, C64, CUDA, "auto", False),   # the fused plane
    ((128, 3, 256), [0, 2], None, C64, CUDA, "pallas", True),  # axis 0 on the view
    ((4096, 4096), [0, 1], [4096, 4096], C64, CUDA, "auto", True),
    ((4096, 4096), [0, 1], None, C64, CPU, "auto", False),     # the CPU
    ((4096, 4096), [0, 1], None, torch.complex128, CUDA, "auto", False),
    ((4096, 4096), [0, 1], [2048, 4096], C64, CUDA, "auto", False),  # a trim
    ((1080, 1920), [0, 1], None, C64, CUDA, "auto", False),    # composite axes
    ((64, 4096), [0, 1], None, C64, CUDA, "auto", False),      # below 128
    ((32768, 128), [0, 1], None, C64, CUDA, "auto", False),    # above 16384
    ((8, 256, 256), [1, 2], None, C64, CUDA, "auto", False),   # the fused plane
    ((256, 256, 256), [0, 1, 2], None, C64, CUDA, "auto", False),
    ((4096, 4096), [0, 1], None, C64, CUDA, "xla", False),
    ((4096, 4096), [], None, C64, CUDA, "auto", False),
])
def test_nd_complex64_route_predicate(shape, axes, s, dtype, device, executor, takes):
    s = s if s is not None else [None] * len(axes)
    assert nd._c64_route(shape, dtype, device, s, axes, executor) is takes


def test_rfft_complex64_route_predicate():
    for n in (128, 256, 4096, 16384):
        assert rfft._rfft_c64(CUDA, n) and not rfft._rfft_c64(CPU, n)
    for n in (64, 1000, 4095, 32768):
        assert not rfft._rfft_c64(CUDA, n)


def test_irfft_complex64_route_predicate():
    for n in (128, 256, 4096, 16384):
        assert rfft._irfft_c64(CUDA, n) and not rfft._irfft_c64(CPU, n)
    for n in (64, 1000, 4094, 32768):
        assert not rfft._irfft_c64(CUDA, n)


@pytest.mark.parametrize("shape,axes,s,dtype,device,takes", [
    ((4096, 2049), [1], [None], C64, CUDA, True),            # irfft, config 4
    ((4096, 2049), [1], [4096], C64, CUDA, True),
    ((2049, 7), [0], [None], C64, CUDA, True),               # along axis 0
    ((4096, 8193), [1], [None], C64, CUDA, True),            # n = 16384
    ((4096, 2049), [1], [2048], C64, CUDA, False),           # a trim
    ((4096, 1025), [1], [4096], C64, CUDA, False),           # a pad
    ((4096, 1001), [1], [None], C64, CUDA, False),           # n = 2000
    ((4096, 16385), [1], [None], C64, CUDA, False),          # n = 32768
    ((4096, 2049), [1], [None], C64, CPU, False),            # the CPU
    ((4096, 2049), [1], [None], torch.complex128, CUDA, False),
    ((4096, 2049), [1], [None], torch.float32, CUDA, False),
    ((4096, 2049), [0, 1], [4096, 4096], C64, CUDA, True),   # irfft2, config 4
    ((4096, 2049), [0, 1], [2048, 4096], C64, CUDA, False),  # a trim of axis 0
    ((100, 2049), [0, 1], [None, None], C64, CUDA, False),   # axis 0 below 128
    ((128, 256, 129), [0, 1, 2], [None] * 3, C64, CUDA, True),    # irfftn
    ((129, 256, 256), [1, 2, 0], [None] * 3, C64, CUDA, True),    # the fused plane first
    ((129, 1080, 1920), [1, 2, 0], [None] * 3, C64, CUDA, False),  # composite axes
    ((129, 256, 256), [1, 2, 0], [None] * 3, C64, CPU, False),
])
def test_irfftn_complex64_route_predicate(shape, axes, s, dtype, device, takes):
    assert rfft._irfftn_c64(shape, dtype, device, s, axes) is takes


def test_irfftn_complex64_route_takes_the_plane(rng, assert_close):
    # the leading axes of irfftn over (1, 2, 0) are the trailing plane: the
    # fused plane's complex64 entry goes first (its plain version here)
    shape, axes = (129, 128, 256), [1, 2, 0]
    assert nd._c64_plane(shape, C64, CUDA, [None, None], axes[:-1])
    X = crand(rng, *shape)
    got = rfft._irfftn_c64_run(torch.from_numpy(X), [None] * 3, axes, "ortho")
    assert_close(got.numpy(), np.asarray(ftt.irfftn(X, axes=axes, norm="ortho")))
    assert_no_launches()


def test_ax0_cluster_table_matches_source():
    # the host builds the pass twiddles of n / 2^log2c, so its table of
    # cluster sizes is the kernel's compiled one; both redesigned kernels
    # run mixed_fft.cuh's compiled passes, not stockham.cuh's
    csrc = pathlib.Path(cuda_fft.__file__).parent.parent / "csrc"
    src = (csrc / "ax0_fft.cu").read_text()
    body = re.search(r"int ax0_log2c\(int log2n, int c64\) \{\s*constexpr int t\[2\]\[8\] = "
                     r"\{(.*?)\};", src, re.S)[1]
    rows = [tuple(map(int, r.split(","))) for r in re.findall(r"\{([\d, ]+)\}", body)]
    assert rows == [cuda_fft._AX0_LOG2C[False], cuda_fft._AX0_LOG2C[True]]
    for c64 in (False, True):
        for e in range(7, 15):
            q = (1 << e) >> cuda_fft._ax0_log2c(1 << e, c64)
            assert 64 <= q <= 1 << 14 and cuda_fft._mixed_radix_plan(q)
    for name in ("ax0_fft.cu", "r2c_fft.cu"):
        text = (csrc / name).read_text()
        assert "plan_fft<" in text and "fft_passes" not in text, name


def test_axis0_out_in_place_matches_jax(rng, assert_close):
    # out= (the planar axis(-2) entry's in-place form, the route of
    # Plan(donate=True) on axis -2) against the JAX kernel
    import fft_wgpu_tpu_torch as ft

    x = crand(rng, 2, 256, 37)
    want = cplx(j_pf.fft_axis0_split(np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag),
                                     1, 1.0 / 256, interpret=True))
    re, im = torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())
    out = cuda_fft.fft_axis0_split(re, im, 1, 1.0 / 256, out=(re, im))
    assert out[0] is re and out[1] is im
    assert_close(re.numpy() + 1j * im.numpy(), want)
    re, im = torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())
    got = ft.plan(256, donate=True).inverse_split(re, im, axis=-2)
    assert got[0] is re and got[1] is im
    assert_close(re.numpy() + 1j * im.numpy(), want)
    with pytest.raises(ValueError, match="gradient"):
        cuda_fft.fft_axis0_split(re.requires_grad_(), im, 1, out=(re, im))
    with pytest.raises(ValueError, match="out planes"):
        cuda_fft.fft_axis0_split(torch.zeros(256, 4), torch.zeros(256, 4), 1,
                                 out=(torch.zeros(256, 5), torch.zeros(256, 5)))


# ---------------------------------------------------------------------- #
# B5: the fused plane's complex64 entry and the plain version of its own
# passes and exchange, and the complex64 plane route of fftn
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(2, 128, 128), (128, 256), (256, 128), (512, 128),
                                   (128, 512), (256, 256)])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("scaled", [False, True])
def test_fft2_fused_c64_matches_jax_kernel(shape, sign, scaled, rng, assert_close):
    x = crand(rng, *shape)
    A, B = shape[-2:]
    scale = 1.0 / (A * B) if scaled else None
    want = cplx(j_pf.fft2_fused_split(np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag),
                                      sign, scale, interpret=True))
    got = cuda_fft.fft2_fused_c64(torch.from_numpy(x), sign, scale)
    assert got.dtype == torch.complex64 and got.shape == shape
    assert_close(got.numpy(), want, what="entry")
    assert_close(cuda_fft._fft2f_passes(torch.from_numpy(x), sign, scale).numpy(), want,
                 what="the kernel's passes")
    assert_no_launches()


def test_fft2_fused_c64_grad_matches_jax(rng, assert_close):
    re, im, wr, wi = (rng.standard_normal((2, 128, 256)).astype(np.float32) for _ in range(4))
    jg = _jax_grad(lambda a, b: j_pf.fft2_fused_split(a, b, 1, 0.5, interpret=True),
                   re, im, wr, wi)
    tre, tim = torch.from_numpy(re).requires_grad_(), torch.from_numpy(im).requires_grad_()
    y = cuda_fft.fft2_fused_c64(torch.complex(tre, tim), 1, 0.5)
    (y.real * torch.from_numpy(wr) + y.imag * torch.from_numpy(wi)).sum().backward()
    assert_close(tre.grad.numpy(), np.asarray(jg[0]), what="d/dre")
    assert_close(tim.grad.numpy(), np.asarray(jg[1]), what="d/dim")
    assert_no_launches()


def test_fft2f_block_size_matches_source():
    # the host passes the cluster size of each plane, A*B >> _FFT2F_LOG2P,
    # which the kernel checks against its compiled block size; the kernel
    # runs the compiled plans of A and B (plan_fft), whose pass roots the
    # host builds
    csrc = pathlib.Path(cuda_fft.__file__).parent.parent / "csrc"
    src = (csrc / "fft2f_fft.cu").read_text()
    assert int(re.search(r"constexpr int kFft2fLog2P = (\d+);", src)[1]) == cuda_fft._FFT2F_LOG2P
    assert "plan_fft<" in src and "fft_passes" not in src
    for a in range(7, 10):
        for b in range(7, 10):
            if cuda_fft._fft2f_supported(1 << a, 1 << b):
                assert 2 <= 1 << (a + b - cuda_fft._FFT2F_LOG2P) <= 16, (a, b)


@pytest.mark.parametrize("shape,axes", [((4, 128, 256), (1, 2)), ((3, 2, 128, 128), (2, 3)),
                                        ((128, 2, 128, 128), (0, 2, 3))])
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_fftn_c64_plane_matches_jax(shape, axes, norm, rng, assert_close):
    # the complex64 plane route's arithmetic as fftn runs it on the card:
    # the fused plane's complex64 entry over the trailing plane, then the
    # axes before it through the axis(-3) entry
    x = crand(rng, *shape)
    ax = list(axes)
    total = int(np.prod([shape[a] for a in ax]))
    for sign, jfn in ((-1, ftt.fftn), (1, ftt.ifftn)):
        got = nd.fftn_c64(torch.from_numpy(x), ax, sign, nd._nd_scale(total, sign, norm),
                          plane=True)
        assert got.dtype == torch.complex64 and got.shape == shape
        assert_close(got.numpy(), np.asarray(jfn(x, axes=axes, norm=norm)), what=f"sign={sign}")
    assert_no_launches()


@pytest.mark.parametrize("shape,axes,dtype,device,takes", [
    ((1, 128, 128), [1, 2], C64, CUDA, True),        # a single plane
    ((2, 256, 256), [2, 1], C64, CUDA, True),        # any order
    ((256, 512, 128), [1, 2], C64, CUDA, True),
    ((128, 256, 256), [0, 1, 2], C64, CUDA, True),   # fftn: the plane, then axis -3
    ((128, 256, 256), [0, 1, 2], torch.complex128, CUDA, False),
    ((128, 256, 256), [0, 1, 2], C64, CPU, False),
    ((4, 256, 256), [0, 1, 2], C64, CUDA, False),    # axis 0 outside the complex64 kernels
    ((2, 512, 256), [1, 2], C64, CUDA, False),       # outside the fused envelope
    ((256, 256, 256), [0, 2], C64, CUDA, False),     # not the trailing plane
])
def test_nd_complex64_plane_predicate(shape, axes, dtype, device, takes):
    # a complex64 CUDA tensor's trailing plane in the fused envelope takes
    # the fused plane's complex64 entry at every plane count (the measured
    # route, PERF.md), then the complex64 entries for the axes before it;
    # the per-axis complex64 route takes the other complex64 shapes
    s = [None] * len(axes)
    assert nd._c64_plane(shape, dtype, device, s, axes) is takes
    if takes:
        assert not nd._c64_route(shape, dtype, device, s, axes)
