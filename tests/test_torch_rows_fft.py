"""Torch port, B1 row kernel entry point (ops/cuda_fft.py) on the CPU.

On a CPU tensor ``fft_batched_split`` runs its plain version (the port's
mixed-radix path plus the scale).  It is held against the JAX package's
Pallas kernel ``pallas_fft.fft_batched_split`` run in interpret mode, as
``tests/test_pallas.py`` runs it, values and gradient.  The kernel itself
needs the card: ``tests/test_torch_cuda.py``.  Tolerance: 1e-5 relative L2.

The complex64 entry ``fft_batched_c64`` (the plan's route for a complex64
CUDA tensor, with no split and no merge) runs the same plain version on a
CPU tensor; it is held against the JAX package's plan modes and
``fft``/``ifft`` norms, and its gradient against ``jax.grad`` of the JAX
kernel.

The JAX kernel's interpret-mode cost is its compile, per shape and constant,
so each JAX call stacks the row shapes of one (n, sign, scale) case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_wgpu_tpu as ftt
from fft_wgpu_tpu.ops import pallas_fft as j_pf
from fft_wgpu_tpu_torch.ops import cuda_fft, transforms

torch.set_num_threads(1)

SHAPES = [(1,), (5,), (2, 3)]


def _scales(n):
    return {"none": None, "inv_n": 1.0 / n, "ortho": n ** -0.5}


CASES = [(n, sign, sc) for n in (128, 256, 512, 1024)
         for sign in (-1, 1) for sc in ("none", "inv_n", "ortho")]
CASES += [(4096, -1, "none")]  # one case: its interpret compile dominates the file


@pytest.mark.parametrize("n,sign,sc", CASES)
def test_matches_jax_kernel(n, sign, sc, rng, assert_close):
    scale = _scales(n)[sc]
    xs = [(rng.standard_normal(s + (n,)).astype(np.float32),
           rng.standard_normal(s + (n,)).astype(np.float32)) for s in SHAPES]
    stacked = [np.concatenate([x[i].reshape(-1, n) for x in xs]) for i in (0, 1)]
    jr, ji = j_pf.fft_batched_split(*stacked, sign, scale, interpret=True)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    start = 0
    for shape, (re, im) in zip(SHAPES, xs):
        yr, yi = cuda_fft.fft_batched_split(torch.from_numpy(re),
                                            torch.from_numpy(im), sign, scale)
        assert yr.shape == shape + (n,) and yr.dtype == torch.float32
        rows = int(np.prod(shape))
        got = (yr.numpy() + 1j * yi.numpy()).reshape(rows, n)
        assert_close(got, want[start:start + rows], what=f"shape {shape}")
        start += rows
    assert cuda_fft.launches == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("n", [64, 32768, 120, 640])
def test_unsupported_shapes_raise(n):
    z = np.zeros((2, n), np.float32)
    with pytest.raises(j_pf.Unsupported):
        j_pf.fft_batched_split(z, z, -1, interpret=True)
    t = torch.from_numpy(z)
    with pytest.raises(cuda_fft.Unsupported):
        cuda_fft.fft_batched_split(t, t, -1)
    with pytest.raises(cuda_fft.Unsupported):
        cuda_fft.fft_batched_split_reference(t, t, -1)


def test_envelope_matches_jax():
    assert (cuda_fft.FUSED_MIN_N, cuda_fft.FUSED_MAX_N) == (j_pf.FUSED_MIN_N,
                                                           j_pf.FUSED_MAX_N)
    for n in range(1, 40000, 7):
        assert cuda_fft._supported(n) == j_pf._supported(n), n
    for e in range(20):
        assert cuda_fft._supported(1 << e) == j_pf._supported(1 << e)


@pytest.mark.parametrize("sign,sc", [(-1, "none"), (1, "inv_n")])
def test_grad_matches_jax_kernel(sign, sc, rng, assert_close):
    # d/dx of sum(w * |y|^2), y = kernel(x): torch.autograd through the
    # sign-flipped backward against jax.grad through the JAX kernel's
    # linear_call transpose (tests/test_ad.py runs the same kernel)
    n = 1024
    scale = _scales(n)[sc]
    re, im, w = (rng.standard_normal((4, n)).astype(np.float32) for _ in range(3))

    def jloss(a, b):
        yr, yi = j_pf.fft_batched_split(a, b, sign, scale, interpret=True)
        return jnp.sum(w * (yr * yr + yi * yi))

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    tre = torch.from_numpy(re).requires_grad_()
    tim = torch.from_numpy(im).requires_grad_()
    yr, yi = cuda_fft.fft_batched_split(tre, tim, sign, scale)
    (torch.from_numpy(w) * (yr * yr + yi * yi)).sum().backward()
    assert_close(tre.grad.numpy(), np.asarray(jg[0]), what="d/dre")
    assert_close(tim.grad.numpy(), np.asarray(jg[1]), what="d/dim")
    assert cuda_fft.launches == 0


def test_out_writes_in_place(rng, assert_close):
    n = 256
    re = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    want = np.fft.fft(re.numpy() + 1j * im.numpy())
    out = cuda_fft.fft_batched_split(re, im, -1, out=(re, im))
    assert out[0] is re and out[1] is im
    assert_close(re.numpy() + 1j * im.numpy(), want)
    g = torch.zeros(2, n, requires_grad=True)
    with pytest.raises(ValueError, match="in place"):
        cuda_fft.fft_batched_split(g, g.detach(), -1, out=(g.detach(), g.detach()))


def test_bad_arguments_raise():
    z = torch.zeros(2, 256)
    with pytest.raises(ValueError, match="sign"):
        cuda_fft.fft_batched_split(z, z, 2)
    with pytest.raises(ValueError, match="float32"):
        cuda_fft.fft_batched_split(z, z.double(), -1)
    with pytest.raises(ValueError, match="float32"):
        cuda_fft.fft_batched_split(z, torch.zeros(3, 256), -1)
    meta = torch.zeros(2, 256, device="meta")
    with pytest.raises(ValueError, match="device"):
        cuda_fft.fft_batched_split(meta, meta, -1)


def test_empty_batch():
    z = torch.zeros(0, 512)
    yr, yi = cuda_fft.fft_batched_split(z, z, -1)
    assert yr.shape == (0, 512) and yi.shape == (0, 512)


def _crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


MODES = {"forward": (-1, lambda n: None), "inverse": (1, lambda n: 1.0 / n),
         "inverse_unnormalized": (1, lambda n: None)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n", [128, 1024, 4096])
def test_c64_entry_matches_jax_plan(n, mode, rng, assert_close):
    x = _crand(rng, 2, 3, n)
    sign, scale = MODES[mode]
    got = cuda_fft.fft_batched_c64(torch.from_numpy(x), sign, scale(n))
    assert got.dtype == torch.complex64 and got.shape == x.shape
    assert_close(got.numpy(), np.asarray(getattr(ftt.plan(n), mode)(x)), what=mode)
    assert cuda_fft.launches == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
@pytest.mark.parametrize("fn", ["fft", "ifft"])
def test_c64_entry_norms_match_jax(fn, norm, rng, assert_close):
    n = 1024
    x = _crand(rng, 4, n)
    fscale, iscale = transforms._norm_scales(n, norm)
    sign, scale = (-1, fscale) if fn == "fft" else (1, iscale)
    got = cuda_fft.fft_batched_c64(torch.from_numpy(x), sign, scale)
    assert_close(got.numpy(), np.asarray(getattr(ftt, fn)(x, norm=norm)))


@pytest.mark.parametrize("sign,sc", [(-1, "none"), (1, "inv_n")])
def test_c64_grad_matches_jax_kernel(sign, sc, rng, assert_close):
    # d/dx of sum(w * |y|^2) for complex x: torch's gradient of a complex
    # input is d/dre + i d/dim, against jax.grad through the JAX kernel
    n = 512
    scale = _scales(n)[sc]
    re, im, w = (rng.standard_normal((3, n)).astype(np.float32) for _ in range(3))

    def jloss(a, b):
        yr, yi = j_pf.fft_batched_split(a, b, sign, scale, interpret=True)
        return jnp.sum(w * (yr * yr + yi * yi))

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    x = torch.from_numpy(re + 1j * im).to(torch.complex64).requires_grad_()
    y = cuda_fft.fft_batched_c64(x, sign, scale)
    (torch.from_numpy(w) * y.abs() ** 2).sum().backward()
    assert_close(x.grad.numpy(), np.asarray(jg[0]) + 1j * np.asarray(jg[1]))
    assert cuda_fft.launches == 0


def test_c64_input_layouts(rng, assert_close):
    # a non-contiguous input is copied, a conjugate view read as its values
    n = 256
    x = _crand(rng, 3, n)
    want = np.fft.fft(x)
    xt = torch.from_numpy(np.ascontiguousarray(x.T)).T
    assert_close(cuda_fft.fft_batched_c64(xt, -1).numpy(), want)
    xc = torch.from_numpy(x.conj().copy()).conj()
    assert_close(cuda_fft.fft_batched_c64(xc, -1).numpy(), want)


def test_c64_bad_arguments_raise():
    with pytest.raises(ValueError, match="complex64"):
        cuda_fft.fft_batched_c64(torch.zeros(2, 256), -1)
    with pytest.raises(ValueError, match="complex64"):
        cuda_fft.fft_batched_c64(torch.zeros(2, 256, dtype=torch.complex128), -1)
    with pytest.raises(ValueError, match="sign"):
        cuda_fft.fft_batched_c64(torch.zeros(2, 256, dtype=torch.complex64), 0)
    with pytest.raises(cuda_fft.Unsupported):
        cuda_fft.fft_batched_c64(torch.zeros(2, 100, dtype=torch.complex64), -1)
