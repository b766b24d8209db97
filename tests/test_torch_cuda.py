"""Torch port on the card: the rows_fft CUDA kernel against its plain version.

Every test here needs a CUDA device and skips without one.  The card's
machine has no jax, so run them without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: 1e-5 relative L2, with TF32 off for the plain version's matmuls.
"""

import numpy as np
import pytest
import torch

import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.ops import cuda_fft

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def rel_l2(got, want) -> float:
    got, want = got.to(torch.complex128), want.to(torch.complex128)
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def crand(dev, *shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(x.astype(np.complex64)).to(dev)


@pytest.mark.parametrize("n", [1 << e for e in range(7, 15)])
@pytest.mark.parametrize("rows", [(1,), (37,), (2, 3)])
def test_kernel_matches_plain_and_torch_fft(dev, n, rows):
    x = crand(dev, *rows, n)
    re, im = x.real.contiguous(), x.imag.contiguous()
    for sign in (-1, 1):
        for scale in (None, 1.0 / n, n ** -0.5):
            before = cuda_fft.launches
            kr, ki = cuda_fft.fft_batched_split(re, im, sign, scale)
            assert cuda_fft.launches == before + 1
            k = torch.complex(kr, ki)
            p = torch.complex(*cuda_fft.fft_batched_split_reference(re, im, sign, scale))
            o = torch.fft.fft(x) if sign < 0 else torch.fft.ifft(x, norm="forward")
            o = o * (1.0 if scale is None else scale)
            assert rel_l2(k, p) < TOL and rel_l2(k, o) < TOL, (sign, scale)


def test_plan_routes_through_kernel(dev):
    x = crand(dev, 1, 1024)  # one row: no small-batch redirect on the card
    before = cuda_fft.launches
    y = ft.fft(x)
    assert cuda_fft.launches == before + 1
    assert rel_l2(y.cpu(), torch.from_numpy(ft.naive_dft(x.cpu().numpy()))) < TOL
    before = cuda_fft.launches
    x = crand(dev, 4, 1000)
    assert rel_l2(ft.fft(x), torch.fft.fft(x)) < TOL  # stockham on the card
    assert cuda_fft.launches == before
    with pytest.raises(NotImplementedError, match="slice 3"):
        ft.fft(crand(dev, 1, 1 << 15))
    with pytest.raises(NotImplementedError, match="autotune"):
        ft.plan(1024, autotune=True).forward(torch.zeros(2, 1024, device=dev))


def test_donate_runs_in_place_on_kernel(dev):
    x = crand(dev, 64, 4096)
    re, im = x.real.contiguous(), x.imag.contiguous()
    ptrs = (re.data_ptr(), im.data_ptr())
    before = cuda_fft.launches
    out = ft.plan(4096, donate=True).forward_split(re, im)
    assert out[0] is re and out[1] is im and (re.data_ptr(), im.data_ptr()) == ptrs
    assert cuda_fft.launches == before + 1
    assert rel_l2(torch.complex(re, im), torch.fft.fft(x)) < TOL


def test_grad_matches_plain(dev):
    rng = np.random.default_rng(1)
    a, b, w = (torch.from_numpy(rng.standard_normal((8, 2048)).astype(np.float32)).to(dev)
               for _ in range(3))

    def grad(fn):
        re, im = a.clone().requires_grad_(), b.clone().requires_grad_()
        yr, yi = fn(re, im)
        (w * (yr * yr + yi * yi)).sum().backward()
        return torch.complex(re.grad, im.grad)

    for sign, scale in ((-1, None), (1, 1.0 / 2048)):
        before = cuda_fft.launches
        gk = grad(lambda r, i: cuda_fft.fft_batched_split(r, i, sign, scale))
        assert cuda_fft.launches == before + 2  # forward and backward kernels
        gp = grad(lambda r, i: cuda_fft.fft_batched_split_reference(r, i, sign, scale))
        assert rel_l2(gk, gp) < TOL
