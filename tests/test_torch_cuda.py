"""Torch port on the card: each CUDA kernel against its plain version.

rows_fft (B1), ax0_fft (B2), rows_t_fft (B4) and big_fft (B15), values,
launch counts and gradients, and the plan's routes through them.

Every test here needs a CUDA device and skips without one.  The card's
machine has no jax, so run them without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: 1e-5 relative L2, with TF32 off for the plain version's matmuls.
"""

import numpy as np
import pytest
import torch

import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.ops import bigfft, cuda_fft, stockham

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
    before = bigfft.launches, cuda_fft.launches
    x = crand(dev, 1, 1 << 15)  # the whole-row kernel, one launch
    assert rel_l2(ft.fft(x), torch.fft.fft(x)) < TOL
    assert (bigfft.launches, cuda_fft.launches) == (before[0] + 1, before[1])
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


def _grad(*shape, seed=1):
    rng = np.random.default_rng(seed)
    a, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
            for _ in range(2))

    def run(f):
        re, im = a.clone().requires_grad_(), b.clone().requires_grad_()
        yr, yi = f(re, im)
        w = torch.linspace(0.5, 1.5, yr.numel(), device=yr.device).reshape(yr.shape)
        (w * (yr * yr + yi * yi)).sum().backward()
        return torch.complex(re.grad, im.grad)

    return run


@pytest.mark.parametrize("n", [1 << e for e in range(7, 15)])
@pytest.mark.parametrize("lead,m", [((), 7), ((2,), 1000)])
def test_axis0_kernel_matches_plain_and_torch_fft(dev, n, lead, m):
    x = crand(dev, *lead, n, m)
    re, im = x.real.contiguous(), x.imag.contiguous()
    for sign, scale in ((-1, None), (1, 1.0 / n)):
        before = cuda_fft.ax0_launches
        k = torch.complex(*cuda_fft.fft_axis0_split(re, im, sign, scale))
        assert cuda_fft.ax0_launches == before + 1
        p = torch.complex(*cuda_fft.fft_axis0_split_reference(re, im, sign, scale))
        o = torch.fft.fft(x, dim=-2) if sign < 0 else torch.fft.ifft(x, dim=-2)
        assert rel_l2(k, p) < TOL and rel_l2(k, o) < TOL, (sign, scale)


@pytest.mark.parametrize("n", [1 << e for e in range(7, 15)])
@pytest.mark.parametrize("rows", [1, 200])
@pytest.mark.parametrize("with_outer", [False, True])
def test_rows_transposed_kernel_matches_plain(dev, n, rows, with_outer):
    outer = (rows, rows * n) if with_outer else None
    x = crand(dev, rows, n)
    re, im = x.real.contiguous(), x.imag.contiguous()
    for sign, scale in ((-1, None), (1, 1.0 / n)):
        before = cuda_fft.rows_t_launches
        k = torch.complex(*cuda_fft.fft_rows_transposed_split(re, im, sign, scale,
                                                              outer=outer))
        assert cuda_fft.rows_t_launches == before + 1
        assert k.shape == (n, rows)
        p = torch.complex(*cuda_fft.fft_rows_transposed_split_reference(
            re, im, sign, scale, outer=outer))
        assert rel_l2(k, p) < TOL, (sign, scale)


@pytest.mark.parametrize("e", [15, 16, 17, 18])
@pytest.mark.parametrize("rows", [1, 3])
def test_bigfft_kernel_matches_plain_and_torch_fft(dev, e, rows):
    n = 1 << e
    x = crand(dev, rows, n)
    re, im = x.real.contiguous(), x.imag.contiguous()
    for sign, scale in ((-1, None), (1, 1.0 / n)):
        before = bigfft.launches
        k = torch.complex(*bigfft.fft_big_split(re, im, sign, scale))
        assert bigfft.launches == before + 1
        p = torch.complex(*bigfft.fft_big_split_reference(re, im, sign, scale))
        o = torch.fft.fft(x) if sign < 0 else torch.fft.ifft(x)
        assert rel_l2(k, p) < TOL and rel_l2(k, o) < TOL, (sign, scale)


@pytest.mark.parametrize("rows,n,route", [(2, 1 << 15, "big"), (256, 1 << 16, "big"),
                                          (1, 1 << 19, "two_pass"),
                                          (1, 1 << 22, "two_pass")])
def test_large_n_routes(dev, rows, n, route):
    x = crand(dev, rows, n)
    counts = lambda: (cuda_fft.launches, cuda_fft.ax0_launches,  # noqa: E731
                      cuda_fft.rows_t_launches, bigfft.launches)
    before = counts()
    p = ft.plan(n)
    X = p.forward(x)
    after = counts()
    delta = tuple(a - b for a, b in zip(after, before))
    assert delta == ((0, 0, 0, 1) if route == "big" else (0, 1, 1, 0))
    assert rel_l2(X, torch.fft.fft(x)) < TOL
    assert rel_l2(p.inverse(X), x) < TOL
    assert rel_l2(p.normalize(p.inverse_unnormalized(X)), x) < TOL


def test_axis0_route_through_plan(dev):
    x = crand(dev, 4096, 64)
    before = cuda_fft.ax0_launches, cuda_fft.launches
    y = ft.plan(4096).forward(x, axis=0)
    assert (cuda_fft.ax0_launches, cuda_fft.launches) == (before[0] + 1, before[1])
    assert rel_l2(y, torch.fft.fft(x, dim=0)) < TOL


def test_bigfft_executor_outside_envelope_raises(dev):
    with pytest.raises(bigfft.Unsupported):
        ft.fft(crand(dev, 1, 1 << 19), executor="bigfft")


def test_donate_on_bigfft_route(dev):
    x = crand(dev, 4, 1 << 16)
    re, im = x.real.contiguous(), x.imag.contiguous()
    before = bigfft.launches
    out = ft.plan(1 << 16, donate=True).forward_split(re, im)
    assert out[0] is re and out[1] is im
    assert bigfft.launches == before + 1
    assert rel_l2(torch.complex(re, im), torch.fft.fft(x)) < TOL


def test_grad_axis0_matches_plain(dev):
    run = _grad(2, 1024, 130)
    for sign, scale in ((-1, None), (1, 1.0 / 1024)):
        before = cuda_fft.ax0_launches
        gk = run(lambda r, i: cuda_fft.fft_axis0_split(r, i, sign, scale))
        assert cuda_fft.ax0_launches == before + 2  # forward and backward
        gp = run(lambda r, i: cuda_fft.fft_axis0_split_reference(r, i, sign, scale))
        assert rel_l2(gk, gp) < TOL


@pytest.mark.parametrize("outer", [None, (64, 64 * 4096)])
def test_grad_rows_transposed_matches_plain(dev, outer):
    run = _grad(64, 4096)
    before = cuda_fft.rows_t_launches, cuda_fft.launches
    gk = run(lambda r, i: cuda_fft.fft_rows_transposed_split(r, i, -1, outer=outer))
    # the forward is the transposed-rows kernel, the backward the row kernel
    assert (cuda_fft.rows_t_launches, cuda_fft.launches) == (before[0] + 1, before[1] + 1)
    gp = run(lambda r, i: cuda_fft.fft_rows_transposed_split_reference(
        r, i, -1, outer=outer))
    assert rel_l2(gk, gp) < TOL


def test_grad_bigfft_matches_plain(dev):
    run = _grad(2, 1 << 16)
    before = bigfft.launches
    gk = run(lambda r, i: bigfft.fft_big_split(r, i, 1, 2.0 ** -16))
    assert bigfft.launches == before + 2
    gp = run(lambda r, i: bigfft.fft_big_split_reference(r, i, 1, 2.0 ** -16))
    assert rel_l2(gk, gp) < TOL


def test_grad_through_fourstep_matches_plain(dev):
    run = _grad(2, 1 << 20)
    gk = run(lambda r, i: (lambda y: (y.real, y.imag))(ft.fft(torch.complex(r, i))))
    gp = run(lambda r, i: stockham.fft_last_axis(r, i, -1))
    assert rel_l2(gk, gp) < TOL
