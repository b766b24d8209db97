"""Torch port on the card: each CUDA kernel against its plain version.

rows_fft (B1), ax0_fft (B2, and B3 on the axis(-3) view), rows_t_fft (B4),
fft2f_fft (B5), r2c_fft (B6), c2r_fft (B7, from planes and from complex64),
big_fft (B15), gen_fft (B13),
r2c_gen_fft (B14), chirp_fft (B11, B12, and the two fused: chirp_full),
filt_fft (B9, B10), the product
form of c2r_fft (B8), ax0_gen_fft (B2's composite range), welch_acc_fft
(B16, B17, B18, B21), spec_fft (B19, B20) and spec_c2c_fft (B22): values,
launch counts and gradients,
and the routes of the plan, the N-D, the real and the non-pow2 transforms,
the fused epilogues, the spectral estimators and the per-segment spectra
(stft, istft, ShortTimeFFT, resample) through them.  No call may move the
thread's current device or the caller's TF32 setting.

Every test here needs a CUDA device and skips without one.  The card's
machine has no jax, so run them without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: 1e-5 relative L2, with TF32 off for the plain version's matmuls.
"""

import math

import numpy as np
import pytest
import torch

import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.ops import bigfft, cuda_fft, cuda_welch, stockham

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


def _planes(fn):
    """fn(re, im, sign, scale) of a planar entry as fn(x, sign, scale) on a
    complex64 x's planes."""
    return lambda x, sign, scale: torch.complex(
        *fn(x.real.contiguous(), x.imag.contiguous(), sign, scale))


def _rows_entry(layout):
    """B1 in one of its two device layouts and its plain version, each as
    fn(x, sign, scale) on a complex64 x: the planar entry on x's planes, or
    the interleaved entry on x as it lies."""
    if layout == "c64":
        return cuda_fft.fft_batched_c64, cuda_fft.fft_batched_c64_reference
    return _planes(cuda_fft.fft_batched_split), _planes(cuda_fft.fft_batched_split_reference)


def _big_entry(layout):
    """B15's two layouts, as :func:`_rows_entry`."""
    if layout == "c64":
        return bigfft.fft_big_c64, bigfft.fft_big_c64_reference
    return _planes(bigfft.fft_big_split), _planes(bigfft.fft_big_split_reference)


@pytest.mark.parametrize("layout", ["planar", "c64"])
@pytest.mark.parametrize("n", [1 << e for e in range(7, 15)])
@pytest.mark.parametrize("rows", [(1,), (37,), (2, 3)])
def test_kernel_matches_plain_and_torch_fft(dev, n, rows, layout):
    x = crand(dev, *rows, n)
    kernel, plain = _rows_entry(layout)
    for sign in (-1, 1):
        for scale in (None, 1.0 / n, n ** -0.5):
            before = cuda_fft.launches
            k = kernel(x, sign, scale)
            assert cuda_fft.launches == before + 1
            p = plain(x, sign, scale)
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


@pytest.mark.parametrize("layout", ["planar", "c64"])
def test_donate_runs_in_place_on_kernel(dev, layout):
    x = crand(dev, 64, 4096)
    p = ft.plan(4096, donate=True)
    before = cuda_fft.launches
    if layout == "planar":
        re, im = x.real.contiguous(), x.imag.contiguous()
        ptrs = (re.data_ptr(), im.data_ptr())
        out = p.forward_split(re, im)
        assert out[0] is re and out[1] is im and (re.data_ptr(), im.data_ptr()) == ptrs
        assert rel_l2(torch.complex(re, im), torch.fft.fft(x)) < TOL
    else:
        # donate concerns the split forms: forward of complex64 leaves x as
        # it is; the interleaved entry's kernel runs in place with out=x
        x0 = x.clone()
        assert rel_l2(p.forward(x), torch.fft.fft(x0)) < TOL and torch.equal(x, x0)
        assert cuda_fft._launch_c64(x, -1, None, out=x) is x
        assert rel_l2(x, torch.fft.fft(x0)) < TOL
    assert cuda_fft.launches == before + 1 + (layout == "c64")


def _grad_c64(fn, x, w):
    """d/dx of sum(w * |fn(x)|^2) for complex x (d/dre + i d/dim)."""
    x = x.clone().requires_grad_()
    (w * fn(x).abs() ** 2).sum().backward()
    return x.grad


@pytest.mark.parametrize("layout", ["planar", "c64"])
def test_grad_matches_plain(dev, layout):
    x = crand(dev, 8, 2048, seed=1)
    w = torch.linspace(0.5, 1.5, x.numel(), device=dev).reshape(x.shape)
    kernel, plain = _rows_entry(layout)
    for sign, scale in ((-1, None), (1, 1.0 / 2048)):
        before = cuda_fft.launches
        gk = _grad_c64(lambda z: kernel(z, sign, scale), x, w)
        assert cuda_fft.launches == before + 2  # forward and backward kernels
        gp = _grad_c64(lambda z: plain(z, sign, scale), x, w)
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


def _outer_oracle(x, sign, scale, outer):
    """transpose(fft(x * w)) in float64, w = exp(sign*2pi*i*((r*m) mod
    outer_n)/outer_n) at the exact index."""
    x = x.to(torch.complex128)
    if outer is not None:
        rows, n = x.shape[-2:]
        r = torch.arange(rows, device=x.device, dtype=torch.int64)[:, None]
        m = torch.arange(n, device=x.device, dtype=torch.int64)[None, :]
        ang = (sign * 2 * np.pi / outer[1]) * ((r * m) % outer[1]).double()
        x = x * torch.polar(torch.ones_like(ang), ang)
    y = torch.fft.fft(x) if sign < 0 else torch.fft.ifft(x, norm="forward")
    return (y * (1.0 if scale is None else scale)).transpose(-1, -2)


@pytest.mark.parametrize("n", [1 << e for e in range(7, 15)])
@pytest.mark.parametrize("rows", [1, 7, 200, 1024])
@pytest.mark.parametrize("with_outer", [None, "pow2", "non-pow2", "wide"])
def test_rows_transposed_kernel_matches_plain(dev, n, rows, with_outer):
    # no twiddle, the four-step's pow2 outer_n = rows*n, 3*2^12, and one
    # past 2^31, where the kernel carries the exponent in 64 bits
    outer = {None: None, "pow2": (rows, rows * n), "non-pow2": (rows, 3 << 12),
             "wide": (rows, (1 << 31) + 11)}[with_outer]
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
        assert rel_l2(k, _outer_oracle(x, sign, scale, outer)) < TOL, (sign, scale)


@pytest.mark.parametrize("layout", ["planar", "c64"])
@pytest.mark.parametrize("e", [15, 16, 17, 18])
@pytest.mark.parametrize("rows", [1, 3])
def test_bigfft_kernel_matches_plain_and_torch_fft(dev, e, rows, layout):
    n = 1 << e
    x = crand(dev, rows, n)
    kernel, plain = _big_entry(layout)
    for sign, scale in ((-1, None), (1, 1.0 / n)):
        before = bigfft.launches
        k = kernel(x, sign, scale)
        assert bigfft.launches == before + 1
        p = plain(x, sign, scale)
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


@pytest.mark.parametrize("layout", ["planar", "c64"])
def test_donate_on_bigfft_route(dev, layout):
    x = crand(dev, 4, 1 << 16)
    p = ft.plan(1 << 16, donate=True)
    before = bigfft.launches
    if layout == "planar":
        re, im = x.real.contiguous(), x.imag.contiguous()
        out = p.forward_split(re, im)
        assert out[0] is re and out[1] is im
        assert rel_l2(torch.complex(re, im), torch.fft.fft(x)) < TOL
    else:  # donate concerns the split forms: x stays as it is
        x0 = x.clone()
        assert rel_l2(p.forward(x), torch.fft.fft(x0)) < TOL and torch.equal(x, x0)
    assert bigfft.launches == before + 1


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


@pytest.mark.parametrize("layout", ["planar", "c64"])
def test_grad_bigfft_matches_plain(dev, layout):
    x = crand(dev, 2, 1 << 16, seed=1)
    w = torch.linspace(0.5, 1.5, x.numel(), device=dev).reshape(x.shape)
    kernel, plain = _big_entry(layout)
    before = bigfft.launches
    gk = _grad_c64(lambda z: kernel(z, 1, 2.0 ** -16), x, w)
    assert bigfft.launches == before + 2
    gp = _grad_c64(lambda z: plain(z, 1, 2.0 ** -16), x, w)
    assert rel_l2(gk, gp) < TOL


def _device_kernels(fn, calls=1, per_call=1):
    """The names of the device kernels ``calls`` calls of fn() run
    (torch.profiler), after one warm-up step of the profiler (a call traced
    and dropped, as chip_smoke.py's breakdown() does: on the card a window
    that starts the trace has been seen to come back without device events,
    or with some of them missing).  A window with fewer than ``per_call``
    device events a call is taken again, as chip_smoke.py's alone() does
    (at most five, every other one without the schedule: three scheduled
    windows in a row have come back empty); count launches with the
    wrappers' counters, not from here."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    names = []
    for attempt in range(5):
        plan = schedule(wait=0, warmup=1, active=1, repeat=1) if attempt % 2 == 0 else None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=plan) as prof:
            if plan is not None:
                fn()
                torch.cuda.synchronize()
                prof.step()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            if plan is not None:
                prof.step()
        # the schedule's step marker has a device row of its own
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith("ProfilerStep")]
        if len(names) >= calls * per_call:
            return names
    return names


@pytest.mark.parametrize("n,kernel", [(4096, "rows_fft_kernel"), (128, "rows_fft_kernel"),
                                      (1 << 16, "big_fft_kernel")])
def test_complex64_route_is_one_launch(dev, n, kernel):
    # a complex64 CUDA tensor along its last axis: the interleaved entry, one
    # launch and no other device work (no split, no merge) in every mode of
    # the plan, the functional API and the parity classes
    x = crand(dev, 16, n)
    p = ft.plan(n)
    calls = {"forward": (lambda: p.forward(x), torch.fft.fft(x)),
             "inverse": (lambda: p.inverse(x), torch.fft.ifft(x)),
             "inverse_unnormalized": (lambda: p.inverse_unnormalized(x),
                                      torch.fft.ifft(x, norm="forward")),
             "fft": (lambda: ft.fft(x, norm="ortho"), torch.fft.fft(x, norm="ortho")),
             "ifft": (lambda: ft.ifft(x), torch.fft.ifft(x)),
             "Inverse": (lambda: ft.Inverse(n).proc(x), torch.fft.ifft(x))}
    launches = lambda: (bigfft if kernel == "big_fft_kernel" else cuda_fft).c64_launches  # noqa: E731
    for name, (call, want) in calls.items():
        names = _device_kernels(call, calls=10)
        assert names and all(kernel in k for k in names), (name, names)
        before = launches()
        assert rel_l2(call(), want) < TOL, name
        assert launches() == before + 1, name
    # the split forms keep the planar path: copies of the planes beside it
    names = _device_kernels(lambda: p.forward_split(x.real, x.imag), calls=10)
    assert any(kernel in k for k in names) and any(kernel not in k for k in names)


def test_grad_through_fourstep_matches_plain(dev):
    run = _grad(2, 1 << 20)
    gk = run(lambda r, i: (lambda y: (y.real, y.imag))(ft.fft(torch.complex(r, i))))
    gp = run(lambda r, i: stockham.fft_last_axis(r, i, -1))
    assert rel_l2(gk, gp) < TOL


# ---------------------------------------------------------------------- #
# N-D and real transforms: B3, B5, B6, B7 and their routes
# ---------------------------------------------------------------------- #
def _counts():
    return {"rows_fft": cuda_fft.launches, "ax0_fft": cuda_fft.ax0_launches,
            "ax3": cuda_fft.ax3_launches, "rows_t_fft": cuda_fft.rows_t_launches,
            "fft2f_fft": cuda_fft.fft2f_launches, "r2c_fft": cuda_fft.r2c_launches,
            "c2r_fft": cuda_fft.c2r_launches, "big_fft": bigfft.launches,
            "gen_fft": cuda_fft.gen_launches, "r2c_gen_fft": cuda_fft.r2c_gen_launches,
            "chirp_fwd": cuda_fft.chirp_fwd_launches,
            "chirp_inv": cuda_fft.chirp_inv_launches,
            "chirp_full": cuda_fft.chirp_full_launches, "filt": cuda_fft.filt_launches,
            "bank": cuda_fft.bank_launches, "c2r_prod": cuda_fft.c2r_prod_launches,
            "ax0_gen": cuda_fft.ax0_gen_launches, "welch": cuda_welch.welch_launches,
            "psd": cuda_welch.psd_launches, "csd": cuda_welch.csd_launches,
            "coh": cuda_welch.coh_launches, "c2c": cuda_welch.c2c_launches,
            "spec": cuda_welch.spec_launches, "spec_c2c": cuda_welch.spec_c2c_launches,
            "filt_c64": cuda_fft.filt_c64_launches, "c2c_c64": cuda_welch.c2c_c64_launches,
            "spec_c2c_c64": cuda_welch.spec_c2c_c64_launches,
            "c2r_fft_c64": cuda_fft.c2r_c64_launches}


def _through(fn, **want):
    """fn()'s result; the launch counts must rise by exactly ``want``."""
    before = _counts()
    out = fn()
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in _counts().items()}
    assert delta == {k: want.get(k, 0) for k in delta}
    return out


def rrand(dev, *shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("shape", [(2, n, 7, 130) for n in (1 << e for e in range(7, 15))]
                         + [(256, 256, 256)])
def test_axis3_kernel_matches_plain_and_torch_fft(dev, shape):
    x = crand(dev, *shape)
    re, im = x.real.contiguous(), x.imag.contiguous()
    n = shape[-3]
    for sign, scale in ((-1, None), (1, 1.0 / n)):
        k = torch.complex(*_through(lambda: cuda_fft.fft_axis3_split(re, im, sign, scale),
                                    ax3=1))
        p = torch.complex(*cuda_fft.fft_axis3_split_reference(re, im, sign, scale))
        o = torch.fft.fft(x, dim=-3) if sign < 0 else torch.fft.ifft(x, dim=-3)
        assert rel_l2(k, p) < TOL and rel_l2(k, o) < TOL, (sign, scale)


PLANES = [(128, 128), (128, 256), (256, 128), (128, 512), (512, 128), (256, 256)]


@pytest.mark.parametrize("A,B", PLANES)
@pytest.mark.parametrize("lead", [(), (3,), (2, 5)])
def test_fft2_fused_kernel_matches_plain_and_torch_fft(dev, A, B, lead):
    x = crand(dev, *lead, A, B)
    re, im = x.real.contiguous(), x.imag.contiguous()
    for sign, scale in ((-1, None), (1, 1.0 / (A * B)), (-1, 1.0 / (A * B))):
        k = torch.complex(*_through(lambda: cuda_fft.fft2_fused_split(re, im, sign, scale),
                                    fft2f_fft=1))
        p = torch.complex(*cuda_fft.fft2_fused_split_reference(re, im, sign, scale))
        o = torch.fft.fft2(x) if sign < 0 else torch.fft.ifft2(x, norm="forward")
        o = o * (1.0 if scale is None else scale)
        assert rel_l2(k, p) < TOL and rel_l2(k, o) < TOL, (sign, scale)


def test_fft2_fused_kernel_refused_shape_raises(dev):
    z = torch.zeros(2, 512, 256, device=dev)
    with pytest.raises(cuda_fft.Unsupported):
        cuda_fft.fft2_fused_split(z, z, -1)


@pytest.mark.parametrize("n", [1 << e for e in range(7, 15)])
@pytest.mark.parametrize("pad", [False, True])
def test_real_kernels_match_plain_and_torch_fft(dev, n, pad):
    x = rrand(dev, 37, n)
    mp = n // 2 + 1
    for scale in (None, 1.0 / n):
        kr, ki = _through(lambda: cuda_fft.rfft_rows_split(x, scale, pad_out=pad), r2c_fft=1)
        pr, pi = cuda_fft.rfft_rows_split_reference(x, scale, pad_out=pad)
        o = torch.fft.rfft(x) * (1.0 if scale is None else scale)
        assert kr.shape[-1] == (cuda_fft.pad_bins(n) if pad else mp)
        assert rel_l2(torch.complex(kr, ki), torch.complex(pr, pi)) < TOL
        assert rel_l2(torch.complex(kr[:, :mp], ki[:, :mp]), o) < TOL
        assert not kr[:, mp:].any() and not ki[:, mp:].any()  # exact zeros
        # C2R: imaginary DC and Nyquist parts and pad columns are not read
        Xr, Xi = kr.clone(), ki.clone()
        Xi[:, 0] += 3.0
        Xi[:, mp - 1] -= 2.0
        Xr[:, mp:] = 1e6
        Xi[:, mp:] = -1e6
        y = _through(lambda: cuda_fft.irfft_rows_split(Xr, Xi, n, scale, padded_in=pad),
                     c2r_fft=1)
        yp = cuda_fft.irfft_rows_split_reference(Xr, Xi, n, scale, padded_in=pad)
        yo = torch.fft.irfft(torch.complex(kr[:, :mp], ki[:, :mp]), n=n, norm="forward")
        yo = yo * (1.0 if scale is None else scale)
        assert rel_l2(y, yp) < TOL and rel_l2(y, yo) < TOL, scale
        # the plain version of the kernel's own passes
        assert rel_l2(y, cuda_fft._c2r_passes(Xr, Xi, n, scale)) < TOL, scale


@pytest.mark.parametrize("n", [1 << e for e in range(7, 15)])
@pytest.mark.parametrize("pad", [False, True])
def test_c2r_complex64_source_matches_plain_and_torch_fft(dev, n, pad):
    # B7 from a complex64 tensor as it lies, 37 rows of n/2 + 1 or
    # pad_bins(n) bins: imaginary DC and Nyquist parts and garbage pad
    # columns are not read
    mp = n // 2 + 1
    X = crand(dev, 37, cuda_fft.pad_bins(n) if pad else mp, seed=5)
    X[:, mp:] = 1e6 - 1e6j
    Xr, Xi = X.real.contiguous(), X.imag.contiguous()
    Xh = X[:, :mp].clone()
    Xh.imag[:, 0] = Xh.imag[:, -1] = 0.0
    for scale in (None, 1.0 / n):
        y = _through(lambda: cuda_fft.irfft_rows_c64(X, n, scale, padded_in=pad), c2r_fft=1,
                     c2r_fft_c64=1)
        assert y.dtype == torch.float32 and y.shape == (37, n)
        yo = torch.fft.irfft(Xh, n=n, norm="forward") * (1.0 if scale is None else scale)
        for want in (cuda_fft.irfft_rows_c64_reference(X, n, scale, padded_in=pad),
                     cuda_fft.irfft_rows_split_reference(Xr, Xi, n, scale, padded_in=pad),
                     cuda_fft._c2r_passes(Xr, Xi, n, scale), yo):
            assert rel_l2(y, want) < TOL, scale
        # the same bits as the planar source's: one staging, one set of passes
        assert torch.equal(y, cuda_fft._c2r_launch(Xr, Xi, n, scale))


@pytest.mark.parametrize("pad", [False, True])
def test_grad_irfft_rows_c64_matches_plain(dev, pad):
    # the backward is the R2C kernel's complex64 sink
    n = 2048
    bins = cuda_fft.pad_bins(n) if pad else n // 2 + 1
    X = crand(dev, 8, bins, seed=6)
    X[:, n // 2 + 1:] = 0
    w = torch.linspace(0.5, 1.5, 8 * n, device=dev).reshape(8, n)

    def grad(f, v):
        t = v.clone().requires_grad_()
        y = f(t)
        (w.to(y.device) * y * y).sum().backward()
        return t.grad

    gk = _through(lambda: grad(lambda t: cuda_fft.irfft_rows_c64(t, n, 1.0 / n, padded_in=pad),
                               X), c2r_fft=1, c2r_fft_c64=1, r2c_fft=1)
    assert gk.dtype == torch.complex64 and gk.shape == X.shape
    assert not gk[:, n // 2 + 1:].any()  # pad columns get zero
    gp = grad(lambda t: cuda_fft.irfft_rows_c64(t, n, 1.0 / n, padded_in=pad), X.cpu())
    assert rel_l2(gk.cpu(), gp) < TOL


@pytest.mark.parametrize("entry", ["axis3", "fused", "r2c", "r2c_pad", "c2r", "c2r_pad"])
def test_grad_new_kernels_match_plain(dev, entry):
    if entry in ("axis3", "fused"):
        shape, kernel = ((2, 256, 8, 130), "ax3") if entry == "axis3" else ((3, 256, 128), "fft2f_fft")
        run = _grad(*shape)
        fn, ref = {"axis3": (cuda_fft.fft_axis3_split, cuda_fft.fft_axis3_split_reference),
                   "fused": (cuda_fft.fft2_fused_split, cuda_fft.fft2_fused_split_reference)}[entry]
        gk = _through(lambda: run(lambda r, i: fn(r, i, 1, 0.5)), **{kernel: 2})
        gp = run(lambda r, i: ref(r, i, 1, 0.5))
        assert rel_l2(gk, gp) < TOL
        return
    pad = entry.endswith("_pad")
    n = 2048
    if entry.startswith("r2c"):
        x = rrand(dev, 8, n, seed=2)
        w = torch.linspace(0.5, 1.5, 8 * cuda_fft.pad_bins(n), device=dev)

        def grad(f):
            t = x.clone().requires_grad_()
            yr, yi = f(t)
            ww = w[:yr.numel()].reshape(yr.shape)
            (ww * (yr * yr + yi * yi)).sum().backward()
            return t.grad

        # the backward is the row kernel with the + sign
        gk = _through(lambda: grad(lambda t: cuda_fft.rfft_rows_split(t, n ** -0.5,
                                                                     pad_out=pad)),
                      r2c_fft=1, rows_fft=1)
        gp = grad(lambda t: cuda_fft.rfft_rows_split_reference(t, n ** -0.5, pad_out=pad))
    else:
        bins = cuda_fft.pad_bins(n) if pad else n // 2 + 1
        Xr, Xi = rrand(dev, 8, bins, seed=3), rrand(dev, 8, bins, seed=4)
        if pad:
            Xr[:, n // 2 + 1:] = 0
            Xi[:, n // 2 + 1:] = 0
        w = torch.linspace(0.5, 1.5, 8 * n, device=dev).reshape(8, n)

        def grad(f):
            a, b = Xr.clone().requires_grad_(), Xi.clone().requires_grad_()
            y = f(a, b)
            (w * y * y).sum().backward()
            return torch.complex(a.grad, b.grad)

        # the backward is the R2C kernel
        gk = _through(lambda: grad(lambda a, b: cuda_fft.irfft_rows_split(
            a, b, n, 1.0 / n, padded_in=pad)), c2r_fft=1, r2c_fft=1)
        gp = grad(lambda a, b: cuda_fft.irfft_rows_split_reference(a, b, n, 1.0 / n,
                                                                   padded_in=pad))
    assert rel_l2(gk, gp) < TOL


def test_irfft_complex64_routes(dev):
    # irfft of a complex64 4096 x 2049 tensor: the C2R kernel's complex64
    # source on the tensor as it lies, one launch and no other device work
    # (no split); irfft2 at s = (4096, 4096): ax0_fft's complex64 entry,
    # then the C2R's; irfftn of 128 x 256 x 129: the axis(-3) view's and
    # ax0_fft's complex64 entries, then the C2R's; other shapes keep the
    # planar route (the names over ten calls from the profiler, the
    # launches from the counters)
    X = torch.fft.rfft(rrand(dev, 4096, 4096, seed=1))
    names = _device_kernels(lambda: ft.irfft(X), calls=10)
    assert names and all("c2r_fft_kernel" in k for k in names), names
    y = _through(lambda: ft.irfft(X), c2r_fft=1, c2r_fft_c64=1)
    assert y.dtype == torch.float32 and rel_l2(y, torch.fft.irfft(X.to(torch.complex128))) < TOL
    names = _device_kernels(lambda: ft.irfft2(X, s=(4096, 4096)), calls=10, per_call=2)
    assert {next((k for k in ("ax0_fft_kernel", "c2r_fft_kernel") if k in name), name)
            for name in names} == {"ax0_fft_kernel", "c2r_fft_kernel"}, names
    before = _c64_counts()
    y = _through(lambda: ft.irfft2(X, s=(4096, 4096), norm="ortho"), ax0_fft=1, c2r_fft=1,
                 c2r_fft_c64=1)
    assert tuple(a - b for a, b in zip(_c64_counts(), before)) == (0, 1, 0, 0)
    assert rel_l2(y, torch.fft.irfft2(X.to(torch.complex128), s=(4096, 4096),
                                      norm="ortho")) < TOL
    Z = crand(dev, 128, 256, 129, seed=2)
    before = _c64_counts()
    y = _through(lambda: ft.irfftn(Z, norm="forward"), ax3=1, ax0_fft=1, c2r_fft=1,
                 c2r_fft_c64=1)
    assert tuple(a - b for a, b in zip(_c64_counts(), before)) == (0, 1, 1, 0)
    assert rel_l2(y, torch.fft.irfftn(Z.to(torch.complex128), norm="forward")) < TOL
    W = crand(dev, 257, 6, seed=3)  # along axis 0: the moved axis, copied once
    assert rel_l2(_through(lambda: ft.irfft(W, axis=0), c2r_fft=1, c2r_fft_c64=1),
                  torch.fft.irfft(W.to(torch.complex128), dim=0)) < TOL
    # a trim, and a length outside the envelope: the planar route
    assert rel_l2(_through(lambda: ft.irfft(X[:8], n=2048), c2r_fft=1),
                  torch.fft.irfft(X[:8].to(torch.complex128), n=2048)) < TOL
    _through(lambda: ft.irfft(crand(dev, 4, 1001)), gen_fft=1)  # n = 2000: B13 at 1000
    # fft_convolve's real route: two R2C sinks, then the C2R's complex64 source
    a, b = rrand(dev, 16, 3000, seed=4), rrand(dev, 16, 1000, seed=5)
    c = _through(lambda: ft.fft_convolve(a, b), r2c_fft=2, c2r_fft=1, c2r_fft_c64=1)
    assert rel_l2(c, torch.fft.irfft(torch.fft.rfft(a.double(), n=4096)
                                     * torch.fft.rfft(b.double(), n=4096), n=4096)[:, :3999]) < TOL


def test_config4_routes(dev):
    # BASELINE config 4: 2-D 4096 x 4096 and R2C/C2R on the card
    x = crand(dev, 4096, 4096)
    X = _through(lambda: ft.fft2(x), rows_fft=1, ax0_fft=1)
    assert rel_l2(X, torch.fft.fft2(x)) < TOL
    assert rel_l2(_through(lambda: ft.ifft2(X), rows_fft=1, ax0_fft=1), x) < TOL
    r = rrand(dev, 4096, 4096)
    R = _through(lambda: ft.rfft2(r), r2c_fft=1, ax0_fft=1)
    assert R.shape == (4096, 2049) and rel_l2(R, torch.fft.rfft2(r)) < TOL
    back = _through(lambda: ft.irfft2(R, s=(4096, 4096)), ax0_fft=1, c2r_fft=1,
                    c2r_fft_c64=1)
    assert rel_l2(back, r) < TOL


def test_fftn_3d_routes(dev):
    # 256^3 complex64: the fused plane, then axis -3, through their
    # complex64 entries
    x = crand(dev, 256, 256, 256)
    before = _fused_c64_counts()
    X = _through(lambda: ft.fftn(x), fft2f_fft=1, ax3=1)
    assert rel_l2(X, torch.fft.fftn(x)) < TOL
    assert rel_l2(_through(lambda: ft.ifftn(X), fft2f_fft=1, ax3=1), x) < TOL
    assert tuple(a - b for a, b in zip(_fused_c64_counts(), before)) == (2, 2, 0)
    y = crand(dev, 2, 128, 3, 64)  # the plan's axis(-3) route, any trailing shape
    Y = _through(lambda: ft.fft(y, axis=1), ax3=1)
    assert rel_l2(Y, torch.fft.fft(y, dim=1)) < TOL
    r = rrand(dev, 128, 128, 256)  # rfftn: R2C, then axes 0 and 1 by the plan
    R = _through(lambda: ft.rfftn(r), r2c_fft=1, ax3=1, ax0_fft=1)
    assert rel_l2(R, torch.fft.rfftn(r)) < TOL
    assert rel_l2(ft.irfftn(R, s=r.shape), r) < TOL


def test_real_routes_outside_the_kernels(dev):
    r = rrand(dev, 4, 32768)  # even n beyond R2C: packed, half on the row kernel
    R = _through(lambda: ft.rfft(r), rows_fft=1)
    assert rel_l2(R, torch.fft.rfft(r)) < TOL
    r = rrand(dev, 4, 255)  # odd n: zero-imaginary C2C, mixed radix
    assert rel_l2(_through(lambda: ft.rfft(r)), torch.fft.rfft(r)) < TOL


# ---------------------------------------------------------------------- #
# non-pow2 lengths: B13 (gen_fft), B14 (r2c_gen_fft), B11 and B12
# (chirp_fft) and their routes
# ---------------------------------------------------------------------- #
# composite lengths: the two-factor splits of the JAX kernel, then one
# length for each pass type of the mixed-radix plan (powers of 2 with 3 and
# 5; 13^3, 7^4, 11^4, 5^6; the generic primes 251 and 127; 7 and 13 at
# more butterflies a thread; R2C's half-length 17*19, generic last), and
# the 1080p frames' height
GEN_NS = [640, 1000, 1005, 2047, 4095, 4097, 6561, 10000, 16383, 1920, 3072, 12288,
          2197, 2401, 14641, 15625, 1004, 16129, 14406, 16224, 646, 1080]


@pytest.mark.parametrize("n", GEN_NS)
@pytest.mark.parametrize("rows", [(1,), (2, 37)])
def test_gen_kernel_matches_plain_and_torch_fft(dev, n, rows):
    x = crand(dev, *rows, n)
    re, im = x.real.contiguous(), x.imag.contiguous()
    for sign, scale in ((-1, None), (1, 1.0 / n), (-1, n ** -0.5)):
        k = torch.complex(*_through(
            lambda: cuda_fft.fft_rows_general_split(re, im, sign, scale), gen_fft=1))
        p = torch.complex(*cuda_fft.fft_rows_general_split_reference(re, im, sign, scale))
        o = torch.fft.fft(x) if sign < 0 else torch.fft.ifft(x, norm="forward")
        o = o * (1.0 if scale is None else scale)
        assert rel_l2(k, p) < TOL and rel_l2(k, o) < TOL, (sign, scale)


@pytest.mark.parametrize("n", GEN_NS)
@pytest.mark.parametrize("pad", [False, True])
def test_r2c_gen_kernel_matches_plain_and_torch_fft(dev, n, pad):
    x = rrand(dev, 37, n)
    mp = n // 2 + 1
    for scale in (None, 1.0 / n):
        kr, ki = _through(lambda: cuda_fft.rfft_rows_general_split(x, scale, pad_out=pad),
                           r2c_gen_fft=1)
        assert kr.shape[-1] == (cuda_fft.pad_bins(n) if pad else mp)
        pr, pi = cuda_fft.rfft_rows_general_split_reference(x, scale, pad_out=pad)
        o = torch.fft.rfft(x) * (1.0 if scale is None else scale)
        assert rel_l2(torch.complex(kr, ki), torch.complex(pr, pi)) < TOL
        assert rel_l2(torch.complex(kr[:, :mp], ki[:, :mp]), o) < TOL
        assert not kr[:, mp:].any() and not ki[:, mp:].any()  # exact zeros


@pytest.mark.parametrize("e", list(range(7, 15)))
@pytest.mark.parametrize("rows", [3, 300])
def test_chirp_kernels_match_plain_and_torch_fft(dev, e, rows):
    m = 1 << e
    n_in, n_out = m // 2 + 3, 3 * m // 4 + 1  # not multiples of 128
    x, h = crand(dev, rows, n_in, seed=1), crand(dev, n_in, seed=2)
    X, H, g = crand(dev, rows, m, seed=3), crand(dev, m, seed=4), crand(dev, n_out, seed=5)
    for sign in (-1, 1):
        k = torch.complex(*_through(lambda: cuda_fft.fft_chirp_forward_split(
            x.real.contiguous(), x.imag.contiguous(), h.real, h.imag, m, sign), chirp_fwd=1))
        p = torch.complex(*cuda_fft.fft_chirp_forward_split_reference(
            x.real, x.imag, h.real, h.imag, m, sign))
        o = torch.fft.fft(x * h, n=m) if sign < 0 else torch.fft.ifft(x * h, n=m) * m
        assert rel_l2(k, p) < TOL and rel_l2(k, o) < TOL, sign
        for scale in (None, 1.0 / m):
            k = torch.complex(*_through(lambda: cuda_fft.fft_chirp_inverse_split(
                X.real.contiguous(), X.imag.contiguous(), H.real, H.imag, g.real, g.imag,
                n_out, sign, scale), chirp_inv=1))
            p = torch.complex(*cuda_fft.fft_chirp_inverse_split_reference(
                X.real, X.imag, H.real, H.imag, g.real, g.imag, n_out, sign, scale))
            y = torch.fft.fft(X * H) if sign < 0 else torch.fft.ifft(X * H) * m
            o = g * y[:, :n_out] * (1.0 if scale is None else scale)
            assert rel_l2(k, p) < TOL and rel_l2(k, o) < TOL, (sign, scale)


@pytest.mark.parametrize("e", list(range(7, 15)))
@pytest.mark.parametrize("rows", [3, 300])
def test_chirp_full_kernel_matches_plain_and_torch_fft(dev, e, rows):
    m = 1 << e
    n_in, n_out = m // 2 + 3, 3 * m // 4 + 1  # not multiples of 128
    x, h = crand(dev, rows, n_in, seed=1), crand(dev, n_in, seed=2)
    H, g = crand(dev, m, seed=4), crand(dev, n_out, seed=5)
    tabs = (h.real, h.imag, H.real, H.imag, g.real, g.imag)
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    for scale in (None, 1.0 / m):
        k = torch.complex(*_through(lambda: cuda_fft.fft_chirp_full_split(
            xr, xi, *tabs, m, n_out, scale), chirp_full=1))
        p = torch.complex(*cuda_fft.fft_chirp_full_split_reference(xr, xi, *tabs, m, n_out,
                                                                     scale))
        q = torch.complex(*cuda_fft._chirp_full_passes(xr, xi, *tabs, m, n_out, scale))
        y = torch.fft.ifft(torch.fft.fft(x.to(torch.complex128) * h, n=m) * H) * m
        o = g * y[:, :n_out] * (1.0 if scale is None else scale)
        assert rel_l2(k, p) < TOL and rel_l2(k, q) < TOL and rel_l2(k, o) < TOL, scale


@pytest.mark.parametrize("entry", ["gen", "r2c_gen", "r2c_gen_pad", "chirp_fwd", "chirp_inv",
                                   "chirp_full"])
def test_grad_nonpow2_kernels_match_plain(dev, entry):
    if entry == "gen":  # forward and backward: the composite kernel
        run = _grad(8, 4095)
        gk = _through(lambda: run(lambda r, i: cuda_fft.fft_rows_general_split(r, i, 1, 0.5)),
                       gen_fft=2)
        gp = run(lambda r, i: cuda_fft.fft_rows_general_split_reference(r, i, 1, 0.5))
    elif entry.startswith("r2c_gen"):  # backward: the +sign composite C2C
        pad, n = entry.endswith("_pad"), 1005
        x = rrand(dev, 8, n, seed=2)
        w = torch.linspace(0.5, 1.5, 8 * cuda_fft.pad_bins(n), device=dev)

        def grad(f):
            t = x.clone().requires_grad_()
            yr, yi = f(t)
            ww = w[:yr.numel()].reshape(yr.shape)
            (ww * (yr * yr + yi * yi)).sum().backward()
            return t.grad

        gk = _through(lambda: grad(lambda t: cuda_fft.rfft_rows_general_split(
            t, n ** -0.5, pad_out=pad)), r2c_gen_fft=1, gen_fft=1)
        gp = grad(lambda t: cuda_fft.rfft_rows_general_split_reference(
            t, n ** -0.5, pad_out=pad))
    elif entry == "chirp_full":  # forward and backward: the fused kernel
        m, n = 8192, 4093
        h, H, g = crand(dev, n, seed=6), crand(dev, m, seed=7), crand(dev, n, seed=8)
        tabs = (h.real, h.imag, H.real, H.imag, g.real, g.imag)
        run = _grad(4, n)
        gk = _through(lambda: run(lambda r, i: cuda_fft.fft_chirp_full_split(
            r, i, *tabs, m, n, 1.0 / m)), chirp_full=2)
        gp = run(lambda r, i: cuda_fft.fft_chirp_full_split_reference(r, i, *tabs, m, n,
                                                                        1.0 / m))
    else:  # backward: the row kernel
        m, n = 8192, 4093
        h, g = crand(dev, n if entry == "chirp_fwd" else m, seed=6), crand(dev, n, seed=7)
        if entry == "chirp_fwd":
            run = _grad(4, n)
            fn = lambda r, i: cuda_fft.fft_chirp_forward_split(r, i, h.real, h.imag, m, -1)  # noqa: E731
            ref = lambda r, i: cuda_fft.fft_chirp_forward_split_reference(  # noqa: E731
                r, i, h.real, h.imag, m, -1)
        else:
            run = _grad(4, m)
            fn = lambda r, i: cuda_fft.fft_chirp_inverse_split(  # noqa: E731
                r, i, h.real, h.imag, g.real, g.imag, n, 1, 1.0 / m)
            ref = lambda r, i: cuda_fft.fft_chirp_inverse_split_reference(  # noqa: E731
                r, i, h.real, h.imag, g.real, g.imag, n, 1, 1.0 / m)
        gk = _through(lambda: run(fn), **{entry: 1, "rows_fft": 1})
        gp = run(ref)
    assert rel_l2(gk, gp) < TOL


NONPOW2_ROUTES = [  # (call, shape, launches), the slice's main path
    ("fft", (1024, 4095), {"gen_fft": 1}), ("ifft", (1024, 4097), {"gen_fft": 1}),
    ("plan", (2048, 1000), {"gen_fft": 1}),
    ("fft", (1024, 4093), {"chirp_full": 1}),
    ("ifft", (64, 1031), {"chirp_full": 1}),
    ("fft", (4, 526), {"chirp_full": 1}),
]


@pytest.mark.parametrize("call,shape,want", NONPOW2_ROUTES)
def test_nonpow2_routes(dev, call, shape, want):
    x = crand(dev, *shape)
    n = shape[-1]
    if call == "plan":
        p = ft.plan(n)
        X = _through(lambda: p.forward(x), **want)
        assert rel_l2(X, torch.fft.fft(x)) < TOL
        assert rel_l2(_through(lambda: p.inverse(X), **want), x) < TOL
        xu = _through(lambda: p.inverse_unnormalized(X), **want)
        assert rel_l2(p.normalize(xu), x) < TOL
        return
    y = _through(lambda: getattr(ft, call)(x), **want)
    assert rel_l2(y, getattr(torch.fft, call)(x)) < TOL


def test_bluestein_and_czt_routes(dev):
    from fft_wgpu_tpu_torch.ops import bluestein

    x = crand(dev, 64, 4097)  # a direct call: m = 16384
    re, im = x.real.contiguous(), x.imag.contiguous()
    y = torch.complex(*_through(lambda: bluestein.fft_bluestein_split(re, im, -1),
                                 chirp_full=1))
    assert rel_l2(y, torch.fft.fft(x)) < TOL
    x = crand(dev, 64, 4096)  # 1024 bins of a band: L = 8192
    w, a = np.exp(-2j * np.pi * 0.25 / 1024), np.exp(2j * np.pi * 0.1)
    got = _through(lambda: ft.czt(x, m=1024, w=w, a=a), chirp_full=1)
    want = ft.czt(x.cpu(), m=1024, w=w, a=a)  # the composed path on the CPU
    assert got.device.type == "cuda" and rel_l2(got.cpu(), want) < TOL
    zf = ft.ZoomFFT(4096, [0.1, 0.35], m=1024)
    got = _through(lambda: zf(x), chirp_full=1)
    assert rel_l2(got.cpu(), zf(x.cpu())) < TOL
    # prime 8209 needs m = 32768: the composed path, its FFTs the whole-row kernel
    y = crand(dev, 2, 8209)
    assert rel_l2(_through(lambda: ft.fft(y), big_fft=2), torch.fft.fft(y)) < TOL


def test_real_nonpow2_routes(dev):
    for n in (4095, 1000):  # odd, and even composite: the composite R2C kernel
        r = rrand(dev, 1024, n)
        R = _through(lambda: ft.rfft(r), r2c_gen_fft=1)
        assert rel_l2(R, torch.fft.rfft(r)) < TOL
    r = rrand(dev, 1024, 4095)
    R = torch.fft.rfft(r)
    back = _through(lambda: ft.irfft(R, n=4095), gen_fft=1)  # Hermitian extension, C2C
    assert rel_l2(back, r) < TOL


def test_numpy_input_runs_on_the_card(dev):
    x = (np.random.default_rng(0).standard_normal((64, 4096))).astype(np.complex64)
    y = _through(lambda: ft.fft(x), rows_fft=1)
    assert y.device.type == "cuda"
    assert rel_l2(y.cpu(), torch.fft.fft(torch.from_numpy(x))) < TOL
    assert ft.rfft(x.real).device.type == "cuda"
    assert ft.plan(4096).warmup((2,)) is not None


# ---------------------------------------------------------------------- #
# the fused epilogues: B9 and B10 (filt_fft), B8 (c2r_fft's product form),
# B2's composite range (ax0_gen_fft) and their routes
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n", GEN_NS)
@pytest.mark.parametrize("lead,m", [((), 7), ((), 8), ((2,), 300), ((2,), 1000)])
def test_ax0_gen_kernel_matches_plain_and_torch_fft(dev, n, lead, m):
    x = crand(dev, *lead, n, m)
    re, im = x.real.contiguous(), x.imag.contiguous()
    for sign, scale in ((-1, None), (1, 1.0 / n)):
        k = torch.complex(*_through(lambda: cuda_fft.fft_axis0_split(re, im, sign, scale),
                                    ax0_gen=1))
        p = torch.complex(*cuda_fft.fft_axis0_split_reference(re, im, sign, scale))
        q = torch.complex(*cuda_fft._mixed_radix_axis(re, im, sign, scale))
        o = torch.fft.fft(x, dim=-2) if sign < 0 else torch.fft.ifft(x, dim=-2)
        assert rel_l2(k, p) < TOL and rel_l2(k, q) < TOL and rel_l2(k, o) < TOL, (sign, scale)


def test_axis3_composite_kernel_matches_plain_and_torch_fft(dev):
    x = crand(dev, 2, 1000, 7, 13)
    re, im = x.real.contiguous(), x.imag.contiguous()
    k = torch.complex(*_through(lambda: cuda_fft.fft_axis3_split(re, im, -1, None), ax3=1))
    p = torch.complex(*cuda_fft.fft_axis3_split_reference(re, im, -1, None))
    assert rel_l2(k, p) < TOL and rel_l2(k, torch.fft.fft(x, dim=-3)) < TOL


@pytest.mark.parametrize("n", [1 << e for e in range(7, 15)])
@pytest.mark.parametrize("rows", [(1,), (2, 37)])
def test_filt_kernel_matches_plain_and_torch_fft(dev, n, rows):
    x, h = crand(dev, *rows, n, seed=1), crand(dev, n, seed=2)
    re, im = x.real.contiguous(), x.imag.contiguous()
    for sign, scale in ((-1, None), (1, 1.0 / n)):
        k = torch.complex(*_through(lambda: cuda_fft.fft_filtered_split(
            re, im, h.real, h.imag, sign, scale), filt=1))
        p = torch.complex(*cuda_fft.fft_filtered_split_reference(re, im, h.real, h.imag,
                                                                 sign, scale))
        o = torch.fft.fft(x * h) if sign < 0 else torch.fft.ifft(x * h, norm="forward")
        o = o * (1.0 if scale is None else scale)
        assert rel_l2(k, p) < TOL and rel_l2(k, o) < TOL, (sign, scale)


@pytest.mark.parametrize("n", [1 << e for e in range(7, 15)])
@pytest.mark.parametrize("S", [1, 7, 128])
def test_bank_kernel_matches_plain_and_torch_fft(dev, n, S):
    x, h = crand(dev, n, seed=1), crand(dev, S, n, seed=2)
    re, im = x.real.contiguous(), x.imag.contiguous()
    for sign, scale in ((-1, None), (1, 1.0 / n)):
        k = torch.complex(*_through(lambda: cuda_fft.fft_bank_split(
            re, im, h.real, h.imag, sign, scale), bank=1))
        assert k.shape == (S, n)
        p = torch.complex(*cuda_fft.fft_bank_split_reference(re, im, h.real, h.imag, sign,
                                                             scale))
        o = torch.fft.fft(x * h) if sign < 0 else torch.fft.ifft(x * h, norm="forward")
        o = o * (1.0 if scale is None else scale)
        assert rel_l2(k, p) < TOL and rel_l2(k, o) < TOL, (sign, scale)
        # the plain version of its own passes (the filtered rows' kernel)
        q = cuda_fft._bank_passes(re, im, h.real, h.imag, sign, scale)
        assert rel_l2(k, q) < TOL, (sign, scale)


@pytest.mark.parametrize("n", [1 << e for e in range(7, 15)])
@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("bcast", [False, True])
def test_c2r_prod_kernel_matches_plain_and_torch_fft(dev, n, pad, bcast):
    mp = n // 2 + 1
    bins = cuda_fft.pad_bins(n) if pad else mp
    A, B = crand(dev, 37, bins, seed=1), crand(dev, 1 if bcast else 37, bins, seed=2)
    A[:, mp:], B[:, mp:] = 1e6, -1e6  # garbage pad columns: never read
    Ar, Ai = A.real.contiguous(), A.imag.contiguous()
    Br, Bi = B.real.contiguous(), B.imag.contiguous()
    if bcast:
        Br, Bi = Br[0], Bi[0]
    P = (A * B)[:, :mp]
    P.imag[:, 0] = P.imag[:, -1] = 0.0  # the product's DC and Nyquist: real
    for scale in (None, 1.0 / n):
        k = _through(lambda: cuda_fft.irfft_prod_rows_split(Ar, Ai, Br, Bi, n, scale,
                                                            padded_in=pad), c2r_prod=1)
        p = cuda_fft.irfft_prod_rows_split_reference(Ar, Ai, Br, Bi, n, scale,
                                                     padded_in=pad)
        o = torch.fft.irfft(P, n=n, norm="forward") * (1.0 if scale is None else scale)
        assert rel_l2(k, p) < TOL and rel_l2(k, o) < TOL, scale
        # the plain version of the kernel's own passes
        assert rel_l2(k, cuda_fft._c2r_prod_passes(Ar, Ai, Br, Bi, n, scale)) < TOL, scale


@pytest.mark.parametrize("entry", ["filt", "bank", "c2r_prod", "c2r_prod_bcast", "ax0_gen"])
def test_grad_fused_kernels_match_plain(dev, entry):
    if entry == "ax0_gen":  # forward and backward: the composite axis(-2) kernel
        run = _grad(2, 1000, 33)
        gk = _through(lambda: run(lambda r, i: cuda_fft.fft_axis0_split(r, i, 1, 1e-3)),
                      ax0_gen=2)
        gp = run(lambda r, i: cuda_fft.fft_axis0_split_reference(r, i, 1, 1e-3))
    elif entry in ("filt", "bank"):  # backward: the row kernel, sign flipped
        n = 2048
        h = crand(dev, *((n,) if entry == "filt" else (16, n)), seed=3)
        run = _grad(*((8, n) if entry == "filt" else (n,)))
        fn = cuda_fft.fft_filtered_split if entry == "filt" else cuda_fft.fft_bank_split
        ref = (cuda_fft.fft_filtered_split_reference if entry == "filt"
               else cuda_fft.fft_bank_split_reference)
        gk = _through(lambda: run(lambda r, i: fn(r, i, h.real, h.imag, 1, 1.0 / n)),
                      **{entry: 1, "rows_fft": 1})
        gp = run(lambda r, i: ref(r, i, h.real, h.imag, 1, 1.0 / n))
    else:  # backward: the R2C kernel, in A and B
        n, rows = 1024, 8
        bcast = entry.endswith("bcast")
        bins = cuda_fft.pad_bins(n)
        A, B = crand(dev, rows, bins, seed=4), crand(dev, 1 if bcast else rows, bins, seed=5)
        A[:, n // 2 + 1:] = B[:, n // 2 + 1:] = 0
        w = torch.linspace(0.5, 1.5, rows * n, device=dev).reshape(rows, n)

        def grad(f):
            ins = [t.contiguous().requires_grad_() for t in
                   (A.real, A.imag, *((B.real[0], B.imag[0]) if bcast else (B.real, B.imag)))]
            y = f(*ins)
            (w * y * y).sum().backward()
            return torch.cat([t.grad.reshape(-1) for t in ins])

        gk = _through(lambda: grad(lambda *v: cuda_fft.irfft_prod_rows_split(
            *v, n, 1.0 / n, padded_in=True)), c2r_prod=1, r2c_fft=1)
        gp = grad(lambda *v: cuda_fft.irfft_prod_rows_split_reference(
            *v, n, 1.0 / n, padded_in=True))
    assert rel_l2(gk, gp) < TOL


def test_psd_and_c2r_prod_are_their_kernels_alone(dev):
    # B19 at the psd spectrogram's 2^22 (nperseg 4096, hop 3584) and at the
    # pairs' nfft 256, and B8 at 2048 x 8192 padded: one launch of the kernel
    # a call and no other device work (over ten calls, from the profiler)
    x = rrand(dev, 1 << 22, seed=1)
    A, B = crand(dev, 2048, cuda_fft.pad_bins(8192), seed=2), crand(dev, 2048, 4224, seed=3)
    A[:, 4097:] = B[:, 4097:] = 0
    planes = [v.contiguous() for v in (A.real, A.imag, B.real, B.imag)]
    w4096, w256 = torch.hann_window(4096, device=dev), torch.hann_window(256, device=dev)
    for fn, kernel in (
            (lambda: cuda_welch.spec_psd_split(x, w4096, 4096, 3584, 4096, "constant"), "psd"),
            (lambda: cuda_welch.spec_psd_split(x, w256, 256, 128, 256, False), "psd"),
            (lambda: cuda_fft.irfft_prod_rows_split(*planes, 8192, 1.0 / 8192, padded_in=True),
             "c2r_prod")):
        names = _device_kernels(fn, calls=10)
        name = {"psd": "psd_pairs_kernel", "c2r_prod": "c2r_prod_kernel"}[kernel]
        assert names and all(name in k for k in names), names
        _through(lambda: [fn() for _ in range(10)], **{kernel: 10})


def test_fused_epilogue_routes(dev):
    x, H = crand(dev, 64, 4096, seed=1), crand(dev, 4096, seed=2)
    sf = ft.SpectralFilter(H)
    y = _through(lambda: sf(x), rows_fft=1, filt=1, filt_c64=1)
    assert y.device.type == "cuda" and rel_l2(y, torch.fft.ifft(torch.fft.fft(x) * H)) < TOL
    xc = crand(dev, 16, 1000, seed=3)  # composite n: the plan, B13 both ways
    y = _through(lambda: ft.SpectralFilter(H[:1000])(xc), gen_fft=2)
    assert rel_l2(y, torch.fft.ifft(torch.fft.fft(xc) * H[:1000])) < TOL
    r = rrand(dev, 64, 4096)
    z = _through(lambda: ft.hilbert(r), r2c_fft=1, filt=1, filt_c64=1)
    assert rel_l2(z.cpu(), ft.hilbert(r.cpu())) < TOL
    a, b = rrand(dev, 16, 4096, seed=4), rrand(dev, 16, 4096, seed=5)
    c = _through(lambda: ft.fftconvolve(a, b, axes=-1), r2c_fft=2, c2r_prod=1)
    assert rel_l2(c, torch.fft.irfft(torch.fft.rfft(a, n=8192) * torch.fft.rfft(b, n=8192),
                                     n=8192)[:, :8191]) < TOL
    s, t = rrand(dev, 1 << 16, seed=6), rrand(dev, 129, seed=7)
    o = _through(lambda: ft.oaconvolve(s, t), r2c_fft=2, c2r_prod=1)
    assert rel_l2(o, torch.fft.irfft(torch.fft.rfft(s, n=1 << 17) * torch.fft.rfft(t, n=1 << 17),
                                     n=1 << 17)[:(1 << 16) + 128]) < TOL
    cw = ft.CWT(2000, np.arange(1, 33), device=dev)
    sig = rrand(dev, 2000, seed=8)
    assert cw.nfft == 4096
    w = _through(lambda: cw(sig), rows_fft=1, bank=1)
    assert rel_l2(w.cpu(), ft.CWT(2000, np.arange(1, 33), device="cpu")(sig.cpu())) < TOL


def test_composite_axis_routes(dev):
    x = crand(dev, 2, 1080, 1920, seed=1)  # fft2 of frames: rows B13, columns B2-composite
    X = _through(lambda: ft.fft2(x), gen_fft=1, ax0_gen=1)
    assert rel_l2(X, torch.fft.fft2(x)) < TOL
    assert rel_l2(_through(lambda: ft.ifft2(X), gen_fft=1, ax0_gen=1), x) < TOL
    r = rrand(dev, 1080, 1920)  # rfft2: B14 then B2-composite
    R = _through(lambda: ft.rfft2(r), r2c_gen_fft=1, ax0_gen=1)
    assert rel_l2(R, torch.fft.rfft2(r)) < TOL
    y = crand(dev, 1000, 3, 64, seed=2)  # axis -3: B2-composite on the free view
    assert rel_l2(_through(lambda: ft.fft(y, axis=0), ax3=1), torch.fft.fft(y, dim=0)) < TOL


# ---------------------------------------------------------------------- #
# the caller's state: TF32 and the current device
# ---------------------------------------------------------------------- #
def test_tf32_setting_is_restored(dev):
    x = crand(dev, 64, 100)  # 100 = 4 * 25: the plain path's matmuls
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y = ft.fft(x)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        w = ft.lombscargle(torch.linspace(0, 10, 300, device=dev),
                           torch.sin(torch.linspace(0, 23, 300, device=dev)),
                           torch.linspace(0.5, 6.0, 50, device=dev))
        assert torch.backends.cuda.matmul.allow_tf32 is True and w.device == x.device
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert rel_l2(y, torch.fft.fft(x)) < TOL


def _every_kernel(dev):
    """One small call of each C entry point of the fifteen libraries."""
    from fft_wgpu_tpu_torch.ops import bluestein

    def planar(*shape):
        x = crand(dev, *shape)
        return x.real.contiguous(), x.imag.contiguous()

    re, im = planar(3, 1024)
    hr, hi = planar(1024)
    r = rrand(dev, 3, 1024)
    Rr, Ri = cuda_fft._r2c_launch(r, None, False)
    g = rrand(dev, 3, 1000)
    s, w = rrand(dev, 2, 4096), torch.hann_window(256, device=dev)
    (cr, ci, bfr, bfi), m = bluestein._chirp_tables(1031, -1, dev)
    return {
        "rows_fft": lambda: cuda_fft._launch(re, im, -1, None),
        "rows_fft c64": lambda: cuda_fft._launch_c64(torch.complex(re, im), -1, None),
        "ax0_fft": lambda: cuda_fft._ax0_launch(*planar(2, 128, 5), -1, None),
        "rows_t_fft": lambda: cuda_fft._rows_t_launch(re, im, -1, None, None),
        "big_fft": lambda: bigfft._launch(*planar(1, 1 << 15), -1, None),
        "big_fft c64": lambda: bigfft._launch_c64(crand(dev, 1, 1 << 15), -1, None),
        "fft2f_fft": lambda: cuda_fft._fft2f_launch(*planar(2, 128, 128), -1, None),
        "r2c_fft": lambda: cuda_fft._r2c_launch(r, None, False),
        "c2r_fft": lambda: cuda_fft._c2r_launch(Rr, Ri, 1024, None),
        "c2r_fft c64": lambda: cuda_fft._c2r_launch_c64(torch.complex(Rr, Ri), 1024, None),
        "c2r_prod": lambda: cuda_fft._c2r_prod_launch(Rr, Ri, Rr, Ri, 1024, None),
        "gen_fft": lambda: cuda_fft._gen_launch(g, g, -1, None),
        "r2c_gen_fft": lambda: cuda_fft._r2c_gen_launch(g, None, False),
        "ax0_gen": lambda: cuda_fft._ax0_launch(*planar(1000, 3), -1, None),
        "chirp_fwd": lambda: cuda_fft._chirp_fwd_launch(*planar(2, 1031), cr, ci, m, -1),
        "chirp_full": lambda: cuda_fft._chirp_full_launch(*planar(2, 1031), cr, ci, bfr, bfi,
                                                          cr, ci, m, 1031, 1.0 / m),
        "chirp_inv": lambda: cuda_fft._chirp_inv_launch(*planar(2, m), bfr, bfi, cr, ci, 1031,
                                                        1, 1.0 / m),
        "filt": lambda: cuda_fft._filt(re, im, hr, hi, -1, None),
        "bank": lambda: cuda_fft._bank(hr, hi, re, im, -1, None),
        "welch": lambda: cuda_welch.welch_accum_split(s, w, 256, 128, 256, "constant"),
        "psd": lambda: cuda_welch.spec_psd_split(s, w, 256, 128, 256, "constant"),
        "csd": lambda: cuda_welch.csd_accum_split(s, s, w, 256, 128, 256, "constant"),
        "coh": lambda: cuda_welch.coherence_accum_split(s, s, w, 256, 128, 256, "constant"),
        "c2c": lambda: cuda_welch.welch_accum_c2c_split(s, s, w, 256, 128, 256, "constant"),
        "spec": lambda: cuda_welch.spec_rfft_split(s, w, 256, 128, 256, "constant", roll_s=3),
        "spec_c2c": lambda: cuda_welch.spec_c2c_split(s, s, w, 256, 128, 256, "constant"),
        "filt c64": lambda: cuda_fft._filt_launch_c64(torch.complex(re, im),
                                                      torch.complex(hr, hi), -1, None),
        "c2c c64": lambda: cuda_welch.welch_accum_c2c_c64(torch.complex(s, s), w, 256, 128,
                                                          256, "constant"),
        "spec_c2c c64": lambda: cuda_welch.spec_c2c_c64(torch.complex(s, s), w, 256, 128, 256,
                                                        "constant"),
    }


def test_kernels_leave_current_device(dev):
    """Each launch runs on its tensors' device inside a device guard; the
    thread's current device is what it was (with two cards or more the
    current device is set to another card than the tensors')."""
    calls = _every_kernel(dev)
    other = torch.cuda.device_count() - 1
    prev = torch.cuda.current_device()
    torch.cuda.set_device(other)
    try:
        for name, call in calls.items():
            before = _counts()
            call()
            torch.cuda.synchronize(dev)
            assert torch.cuda.current_device() == other, name
            assert sum(_counts().values()) > sum(before.values()), name
    finally:
        torch.cuda.set_device(prev)


# ---------------------------------------------------------------------- #
# the fused segment-spectrum kernels: B16 (welch), B19 (psd), B17 (csd),
# B18 (coh), B21 (c2c: y is the imaginary plane; c2c_c64: the complex64
# signal x + iy as it lies), B20 (spec), B22 (spec_c2c: y is the imaginary
# plane) and the spectral estimators' routes
# ---------------------------------------------------------------------- #
WELCH_KINDS = ("welch", "psd", "csd", "coh", "c2c", "c2c_c64", "spec", "spec_c2c")


def _launches(kind):
    """The counters a call of ``kind`` moves: B21's complex64 entry counts
    as c2c too."""
    return {kind: 1, "c2c": 1} if kind == "c2c_c64" else {kind: 1}


def _welch_call(kind, x, y, w, args, plain=False, **opts):
    suffix = "_reference" if plain else ""
    if kind == "spec":
        return getattr(cuda_welch, "spec_rfft_split" + suffix)(x, w, *args, **opts)
    if kind == "spec_c2c":
        return getattr(cuda_welch, "spec_c2c_split" + suffix)(x, y, w, *args)
    if kind == "welch":
        return (getattr(cuda_welch, "welch_accum_split" + suffix)(x, w, *args)[0],)
    if kind == "psd":
        return (getattr(cuda_welch, "spec_psd_split" + suffix)(x, w, *args),)
    if kind == "c2c":
        return (getattr(cuda_welch, "welch_accum_c2c_split" + suffix)(x, y, w, *args)[0],)
    if kind == "c2c_c64":
        return (getattr(cuda_welch, "welch_accum_c2c_c64" + suffix)(torch.complex(x, y), w,
                                                                   *args)[0],)
    fn = "csd_accum_split" if kind == "csd" else "coherence_accum_split"
    return getattr(cuda_welch, fn + suffix)(x, y, w, *args)[:-1]


def _welch_oracle(kind, x, y, w, nperseg, hop, nfft, detrend, roll_s=0, pad_out=False):
    """float64 torch.fft of the frames: an oracle, never the implementation."""
    def spectra(v):
        fr = v.unfold(-1, nperseg, hop)
        if detrend == "constant":
            fr = fr - fr.mean(-1, keepdim=True)
        fr = torch.nn.functional.pad(fr * w.double(), (0, nfft - nperseg)).roll(-roll_s, -1)
        return (torch.fft.fft if v.is_complex() else torch.fft.rfft)(fr)

    if kind == "spec":
        X = spectra(x.double())
        if pad_out:
            X = torch.nn.functional.pad(X, (0, cuda_fft.pad_bins(nfft) - X.shape[-1]))
        return X.real, X.imag
    if kind == "spec_c2c":
        X = spectra(torch.complex(x.double(), y.double()))
        return X.real, X.imag
    if kind in ("c2c", "c2c_c64"):
        return ((spectra(torch.complex(x.double(), y.double())).abs() ** 2).sum(-2),)
    X = spectra(x.double())
    if kind == "psd":
        return (X.abs() ** 2,)
    if kind == "welch":
        return ((X.abs() ** 2).sum(-2),)
    Y = spectra(y.double())
    P = (X.conj() * Y).sum(-2)
    outs = (P.real, P.imag)
    return outs + ((X.abs() ** 2).sum(-2), (Y.abs() ** 2).sum(-2)) if kind == "coh" else outs


def _stack(outs):
    return torch.stack([o.reshape(-1) for o in outs])


@pytest.mark.parametrize("nfft", [1 << e for e in range(7, 15)])
@pytest.mark.parametrize("kind", WELCH_KINDS)
def test_welch_kernels_match_plain_and_torch_fft(dev, nfft, kind):
    """Each kernel against its plain version and float64 torch.fft at 38
    segments (a ragged last tile) and at 37 and 39 (odd counts: B16's and
    B19's last frame paired with a zero plane, B17's and B18's last
    unswapped), one signal and batches of 3 and 5, hops even and odd,
    nperseg = nfft and below; B16, B17, B18 and B21 (both entries; the
    complex64 one also on a real signal, no imaginary plane) also against
    the plain version of their own passes and epilogue (``_acc_passes``;
    B16: of both its designs), B19 against the plain version of its passes
    and epilogue (``_psd_passes``)."""
    cases = 0
    for nperseg in (nfft, nfft - nfft // 4 + 1):
        for hop in (nperseg, nperseg // 2, nperseg - nperseg // 8):
            for lead, detrend, num in (((), False, 38), ((3,), "constant", 38),
                                       ((), "constant", 37), ((5,), False, 39)):
                t = nperseg + (num - 1) * hop + hop // 3  # a ragged last tile
                x, y = rrand(dev, *lead, t, seed=1), rrand(dev, *lead, t, seed=2)
                w = torch.hann_window(nperseg, device=dev) + 0.1
                args = (nperseg, hop, nfft, detrend)
                got = _through(lambda: _welch_call(kind, x, y, w, args), **_launches(kind))
                plain = _welch_call(kind, x, y, w, args, plain=True)
                want = _welch_oracle(kind, x, y, w, *args)
                what = (nperseg, hop, lead, num)
                assert rel_l2(_stack(got), _stack(plain)) < TOL, what
                assert rel_l2(_stack(got), _stack(want)) < TOL, what
                acc = "c2c" if kind == "c2c_c64" else kind
                for half in {"welch": (False, True), "coh": (False,), "csd": (False,),
                             "c2c": (False,)}.get(acc, ()):
                    passes = cuda_welch._acc_passes(acc, torch.complex(x, y) if kind == "c2c_c64"
                                                    else x, y, w, *args, half=half)
                    assert rel_l2(_stack(got), _stack(passes)) < TOL, what
                if kind == "c2c_c64":  # a real signal taken two-sided: no imaginary plane
                    got = _through(lambda: cuda_welch.welch_accum_c2c_c64(x, w, *args)[0],
                                   c2c=1, c2c_c64=1)
                    passes = cuda_welch._acc_passes("c2c", x, None, w, *args)[0]
                    assert rel_l2(got, passes) < TOL, what
                    assert rel_l2(got, _welch_oracle(kind, x, torch.zeros_like(x), w,
                                                     *args)[0]) < TOL, what
                if kind == "psd":
                    assert rel_l2(got[0], cuda_welch._psd_passes(x, w, *args)) < TOL, what
                cases += 1
    assert cases == 24


def test_welch_kernels_are_bit_identical_across_runs(dev):
    x, y = rrand(dev, 1 << 22, seed=1), rrand(dev, 1 << 22, seed=2)
    w = torch.hann_window(4096, device=dev)
    for kind in WELCH_KINDS:
        a = _welch_call(kind, x, y, w, (4096, 2048, 4096, "constant"))
        b = _welch_call(kind, x, y, w, (4096, 2048, 4096, "constant"))
        assert all(torch.equal(u, v) for u, v in zip(a, b)), kind
    a = cuda_welch.spec_rfft_split(x, w, 4096, 2048, 4096, False, pad_out=True, roll_s=100)
    b = cuda_welch.spec_rfft_split(x, w, 4096, 2048, 4096, False, pad_out=True, roll_s=100)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    x = rrand(dev, 64, 1 << 16, seed=3)  # many small blocks
    w = torch.hann_window(256, device=dev)
    a = cuda_welch.welch_accum_split(x, w, 256, 128, 256, "constant")[0]
    assert torch.equal(a, cuda_welch.welch_accum_split(x, w, 256, 128, 256, "constant")[0])


@pytest.mark.parametrize("nfft", [1 << e for e in range(7, 15)])
def test_spec_kernel_roll_and_padded_output(dev, nfft):
    """B20 with a left roll of each padded frame (ShortTimeFFT's phase
    shift) and the padded serving form, whose extra columns are zeros."""
    for nperseg, roll_s in ((nfft, nfft // 2 + 1), (nfft - nfft // 4 + 1, nfft - 1),
                            (nfft // 2, 7)):
        hop = max(nperseg // 4, 1)
        t = nperseg + 37 * hop + hop // 3
        x = rrand(dev, 2, t, seed=nperseg)
        w = torch.hann_window(nperseg, device=dev) + 0.1
        args = (nperseg, hop, nfft, "constant")
        for pad_out in (False, True):
            opts = {"roll_s": roll_s, "pad_out": pad_out}
            got = _through(lambda: _welch_call("spec", x, None, w, args, **opts), spec=1)
            plain = _welch_call("spec", x, None, w, args, plain=True, **opts)
            want = _welch_oracle("spec", x, None, w, *args, **opts)
            assert got[0].shape == (2, 38, cuda_fft.pad_bins(nfft) if pad_out else nfft // 2 + 1)
            assert rel_l2(_stack(got), _stack(plain)) < TOL, (nperseg, roll_s, pad_out)
            assert rel_l2(_stack(got), _stack(want)) < TOL, (nperseg, roll_s, pad_out)
            if pad_out:
                assert not got[0][..., nfft // 2 + 1:].any()
                assert not got[1][..., nfft // 2 + 1:].any()


def test_welch_kernels_raise_outside_envelope(dev):
    x, w = rrand(dev, 4096), torch.ones(512, device=dev)
    with pytest.raises(cuda_welch.Unsupported):
        cuda_welch.welch_accum_split(x, w, 512, 256, 512, "linear")
    with pytest.raises(cuda_welch.Unsupported):
        cuda_welch.spec_c2c_split(x, x[:4000], w, 512, 256, 512, False)
    with pytest.raises(ValueError, match="roll_s"):
        cuda_welch.spec_rfft_split(x, w, 512, 256, 512, False, roll_s=512)
    with pytest.raises(cuda_welch.Unsupported):
        cuda_welch.spec_psd_split(x, w, 512, 256, 32768, False)
    with pytest.raises(ValueError, match="win"):
        cuda_welch.welch_accum_split(x, w.cpu(), 512, 256, 512, False)


@pytest.mark.parametrize("kind", WELCH_KINDS)
def test_grad_welch_kernels_match_plain(dev, kind):
    """Backward: the frames rebuilt and run through B6 under autograd (B6
    forward, B1 back, for each signal; B21: B1 forward and back, through its
    complex64 entry for B21's)."""
    x0, y0 = rrand(dev, 2, 5000, seed=4), rrand(dev, 2, 5000, seed=5)
    w = torch.hann_window(512, device=dev)
    args = (512, 200, 1024, "constant")

    def grad(plain):
        x, y = x0.clone().requires_grad_(), y0.clone().requires_grad_()
        outs = _welch_call(kind, x, y, w, args, plain=plain)
        if kind in ("spec", "spec_c2c"):
            # weighted powers of the spectra: a weighted sum of the spectra
            # themselves is a ramp's transform, whose large DC term the
            # detrend cancels, leaving float32 rounding of 1e-4
            outs = [o * o for o in outs]
        loss = sum((torch.linspace(0.5, 1.5, o.numel(), device=dev).reshape(o.shape) * o).sum()
                   for o in outs)
        loss.backward()
        return torch.cat([x.grad.reshape(-1)] + ([y.grad.reshape(-1)] if kind in (
            "csd", "coh", "c2c", "c2c_c64", "spec_c2c") else []))

    two = 2 if kind in ("csd", "coh") else 1
    back = ({"rows_fft": 2} if kind in ("c2c", "c2c_c64", "spec_c2c")
            else {"r2c_fft": two, "rows_fft": two})
    gk = _through(lambda: grad(False), **_launches(kind), **back)
    assert rel_l2(gk, grad(True)) < TOL


def test_csd_of_independent_signals_at_many_segments(dev):
    """B17 at 32767 segments of two independent 2^22 signals (nperseg
    256): the transform's rounding leaks a bias into conj(X) Y that grows
    as the segment count, the cross spectrum only as its square root; the
    planes swapped on odd segments cancel it (scipy.signal in float64)."""
    import scipy.signal as ss

    x, y = rrand(dev, 1 << 22, seed=12), rrand(dev, 1 << 22, seed=13)
    P = _through(lambda: ft.csd(x, y, nperseg=256)[1], csd=1)
    want = ss.csd(x.double().cpu().numpy(), y.double().cpu().numpy(), nperseg=256)[1]
    assert rel_l2(P.cpu(), torch.from_numpy(want)) < TOL


@pytest.mark.parametrize("source", ["complex64", "real"])
def test_two_sided_welch_reads_the_signal_as_it_lies(dev, source):
    """The two-sided welch of a complex64 signal, or of a real one: one
    launch of B21 (its complex64 entry), no copy of the signal's planes and
    no zero imaginary plane (no copy kernel in the profiler's window; the
    call's peak allocation below one plane's bytes)."""
    n = 1 << 22
    x = crand(dev, n, seed=14) if source == "complex64" else rrand(dev, n, seed=14)
    seg = {"nperseg": 4096, "noverlap": 2048, "return_onesided": False}

    def call():
        return ft.welch(x, **seg)[1]

    P = _through(call, c2c=1, c2c_c64=1)
    assert rel_l2(P.cpu(), ft.welch(x.cpu(), **seg)[1]) < TOL
    names = _device_kernels(call, calls=10)
    assert any("welch_acc_kernel" in k for k in names), names
    assert not any("copy" in k for k in names), names
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    call()
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base < 4 * n


def test_spectral_estimator_routes(dev):
    """Each estimator on the card takes its route with exact launches and
    matches the same call on CPU tensors (the composed route)."""
    x, y = rrand(dev, 3, 1 << 16, seed=6), rrand(dev, 3, 1 << 16, seed=7)
    xc = crand(dev, 1 << 14, seed=8)
    calls = [
        ("welch", lambda v, u: ft.welch(v, nperseg=1024)[1], {"welch": 1}),
        ("welch scipy defaults", lambda v, u: ft.welch(v)[1], {"welch": 1}),
        ("welch median", lambda v, u: ft.welch(v[0], nperseg=512, average="median")[1],
         {"psd": 1}),
        ("periodogram", lambda v, u: ft.periodogram(v[:, :16384])[1], {"welch": 1}),
        ("csd", lambda v, u: ft.csd(v, u, nperseg=2048)[1], {"csd": 1}),
        ("coherence", lambda v, u: ft.coherence(v, u, nperseg=512)[1], {"coh": 1}),
        ("spectrogram", lambda v, u: ft.spectrogram(v, nperseg=1024)[2], {"psd": 1}),
        ("spectrogram magnitude",
         lambda v, u: ft.spectrogram(v, nperseg=1024, mode="magnitude")[2], {"psd": 1}),
        ("spectrogram complex", lambda v, u: ft.spectrogram(v, nperseg=1024, mode="complex")[2],
         {"spec": 1}),
        ("spectrogram phase", lambda v, u: ft.spectrogram(v, nperseg=1024, mode="phase")[2],
         {"spec": 1}),
        ("spectrogram two-sided",
         lambda v, u: ft.spectrogram(v, nperseg=1024, return_onesided=False)[2],
         {"spec_c2c": 1, "spec_c2c_c64": 1}),
        ("welch linear", lambda v, u: ft.welch(v, nperseg=1024, detrend="linear")[1],
         {"r2c_fft": 1}),
        ("multitaper", lambda v, u: ft.multitaper(v[0, :16384], NW=4.0)[1], {"r2c_fft": 1}),
        ("welch two-sided", lambda v, u: ft.welch(v, nperseg=1024, return_onesided=False)[1],
         {"c2c": 1, "c2c_c64": 1}),
        ("csd two-sided", lambda v, u: ft.csd(v, u, nperseg=1024, return_onesided=False)[1],
         {"spec_c2c": 2, "spec_c2c_c64": 2}),
        ("csd unequal shapes", lambda v, u: ft.csd(v, u[0], nperseg=1024)[1], {"spec": 2}),
    ]
    for what, call, want in calls:
        got = _through(lambda: call(x, y), **want)
        assert got.device.type == "cuda", what
        assert rel_l2(got.cpu(), call(x.cpu(), y.cpu())) < TOL, what
    got = _through(lambda: ft.welch(xc, nperseg=4096)[1], c2c=1, c2c_c64=1)  # complex: B21
    assert rel_l2(got.cpu(), ft.welch(xc.cpu(), nperseg=4096)[1]) < TOL
    for what, call, want in (  # complex input: B22
            ("complex spectrogram", lambda v: ft.spectrogram(v, nperseg=1024, mode="complex")[2],
             {"spec_c2c": 1, "spec_c2c_c64": 1}),
            ("complex csd", lambda v: ft.csd(v, v * 2, nperseg=1024)[1],
             {"spec_c2c": 2, "spec_c2c_c64": 2}),
            ("complex welch median",
             lambda v: ft.welch(v, nperseg=1024, average="median")[1],
             {"spec_c2c": 1, "spec_c2c_c64": 1})):
        got = _through(lambda: call(xc), **want)
        assert rel_l2(got.cpu(), call(xc.cpu())) < TOL, what
    f, P = ft.welch(x.cpu().numpy()[0], nperseg=1024)  # numpy input: the current card
    assert P.device.type == "cuda" and f.device.type == "cuda"


# ---------------------------------------------------------------------- #
# the per-segment spectra: stft, istft, ShortTimeFFT and resample
# ---------------------------------------------------------------------- #
def test_segment_spectra_routes(dev):
    """stft and ShortTimeFFT.stft launch B20 once in the envelope, istft
    the C2R kernel, resample the plan's real kernels; each matches the same
    call on CPU tensors."""
    x = rrand(dev, 2, 1 << 14, seed=9)
    w = torch.from_numpy(np.hanning(256).astype(np.float32))
    S = ft.ShortTimeFFT(w.numpy(), 64, 1.0, mfft=512, phase_shift=40)
    calls = [
        ("stft", lambda v: ft.stft(v, 512, 128), {"spec": 1}),
        ("stft win_length", lambda v: ft.stft(v, 512, 100, win_length=300), {"spec": 1}),
        ("stft composite n_fft", lambda v: ft.stft(v, 1000, 250), {"r2c_gen_fft": 1}),
        ("istft", lambda v: ft.istft(ft.stft(v.cpu(), 512, 128).to(v.device), 512, 128),
         {"c2r_fft": 1}),
        ("ShortTimeFFT.stft", lambda v: S.stft(v), {"spec": 1}),
        ("ShortTimeFFT.istft", lambda v: S.istft(S.stft(v.cpu()).to(v.device),
                                                 k1=v.shape[-1]), {"c2r_fft": 1}),
        ("ShortTimeFFT two-sided", lambda v: ft.ShortTimeFFT(
            w.numpy(), 64, 1.0, fft_mode="twosided").stft(v), {"rows_fft": 1}),
        ("resample down", lambda v: ft.resample(v, 1 << 13, axis=-1), {"r2c_fft": 1,
                                                                       "c2r_fft": 1}),
    ]
    for what, call, want in calls:
        got = _through(lambda: call(x), **want)
        assert got.device.type == "cuda", what
        assert rel_l2(got.cpu(), call(x.cpu())) < TOL, what


def test_segment_spectra_never_compose_on_the_card(dev, monkeypatch):
    """A CUDA tensor in the envelope runs B20 or B22: the plain versions,
    the composed form and the plan's transforms are never reached."""
    from fft_wgpu_tpu_torch.ops import short_time_fft, spectral_est
    from fft_wgpu_tpu_torch.ops import stft as stft_mod

    def refuse(name):
        def fail(*a, **k):
            raise AssertionError(f"{name} ran on the card")
        return fail

    for mod, name in ((cuda_welch, "_composed"), (cuda_welch, "_reference"),
                      (cuda_fft, "rfft_rows_split"), (cuda_fft, "fft_batched_split"),
                      (spectral_est, "rfft_last_split"), (spectral_est, "fftn_split"),
                      (stft_mod, "_rfft_split"), (short_time_fft, "rfft_last_split"),
                      (short_time_fft, "fftn_split")):
        monkeypatch.setattr(mod, name, refuse(f"{mod.__name__}.{name}"))
    x, xc = rrand(dev, 1 << 15, seed=10), crand(dev, 1 << 15, seed=11)
    S = ft.ShortTimeFFT(np.hanning(512), 128, 1.0, mfft=1024)
    for call, want in ((lambda: ft.stft(x, 512, 128), {"spec": 1}),
                       (lambda: S.stft(x), {"spec": 1}),
                       (lambda: ft.spectrogram(x, nperseg=1024, mode="complex"), {"spec": 1}),
                       (lambda: ft.spectrogram(xc, nperseg=1024),
                        {"spec_c2c": 1, "spec_c2c_c64": 1}),
                       (lambda: ft.csd(xc, x, nperseg=1024), {"spec_c2c": 2, "spec_c2c_c64": 2})):
        _through(call, **want)


def test_grad_segment_spectra_match_plain(dev):
    """d/dx of stft and of ShortTimeFFT.stft with a phase shift: B20
    forward, B6 and B1 back; against the CPU route."""
    x0 = rrand(dev, 4096, seed=12)
    S = ft.ShortTimeFFT(np.hanning(256), 64, 1.0, mfft=512, phase_shift=30)
    for what, call in (("stft", lambda v: ft.stft(v, 512, 128)), ("ShortTimeFFT", S.stft)):
        def grad(v):
            v = v.clone().requires_grad_()
            y = call(v)
            (torch.linspace(0.5, 1.5, y.numel(), device=v.device).reshape(y.shape)
             * y.abs() ** 2).sum().backward()
            return v.grad

        gk = _through(lambda: grad(x0), spec=1, r2c_fft=1, rows_fft=1)
        assert rel_l2(gk.cpu(), grad(x0.cpu())) < TOL, what


# ---------------------------------------------------------------------- #
# B2/B3 (ax0_fft) and B6 (r2c_fft) on the compiled pow2 passes: both
# layouts and sinks, the complex64 entries and the routes through them
# ---------------------------------------------------------------------- #
POW2 = [1 << e for e in range(7, 15)]


def _column_entry(kind, layout):
    """B2 (axis -2) or B3 (axis -3, the free view) in one of its layouts and
    its plain version, each as fn(x, sign, scale) on a complex64 x; the
    axis and the launch counter of the kind."""
    entries = {
        ("axis0", "planar"): (_planes(cuda_fft.fft_axis0_split),
                              _planes(cuda_fft.fft_axis0_split_reference)),
        ("axis0", "c64"): (cuda_fft.fft_axis0_c64, cuda_fft.fft_axis0_c64_reference),
        ("axis3", "planar"): (_planes(cuda_fft.fft_axis3_split),
                              _planes(cuda_fft.fft_axis3_split_reference)),
        ("axis3", "c64"): (cuda_fft.fft_axis3_c64, cuda_fft.fft_axis3_c64_reference)}
    return (*entries[kind, layout], -2 if kind == "axis0" else -3,
            "ax0_fft" if kind == "axis0" else "ax3")


def _c64_counts():
    return (cuda_fft.c64_launches, cuda_fft.ax0_c64_launches, cuda_fft.ax3_c64_launches,
            cuda_fft.r2c_c64_launches)


@pytest.mark.parametrize("layout", ["planar", "c64"])
@pytest.mark.parametrize("kind", ["axis0", "axis3"])
@pytest.mark.parametrize("n", POW2)
def test_column_kernel_matches_float64(dev, n, kind, layout):
    # odd column counts and ragged last tiles (8, 16 or 32 columns a tile),
    # both signs, three scales, against the plain version and float64
    kernel, plain, axis, counter = _column_entry(kind, layout)
    shapes = [(n, 37), (2, n, 130)] if kind == "axis0" else [(2, n, 7, 13), (1, n, 3, 40)]
    for shape in shapes:
        x = crand(dev, *shape)
        x64 = x.to(torch.complex128)
        for sign in (-1, 1):
            for scale in (None, 1.0 / n, n ** -0.5):
                before = _c64_counts()
                k = _through(lambda: kernel(x, sign, scale), **{counter: 1})
                grew = tuple(a - b for a, b in zip(_c64_counts(), before))
                c64 = int(layout == "c64")
                assert grew == (0, c64 * (kind == "axis0"), c64 * (kind == "axis3"), 0)
                p = plain(x, sign, scale)
                o = (torch.fft.fft(x64, dim=axis) if sign < 0
                     else torch.fft.ifft(x64, dim=axis, norm="forward"))
                o = o * (1.0 if scale is None else scale)
                assert k.dtype == torch.complex64 and k.shape == x.shape
                assert rel_l2(k, p) < TOL and rel_l2(k, o) < TOL, (shape, sign, scale)


@pytest.mark.parametrize("n", POW2)
def test_column_kernel_runs_in_place(dev, n):
    # out = in, both layouts: every block (cluster) reads its tile whole
    # before it stores; the planar one through Plan(donate=True)
    x = crand(dev, 2, n, 45)
    want = torch.fft.fft(x.to(torch.complex128), dim=-2)
    y = x.clone()
    assert cuda_fft._ax0_launch_c64(y, -1, None, out=y) is y
    assert rel_l2(y, want) < TOL
    re, im = x.real.contiguous(), x.imag.contiguous()
    ptrs = (re.data_ptr(), im.data_ptr())
    before = cuda_fft.ax0_launches
    out = ft.plan(n, donate=True).forward_split(re, im, axis=-2)
    assert out[0] is re and out[1] is im and (re.data_ptr(), im.data_ptr()) == ptrs
    assert cuda_fft.ax0_launches == before + 1
    assert rel_l2(torch.complex(re, im), want) < TOL


@pytest.mark.parametrize("n", POW2)
@pytest.mark.parametrize("rows", [(1,), (37,), (2, 3)])
def test_r2c_complex64_sink_matches_float64(dev, n, rows):
    x = rrand(dev, *rows, n)
    X64 = torch.fft.rfft(x.double())
    for scale in (None, 1.0 / n, n ** -0.5):
        before = cuda_fft.r2c_c64_launches
        k = _through(lambda: cuda_fft.rfft_rows_c64(x, scale), r2c_fft=1)
        assert cuda_fft.r2c_c64_launches == before + 1
        p = cuda_fft.rfft_rows_c64_reference(x, scale)
        assert k.dtype == torch.complex64 and k.shape == (*rows, n // 2 + 1)
        s = 1.0 if scale is None else scale
        assert rel_l2(k, p) < TOL and rel_l2(k, X64 * s) < TOL, scale
        # the planar sink from the same kernel template: the same bits
        kr, ki = cuda_fft._r2c_launch(x, scale, False)
        assert torch.equal(torch.complex(kr, ki), k)
    # an input not 8-byte aligned is copied first, as the pairs need
    xo = rrand(dev, 3 * n + 1)[1:].view(3, n)
    assert rel_l2(cuda_fft.rfft_rows_c64(xo), torch.fft.rfft(xo.double())) < TOL


@pytest.mark.parametrize("entry", ["axis0_c64", "axis3_c64", "axis0_planar_16384", "r2c_c64"])
def test_grad_c64_entries_match_plain(dev, entry):
    # forward and backward: the entry's kernel twice (r2c: r2c_fft, then the
    # row kernel's complex64 entry)
    if entry == "r2c_c64":
        x = rrand(dev, 8, 2048, seed=2)

        def grad(f):
            t = x.clone().requires_grad_()
            y = f(t)
            w = torch.linspace(0.5, 1.5, y.numel(), device=dev).reshape(y.shape)
            (w * y.abs() ** 2).sum().backward()
            return t.grad

        before = _c64_counts()
        gk = _through(lambda: grad(lambda t: cuda_fft.rfft_rows_c64(t, 2048 ** -0.5)),
                      r2c_fft=1, rows_fft=1)
        assert tuple(a - b for a, b in zip(_c64_counts(), before)) == (1, 0, 0, 1)
        gp = grad(lambda t: cuda_fft.rfft_rows_c64_reference(t, 2048 ** -0.5))
        assert rel_l2(gk, gp) < TOL
        return
    if entry == "axis0_planar_16384":
        run = _grad(16384, 20)
        gk = _through(lambda: run(lambda r, i: cuda_fft.fft_axis0_split(r, i, 1, 1e-3)),
                      ax0_fft=2)
        gp = run(lambda r, i: cuda_fft.fft_axis0_split_reference(r, i, 1, 1e-3))
        assert rel_l2(gk, gp) < TOL
        return
    kind = entry.split("_")[0]
    kernel, plain, _, counter = _column_entry(kind, "c64")
    x = crand(dev, *((2, 4096, 130) if kind == "axis0" else (2, 1024, 9, 13)), seed=1)
    w = torch.linspace(0.5, 1.5, x.numel(), device=dev).reshape(x.shape)
    gk = _through(lambda: _grad_c64(lambda z: kernel(z, 1, 0.5), x, w), **{counter: 2})
    gp = _grad_c64(lambda z: plain(z, 1, 0.5), x, w)
    assert rel_l2(gk, gp) < TOL


def test_complex64_nd_and_rfft_routes(dev):
    # fft2 of a 4096^2 complex64 plane: the row kernel's complex64 entry and
    # the axis(-2) kernel's, one launch each and no other device work (no
    # split, no merge); rfft of 4096^2 float32: r2c_fft's complex64 sink
    # alone; ifft2, fftn of other axes and a plan on axis 0 take the same
    # entries; the fused plane and composite axes keep their routes
    # (the launch counts from the counters, the kernels' names over ten calls
    # from the profiler, whose windows on the card drop device events)
    x = crand(dev, 4096, 4096)
    names = _device_kernels(lambda: ft.fft2(x), calls=10, per_call=2)
    assert {next((k for k in ("ax0_fft_kernel", "rows_fft_kernel") if k in name), name)
            for name in names} == {"ax0_fft_kernel", "rows_fft_kernel"}, names
    before = _c64_counts()
    X = _through(lambda: ft.fft2(x), rows_fft=1, ax0_fft=1)
    assert tuple(a - b for a, b in zip(_c64_counts(), before)) == (1, 1, 0, 0)
    assert X.dtype == torch.complex64 and rel_l2(X, torch.fft.fft2(x.to(torch.complex128))) < TOL
    assert rel_l2(_through(lambda: ft.ifft2(X, norm="ortho"), rows_fft=1, ax0_fft=1),
                  torch.fft.ifft2(X, norm="ortho")) < TOL
    r = rrand(dev, 4096, 4096)
    names = _device_kernels(lambda: ft.rfft(r), calls=10)
    assert names and all("r2c_fft_kernel" in name for name in names), names
    before = _c64_counts()
    R = _through(lambda: ft.rfft(r), r2c_fft=1)
    assert tuple(a - b for a, b in zip(_c64_counts(), before)) == (0, 0, 0, 1)
    assert R.dtype == torch.complex64 and R.shape == (4096, 2049)
    assert rel_l2(R, torch.fft.rfft(r.double())) < TOL
    r3 = rrand(dev, 256, 3, 512)  # along another axis: the moved axis, copied once
    assert rel_l2(_through(lambda: ft.rfft(r3, axis=0, norm="ortho"), r2c_fft=1),
                  torch.fft.rfft(r3.double(), dim=0, norm="ortho")) < TOL
    y = crand(dev, 128, 3, 256)
    before = _c64_counts()
    Y = _through(lambda: ft.fftn(y, axes=(0, 2)), rows_fft=1, ax3=1)
    assert tuple(a - b for a, b in zip(_c64_counts(), before)) == (1, 0, 1, 0)
    assert rel_l2(Y, torch.fft.fftn(y, dim=(0, 2))) < TOL
    z = crand(dev, 2048, 64)
    before = _c64_counts()
    Z = _through(lambda: ft.plan(2048).forward(z, axis=0), ax0_fft=1)
    assert tuple(a - b for a, b in zip(_c64_counts(), before)) == (0, 1, 0, 0)
    assert rel_l2(Z, torch.fft.fft(z, dim=0)) < TOL
    before = _c64_counts()
    _through(lambda: ft.fft2(crand(dev, 8, 256, 256)), fft2f_fft=1)
    _through(lambda: ft.fft2(crand(dev, 1080, 1920)), gen_fft=1, ax0_gen=1)
    assert _c64_counts() == before


# ---------------------------------------------------------------------- #
# B5 (fft2f_fft) and B20 (spec_fft) on the compiled pow2 passes: both
# layouts and sinks, the complex64 entries and the routes through them
# ---------------------------------------------------------------------- #
def _fused_c64_counts():
    return (cuda_fft.fft2f_c64_launches, cuda_fft.ax3_c64_launches,
            cuda_welch.spec_c64_launches)


@pytest.mark.parametrize("A,B", PLANES)
@pytest.mark.parametrize("lead", [(), (3,), (2, 5)])
def test_fft2_fused_c64_kernel_matches_plain(dev, A, B, lead):
    # the complex64 entry against the plain version of its own passes and
    # exchange and against float64 torch.fft, both signs, and in place
    x = crand(dev, *lead, A, B)
    want = torch.fft.fft2(x.to(torch.complex128))
    for sign, scale in ((-1, None), (1, 1.0 / (A * B))):
        o = want if sign < 0 else torch.fft.ifft2(x.to(torch.complex128), norm="forward") * scale
        before = _fused_c64_counts()
        k = _through(lambda: cuda_fft.fft2_fused_c64(x, sign, scale), fft2f_fft=1)
        assert _fused_c64_counts()[0] == before[0] + 1
        assert rel_l2(k, cuda_fft._fft2f_passes(x, sign, scale)) < TOL, sign
        assert rel_l2(k, o) < TOL, sign
    y = x.clone()
    assert cuda_fft._fft2f_launch_c64(y, -1, None, out=y) is y
    assert rel_l2(y, want) < TOL


def test_grad_fft2_fused_c64_matches_plain(dev):
    x = crand(dev, 4, 128, 512, seed=3)
    w = torch.linspace(0.5, 1.5, x.numel(), device=dev).reshape(x.shape)
    gk = _through(lambda: _grad_c64(lambda z: cuda_fft.fft2_fused_c64(z, 1, 0.5), x, w),
                  fft2f_fft=2)
    gp = _grad_c64(lambda z: cuda_fft.fft2_fused_c64_reference(z, 1, 0.5), x, w)
    assert rel_l2(gk, gp) < TOL


@pytest.mark.parametrize("nfft", POW2)
def test_spec_c64_sink_matches_plain(dev, nfft):
    # B20's complex64 sink against the plain version of its passes and
    # float64 torch.fft: odd nperseg, a roll (odd: scalar loads; even: pair
    # loads), a ragged last group of segments, the reflect pad of stft
    for nperseg, roll_s, pad in ((nfft, 0, 0), (nfft - nfft // 4 + 1, nfft // 2 + 1, 0),
                                 (nfft // 2, 6, 0), (nfft, 0, nfft // 2)):
        hop = max(nperseg // 4, 1)
        t = nperseg + 37 * hop + hop // 3
        x = rrand(dev, 2, t, seed=nperseg)
        w = torch.hann_window(nperseg, device=dev) + 0.1
        for detrend in (False, "constant"):
            before = _fused_c64_counts()
            got = _through(lambda: cuda_welch.spec_rfft_c64(x, w, nperseg, hop, nfft, detrend,
                                                             roll_s=roll_s, pad=pad), spec=1)
            assert _fused_c64_counts()[2] == before[2] + 1
            plain = cuda_welch._spec_passes(x, w, nperseg, hop, nfft, detrend, roll_s, pad=pad)
            v = torch.nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
            want = torch.complex(*_welch_oracle("spec", v.double(), None, w, nperseg, hop,
                                                nfft, detrend, roll_s=roll_s))
            assert got.dtype == torch.complex64 and got.shape == want.shape
            assert rel_l2(got, plain) < TOL and rel_l2(got, want) < TOL, (nperseg, roll_s, pad)
            again = cuda_welch.spec_rfft_c64(x, w, nperseg, hop, nfft, detrend, roll_s=roll_s,
                                             pad=pad)
            assert torch.equal(got, again)


def test_grad_spec_c64_matches_plain(dev):
    x0 = rrand(dev, 3, 5000, seed=13)
    w = torch.hann_window(512, device=dev)

    def grad(v):
        v = v.clone().requires_grad_()
        y = cuda_welch.spec_rfft_c64(v, w.to(v.device), 512, 200, 1024, "constant", roll_s=7,
                                     pad=256)
        (torch.linspace(0.5, 1.5, y.numel(), device=v.device).reshape(y.shape)
         * y.abs() ** 2).sum().backward()
        return v.grad

    gk = _through(lambda: grad(x0), spec=1, r2c_fft=1, rows_fft=1)
    assert rel_l2(gk.cpu(), grad(x0.cpu())) < TOL


def test_fftn_256_cubed_and_stft_are_their_kernels_alone(dev):
    # fftn of 256^3 complex64: the fused plane's complex64 entry, then the
    # axis(-3) pass's, one launch each and no other device work; stft of
    # 2^20 samples: B20's complex64 sink once, the center pad read in place,
    # no merge (over ten calls, from the profiler)
    x = crand(dev, 256, 256, 256)
    names = _device_kernels(lambda: ft.fftn(x), calls=10, per_call=2)
    assert {next((k for k in ("fft2f_fft_kernel", "ax0_fft_kernel") if k in name), name)
            for name in names} == {"fft2f_fft_kernel", "ax0_fft_kernel"}, names
    before = _fused_c64_counts()
    X = _through(lambda: ft.fftn(x), fft2f_fft=1, ax3=1)
    assert tuple(a - b for a, b in zip(_fused_c64_counts(), before)) == (1, 1, 0)
    assert rel_l2(X, torch.fft.fftn(x.to(torch.complex128))) < TOL
    v = rrand(dev, 1 << 20, seed=14)
    names = _device_kernels(lambda: ft.stft(v, 512, 128), calls=10)
    assert names and all("spec_fft_kernel" in name for name in names), names
    before = _fused_c64_counts()
    Z = _through(lambda: ft.stft(v, 512, 128), spec=1)
    assert tuple(a - b for a, b in zip(_fused_c64_counts(), before)) == (0, 0, 1)
    assert Z.dtype == torch.complex64 and rel_l2(Z.cpu(), ft.stft(v.cpu(), 512, 128)) < TOL


def test_fused_and_spec_plans_are_the_planner_s(dev):
    # the new kernels run the one compiled plan table (plan_fft) on every
    # pass length (rows and columns of each plane, each half length of
    # B20), whose pass roots the host builds from the planner's plan
    import pathlib

    csrc = pathlib.Path(cuda_fft.__file__).parent.parent / "csrc"
    for name in ("fft2f_fft.cu", "spec_fft.cu", "spec_c2c_fft.cu"):
        text = (csrc / name).read_text()
        assert '#include "mixed_fft.cuh"' in text, name
        assert "plan_fft<" in text and "fft_passes" not in text and "plans[" not in text, name
    for A, B in PLANES:
        for n in (A, B):
            tab = cuda_fft._twiddle_table(n, -1, dev, cuda_fft._pass_roots_np)
            assert tab.shape[0] == sum(math.prod(cuda_fft._mixed_radix_plan(n)[:i])
                                       for i in range(1, len(cuda_fft._mixed_radix_plan(n))))


# ---------------------------------------------------------------------- #
# B9 (filt_fft's filtered rows) and B22 (spec_c2c_fft) on the compiled pow2
# passes: both layouts, sources and sinks, and the routes through their
# complex64 entries
# ---------------------------------------------------------------------- #
def _new_c64_counts():
    return cuda_fft.filt_c64_launches, cuda_welch.spec_c2c_c64_launches


@pytest.mark.parametrize("n", POW2)
@pytest.mark.parametrize("rows", [(1,), (2, 37)])
def test_filt_c64_kernel_matches_plain(dev, n, rows):
    # the complex64 entry, rows of n and of n/2 + 1 points (zero past them),
    # against the plain version of its own passes and float64 torch.fft,
    # both signs, scale None and 1/n, and in place
    h = crand(dev, n, seed=2)
    for n_in in (n, n // 2 + 1):
        x = crand(dev, *rows, n_in, seed=1)
        xp = torch.nn.functional.pad(x.to(torch.complex128), (0, n - n_in)) * h
        for sign, scale in ((-1, None), (1, 1.0 / n)):
            before = _new_c64_counts()
            k = _through(lambda: cuda_fft.fft_filtered_c64(x, h, sign, scale), filt=1,
                         filt_c64=1)
            assert _new_c64_counts()[0] == before[0] + 1
            o = torch.fft.fft(xp) if sign < 0 else torch.fft.ifft(xp, norm="forward")
            o = o * (1.0 if scale is None else scale)
            assert k.dtype == torch.complex64 and k.shape == (*rows, n)
            assert rel_l2(k, cuda_fft._filt_passes(x, h, sign, scale)) < TOL, (n_in, sign)
            assert rel_l2(k, o) < TOL, (n_in, sign)
            assert rel_l2(k, cuda_fft.fft_filtered_c64_reference(x, h, sign, scale)) < TOL
    y = crand(dev, *rows, n, seed=3)
    want = cuda_fft._filt_passes(y, h, 1, 1.0 / n)
    assert cuda_fft._filt_launch_c64(y, h, 1, 1.0 / n, out=y) is y
    assert rel_l2(y, want) < TOL


@pytest.mark.parametrize("n_in", [2048, 1025])
def test_grad_filt_c64_matches_plain(dev, n_in):
    # forward: the filtered kernel's complex64 entry; backward: the row
    # kernel's complex64 entry, sign flipped, cut to the first n_in points
    n = 2048
    h = crand(dev, n, seed=3)
    x0 = crand(dev, 8, n_in, seed=4)

    def grad(v, fn):
        v = v.clone().requires_grad_()
        y = fn(v, h.to(v.device), 1, 1.0 / n)
        (torch.linspace(0.5, 1.5, y.numel(), device=v.device).reshape(y.shape)
         * y.abs() ** 2).sum().backward()
        return v.grad

    gk = _through(lambda: grad(x0, cuda_fft.fft_filtered_c64), filt=1, filt_c64=1, rows_fft=1)
    assert rel_l2(gk, grad(x0, cuda_fft.fft_filtered_c64_reference)) < TOL
    assert rel_l2(gk.cpu(), grad(x0.cpu(), cuda_fft.fft_filtered_c64)) < TOL


@pytest.mark.parametrize("nfft", POW2)
def test_spec_c2c_kernel_sources_and_sinks_match_plain(dev, nfft):
    # B22 from the complex64 signal, from two planes and from one real
    # plane, into planes and into complex64, against the plain version of
    # its own passes and float64 torch.fft: odd nperseg, a ragged last group
    # of segments, both detrends, the scale; a second run gives the same bits
    for nperseg in (nfft, nfft - nfft // 4 + 1):
        hop = max(nperseg // 4, 1)
        t = nperseg + 37 * hop + hop // 3
        z = crand(dev, 2, t, seed=nperseg)
        re, im = z.real.contiguous(), z.imag.contiguous()
        w = torch.hann_window(nperseg, device=dev) + 0.1
        for detrend in (False, "constant"):
            args = (w, nperseg, hop, nfft, detrend)
            for src, x, y in (("c64", z, None), ("planes", re, im), ("real", re, None)):
                imag = torch.zeros_like(re) if src == "real" else im
                want = torch.complex(*_welch_oracle("spec_c2c", re, imag, *args))
                plain = cuda_welch._spec_c2c_passes(x, y, *args, scale=0.5)
                before = _new_c64_counts()
                k = _through(lambda: cuda_welch.spec_c2c_c64(x, *args, scale=0.5, im=y),
                             spec_c2c=1, spec_c2c_c64=1)
                assert _new_c64_counts()[1] == before[1] + 1
                assert k.dtype == torch.complex64 and k.shape == want.shape
                assert rel_l2(k, plain) < TOL and rel_l2(k, want * 0.5) < TOL, (src, nperseg)
                again = cuda_welch.spec_c2c_c64(x, *args, scale=0.5, im=y)
                assert torch.equal(k, again), (src, nperseg)
                kp = torch.complex(*cuda_welch._spec_c2c_launch(x, y, *args, False, 0.5))
                assert rel_l2(kp, plain) < TOL, (src, "planar sink")
            kp = torch.complex(*_through(lambda: cuda_welch.spec_c2c_split(re, im, *args),
                                         spec_c2c=1))
            assert rel_l2(kp, cuda_welch._spec_c2c_passes(re, im, *args)) < TOL


def test_grad_spec_c2c_c64_matches_plain(dev):
    # forward: B22's complex64 sink; backward: the row kernel's complex64
    # entry on the frames; a complex64 signal and a real one taken two-sided
    w = torch.hann_window(512, device=dev)
    for x0 in (crand(dev, 3, 5000, seed=13), rrand(dev, 3, 5000, seed=14)):
        def grad(v):
            v = v.clone().requires_grad_()
            y = cuda_welch.spec_c2c_c64(v, w.to(v.device), 512, 200, 1024, "constant", scale=0.3)
            (torch.linspace(0.5, 1.5, y.numel(), device=v.device).reshape(y.shape)
             * y.abs() ** 2).sum().backward()
            return v.grad

        gk = _through(lambda: grad(x0), spec_c2c=1, spec_c2c_c64=1, rows_fft=2)
        assert rel_l2(gk.cpu(), grad(x0.cpu())) < TOL


def test_filter_hilbert_and_complex_spectrogram_are_their_kernels_alone(dev):
    # SpectralFilter of complex64 4096 x 4096: the row kernel's complex64
    # entry, then the filtered kernel's; hilbert of real 4096 x 4096: the
    # R2C kernel's complex64 sink, then the filtered kernel's complex64
    # entry on its n/2 + 1 bins; spectrogram(mode="complex") of a complex64
    # 2^22 signal: B22's complex64 sink once, beside the one copy of the
    # cached (f, t) grid that it returns as fresh tensors.  Nothing else on
    # the device (no split, no merge, no zero plane) over ten calls, from
    # the profiler
    x, H = crand(dev, 4096, 4096, seed=1), crand(dev, 4096, seed=2)
    r = rrand(dev, 4096, 4096, seed=3)
    xc = crand(dev, 1 << 22, seed=4)
    sf = ft.SpectralFilter(H)
    seg = {"nperseg": 4096, "noverlap": 2048}
    for what, fn, kernels, want in (
            ("SpectralFilter", lambda: sf(x), {"rows_fft_kernel", "filt_fft_kernel"},
             {"rows_fft": 1, "filt": 1, "filt_c64": 1}),
            ("hilbert", lambda: ft.hilbert(r), {"r2c_fft_kernel", "filt_fft_kernel"},
             {"r2c_fft": 1, "filt": 1, "filt_c64": 1}),
            ("spectrogram", lambda: ft.spectrogram(xc, mode="complex", **seg)[2],
             {"spec_c2c_kernel", "Memcpy DtoD"}, {"spec_c2c": 1, "spec_c2c_c64": 1})):
        names = _device_kernels(fn, calls=10, per_call=len(kernels))
        parts = {next((k for k in kernels if k in name), name) for name in names}
        assert parts == kernels, (what, names)
        _through(lambda: [fn() for _ in range(10)], **{k: 10 * v for k, v in want.items()})
    y = sf(x)
    assert y.dtype == torch.complex64
    assert rel_l2(y, torch.fft.ifft(torch.fft.fft(x.to(torch.complex128)) * H)) < TOL
    hw = torch.zeros(4096, device=dev, dtype=torch.float64)
    hw[0] = hw[2048] = 1.0
    hw[1:2048] = 2.0
    assert rel_l2(ft.hilbert(r), torch.fft.ifft(torch.fft.fft(r.double()) * hw)) < TOL
    S = ft.spectrogram(xc, mode="complex", **seg)[2]
    assert S.dtype == torch.complex64 and rel_l2(
        S[:, :64].cpu(), ft.spectrogram(xc[:64 * 2048 + 2048].cpu(), mode="complex",
                                        **seg)[2]) < TOL


def test_bank_and_rows_keep_their_bits(dev):
    # B1 (rows_fft) computes the bits of the kernel it was before its row
    # types moved into mixed_fft.cuh (chip_smoke.KEPT_BITS, recorded from
    # it); B10's were taken out when the bank became the filtered rows'
    # kernel
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke

    got = chip_smoke.kept_bits(cuda_fft, dev)
    assert got == chip_smoke.KEPT_BITS, {k: (got[k], chip_smoke.KEPT_BITS.get(k))
                                         for k in got if got[k] != chip_smoke.KEPT_BITS.get(k)}


# ---------------------------------------------------------------------- #
# the transform long tail (dct, chebyshev, mdct, fftlog, spectral,
# fourier_filters, structured, cepstrum, envelope, channelizer, wigner):
# each family on the card against the port's plain path on the CPU
# ---------------------------------------------------------------------- #
def _long_tail_counts():
    return {**_counts(), "r2c_fft_c64": cuda_fft.r2c_c64_launches,
            "rows_fft_c64": cuda_fft.c64_launches}


def _launched(fn):
    """fn()'s result and the port kernels it launched (name -> count; the
    complex64 R2C sink and row entry counted apart too)."""
    before = _long_tail_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in _long_tail_counts().items() if v != before[k]}


def _long_tail_through(fn, **want):
    """fn()'s result; it must launch exactly ``want``."""
    out, launched = _launched(fn)
    assert launched == want
    return out


def _on_card_and_cpu(fn, *args, tol=TOL, launches=True):
    """fn on the card's tensors against fn on their CPU copies (the plain
    path); returns the port kernels the card's call launched, which must
    be some unless ``launches`` is false."""
    got, launched = _launched(lambda: fn(*args))
    want = fn(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in args])
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.device.type == "cuda" and rel_l2(g.cpu(), w) < tol
    assert launched or not launches
    return launched


def test_long_tail_dct_family_on_card(dev):
    # along the last axis every type launches a kernel (type 1 at n = 257 and
    # 255: extensions of 512 points); along axis 0 (n = 256) types 2-4 do
    x = rrand(dev, 256, 512, seed=1)
    x1 = {"dct": rrand(dev, 256, 257, seed=2), "dst": rrand(dev, 256, 255, seed=3)}
    for t in (1, 2, 3, 4):
        for name in ("dct", "idct", "dst", "idst"):
            v = x1[name.lstrip("i")] if t == 1 else x
            for norm in (None, "ortho", "forward"):
                _on_card_and_cpu(lambda u, f=getattr(ft, name): f(u, type=t, norm=norm), v)
            _on_card_and_cpu(lambda u, f=getattr(ft, name): f(u, type=t, axis=0), v,
                             launches=t != 1)
    # dct type 2 is one row-kernel launch; dctn of a plane one axis(-2) and
    # one row launch; DCT-I at n = 257 and DST-I at 255 one R2C launch
    _long_tail_through(lambda: ft.dct(x, type=2), rows_fft=1)
    _long_tail_through(lambda: ft.dctn(rrand(dev, 512, 512, seed=4), type=2), ax0_fft=1,
                       rows_fft=1)
    _long_tail_through(lambda: ft.dct(x1["dct"], type=1), r2c_fft=1)
    _long_tail_through(lambda: ft.dst(x1["dst"], type=1), r2c_fft=1)
    for name in ("dctn", "idctn", "dstn", "idstn"):
        _on_card_and_cpu(lambda v, f=getattr(ft, name): f(v, type=2, s=(300, 128)),
                         rrand(dev, 256, 200, seed=5))
    u = rrand(dev, 16, 257, seed=6)
    for fn, want in ((ft.cheb_coeffs, 1), (ft.cheb_values, 1), (ft.cheb_derivative, 2)):
        assert _on_card_and_cpu(fn, u) == {"r2c_fft": want}
    _on_card_and_cpu(lambda v: ft.cheb_integrate(v, interval=(0.0, 2.0)), u, launches=False)
    s = rrand(dev, 2, 1 << 14, seed=7)
    assert _on_card_and_cpu(lambda v: ft.mdct(v, 256), s) == {"rows_fft": 1}
    assert _on_card_and_cpu(lambda v: ft.imdct(ft.mdct(v, 256)), s) == {"rows_fft": 2}


def test_long_tail_spectral_and_fftlog_on_card(dev):
    # spectral_derivative along the last axis: the R2C kernel's complex64
    # sink once and the C2R kernel's complex64 source once, nothing else
    f = rrand(dev, 512, 512, seed=1)
    _long_tail_through(lambda: ft.spectral_derivative(f), r2c_fft=1, r2c_fft_c64=1,
                       c2r_fft=1, c2r_fft_c64=1)
    for order, axis in ((1, -1), (2, 0), (3, -1)):
        assert _on_card_and_cpu(lambda v: ft.spectral_derivative(v, order, axis, 3.0), f) == {
            "r2c_fft": 1, "r2c_fft_c64": 1, "c2r_fft": 1, "c2r_fft_c64": 1}
    _on_card_and_cpu(ft.spectral_laplacian, rrand(dev, 128, 128, 128, seed=2))
    for g, w in zip(ft.spectral_gradient(f), ft.spectral_gradient(f.cpu())):
        assert rel_l2(g.cpu(), w) < TOL
    n, dln = 1024, 0.01
    r = np.exp((np.arange(n) - (n - 1) / 2) * dln)
    a = torch.from_numpy((r**2 * np.exp(-(r**2) / 2)).astype(np.float32)).to(dev)
    a = a * (1 + 0.1 * rrand(dev, 16, n, seed=3))
    for name, mu, bias in (("fht", 0.5, 0.0), ("ifht", 2.0, 0.1)):
        launched = _on_card_and_cpu(lambda v, f=getattr(ft, name): f(v, dln, mu, bias=bias), a)
        assert launched == {"r2c_fft": 1, "c2r_fft": 1}


def test_long_tail_filters_and_solvers_on_card(dev):
    X = crand(dev, 256, 192, seed=1)
    for fn, p in ((ft.fourier_gaussian, 2.0), (ft.fourier_uniform, (3, 4.5)),
                  (ft.fourier_shift, (1.5, -2.25)), (ft.fourier_ellipsoid, 4.0)):
        y = fn(X, p)
        assert y.device.type == "cuda" and rel_l2(y.cpu(), fn(X.cpu(), p)) < TOL
    c = rrand(dev, 1024, seed=2)
    c[0] += 1024.0
    b = rrand(dev, 16, 1024, seed=3)
    for fn in (ft.circulant_matvec, ft.circulant_solve):
        _on_card_and_cpu(fn, c, b)
    _on_card_and_cpu(ft.toeplitz_matvec, c, rrand(dev, 1024, seed=4), b)
    ct = torch.exp(-torch.arange(512, device=dev, dtype=torch.float32) / 7.0)
    _on_card_and_cpu(ft.toeplitz_solve, ct, b[:, :512], tol=1e-4)
    k = 0.05 * rrand(dev, 256, 256, seed=5)
    k[0, 0] += 1.0
    for fn in (ft.bccb_matvec, lambda u, v: ft.bccb_solve(u, v, reg=1e-3)):
        _on_card_and_cpu(fn, k, rrand(dev, 2, 256, 256, seed=6))
    # the field of one noise draw, and the sampler's device and covariance
    from fft_wgpu_tpu_torch.ops import structured

    acf = np.exp(-np.arange(1 << 12) / 5.0)
    sqrt_lam, n = structured._grf_embedding(acf)
    sl = torch.from_numpy(sqrt_lam.astype(np.float32)).to(dev)
    _on_card_and_cpu(lambda *a: structured._grf_from_noise(*a, 3, n), sl,
                     rrand(dev, 2, sl.numel(), seed=7), rrand(dev, 2, sl.numel(), seed=8))
    s = ft.grf_sample(acf[:32], torch.Generator(device=dev).manual_seed(0), 8192).cpu().numpy()
    assert s.shape == (8192, 32)
    # numpy acf runs on the card whatever the generator's device
    assert ft.grf_sample(acf[:32], torch.Generator().manual_seed(0), 2).device.type == "cuda"
    emp = [np.mean(s[:, : 32 - lag] * s[:, lag:]) for lag in range(8)]
    assert np.abs(np.array(emp) - acf[:8]).max() < 0.06


def test_long_tail_cepstra_and_analysis_on_card(dev):
    x = rrand(dev, 16, 1024, seed=1)
    assert _on_card_and_cpu(ft.real_cepstrum, x) == {"r2c_fft": 1, "c2r_fft": 1}
    t = torch.arange(128, dtype=torch.float32, device=dev)
    rows = torch.stack([torch.sin(2 * math.pi * t / 128 * 5) * torch.exp(-t / 40.0)
                        + 8.0 * torch.exp(-((t - 3.0) ** 2) / 4.0), 0.9 ** t])
    _on_card_and_cpu(ft.complex_cepstrum, rows)
    c, nd = ft.complex_cepstrum(rows)
    _on_card_and_cpu(ft.inverse_complex_cepstrum, c, nd)
    import scipy.signal as ss

    h = torch.from_numpy(ss.firwin(31, 0.2).astype(np.float32)).to(dev)
    for method, tol in (("homomorphic", 5e-4), ("hilbert", 5e-3)):  # test_cepstrum.py's bars
        _on_card_and_cpu(lambda v: ft.minimum_phase(v, method=method), h, tol=tol)
    for z in (rrand(dev, 4, 4096, seed=2), crand(dev, 4, 4096, seed=3)):
        for kw in ({}, {"n_out": 1024, "residual": "all"}, {"bp_in": (3, 500),
                                                            "residual": None}):
            _on_card_and_cpu(lambda v: ft.envelope(v, **kw), z)
    for z in (rrand(dev, 2, 1 << 14, seed=4), crand(dev, 1 << 14, seed=5)):
        assert _on_card_and_cpu(lambda v: ft.channelize(v, 128), z)["rows_fft"] == 1
    w = crand(dev, 256, seed=6)
    _on_card_and_cpu(lambda v: ft.wigner_ville(v)[1], w)
    _on_card_and_cpu(lambda v: ft.wigner_ville(v, window=np.hanning(33))[1], w)


def test_grad_long_tail_dct2_matches_plain(dev):
    # dct type 2: the row kernel forward and, for its adjoint, back;
    # spectral_derivative: the R2C kernel's complex64 sink and the C2R
    # kernel's complex64 source forward, their adjoints back
    for fn, want in ((lambda v: ft.dct(v, type=2, norm="ortho"), {"rows_fft": 2}),
                     (ft.spectral_derivative, {"r2c_fft": 2, "r2c_fft_c64": 2, "c2r_fft": 1,
                                               "c2r_fft_c64": 1, "rows_fft": 1,
                                               "rows_fft_c64": 1})):
        x0 = rrand(dev, 64, 1024, seed=1)
        w = torch.rand(64, 1024, generator=torch.Generator().manual_seed(2))

        def grad(v):
            v = v.clone().requires_grad_()
            (w.to(v.device) * fn(v) ** 2).sum().backward()
            return v.grad

        gk = _long_tail_through(lambda: grad(x0), **want)
        assert rel_l2(gk.cpu(), grad(x0.cpu())) < TOL


# ---------------------------------------------------------------------- #
# the signal-processing and non-uniform long tail (waveforms, multirate,
# conv2d, frft, nufft): each family on the card against the port's plain
# path on the CPU; three launch counts exact against bare calls of the
# transforms they compose
# ---------------------------------------------------------------------- #
def _summed(*deltas):
    out = {}
    for d in deltas:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def test_signal_tail_multirate_and_waveforms_on_card(dev):
    from fft_wgpu_tpu_torch.ops.rfft import irfft_last_split, rfft_last_split

    t = torch.linspace(0, 10, 501, dtype=torch.float64, device=dev)
    for name, kw in (("chirp", dict(f0=1.5, t1=10, f1=6.0, method="hyperbolic")),
                     ("sweep_poly", dict(poly=[0.05, -0.75, 2.0])),
                     ("sawtooth", dict(width=0.3)), ("square", dict(duty=0.2)),
                     ("gausspulse", dict(fc=0.5))):
        y = getattr(ft, name)(t, **kw)
        assert y.device.type == "cuda"
        np.testing.assert_allclose(y.cpu().numpy(), getattr(ft, name)(t.cpu().numpy(), **kw),
                                   rtol=0, atol=1e-12)
    x = rrand(dev, 2, 4096, seed=1)
    h = ft.firwin(33, 0.3)
    assert _on_card_and_cpu(lambda v: ft.upfirdn(h, v, 4, 3), x)
    assert _on_card_and_cpu(lambda v: ft.upfirdn(h * (1 + 1j), v, 2, 1, mode="reflect"),
                            crand(dev, 3, 1000, seed=2))
    for padtype in ("constant", "mean", "median", "antisymmetric"):
        assert _on_card_and_cpu(lambda v: ft.resample_poly(v, 3, 4, padtype=padtype), x)
    assert _on_card_and_cpu(lambda v: ft.decimate(v, 8), x)
    # resample_poly at 147/160: exactly the R2C of the signal rows and of the
    # taps row and the C2R, at nfft 2^20 (the packed half-length rows through
    # the four-step)
    nfft = 1 << 20
    _, a = _launched(lambda: rfft_last_split(torch.zeros(2, nfft, device=dev), None))
    _, b = _launched(lambda: rfft_last_split(torch.zeros(1, nfft, device=dev), None))
    bins = torch.zeros(2, nfft // 2 + 1, device=dev)
    _, c = _launched(lambda: irfft_last_split(bins, bins, nfft, 1.0 / nfft))
    _long_tail_through(lambda: ft.resample_poly(x, 147, 160), **_summed(a, b, c))


def test_signal_tail_conv2d_on_card(dev):
    # 600 x 1000 with 9 x 8: 5-smooth even lengths 640 (composite) and 1024
    a, k = rrand(dev, 600, 1000, seed=1), rrand(dev, 9, 8, seed=2)
    for mode in ("full", "same", "valid"):
        for boundary in ("fill", "wrap", "symm"):
            assert _on_card_and_cpu(lambda u, v: ft.convolve2d(u, v, mode, boundary), a, k)
    assert _on_card_and_cpu(lambda u, v: ft.correlate2d(u, v, "valid"), crand(dev, 600, 600,
                                                                              seed=3),
                            crand(dev, 64, 64, seed=4), tol=1e-4)
    assert _on_card_and_cpu(lambda u: ft.wiener(u, 5), a, tol=2e-4)
    for mode in ("interp", "mirror", "wrap"):
        assert _on_card_and_cpu(lambda u: ft.savgol_filter(u, 31, 3, mode=mode),
                                rrand(dev, 8, 4000, seed=5))
    # the taps row of the FIR pass broadcasts on the product C2R kernel
    _, launched = _launched(lambda: ft.savgol_filter(rrand(dev, 8, 1000, seed=6), 31, 3))
    assert launched.get("c2r_prod") == 1


def test_signal_tail_frft_on_card(dev):
    from fft_wgpu_tpu_torch.core.twiddle import FORWARD, INVERSE

    x = crand(dev, 8, 1024, seed=1)
    for a in (0.5, 0.9, 1.7, 3.0):
        assert _on_card_and_cpu(lambda v: ft.frft(v, a), x)
    # frft at a = 0.5 is exactly the forward and inverse transforms of
    # [8, 8192] and [8, 16384] (the row kernel)
    bare = []
    for L in (8192, 16384):
        z = torch.zeros(8, L, device=dev)
        p = ft.get_plan(L)
        bare += [_launched(lambda: p._execute_split(z, z, FORWARD, None))[1],
                 _launched(lambda: p._execute_split(z, z, INVERSE, 1.0 / L))[1]]
    _long_tail_through(lambda: ft.frft(x, 0.5), **_summed(*bare))
    # along axis 0 the axis(-2) kernel, with no transpose
    assert "ax0_fft" in _on_card_and_cpu(lambda v: ft.frft2(v, (0.5, 0.7)),
                                         crand(dev, 1024, 256, seed=2))
    _on_card_and_cpu(lambda v: ft.dfrft(v, 0.4), x, launches=False)


def test_signal_tail_nufft_on_card(dev):
    from fft_wgpu_tpu_torch.core.twiddle import INVERSE
    from fft_wgpu_tpu_torch.ops import nd

    rng = np.random.default_rng(7)

    def pts(m, lo=0.0, hi=2 * np.pi):
        return torch.from_numpy(rng.uniform(lo, hi, m).astype(np.float32)).to(dev)

    x, y, z = pts(3000), pts(3000), pts(3000)
    c = crand(dev, 2, 3000, seed=1)
    for isign in (1, -1):
        assert _on_card_and_cpu(lambda *a: ft.nufft1d1(*a, 4096, isign=isign), x, c)
        assert _on_card_and_cpu(lambda *a: ft.nufft2d1(*a, (64, 96), isign=isign), x, y, c)
        assert _on_card_and_cpu(lambda *a: ft.nufft3d1(*a, (64, 64, 64), isign=isign),
                                x, y, z, c)
    assert _on_card_and_cpu(ft.nufft1d2, x, crand(dev, 2, 4096, seed=2))
    assert _on_card_and_cpu(ft.nufft2d2, x, y, crand(dev, 64, 96, seed=3))
    assert _on_card_and_cpu(ft.nufft3d2, x, y, z, crand(dev, 64, 64, 64, seed=4))
    s, t, u = pts(500, -30, 30), pts(500, -20, 20), pts(500, -10, 10)
    xs, ys, zs = pts(3000, -20, 20), pts(3000, -10, 10), pts(3000, -5, 5)
    for fn, args in ((ft.nufft1d3, (xs, c, s)), (ft.nufft2d3, (xs, ys, c, s, t)),
                     (ft.nufft3d3, (xs, ys, zs, c, s, t, u))):
        assert _on_card_and_cpu(fn, *args, tol=2e-4 if fn is ft.nufft3d3 else TOL)
    # nufft2d1 at 64^2 modes is exactly one 2-D transform of its planar
    # 128^2 fine grid
    g = torch.zeros(128, 128, device=dev)
    _, bare = _launched(lambda: nd.fftn_split(g, g, (0, 1), INVERSE, None))
    _long_tail_through(lambda: ft.nufft2d1(x, y, c[0], (64, 64)), **bare)


def _grad_on_card_and_cpu(dev, fn, inputs, want):
    """d/d(inputs) of sum(w * |fn(*inputs)|^2) on the card, launching
    exactly ``want``, against the same on the CPU."""
    w = torch.rand(fn(*inputs).shape, generator=torch.Generator().manual_seed(3))

    def grad(device):
        ins = [v.to(device).requires_grad_() for v in inputs]
        (w.to(device) * fn(*ins).abs() ** 2).sum().backward()
        return torch.cat([v.grad.reshape(-1) for v in ins])

    gk = _long_tail_through(lambda: grad(dev), **want)
    assert rel_l2(gk.cpu(), grad(torch.device("cpu"))) < TOL


def test_grad_nufft1d1(dev):
    # the values: the row kernel forward (fine grid 8192) and back
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 2 * np.pi, 4096)
                         .astype(np.float32))
    _grad_on_card_and_cpu(dev, lambda c: ft.nufft1d1(x.to(c.device), c, 4096),
                          [crand(dev, 4096, seed=2).cpu()], {"rows_fft": 2})


def test_grad_convolve2d(dev):
    # both inputs: R2C and axis(-2) forward for each, axis(-2) and C2R
    # for the product; back, the C2R's adjoint (R2C), the axis(-2) passes'
    # and the R2Cs' (C2C rows)
    _grad_on_card_and_cpu(dev, lambda u, v: ft.convolve2d(u, v, mode="same"),
                          [rrand(dev, 500, 1000, seed=1).cpu(), rrand(dev, 13, 25, seed=2).cpu()],
                          {"r2c_fft": 3, "ax0_fft": 6, "c2r_fft": 1, "rows_fft": 2})
