"""Torch port, the batched 1-D C2C slice as a whole against the JAX package.

Plan, the functional API and the parity classes of ``fft_wgpu_tpu_torch``
get the same numpy inputs as ``fft_wgpu_tpu`` on the CPU.  Tolerance: 1e-5
relative L2 (the ``assert_close`` fixture).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu.ops import pallas_fft as j_pf
from fft_wgpu_tpu_torch.ops import cuda_fft

torch.set_num_threads(1)


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _np(z):
    return z.numpy() if isinstance(z, torch.Tensor) else np.asarray(z)


def _t(x):
    # a CPU tensor asks the port for the CPU; numpy input goes to the card
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n", [128, 1000, 4096])
def test_plan_modes_match_jax(n, rng, assert_close, monkeypatch):
    x = crand(rng, 3, n)
    tp, jp = ft.plan(n), ftt.plan(n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("forward", "inverse", "inverse_unnormalized", "normalize"):
        got = getattr(tp, mode)(_t(x))
        assert got.dtype == torch.complex64 and got.shape == x.shape
        assert_close(_np(got), _np(getattr(jp, mode)(x)), what=mode)
        # numpy input asks for the card, and never runs on the CPU unasked
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(tp, mode)(x)
    assert cuda_fft.launches == 0


@pytest.mark.parametrize("n", [256, 1000])
def test_split_forms_match_jax(n, rng, assert_close):
    x = crand(rng, 4, n)
    re, im = x.real.copy(), x.imag.copy()
    tp, jp = ft.plan(n), ftt.plan(n)
    for mode in ("forward_split", "inverse_split", "inverse_unnormalized_split"):
        tr, ti = getattr(tp, mode)(torch.from_numpy(re), torch.from_numpy(im))
        jr, ji = getattr(jp, mode)(re, im)
        assert tr.dtype == torch.float32
        assert_close(_np(tr) + 1j * _np(ti), _np(jr) + 1j * _np(ji), what=mode)


@pytest.mark.parametrize("executor", ["auto", "xla", "pallas"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_donate_writes_in_place(executor, axis, rng, assert_close):
    n = 512
    x = crand(rng, n, n) if axis == 0 else crand(rng, 3, n)
    want = _np(ftt.plan(n).inverse_split(x.real.copy(), x.imag.copy(), axis=axis)[0])
    re = torch.from_numpy(x.real.copy())
    im = torch.from_numpy(x.imag.copy())
    p = ft.plan(n, executor=executor, donate=True)
    out = p.inverse_split(re, im, axis=axis)
    assert out[0] is re and out[1] is im  # the result lives in the inputs
    assert_close(re.numpy(), want)
    g = torch.zeros(2, n, requires_grad=True)
    with pytest.raises(ValueError, match="donate"):
        p.forward_split(g, g)


def test_axis0_on_2d_input(rng, assert_close):
    n = 256
    x = crand(rng, n, 6)
    for mode in ("forward", "inverse", "inverse_unnormalized"):
        got = getattr(ft.plan(n), mode)(_t(x), axis=0)
        assert_close(_np(got), _np(getattr(ftt.plan(n), mode)(x, axis=0)), what=mode)
    assert_close(_np(ft.fft(_t(x), axis=0)), np.fft.fft(x, axis=0))
    tr, ti = ft.plan(n).forward_split(torch.from_numpy(x.real.copy()),
                                      torch.from_numpy(x.imag.copy()), axis=0)
    assert_close(_np(tr) + 1j * _np(ti), np.fft.fft(x, axis=0))


@pytest.mark.parametrize("n_arg", [100, 128, 200])
@pytest.mark.parametrize("fn", ["fft", "ifft", "ifft_unnormalized"])
def test_n_pads_or_trims(n_arg, fn, rng, assert_close):
    x = crand(rng, 3, 128)
    got = getattr(ft, fn)(_t(x), n=n_arg)
    assert got.shape == (3, n_arg)
    assert_close(_np(got), _np(getattr(ftt, fn)(x, n=n_arg)))
    x0 = crand(rng, 128, 2)
    assert_close(_np(getattr(ft, fn)(_t(x0), n=n_arg, axis=0)),
                 _np(getattr(ftt, fn)(x0, n=n_arg, axis=0)))


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
def test_norm_modes_match_jax(norm, rng, assert_close):
    x = crand(rng, 2, 512)
    assert_close(_np(ft.fft(_t(x), norm=norm)), _np(ftt.fft(x, norm=norm)))
    assert_close(_np(ft.ifft(_t(x), norm=norm)), _np(ftt.ifft(x, norm=norm)))
    assert_close(_np(ft.fft(_t(x), norm=norm)), np.fft.fft(x, norm=norm))


def test_invalid_norm_raises():
    x = np.zeros((2, 8), np.complex64)
    for pkg in (ft, ftt):
        with pytest.raises(ValueError, match="norm"):
            pkg.fft(x, norm="bogus")


def test_functional_and_normalize_match_jax(rng, assert_close):
    x = crand(rng, 5, 1024)
    for fn in ("fft", "ifft", "ifft_unnormalized", "normalize"):
        assert_close(_np(getattr(ft, fn)(_t(x))), _np(getattr(ftt, fn)(x)), what=fn)
    assert_close(_np(ft.normalize(_t(x), n=4096)), _np(ftt.normalize(x, n=4096)))
    y = ft.normalize(ft.ifft_unnormalized(ft.fft(_t(x))))
    assert_close(_np(y), x)
    assert_close(_np(ft.fft(_t(x[0]))), ft.naive_dft(x[0]))


@pytest.mark.parametrize("cls", ["Forward", "Inverse", "Onlyinverse", "Normalize"])
def test_parity_classes_match_jax(cls, rng, assert_close):
    x = crand(rng, 4, 512)
    tp, jp = getattr(ft, cls)(512), getattr(ftt, cls)(512)
    assert_close(_np(tp.proc(_t(x))), _np(jp.proc(x)))
    assert_close(_np(tp(_t(x))), _np(jp(x)))
    assert repr(tp) == repr(jp) == f"{cls}(fft_len=512)"


def test_executors_match_jax(rng, assert_close, monkeypatch):
    # the JAX Pallas kernel runs in interpret mode on the CPU via its test hook
    monkeypatch.setattr(j_pf, "_FORCE_INTERPRET", True)
    x = crand(rng, 5, 512)
    for ex in ("xla", "direct", "pallas"):
        got = ft.plan(512, executor=ex).forward(_t(x))
        assert_close(_np(got), _np(ftt.plan(512, executor=ex).forward(x)), what=ex)
    want = _np(ft.plan(512, executor="pallas").inverse(_t(x)))
    for ex in ("pallas:classic", "pallas:dit", "pallas:balanced"):
        # the TPU schedules collapse into the one row kernel
        np.testing.assert_array_equal(_np(ft.plan(512, executor=ex).inverse(_t(x))), want)
    with pytest.raises(cuda_fft.Unsupported):
        ft.plan(1000, executor="pallas").forward(_t(crand(rng, 2, 1000)))


def test_value_errors_match_jax():
    for pkg, c128, arr in ((ft, torch.complex128, _t), (ftt, jnp.complex128, np.asarray)):
        x = arr(np.zeros((2, 64), np.complex64))
        z = arr(np.zeros((2, 64), np.float32))
        p = pkg.plan(128)
        with pytest.raises(ValueError, match="n=128"):
            p.forward(x)
        with pytest.raises(ValueError, match="n=128"):
            p.forward_split(z, z)
        with pytest.raises(ValueError, match="dtype"):
            pkg.plan(128, dtype=c128)
        with pytest.raises(ValueError, match="dtype"):
            pkg.plan(128, dtype=np.complex128)
        with pytest.raises(ValueError, match="executor"):
            pkg.plan(128, executor="cufft")
        with pytest.raises(ValueError, match=">= 1"):
            pkg.plan(0)
    assert ft.plan(128, dtype=np.complex64).dtype == torch.complex64


@pytest.mark.parametrize("fn", ["fft", "ifft", "ifft_unnormalized"])
def test_zero_length_raises_value_error(fn):
    # numpy.fft's error, and Plan(0)'s, for a zero-length axis and for n=0
    # (the scale of the norm is never computed for them)
    call = getattr(ft, fn)
    with pytest.raises(ValueError, match="fft length must be >= 1, got 0"):
        call(torch.zeros(3, 0, dtype=torch.complex64))
    with pytest.raises(ValueError, match="fft length must be >= 1, got 0"):
        call(torch.zeros(0, 4, dtype=torch.complex64), axis=0)
    with pytest.raises(ValueError, match="fft length must be >= 1, got 0"):
        call(torch.zeros(3, 8, dtype=torch.complex64), n=0)
    with pytest.raises(ValueError, match="fft length must be >= 1, got -2"):
        call(torch.zeros(3, 8, dtype=torch.complex64), n=-2)


def test_routing_on_cuda_tensors():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    for e in range(7, 15):
        # the kernel for every pow2 n in its envelope; the row count plays no part
        assert ft.plan(1 << e)._resolve_executor(cuda) == "pallas"
        assert ft.plan(1 << e)._resolve_executor(cpu) == "xla"
    for n in (1, 64, 120, 500, 511, 1 << 14 | 1, 3 * 5 * 1093):
        assert ft.plan(n)._resolve_executor(cuda) == "xla"
    for n in (640, 1000, 4095, 4097, 16383):  # the composite-row kernel
        assert ft.plan(n)._resolve_executor(cuda) == "general"
        assert ft.plan(n)._resolve_executor(cpu) == "xla"
    for n in (526, 1031, 1538, 4093, 8191):
        # the mixed-radix path, whose Bluestein branch runs the chirp passes
        assert ft.plan(n)._resolve_executor(cuda) == "xla"
        assert ft.plan(n)._resolve_executor(cpu) == "xla"
    for e in (15, 18, 20, 22, 27):
        # four-step above the row kernel, on the card only (ops/fourstep.py)
        assert ft.plan(1 << e)._resolve_executor(cuda) == "fourstep"
        assert ft.plan(1 << e)._resolve_executor(cpu) == "xla"
    assert ft.plan(512, executor="direct")._resolve_executor(cuda) == "direct"
    for ex in ("fourstep", "bigfft"):
        assert ft.plan(1 << 15, executor=ex)._resolve_executor(cpu) == ex


def test_autotune_not_hidden_on_cuda(rng, assert_close, monkeypatch):
    # a CUDA tensor's route is the measured one (plan/autotune.py), asked
    # for its own shape and axis; nothing is hidden behind a fallback
    from fft_wgpu_tpu_torch.plan import autotune

    asked = []
    monkeypatch.setattr(autotune, "measure_executor",
                        lambda plan, shape, axis, device: asked.append((shape, axis)) or "pallas")
    p = ft.plan(256, autotune=True)
    cuda = torch.device("cuda", 0)
    assert p._route(cuda, (8, 256), -1) == "pallas" and asked == [((8, 256), -1)]
    assert ft.plan(256, autotune=True, executor="xla")._route(cuda, (8, 256), -1) == "xla"
    # on the CPU it changes nothing, as in the JAX package off the TPU
    x = crand(rng, 2, 256)
    assert_close(_np(p.forward(_t(x))), _np(ftt.plan(256, autotune=True).forward(x)))
    assert len(asked) == 1


def test_grad_through_fft_matches_jax(rng, assert_close):
    n = 256
    re, im, w = (rng.standard_normal((3, n)).astype(np.float32) for _ in range(3))

    def jloss(a, b):
        y = ftt.fft(jax.lax.complex(a, b))
        return jnp.sum(w * jnp.abs(y) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    for ex in ("auto", "pallas"):
        tre = torch.from_numpy(re).requires_grad_()
        tim = torch.from_numpy(im).requires_grad_()
        y = ft.fft(torch.complex(tre, tim), executor=ex)
        (torch.from_numpy(w) * y.abs() ** 2).sum().backward()
        assert_close(tre.grad.numpy(), np.asarray(jg[0]), what=ex)
        assert_close(tim.grad.numpy(), np.asarray(jg[1]), what=ex)


def test_warmup_and_plan_cache(monkeypatch):
    p = ft.plan(256)
    assert p.warmup((3,), device="cpu") is p
    # with no device named, warmup asks for the card and never falls to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.warmup((3,))
    assert ft.get_plan(256) is ft.get_plan(256)
    assert repr(p) == repr(ftt.plan(256)) == "Plan(n=256, executor='auto')"


def test_import_leaves_jax_out():
    code = ("import sys, fft_wgpu_tpu_torch, fft_wgpu_tpu_torch.ops.cuda_fft, "
            "fft_wgpu_tpu_torch.utils.build; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'fft_wgpu_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
