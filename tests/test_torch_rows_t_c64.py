"""Torch port, the four-step's transposed-rows kernel (B4) through its two
entries and the complex64 four-step, on the CPU.

* The plain versions of ``rows_t_fft`` (``cuda_fft.fft_rows_transposed_
  split_reference`` and ``fft_rows_transposed_c64_reference``: the two-level
  twiddle plane, n's compiled plan on its pass roots, the scale, then the
  transpose) against the JAX package's ``fft_rows_transposed_split``, its
  Pallas kernel run in interpret mode as ``tests/test_pallas.py`` runs it,
  at n = 128, 256 and 1024 (``check_rows_t``; n = 4096 and 16384, whose JAX
  kernels take 20-30 s each to compile in interpret mode, are in
  ``test_torch_rows_t_c64_{4096,16384}_{forward,inverse}.py``, one file a
  length and sign, which the test run's ``--dist loadfile`` gives workers
  of their own).
* ``fourstep.fft_last_axis_c64`` (B2's then B4's complex64 entries; their
  plain versions on a CPU tensor) against the JAX package's
  ``fft(executor="fourstep")``, values and gradient.
* ``Plan._execute_c64``'s route for a complex64 CUDA tensor, with no card:
  the launch functions are patched to record their calls.

The kernels themselves need the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Inputs come from numpy's seeded generator.  Tolerance:
1e-5 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu.ops import pallas_fft as j_pf
from fft_wgpu_tpu_torch.ops import bigfft, cuda_fft, fourstep
from fft_wgpu_tpu_torch.plan import plan as plan_mod

torch.set_num_threads(1)

# the outer twiddles of the cases: none, the four-step's (rows, rows*n), and
# one that is not a power of two, (rows, 3*2^12)
OUTERS = ("none", "fourstep", "3x2^12")


def _outer(kind, rows, n):
    return {"none": None, "fourstep": (rows, rows * n), "3x2^12": (rows, 3 << 12)}[kind]


def cplx(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def assert_no_launches():
    assert (cuda_fft.launches, cuda_fft.ax0_launches, cuda_fft.rows_t_launches,
            cuda_fft.rows_t_c64_launches, bigfft.launches) == (0, 0, 0, 0, 0)


# the JAX kernel's outputs for one row, by (n, sign, input): row 0's outer
# twiddle is w^0 = 1 whatever outer_n, so every outer of a one-row case is
# held against the same untwiddled output (two compiles in interpret mode
# for the three outers, not six)
_ONE_ROW: dict = {}


def _jax_rows_t(re, im, sign, scale, outer):
    if re.shape[0] != 1:
        return cplx(j_pf.fft_rows_transposed_split(re, im, sign, scale, outer=outer,
                                                   interpret=True))
    key = (re.shape[1], sign, scale, re.tobytes(), im.tobytes())
    if key not in _ONE_ROW:
        _ONE_ROW[key] = cplx(j_pf.fft_rows_transposed_split(re, im, sign, scale,
                                                            interpret=True))
    return _ONE_ROW[key]


def check_rows_t(n, rows, kind, rng, assert_close, signs=(-1, 1)):
    """Both plain versions of rows_t_fft, and both entries on CPU tensors
    (which run them), against the JAX kernel at each of ``signs``, each
    with a scale (0.5 forward, 1/n inverse)."""
    outer = _outer(kind, rows, n)
    re, im = (rng.standard_normal((rows, n)).astype(np.float32) for _ in range(2))
    tre, tim = torch.from_numpy(re), torch.from_numpy(im)
    z = torch.complex(tre, tim)
    for sign in signs:
        scale = 0.5 if sign < 0 else 1.0 / n
        want = _jax_rows_t(re, im, sign, scale, outer)
        what = f"n={n} rows={rows} outer={outer} sign={sign}"
        got = cuda_fft.fft_rows_transposed_split_reference(tre, tim, sign, scale, outer=outer)
        assert got[0].shape == (n, rows) and got[0].dtype == torch.float32
        assert_close(cplx(got), want, what=f"planar {what}")
        assert_close(cplx(cuda_fft.fft_rows_transposed_split(tre, tim, sign, scale,
                                                             outer=outer)), want, what=what)
        gz = cuda_fft.fft_rows_transposed_c64_reference(z, sign, scale, outer=outer)
        assert gz.shape == (n, rows) and gz.dtype == torch.complex64
        assert_close(gz.numpy(), want, what=f"complex64 {what}")
        assert_close(cuda_fft.fft_rows_transposed_c64(z, sign, scale, outer=outer).numpy(),
                     want, what=f"complex64 entry {what}")
    assert_no_launches()


@pytest.mark.parametrize("kind", OUTERS)
@pytest.mark.parametrize("rows", [1, 200])
@pytest.mark.parametrize("n", [128, 256, 1024])
def test_rows_t_plain_matches_jax(n, rows, kind, rng, assert_close):
    check_rows_t(n, rows, kind, rng, assert_close)


def test_rows_t_c64_leading_axes_and_bad_arguments(rng, assert_close):
    # a leading batch of planes, each transposed on its own; the entry's
    # checks
    x = torch.from_numpy(crand(rng, 2, 3, 40, 256))
    got = cuda_fft.fft_rows_transposed_c64(x, -1, None, outer=(40, 40 * 256))
    assert got.shape == (2, 3, 256, 40)
    for i in range(2):
        for j in range(3):
            assert_close(got[i, j].numpy(), cuda_fft.fft_rows_transposed_c64_reference(
                x[i, j], -1, None, outer=(40, 40 * 256)).numpy())
    with pytest.raises(cuda_fft.Unsupported):
        cuda_fft.fft_rows_transposed_c64(torch.zeros(4, 100, dtype=torch.complex64), -1)
    with pytest.raises(ValueError, match="complex64"):
        cuda_fft.fft_rows_transposed_c64(torch.zeros(4, 256), -1)
    with pytest.raises(ValueError, match="sign"):
        cuda_fft.fft_rows_transposed_c64(torch.zeros(4, 256, dtype=torch.complex64), 0)
    with pytest.raises(ValueError, match="outer_n"):
        cuda_fft.fft_rows_transposed_c64(torch.zeros(4, 256, dtype=torch.complex64), -1,
                                         outer=(4, 0))
    assert cuda_fft.fft_rows_transposed_c64(
        torch.zeros(0, 4, 256, dtype=torch.complex64), -1).shape == (0, 256, 4)


@pytest.mark.parametrize("outer", [None, (8, 1 << 15)])
def test_grad_rows_t_c64_matches_jax(outer, rng, assert_close):
    # tests/test_ad.py's loss through the complex64 entry, against jax.grad
    # of the JAX kernel
    rows = 2 if outer is None else outer[0]
    re, im = (rng.standard_normal((rows, 256)).astype(np.float32) for _ in range(2))
    wr, wi = (rng.standard_normal((256, rows)).astype(np.float32) for _ in range(2))

    def jloss(a, b):
        xr, xi = j_pf.fft_rows_transposed_split(a, b, -1, 1.0 / 256, outer=outer,
                                                interpret=True)
        return jnp.sum(xr * wr + xi * wi)

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    tre = torch.from_numpy(re).requires_grad_()
    tim = torch.from_numpy(im).requires_grad_()
    y = cuda_fft.fft_rows_transposed_c64(torch.complex(tre, tim), -1, 1.0 / 256, outer=outer)
    (y.real * torch.from_numpy(wr) + y.imag * torch.from_numpy(wi)).sum().backward()
    assert_close(tre.grad.numpy(), np.asarray(jg[0]), what="d/dre")
    assert_close(tim.grad.numpy(), np.asarray(jg[1]), what="d/dim")
    assert_no_launches()


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("e", [15, 20])
def test_fourstep_c64_matches_jax(e, direction, rng, assert_close):
    n = 1 << e
    x = crand(rng, 2, n)
    if direction == "forward":
        got = fourstep.fft_last_axis_c64(torch.from_numpy(x), -1)
        want = ftt.fft(x, executor="fourstep")
        oracle = np.fft.fft(x.astype(np.complex128), axis=-1)
    else:
        got = fourstep.fft_last_axis_c64(torch.from_numpy(x), 1, 1.0 / n)
        want = ftt.ifft(x, executor="fourstep")
        oracle = np.fft.ifft(x.astype(np.complex128), axis=-1)
    assert got.shape == x.shape and got.dtype == torch.complex64
    assert_close(got.numpy(), np.asarray(want))
    assert_close(got.numpy(), oracle)
    assert_no_launches()


def test_fourstep_c64_grad_matches_jax(rng, assert_close):
    # test_torch_fourstep.py's loss, sum(w * |fft(x)|^2), through the
    # complex64 four-step as one linear map, against jax.grad
    n = 1 << 15
    re, im, w = (rng.standard_normal((2, n)).astype(np.float32) for _ in range(3))

    def jloss(a, b):
        y = ftt.fft(jax.lax.complex(a, b), executor="fourstep")
        return jnp.sum(w * jnp.abs(y) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    tre = torch.from_numpy(re).requires_grad_()
    tim = torch.from_numpy(im).requires_grad_()
    y = fourstep.fft_last_axis_c64(torch.complex(tre, tim), -1)
    (torch.from_numpy(w) * y.abs() ** 2).sum().backward()
    assert_close(tre.grad.numpy(), np.asarray(jg[0]), what="d/dre")
    assert_close(tim.grad.numpy(), np.asarray(jg[1]), what="d/dim")
    assert_no_launches()


def test_fourstep_c64_envelope():
    # both factors pow2 128..16384: n = 2^14 .. 2^26 (2^14 = 128 * 128; the
    # plan routes only n > 16384 there); the axis(-2) kernel's complex64
    # entry takes no composite n1, and above 2^26 n1 > 16384
    for e in range(10, 30):
        assert fourstep.c64_supported(1 << e) == (14 <= e <= 26), e
    for n in (120, 3 * (1 << 15), 1 << 20 | 1):
        assert not fourstep.c64_supported(n)
    with pytest.raises(cuda_fft.Unsupported):
        fourstep.fft_last_axis_c64(torch.zeros(1, 3 << 15, dtype=torch.complex64), -1)
    with pytest.raises(ValueError, match="complex64"):
        fourstep.fft_last_axis_c64(torch.zeros(1, 1 << 15), -1)


# ---------------------------------------------------------------------- #
# the plan's route of a complex64 CUDA tensor, with no card
# ---------------------------------------------------------------------- #
class _OnCard(torch.Tensor):
    """A meta tensor that says it lies on a CUDA device: the routes read
    ``is_cuda`` and ``device``; the patched launches return meta tensors."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(*shape):
    return torch.Tensor._make_subclass(
        _OnCard, torch.empty(shape, dtype=torch.complex64, device="meta"))


@pytest.fixture
def launches(monkeypatch):
    """Patch every launch a complex64 large-n call could reach: the
    complex64 entries of B2, B4 and B15 record (name, shape, outer) and
    return an empty result; the planar entries, B1 and any split raise."""
    calls = []

    def record(name, result):
        def launch(x, sign, scale, *rest):
            calls.append((name, tuple(x.shape), rest[-1] if name == "rows_t_fft_c64" else None))
            return result(x)
        return launch

    def same(x):
        return _on_card(*x.shape)

    monkeypatch.setattr(cuda_fft, "_ax0_launch_c64", record("ax0_fft_c64", same))
    monkeypatch.setattr(cuda_fft, "_rows_t_launch_c64", record(
        "rows_t_fft_c64", lambda x: _on_card(*x.shape[:-2], x.shape[-1], x.shape[-2])))
    monkeypatch.setattr(bigfft, "_launch_c64", record("big_fft_c64", same))

    def refuse(*args, **kwargs):
        raise AssertionError("a planar launch or a split")

    for mod, name in ((cuda_fft, "_launch"), (cuda_fft, "_launch_c64"),
                      (cuda_fft, "_ax0_launch"), (cuda_fft, "_rows_t_launch"),
                      (bigfft, "_launch"), (plan_mod, "promote_to_split")):
        monkeypatch.setattr(mod, name, refuse)
    return calls


@pytest.mark.parametrize("call", ["plan.forward", "plan.inverse", "fft", "ifft"])
@pytest.mark.parametrize("rows,e", [(4, 22), (1, 20), (2, 24)])
def test_complex64_fourstep_route(rows, e, call, launches):
    n = 1 << e
    x = _on_card(rows, n)
    p = ft.plan(n)
    y = {"plan.forward": p.forward, "plan.inverse": p.inverse, "fft": ft.fft,
         "ifft": ft.ifft}[call](x)
    assert y.shape == (rows, n) and y.dtype == torch.complex64
    n1, n2 = fourstep.choose_factors(n)
    assert launches == [("ax0_fft_c64", (rows, n1, n2), None),
                        ("rows_t_fft_c64", (rows, n1, n2), (n1, n))]


def test_complex64_two_pass_route(launches):
    # a tuned plan's "fourstep:two-pass" takes the complex64 pair where the
    # whole-row kernel would serve "fourstep"
    n = 1 << 16
    p = ft.plan(n)
    y = p._execute_c64(_on_card(4, n), -1, -1, None)
    assert launches == [("big_fft_c64", (4, n), None)] and y.shape == (4, n)
    launches.clear()
    p.executor = "auto"
    p._route = lambda device, shape, axis: "fourstep:two-pass"
    y = p._execute_c64(_on_card(4, n), -1, -1, None)
    n1, n2 = fourstep.choose_factors(n)
    assert launches == [("ax0_fft_c64", (4, n1, n2), None),
                        ("rows_t_fft_c64", (4, n1, n2), (n1, n))] and y.shape == (4, n)


def test_whole_row_route_unchanged(launches):
    # 256 x 2^16 stays on B15's complex64 entry, one launch
    x = _on_card(256, 1 << 16)
    y = ft.plan(1 << 16).forward(x)
    assert launches == [("big_fft_c64", (256, 1 << 16), None)] and y.shape == (256, 1 << 16)


def test_other_shapes_keep_their_paths(launches):
    # along an axis before the last, a composite length or n beyond 2^26
    # the complex64 four-step does not apply: _execute_c64 returns None and
    # the planar path takes the tensor (here: the patched split raises)
    assert ft.plan(1 << 20)._execute_c64(_on_card(1 << 20, 2), 0, -1, None) is None
    assert ft.plan(3 << 15, executor="fourstep")._execute_c64(
        _on_card(1, 3 << 15), -1, -1, None) is None
    assert ft.plan(1 << 27)._execute_c64(_on_card(1, 1 << 27), -1, -1, None) is None
    with pytest.raises(AssertionError, match="split"):
        ft.plan(1 << 27).forward(_on_card(1, 1 << 27))
    assert launches == []
