"""Torch port, the large-N slice as a whole (ops/fourstep.py and the plan's
``"fourstep"`` / ``"bigfft"`` executors) against the JAX package on the CPU.

The same numpy inputs go through ``fft_wgpu_tpu`` and
``fft_wgpu_tpu_torch``; the JAX package's whole-row kernel runs in
interpret mode.  The routing on the card is checked without one, from the
envelopes the routes are chosen by.  Tolerance: 1e-5 relative L2.
"""

import numpy as np
import pytest
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu.ops import bigfft as j_big
from fft_wgpu_tpu.ops import fourstep as j_fourstep
from fft_wgpu_tpu_torch.ops import bigfft, cuda_fft, fourstep

torch.set_num_threads(1)


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _np(z):
    return z.numpy() if isinstance(z, torch.Tensor) else np.asarray(z)


def _t(x):
    # a CPU tensor asks the port for the CPU; numpy input goes to the card
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_no_launches():
    assert (cuda_fft.launches, cuda_fft.ax0_launches, cuda_fft.rows_t_launches,
            bigfft.launches) == (0, 0, 0, 0)


@pytest.mark.parametrize("n", [1 << e for e in range(15, 25)] + [120])
def test_choose_factors_match_jax(n):
    assert fourstep.choose_factors(n) == j_fourstep.choose_factors(n)


@pytest.mark.parametrize("rows,n", [(2, 4096), (2, 32768), (1, 1 << 20)])
def test_fourstep_matches_jax(rows, n, rng, assert_close):
    x = crand(rng, rows, n)
    got = ft.fft(_t(x), executor="fourstep")
    assert got.shape == x.shape and got.dtype == torch.complex64
    assert_close(_np(got), _np(ftt.fft(x, executor="fourstep")))
    assert_close(_np(got), np.fft.fft(x, axis=-1))
    assert_no_launches()


@pytest.mark.parametrize("mode", ["forward", "inverse", "inverse_unnormalized"])
def test_fourstep_plan_modes_match_jax(mode, rng, assert_close):
    n = 1 << 16
    x = crand(rng, 2, n)
    got = getattr(ft.plan(n, executor="fourstep"), mode)(_t(x))
    assert_close(_np(got), _np(getattr(ftt.plan(n, executor="fourstep"), mode)(x)))
    # executor="auto" on a CPU tensor takes the mixed-radix path, as in JAX
    assert_close(_np(getattr(ft.plan(n), mode)(_t(x))), _np(got))


def test_fourstep_roundtrip(rng, assert_close):
    n = 65536
    x = crand(rng, n)
    y = ft.ifft(ft.fft(_t(x), executor="fourstep"), executor="fourstep")
    assert_close(_np(y), x)
    assert_no_launches()


def test_fourstep_composite_n(rng, assert_close):
    x = crand(rng, 3, 120)
    assert_close(_np(ft.fft(_t(x), executor="fourstep")),
                 _np(ftt.fft(x, executor="fourstep")))


@pytest.mark.parametrize("sign", [-1, 1])
def test_bigfft_executor_matches_jax_kernel(sign, rng, assert_close):
    n = 1 << 15
    x = crand(rng, 2, n)
    fn = ft.fft if sign < 0 else ft.ifft
    got = fn(_t(x), executor="bigfft")
    jr, ji = j_big.fft_big_split(x.real.copy(), x.imag.copy(), sign,
                                 None if sign < 0 else 1.0 / n, interpret=True)
    assert_close(_np(got), np.asarray(jr) + 1j * np.asarray(ji))
    assert_no_launches()


def test_bigfft_executor_outside_envelope_raises():
    with pytest.raises(bigfft.Unsupported):
        ft.plan(1 << 14, executor="bigfft").forward(torch.zeros(1, 1 << 14))
    with pytest.raises(bigfft.Unsupported):
        ft.fft(torch.zeros(1, 1 << 19), executor="bigfft")


def test_routing_on_the_card():
    # pure decisions for a CUDA tensor; no card needed
    cuda = torch.device("cuda", 0)
    for e in range(15, 31):
        assert ft.plan(1 << e)._resolve_executor(cuda) == "fourstep"
    for e in range(15, 27):
        n = 1 << e
        n1, n2 = fourstep.choose_factors(n)
        for rows in (1, 4, 256):
            if bigfft.takes(n, rows):
                continue  # one launch of the whole-row kernel
            # else the axis(-2) kernel then the transposed-rows kernel: no
            # pow2 n > 16384 on the card reaches the mixed-radix path
            assert cuda_fft._ax0_supported(n1) and cuda_fft._supported(n2), n
    assert [e for e in range(15, 27) if bigfft._supported(1 << e, 256)] \
        == [15, 16, 17, 18]
    # the static route's crossover to the two passes (bigfft.takes, the
    # card's counterpart of the JAX package's BATCHED_MAX_N): the whole-row
    # kernel below it, at every row count of 2^15 and 2^16 and of planar
    # 2^17; the envelope itself keeps every row count
    for rows in (1, 4, 16, 64, 256, 1024):
        for c64 in (False, True):
            assert bigfft.takes(1 << 15, rows, c64) and bigfft.takes(1 << 16, rows, c64)
        assert bigfft.takes(1 << 17, rows, c64=False)
    assert bigfft.takes(1 << 17, 64, c64=True) and not bigfft.takes(1 << 17, 256, c64=True)
    for c64 in (False, True):
        assert bigfft.takes(1 << 18, 16, c64) and not bigfft.takes(1 << 18, 64, c64)
        assert not bigfft.takes(1 << 18, 1024, c64) and bigfft._supported(1 << 18, 1024)
        assert not bigfft.takes(1 << 19, 1, c64)
    for (n, c64), rows in bigfft.TWO_PASS_FROM.items():
        assert bigfft.takes(n, rows - 1, c64) and not bigfft.takes(n, rows, c64)
        assert fourstep.c64_supported(n)  # the two passes take every n the rule sends them
    assert fourstep.choose_factors(1 << 22) == (1024, 4096)  # BASELINE config 3
    assert fourstep.choose_factors(1 << 20) == (1024, 1024)
    # beyond 2^26, pass 1's n1 > 16384 recurses through the plan's fourstep
    assert fourstep.choose_factors(1 << 27)[0] == 1 << 15
    assert ft.plan(1 << 15, executor="bigfft")._resolve_executor(cuda) == "bigfft"


def test_fourstep_grad_matches_jax(rng, assert_close):
    import jax
    import jax.numpy as jnp

    n = 1 << 15
    re, im, w = (rng.standard_normal((2, n)).astype(np.float32) for _ in range(3))

    def jloss(a, b):
        y = ftt.fft(jax.lax.complex(a, b), executor="fourstep")
        return jnp.sum(w * jnp.abs(y) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(re, im)
    tre = torch.from_numpy(re).requires_grad_()
    tim = torch.from_numpy(im).requires_grad_()
    y = ft.fft(torch.complex(tre, tim), executor="fourstep")
    (torch.from_numpy(w) * y.abs() ** 2).sum().backward()
    assert_close(tre.grad.numpy(), np.asarray(jg[0]), what="d/dre")
    assert_close(tim.grad.numpy(), np.asarray(jg[1]), what="d/dim")
