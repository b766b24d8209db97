"""Torch port, the power of a forward-inverse round trip through the
compiled passes of ``csrc/mixed_fft.cuh`` (ROADMAP §C, C5), on the CPU.

A split-step solver takes one round trip a step, so a transform whose
power gain is below 1 drains a rollout's mass linearly.  Two causes were
found in the passes: the butterfly constants (the float32 pairs of w_16
and w_8 have |w|^2 - 1 down to -5.7e-8, and a radix-16 butterfly
multiplies 8 of its 16 points by them) and the twiddles w^k formed as
k - 1 products of one root, which multiply the root's |w|^2 - 1 by k.
The power-of-two kernels' passes (a plan fixed at compile time) now gather
every w^k from a table of the pass's own powers, and the constants are the
float32 pairs of |w|^2 nearest 1; the composite kernels' run-time passes
keep the chain, which measured faster there and no further from 1.  The
plain versions of the passes (``cuda_fft._fixed_passes``,
``_mixed_passes``) follow the kernels, so these gains are the kernels'
arithmetic on the CPU; the card's are held by ``chip_smoke.py`` path 10
and the ``cuda`` tier.  Bar: |gain - 1| <= 6e-8 (the parent's fixed
passes gave -9.2e-8 at 256 and -1.45e-7 at 4096 here).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from fft_wgpu_tpu_torch.ops import cuda_fft

torch.set_num_threads(1)

GAIN_TOL = 6e-8


def _gain(transform, n, rows=256, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.complex(*(torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32))
                        for _ in range(2)))
    y = transform(transform(x, -1, None), 1, 1.0 / n)
    x, y = x.to(torch.complex128), y.to(torch.complex128)
    return float((y * x.conj()).sum().real / x.abs().square().sum()) - 1.0


def _mixed(z, sign, scale):
    # B13's passes (cuda_fft._mixed_passes), the scale at the store
    return torch.complex(*cuda_fft._mixed_radix(z.real.contiguous(), z.imag.contiguous(),
                                               sign, scale))


def _fixed(z, sign, scale):
    # B1's passes: n's compiled plan on its pass table
    return torch.complex(*cuda_fft._rows_passes(z.real.contiguous(), z.imag.contiguous(),
                                               sign, scale))


@pytest.mark.parametrize("passes,n", [(_fixed, 256), (_fixed, 4096), (_mixed, 1000),
                                      (_mixed, 1080), (_mixed, 4095)],
                         ids=["fixed-256", "fixed-4096", "mixed-1000", "mixed-1080", "mixed-4095"])
def test_round_trip_keeps_power(passes, n):
    gain = _gain(passes, n)
    assert abs(gain) <= GAIN_TOL, f"round-trip gain - 1 = {gain:+.3e} at n={n}"


def test_butterfly_constants_match_the_source():
    src = (pathlib.Path(cuda_fft.__file__).parent.parent / "csrc" / "mixed_fft.cuh").read_text()
    table = re.search(r"kRoot\[76\] = \{(.*?)\n\};", src, re.S)[1]
    pairs = re.findall(r"\{([-\d.e+]+)f, ([-\d.e+]+)f\}", table)
    got = np.array(pairs, dtype=np.float32)
    want = np.concatenate([np.stack(cuda_fft.butterfly_roots_np(r), axis=-1)
                           for r in (3, 4, 5, 7, 8, 9, 11, 13, 16)])
    assert got.shape == want.shape == (76, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r", [3, 4, 5, 7, 8, 9, 11, 13, 16])
def test_butterfly_constants_near_unit(r):
    c, s = (v.astype(np.float64) for v in cuda_fft.butterfly_roots_np(r))
    exact = np.exp(2j * np.pi * np.arange(r) / r)
    assert np.abs(c * c + s * s - 1).max() <= 4e-8  # the lattice allows 3.4e-8 at w_8
    assert np.abs(c + 1j * s - exact).max() <= 2.2e-7  # two ulps a part, and the rounding
    rounded = exact.real.astype(np.float32).astype(np.float64) ** 2 \
        + exact.imag.astype(np.float32).astype(np.float64) ** 2 - 1
    assert np.abs(c * c + s * s - 1).sum() <= np.abs(rounded).sum()


def test_pass_tables_hold_every_power():
    # a fixed pass's table: w_(NS*R)^(k*e) as [k - 1][e], each a root of the
    # m-point table (the kernel gathers w^k, no products)
    for m in (256, 4096, 16384):
        c, s = cuda_fft._pass_roots_np(m, -1)
        plan = cuda_fft._mixed_radix_plan(m)
        assert len(c) == sum(int(np.prod(plan[:i])) * (plan[i] - 1) for i in range(1, len(plan)))
        rc, rs = cuda_fft._tw.roots_np(m, -1)
        table = set(zip(rc.tolist(), rs.tolist()))
        assert set(zip(c.tolist(), s.tolist())) <= table
