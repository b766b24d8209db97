"""Torch port, the plain versions of the four-step's transposed-rows kernel
(B4) at n = 4096, sign 1 (scale 1/n), against the JAX package's Pallas kernel
in interpret mode: ``test_torch_rows_t_c64.py``'s ``check_rows_t``,
rows 1 and 200, each outer twiddle, planar and complex64.

The JAX kernel takes 20-30 s to compile in interpret mode at this n, so
each length and sign has a file of its own, which the test run's
``--dist loadfile`` gives a worker of its own.  Tolerance: 1e-5
relative L2.
"""

import pytest
import torch

from test_torch_rows_t_c64 import OUTERS, check_rows_t

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", OUTERS)
@pytest.mark.parametrize("rows", [1, 200])
def test_rows_t_plain_matches_jax_4096_inverse(rows, kind, rng, assert_close):
    check_rows_t(4096, rows, kind, rng, assert_close, signs=(1,))
