"""Torch port, the 3-D Navier-Stokes DNS (``models/ns3d.py``) and the
distributed Poisson solve against the JAX package on its 8 virtual CPU
devices.

The port's rollouts run on a real 8-rank gloo process group, the (2, 4)
pencil mesh (``tests/torch_dist_cases.py``, one module fixture); the JAX
rollouts on ``make_pencil_mesh()``, the same numpy inputs from a seed.
tests/test_ns3d.py's cases at n = 16: the JAX rollout at 2e-5, the exact
ABC decay at 5e-5; the Poisson solve at 1e-5.  The path with no process
group runs in this process.
"""

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_wgpu_tpu.models import ns3d as jns3d
from fft_wgpu_tpu.models import poisson as jpoisson
from fft_wgpu_tpu.parallel import mesh as jmesh
from fft_wgpu_tpu_torch.models import ns3d, poisson

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_cases as cases  # noqa: E402

torch.set_num_threads(1)

N = 16
INPUTS = {
    "u7": np.random.default_rng(7).standard_normal((3, N, N, N)).astype(np.float32),
    "u3": np.random.default_rng(3).standard_normal((3, N, N, N)).astype(np.float32),
    "poisson": np.random.default_rng(11).standard_normal((N, 32, N)).astype(np.float32),
}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return cases.run_suite("ns3d", tmp_path_factory.mktemp("ns3d"), INPUTS)


@functools.lru_cache(maxsize=None)
def jax_rollout(key, nu, dt, steps):
    u0 = jns3d.abc_flow(N) if key == "abc" else jnp.asarray(INPUTS[key])
    return np.asarray(jns3d.ns3d_rollout(jns3d.ns3d_init(N, nu, dt), u0, steps))


@functools.lru_cache(maxsize=None)
def jax_poisson(lengths):
    return np.asarray(jpoisson.solve_poisson_distributed(INPUTS["poisson"],
                                                         jmesh.make_pencil_mesh(), lengths))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _k(n):
    return (np.fft.fftfreq(n, 1.0 / n)[:, None, None], np.fft.fftfreq(n, 1.0 / n)[None, :, None],
            np.fft.rfftfreq(n, 1.0 / n)[None, None, :])


def test_abc_flow_is_beltrami():
    """curl(abc) == abc on the grid, and the port's field is the JAX one."""
    u = ns3d.abc_flow(N, device="cpu").numpy()
    np.testing.assert_array_equal(u, np.asarray(jns3d.abc_flow(N)))
    U = np.fft.rfftn(u.astype(np.float64), axes=(-3, -2, -1))
    kx, ky, kz = _k(N)
    curl = np.stack([1j * (ky * U[2] - kz * U[1]), 1j * (kz * U[0] - kx * U[2]),
                     1j * (kx * U[1] - ky * U[0])])
    assert np.linalg.norm(curl - U) / np.linalg.norm(U) < 1e-6


def test_abc_viscous_decay_exact(port):
    u0 = ns3d.abc_flow(N, device="cpu").numpy()
    expect = u0 * np.exp(-0.05 * 0.1 * 6, dtype=np.float32)
    assert rel(port["abc"], expect) < 5e-5
    assert rel(port["abc"], jax_rollout("abc", 0.05, 0.1, 6)) < 2e-5


def test_matches_jax_rollout(port):
    """The distributed rollout against the JAX package's, same input."""
    assert rel(port["random"], jax_rollout("u7", 0.02, 0.05, 3)) < 2e-5


def test_natural_spectra_match_transposed(port):
    assert rel(port["natural"], port["random"]) < 1e-5


def test_divergence_free_and_energy_decay(port):
    u1, u2 = port["div/u1"], port["div/u2"]
    U = np.fft.rfftn(u2, axes=(-3, -2, -1))
    kx, ky, kz = _k(N)
    div = kx * U[0] + ky * U[1] + kz * U[2]
    assert np.abs(div).max() / np.abs(U).max() < 1e-4
    assert float((u2 ** 2).sum()) < float((u1 ** 2).sum()), "unforced flow must lose energy"


def test_rollout_cache_replays(port):
    assert port["cache/cached"]
    np.testing.assert_array_equal(port["cache/a"], port["cache/b"])


def test_ns3d_bf16_comm_close_to_exact(port):
    r = rel(port["bf16/got"], port["bf16/exact"])
    assert 0.0 < r < 2e-2  # the bf16 wire path genuinely taken, within its rounding


def test_projection_is_solenoidal_on_every_shard(port):
    assert port["project"] < 1e-6


@pytest.mark.parametrize("lengths", [None, (2 * np.pi, 4 * np.pi, np.pi)])
def test_solve_poisson_distributed(port, lengths):
    got = port["poisson" if lengths is None else "poisson/lengths"]
    assert rel(got, jax_poisson(lengths)) < 1e-5
    if lengths is None:
        assert rel(port["poisson/bf16"], got) < 2e-2


def test_no_group_rollout_and_poisson_run_here():
    """No mesh and no process group: this process alone, every turn the
    identity, on the CPU tensors' device."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    c = ns3d.ns3d_init(N, 0.05, 0.1)
    got = ns3d.ns3d_rollout(c, ns3d.abc_flow(N, device="cpu"), 6)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert rel(got.numpy(), jax_rollout("abc", 0.05, 0.1, 6)) < 2e-5
    f = torch.from_numpy(INPUTS["poisson"])
    u = poisson.solve_poisson_distributed(f)
    assert rel(u.numpy(), jax_poisson(None)) < 1e-5
    assert rel(u.numpy(), poisson.solve_poisson(f).numpy()) < 1e-5


def test_step_and_projection_of_spectra_alone():
    """ns3d_step of the plan's spectra (no process group: the whole
    [n, n, n//2 + 1] spectra) against a rollout of one step."""
    c = ns3d.ns3d_init(N, 0.02, 0.05)
    u0 = torch.from_numpy(INPUTS["u7"])
    t = c.tables("cpu")
    U = torch.fft.rfftn(u0.double(), dim=(-3, -2, -1)).to(torch.complex64) * t["mask"]
    U = torch.stack(ns3d.project_divergence_free(c, *U))
    U1 = ns3d.ns3d_step(c, *U)
    got = torch.fft.irfftn(torch.stack(U1).to(torch.complex128), s=(N, N, N), dim=(-3, -2, -1))
    assert rel(got.numpy(), ns3d.ns3d_rollout(c, u0, 1).numpy()) < 1e-5
