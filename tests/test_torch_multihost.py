"""Torch port, multi-process bring-up (``parallel.multihost``,
``parallel.multihost_selftest``) and the meshes (``parallel.mesh``).

``launch_cluster`` spawns real OS processes that join one gloo group
through ``multihost.initialize`` and run ``fft3d`` and
``fft1d_distributed`` across the process boundary, parity asserted in
every process: with 2 and with 4 processes.  The mesh cases run on one
8-rank gloo group (``tests/torch_dist_cases.py``): the global pencil mesh
against the JAX package's on its 8 virtual devices, the hybrid mesh on one
host and over faked nodes, uneven nodes refused.
"""

import os
import sys

import numpy as np
import pytest
import torch

from fft_wgpu_tpu.parallel import mesh as jmesh
from fft_wgpu_tpu.parallel.multihost import global_pencil_mesh as jglobal_pencil_mesh
from fft_wgpu_tpu_torch.parallel.multihost_selftest import MultihostUnavailable, launch_cluster

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_cases as cases  # noqa: E402

torch.set_num_threads(1)

INPUTS = {
    "hybrid": (np.random.default_rng(5).standard_normal((8, 8, 8))
               + 1j * np.random.default_rng(6).standard_normal((8, 8, 8))).astype(np.complex64),
    "ragged": np.zeros((8, 6, 8), np.complex64),  # 6 rows over py = 4
}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return cases.run_suite("multihost", tmp_path_factory.mktemp("multihost"), INPUTS)


@pytest.mark.parametrize("procs", [2, 4])
def test_process_cluster_fft_parity(procs):
    outs = launch_cluster(num_processes=procs)
    assert len(outs) == procs
    for i, out in enumerate(outs):
        assert "MULTIHOST_SELFTEST_OK" in out
        assert f"proc={i}/{procs}" in out and f"devices={procs}" in out


def test_multihost_unavailable_keeps_its_name():
    assert issubclass(MultihostUnavailable, RuntimeError)


def test_initialize_is_idempotent(port):
    assert tuple(port["initialize"]) == (0, 8)


def test_global_pencil_mesh(port):
    assert tuple(port["global/shape"]) == jglobal_pencil_mesh().devices.shape == (2, 4)


def test_hybrid_mesh_one_node(port):
    j = jmesh.make_hybrid_mesh()
    assert tuple(port["hybrid/shape"]) == j.devices.shape == (1, 8)
    assert tuple(port["hybrid/names"]) == j.axis_names == ("dcn", "ici")


def test_hybrid_mesh_nodes_from_local_world_size(port):
    np.testing.assert_array_equal(port["lws/mesh"], np.arange(8).reshape(2, 4))


def test_fft3d_on_hybrid_minor_axis(port):
    x = INPUTS["hybrid"]
    err = np.linalg.norm(port["hybrid/roundtrip"] - x) / np.linalg.norm(x)
    assert err < 1e-5


def test_uneven_nodes_rejected(port):
    assert port["uneven_raises"]


def test_two_fake_nodes_grouping(port):
    # interleaved host names: make_hybrid_mesh groups each node's ranks
    np.testing.assert_array_equal(port["two/mesh"], [[0, 2, 4, 6], [1, 3, 5, 7]])


def test_mesh_ranks_must_increase(port):
    assert port["decreasing_raises"]


def test_undivided_axis_raises(port):
    assert port["not_divisible_raises"]
