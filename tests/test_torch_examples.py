"""Torch port, the examples (``fft_wgpu_tpu_torch/examples``): each runs
``main(device="cpu", small=True)`` on the CPU, a cut-down size with the
JAX example's own check asserted inside it.  On the card they run at the
JAX examples' own sizes in ``chip_smoke.py``'s path 13.
"""

import importlib

import pytest
import torch

from fft_wgpu_tpu_torch.examples import NAMES
from fft_wgpu_tpu_torch.utils import build

torch.set_num_threads(1)


def test_names_are_the_jax_examples_but_ns3d():
    from pathlib import Path

    jax_examples = {p.stem for p in (Path(__file__).parent.parent / "examples").glob("*.py")}
    # ns3d_dns came with the distributed layer: the set is now all of them
    assert set(NAMES) == jax_examples


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(name, monkeypatch, tmp_path, capsys):
    # the serving example points the build cache at ~/.cache: keep it, and
    # the process's build directory, inside this test
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    importlib.import_module(f"fft_wgpu_tpu_torch.examples.{name}").main(device="cpu", small=True)
    assert capsys.readouterr().out.strip()
