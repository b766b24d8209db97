"""The JAX package's native core, built for one test process alone.

``fft_wgpu_tpu/utils/native.py`` builds ``libfftcore.so`` with g++ into the
package's own directory the first time any process asks for it.  Under
``pytest -n`` several workers ask at once: one may load the file while
another is still writing it, keep ``None`` for the rest of its life, and
then see the JAX tables fall back to numpy without the native core's
``(k*m) mod n`` reduction, whose low bits differ.  The port's tests that
hold its tables against the JAX native generator therefore load a second
copy of that module (its own source file, untouched) whose library path
points into a directory of this process's own, so the same ``fftcore.cpp``
is compiled by the module's own g++ command where no other process writes.
Nothing is written into ``fft_wgpu_tpu/``.
"""

from __future__ import annotations

import importlib.util
import os

import pytest

import fft_wgpu_tpu.utils.native as _public


def load(directory) -> object:
    """A private instance of ``fft_wgpu_tpu.utils.native`` whose library is
    built into ``directory`` (not yet built: its first ``get_lib()`` does)."""
    spec = importlib.util.spec_from_file_location("_jax_native_private", _public.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._LIB = os.path.join(str(directory), "libfftcore.so")
    return mod


@pytest.fixture(scope="session")
def jax_native(tmp_path_factory):
    """This process's private instance of the JAX native module (built on
    first use; a test calls :func:`require` before reading a table)."""
    return load(tmp_path_factory.mktemp("jax_fftcore"))


def require(mod) -> None:
    """Fail (not skip) where the JAX package's native core does not build."""
    if mod.get_lib() is None:  # the JAX module's None: no toolchain
        pytest.fail("the JAX package's native core did not build")


def dft_matrix_np(mod, n: int, sign: int):
    """The JAX package's DFT-matrix table as ``fft_wgpu_tpu.core.twiddle``
    gives it with the native core loaded: the f64 table cast once to
    float32."""
    require(mod)
    wr, wi = mod.dft_matrix_f64(n, sign)
    return wr.astype("float32"), wi.astype("float32")
