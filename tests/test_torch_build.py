"""Torch port, the kernel build module (utils/build.py) without a compiler.

The library's file name carries a hash of the source and of every header
of ``csrc`` it includes, so an edited header is rebuilt and a stale library
is never loaded.  Computing the name needs no ``nvcc``.
"""

import pytest

from fft_wgpu_tpu_torch.utils import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    return tmp_path


@pytest.mark.parametrize("edit", ["k.cu", "a.cuh", "b.cuh"])
def test_hash_covers_source_and_included_headers(csrc, edit):
    before = build.library_path("k")
    assert before.parent == csrc / "_build" and before.name.startswith("libk-")
    assert build.library_path("k") == before  # deterministic
    (csrc / edit).write_text((csrc / edit).read_text() + "// edited\n")
    assert build.library_path("k") != before


def test_hash_ignores_headers_not_included(csrc):
    before = build.library_path("k")
    (csrc / "other.cuh").write_text("// edited\n")
    assert build.library_path("k") == before


def test_port_sources_include_the_shared_passes():
    # every kernel's passes are mixed_fft.cuh's; the radix-4 header they
    # once shared is gone
    names = {p.name for p in build._sources(build.CSRC / "rows_fft.cu")}
    assert names == {"rows_fft.cu", "mixed_fft.cuh"}
    for name in ("ax0_fft", "rows_t_fft", "big_fft"):
        assert {p.name for p in build._sources(build.CSRC / f"{name}.cu")} \
            == {f"{name}.cu", "mixed_fft.cuh"}
    assert not (build.CSRC / "stockham.cuh").exists()
    assert not any('"stockham.cuh"' in p.read_text() for p in build.CSRC.iterdir()
                   if p.suffix in (".cu", ".cuh"))
