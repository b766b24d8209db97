"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled for Hopper into ``_build/`` inside the package (listed in
``.gitignore``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

The host core ``csrc/fftcore.cpp`` (``utils/native.py``) is built the same
way by g++ (:data:`GXX_FLAGS`).

The library's file name carries a hash of the source, of every ``csrc``
header it includes (``#include "<header>.cuh"``, followed into headers) and
of the flags, so an edited source or header is rebuilt and a stale library
is never loaded.  nvcc's output, with ``-Xptxas -v``'s register and
shared-memory report, is kept beside the library as ``<library>.log``.
Every launch goes through :func:`launch`, which calls the C function on
the tensors' device and leaves the thread's current device as it was.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["CompileError", "BUILD_DIR", "library_path", "build", "load",
           "function", "check", "launch", "source_stamp", "set_build_dir", "preload",
           "recording"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread", "-std=c++17")

_LIBS: dict[str, ctypes.CDLL] = {}
# compiler runs of this process, nvcc or g++ (build() counts them)
compiles = 0
# open recordings of the libraries loaded (recording())
_RECORDS: list = []


class CompileError(RuntimeError):
    """nvcc (or g++, for a host source) is missing or refused a source."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME:
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise CompileError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                           "or set CUDA_HOME")
    return nvcc


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source(name: str) -> Path:
    """``csrc/<name>.cu``, or the host source ``csrc/<name>.cpp``."""
    src = CSRC / f"{name}.cu"
    return src if src.exists() else CSRC / f"{name}.cpp"


def _compiler(src: Path) -> tuple:
    """The compiler of ``src`` and its flags: nvcc for CUDA, g++ for host
    C++."""
    if src.suffix == ".cu":
        return _nvcc(), NVCC_FLAGS
    gxx = shutil.which("g++")
    if gxx is None:
        raise CompileError("g++ not found: the host core csrc/fftcore.cpp needs it")
    return gxx, GXX_FLAGS


def _flags(src: Path) -> tuple:
    return NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS


def _sources(src: Path) -> list[Path]:
    """``src`` and every file of its directory that it includes, transitively."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.exists():
                todo.append(dep)
    return seen


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` (or ``.cpp``) lives, named by
    the hash of its sources and the flags."""
    src = _source(name)
    digest = hashlib.sha256(" ".join(_flags(src)).encode())
    for path in _sources(src):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def source_stamp() -> str:
    """A hash of every ``csrc`` source and header and of the flags: what
    the library names carry, for all of them at once (16 hex digits)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return digest.hexdigest()[:16]


def set_build_dir(path) -> Path:
    """Build and load the libraries in ``path`` from now on (created if
    missing); libraries already loaded in this process stay loaded."""
    global BUILD_DIR
    BUILD_DIR = Path(path).expanduser().resolve()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (or ``.cpp``) unless its library is
    already built."""
    src = _source(name)
    out = library_path(name)
    if out.exists():
        return out
    global compiles
    compiler, flags = _compiler(src)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiles += 1
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise CompileError(f"{Path(compiler).name} failed on {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    for names in _RECORDS:
        names.add(name)
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
    return lib


def preload(name: str, path) -> None:
    """Load the library file ``path`` as ``csrc/<name>.cu``'s, with no
    build: its file name must be the one :func:`library_path` gives the
    sources of this checkout (the same sources, headers and flags)."""
    path = Path(path)
    if path.name != library_path(name).name:
        raise ValueError(f"{path.name} was not built from this checkout's {name}.cu "
                         f"(expected {library_path(name).name})")
    _LIBS[name] = ctypes.CDLL(str(path))


@contextlib.contextmanager
def recording():
    """Collect, into the yielded set, the name of every library a launch
    inside the block loads."""
    names: set = set()
    _RECORDS.append(names)
    try:
        yield names
    finally:
        _RECORDS.remove(names)


def function(name: str, fn: str, argtypes: list):
    """The C function ``fn`` of ``csrc/<name>.cu``, typed: it takes
    ``argtypes`` and returns a CUDA error code (0 = ok)."""
    f = getattr(load(name), fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def check(name: str, err: int, what: str) -> None:
    """Raise if a launch of ``csrc/<name>.cu`` returned an error; the
    library's ``<name>_error_string`` names it."""
    if err:
        describe = getattr(load(name), f"{name}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: {describe(err).decode()}")


def launch(name: str, fn: str, argtypes: list, device, *args, what: str) -> None:
    """Call the C function ``fn`` of ``csrc/<name>.cu`` with ``args`` for
    tensors on ``device``, inside a ``torch.cuda.device`` guard: the call
    runs on that device and the thread's current device is restored after
    it.  Raise with ``what`` if it returned an error."""
    import torch

    f = function(name, fn, argtypes)
    with torch.cuda.device(device):
        err = f(*args)
    check(name, err, what)
