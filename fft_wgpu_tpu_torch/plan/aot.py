"""Ahead-of-time plan artifacts for serving (torch port of
``fft_wgpu_tpu.plan.aot``).

The JAX package ships a plan as serialized StableHLO.  The port's plan is
a route through hand-written kernels, so its artifact ships that route and
the kernels' built libraries: a serving process loads the artifact and
replays the transforms with no plan to resolve, no tuning and no nvcc run.

    p = ft.plan(4096)
    ft.export_plan(p, "fft4096.ftta", batch_shape=(512,))

    sp = ft.load_plan("fft4096.ftta")          # no Plan, no nvcc
    re, im = sp.forward_split(re, im)

Artifacts are zip containers: a ``meta.json`` (the format string, n, the
served shape, axis, ops, the torch and CUDA versions, the card's name and
compute capability, the route each op takes) and, for an artifact exported
on the card, every kernel library those routes load, under the file names
``utils/build.py`` gives them (a hash of the sources, headers and flags).
:func:`load_plan` checks the format and the card's compute capability,
and loads the libraries with ctypes; a library built from other sources
than the loading checkout's is refused.  An artifact exported on the CPU
holds no library and replays the plain path.  Executors run in the split
(re, im) domain, as in the JAX package.

``torch.export`` cannot stand in for StableHLO here: it traces torch
operators, and the kernels are ctypes calls into the libraries, which it
cannot trace.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import zipfile
from pathlib import Path

import torch

from ..core.complex_utils import default_device
from ..core.twiddle import FORWARD, INVERSE
from ..utils import build

__all__ = ["export_plan", "load_plan", "AOTPlan"]

_FORMAT = "fft_wgpu_tpu_torch-aot-v1"
_OPS = ("forward", "inverse", "inverse_unnormalized")


def _op_sign_scale(n: int, op: str):
    return {
        "forward": (FORWARD, None),
        "inverse": (INVERSE, 1.0 / n),
        "inverse_unnormalized": (INVERSE, None),
    }[op]


def export_plan(p, path=None, *, batch_shape=(), axis: int = -1, ops=_OPS, device=None):
    """Serialize plan ``p``'s routes for ``batch_shape + (n,)`` inputs,
    transformed along ``axis``, on ``device`` (the current CUDA device by default; pass
    ``"cpu"`` for a CPU artifact).  Each op runs once on zeros there, which
    builds its kernels, and the libraries it loaded go into the artifact.

    ``path=None`` returns the artifact as bytes; otherwise writes the file
    and returns ``path``.
    """
    device = torch.device(device) if device is not None else default_device()
    shape = [int(b) for b in batch_shape] + [p.n]
    ax = axis % len(shape)
    for op in ops:
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r}; expected {_OPS}")
    on_card = device.type == "cuda"
    routes, libs = {}, set()
    for op in ops:
        sign, scale = _op_sign_scale(p.n, op)
        route = p._route(device, shape, ax)
        with build.recording() as names:
            re = torch.zeros(shape, device=device)
            p._execute_split_axis(re, torch.zeros_like(re), sign, scale, ax, ex=route)
        routes[op] = {"route": route, "libraries": sorted(names)}
        libs |= names
    meta = {
        "format": _FORMAT,
        "n": p.n,
        "shape": shape,
        "axis": int(axis),
        "ops": list(ops),
        "routes": routes,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "capability": list(torch.cuda.get_device_capability(device)) if on_card else None,
        "libraries": {name: build.library_path(name).name for name in sorted(libs)},
    }
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        for name, file in meta["libraries"].items():
            z.write(build.library_path(name), f"lib/{file}")
    data = buf.getvalue()
    if path is None:
        return data
    with open(path, "wb") as f:
        f.write(data)
    return path


class AOTPlan:
    """A loaded serving artifact: split-domain executors only, fixed
    shapes, fixed routes.  Mirrors the Plan split API (``forward_split``,
    ``inverse_split``, ``inverse_unnormalized_split``)."""

    def __init__(self, meta: dict):
        from .plan import Plan

        self.n = int(meta["n"])
        self.shape = tuple(meta["shape"])
        self.axis = int(meta["axis"])
        self.device = meta["device"]
        self._meta = meta
        self._plan = Plan(self.n)
        self._routes = {op: r["route"] for op, r in meta["routes"].items()}

    def _run(self, op, re, im):
        route = self._routes.get(op)
        if route is None:
            raise ValueError(
                f"artifact was exported without {op!r} "
                f"(has {sorted(self._routes)})")
        if tuple(re.shape) != self.shape:
            raise ValueError(
                f"artifact serves shape {self.shape}, got {tuple(re.shape)}")
        sign, scale = _op_sign_scale(self.n, op)
        return self._plan._execute_split_axis(re, im, sign, scale, self.axis, ex=route)

    def forward_split(self, re, im):
        return self._run("forward", re, im)

    def inverse_split(self, re, im):
        return self._run("inverse", re, im)

    def inverse_unnormalized_split(self, re, im):
        return self._run("inverse_unnormalized", re, im)

    def __repr__(self):
        return f"AOTPlan(n={self.n}, shape={self.shape}, device={self.device!r})"


def load_plan(src, *, lib_dir=None) -> AOTPlan:
    """Load a serving artifact from a path or bytes -> :class:`AOTPlan`.

    The kernel libraries it holds are written to ``lib_dir`` (a new
    temporary directory by default) and loaded from there; nvcc never runs.
    An artifact with libraries needs a card of the compute capability it
    was exported on."""
    data = src if isinstance(src, (bytes, bytearray)) else Path(src).read_bytes()
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("format") != _FORMAT:
            raise ValueError(f"not a {_FORMAT} artifact")
        libs = meta.get("libraries", {})
        if libs:
            if not torch.cuda.is_available():
                raise RuntimeError("the artifact holds kernel libraries for a card, "
                                   "and no CUDA device is available")
            cap = list(torch.cuda.get_device_capability())
            if cap != meta["capability"]:
                raise ValueError(f"artifact built for compute capability "
                                 f"{meta['capability']}, this card is {cap}")
            out = Path(lib_dir or tempfile.mkdtemp(prefix="fft_wgpu_tpu_torch_aot_"))
            out.mkdir(parents=True, exist_ok=True)
            for name, file in libs.items():
                target = out / file
                target.write_bytes(z.read(f"lib/{file}"))
                os.chmod(target, 0o755)
                build.preload(name, target)
    return AOTPlan(meta)
