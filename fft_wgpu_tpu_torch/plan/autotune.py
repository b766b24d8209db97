"""Measured executor selection, the FFTW_MEASURE analogue for plans (torch
port of ``fft_wgpu_tpu.plan.autotune``).

``plan(n, autotune=True)`` times, once per (card, n, rows bucket, axis),
the routes that can serve a CUDA shape, and the fastest becomes the plan's
route for matching calls.  The JAX package measures among the kernel
routes its TPU has; the port measures among the kernel routes the card
has (:func:`candidates_for`):

* pow2 n in 128..16384: the row kernel alone (its plan is compiled per n,
  so there is no schedule to choose);
* pow2 n above 16384: the whole-row kernel (``"bigfft"``) where its
  envelope holds, against the four-step's two passes, the axis(-2) kernel
  then the transposed-rows kernel (``"fourstep:two-pass"``);
* composite n in the composite-row kernel's envelope with a prime factor
  above 128: that kernel (``"general"``) against Bluestein's fused chirp
  kernel (``"bluestein"``);
* anything else, and every CPU tensor: its one route.

Timing: CUDA events around bursts of calls after a warm-up, the time of a
call taken as the slope between two burst lengths, so the host's fixed
cost per burst cancels.  Each candidate is first held against the plain
path (relative L2 <= 1e-5 on a few rows, on the CPU) before it is timed.
A candidate is skipped only where its kernel does not take the shape
(:class:`~..ops.cuda_fft.Unsupported`); a build or launch error, or a
wrong result, propagates.

Decisions persist as wisdom (``~/.cache/fft_wgpu_tpu_torch_wisdom.json``),
stamped with torch's and CUDA's versions and the hash of the kernel
sources: a file of another stamp is ignored.
"""

from __future__ import annotations

import json
import math
import os

import torch

__all__ = ["candidates_for", "measure_executor", "TUNE_CACHE", "TIMES",
           "PLANE_CACHE", "OVERLAP_CACHE",
           "load_wisdom", "save_wisdom", "split_candidates",
           "tune_balanced", "tune_ax0_tile", "tune_fused_plane",
           "tune_overlap_chunks", "default_overlap_chunks"]

# (card, n, rows_bucket, axis) -> route
TUNE_CACHE: dict = {}

# what the measurements of this process found: the TUNE_CACHE key ->
# {route: seconds a call}, and ("plane", card, A) -> {"fused": s,
# "two-pass": s} for tune_fused_plane's planes
TIMES: dict = {}

# card -> the fused-plane crossover (max A*B where the fused-plane kernel
# beats the row kernel then the axis(-2) kernel)
PLANE_CACHE: dict = {}

# (card, ndev) -> chunks of a distributed FFT's pipeline
OVERLAP_CACHE: dict = {}

_WISDOM_PATH = os.path.expanduser("~/.cache/fft_wgpu_tpu_torch_wisdom.json")
_wisdom_loaded = False

# relative L2 a candidate must hold against the plain path before timing
_CHECK_TOL = 1e-5
# rows of the check (taken from the timing input, transformed on the CPU)
_CHECK_ROWS = 2


def _bucket(rows: int) -> int:
    """Row-count regime bucket: one measurement serves every row count in
    it."""
    if rows < 16:
        return 8
    if rows < 128:
        return 64
    return 1024


def rows_bucket(shape, n: int) -> int:
    """The rows bucket of a call on ``shape`` with n points a row: 1 for a
    single row, else :func:`_bucket` of the row count."""
    rows = math.prod(shape) // n if n else 0
    return 1 if rows == 1 else _bucket(rows)


def _card(device) -> str:
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


def _toolchain_stamp() -> str:
    """Version stamp for the wisdom file: torch, its CUDA, and the hash of
    every kernel source (a kernel edit changes its timing)."""
    from ..utils import build

    return f"torch={torch.__version__};cuda={torch.version.cuda};src={build.source_stamp()}"


def load_wisdom(path: str | None = None) -> None:
    """Load persisted tuning decisions (FFTW-wisdom analogue).  Called
    lazily by :func:`measure_executor`.  A file stamped with another
    toolchain or other kernel sources, or of another format, is ignored."""
    global _wisdom_loaded
    _wisdom_loaded = True
    try:
        with open(path or _WISDOM_PATH) as f:
            data = json.load(f)
        if data.get("__toolchain__") != _toolchain_stamp():
            return
        for k, v in data.get("entries", {}).items():
            parts = k.split("|")
            if parts[0] == "plane":
                PLANE_CACHE[parts[1]] = int(v)
            elif parts[0] == "overlap":
                OVERLAP_CACHE[(parts[1], int(parts[2]))] = int(v)
            else:
                card, n, rows_b, axis = parts
                TUNE_CACHE[(card, int(n), int(rows_b), int(axis))] = v
    except (OSError, ValueError):
        pass


def save_wisdom(path: str | None = None) -> None:
    path = path or _WISDOM_PATH
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        data = {"|".join(map(str, k)): v for k, v in TUNE_CACHE.items()}
        for card, lim in PLANE_CACHE.items():
            data[f"plane|{card}"] = lim
        for (card, ndev), c in OVERLAP_CACHE.items():
            data[f"overlap|{card}|{ndev}"] = c
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"__toolchain__": _toolchain_stamp(), "entries": data}, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass


def _pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def candidates_for(n: int, rows: int, backend: str) -> list[str]:
    """The routes worth measuring for ``rows`` rows of length ``n`` on
    ``backend`` (``"cuda"`` or ``"cpu"``), among those the port has."""
    from ..ops import bigfft, bluestein, cuda_fft

    if backend != "cuda":
        return ["xla"]
    if _pow2(n):
        if cuda_fft.FUSED_MIN_N <= n <= cuda_fft.FUSED_MAX_N:
            return ["pallas"]
        if n > cuda_fft.FUSED_MAX_N:
            if bigfft._supported(n, rows):
                return ["bigfft", "fourstep:two-pass"]
            return ["fourstep"]
        return ["xla"]
    if cuda_fft._gen_supported(n):
        if (max(cuda_fft._factorize(n)) > 128
                and cuda_fft._chirp_supported(bluestein._pad_length(n), n)):
            return ["general", "bluestein"]
        return ["general"]
    return ["xla"]


def _slope_time(fn, shape, device, bursts=(4, 20), repeats=2) -> float:
    """Seconds a call of ``fn(re, im)`` takes on ``device``: CUDA events
    around bursts of ``lo`` and ``hi`` calls after one warm-up call, the
    slope between them (the host's fixed cost per burst cancels), the
    least of ``repeats`` tries.  The bursts grow until the slope window
    is at least 20 ms."""
    gen = torch.Generator(device=device).manual_seed(0)
    re = torch.randn(shape, generator=gen, device=device)
    im = torch.randn(shape, generator=gen, device=device)
    fn(re, im)  # builds and uploads what the route needs
    torch.cuda.synchronize(device)
    lo, hi = bursts
    for _ in range(4):
        best, window = float("inf"), 0.0
        for _ in range(repeats):
            ms = []
            for k in (lo, hi):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(k):
                    fn(re, im)
                stop.record()
                stop.synchronize()
                ms.append(start.elapsed_time(stop))
            window = max(window, ms[1] - ms[0])
            best = min(best, (ms[1] - ms[0]) / (hi - lo) / 1e3)
        if window >= 20.0 or hi >= 2048:
            break
        lo, hi = lo * 4, hi * 4
    return best


def _check_against_plain(plan, fn, shape, axis: int, device) -> float:
    """Relative L2 of route ``fn`` against the plain path (the plan's
    ``"xla"`` route on the CPU) on ``_CHECK_ROWS`` rows of the shape."""
    from ..core.twiddle import FORWARD

    small = list(shape)
    lead = [i for i in range(len(small)) if i != axis % len(small)]
    for i in lead:
        small[i] = 1
    if lead:
        small[lead[0]] = min(shape[lead[0]], _CHECK_ROWS)
    gen = torch.Generator().manual_seed(1)
    re, im = torch.randn(small, generator=gen), torch.randn(small, generator=gen)
    gr, gi = fn(re.to(device), im.to(device))
    wr, wi = plan._execute_split_axis(re, im, FORWARD, None, axis, ex="xla")
    got = torch.complex(gr.cpu(), gi.cpu()).to(torch.complex128)
    want = torch.complex(wr, wi).to(torch.complex128)
    return float((got - want).abs().norm() / want.abs().norm())


def measure_executor(plan, shape, axis: int, device=None) -> str:
    """The fastest route for ``plan.n`` at this shape on ``device`` (the
    current CUDA device by default), cached per (card, n, rows bucket,
    axis) and kept as wisdom."""
    from ..core.twiddle import FORWARD
    from ..ops.cuda_fft import Unsupported

    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    shape = tuple(int(d) for d in shape)
    rows = math.prod(shape) // plan.n if plan.n else 0
    key = (_card(device), plan.n, rows_bucket(shape, plan.n), axis % len(shape) - len(shape))
    if not _wisdom_loaded:
        load_wisdom()
    hit = TUNE_CACHE.get(key)
    if hit is not None:
        return hit
    cands = candidates_for(plan.n, rows, device.type)
    if len(cands) == 1:
        TUNE_CACHE[key] = cands[0]
        return cands[0]
    best_ex, best_t = None, float("inf")
    TIMES[key] = {}
    for ex in cands:
        def fn(a, b, _ex=ex):
            return plan._execute_split_axis(a, b, FORWARD, None, axis, ex=_ex)

        try:
            err = _check_against_plain(plan, fn, shape, axis, device)
        except Unsupported:
            continue  # the route's kernel does not take this shape
        if not err <= _CHECK_TOL:
            raise RuntimeError(f"route {ex!r} is {err:.3e} from the plain path at "
                               f"n={plan.n}, shape {shape} (bar {_CHECK_TOL})")
        t = TIMES[key][ex] = _slope_time(fn, shape, device)
        if t < best_t:
            best_ex, best_t = ex, t
    if best_ex is None:
        raise RuntimeError(f"no route serves n={plan.n} at shape {shape}")
    TUNE_CACHE[key] = best_ex
    save_wisdom()
    return best_ex


# --------------------------------------------------------------------- #
# the TPU tables' tuners: no counterpart on the card
# --------------------------------------------------------------------- #

def split_candidates(n: int):
    """No counterpart: the row kernel's plan is compiled per n, so there
    is no balanced split to choose.  Raises :class:`RuntimeError`."""
    raise RuntimeError("split_candidates has no counterpart on the card: the row "
                       "kernel's plan is compiled per n (csrc/mixed_fft.cuh)")


def tune_balanced(n: int, rows: int = 1024, **kw):
    """No counterpart (see :func:`split_candidates`).  Raises
    :class:`RuntimeError`, as the JAX function does off the TPU."""
    raise RuntimeError("tune_balanced has no counterpart on the card: the row "
                       "kernel's plan is compiled per n")


def tune_ax0_tile(n: int, lanes: int = 65536, **kw):
    """No counterpart: the axis(-2) kernel's tile and cluster shape are
    compiled per n (``csrc/ax0_fft.cu``), with no run-time choice.
    Raises :class:`RuntimeError`."""
    raise RuntimeError("tune_ax0_tile has no counterpart on the card: the axis(-2) "
                       "kernel's tiles are compiled per n")


def tune_fused_plane(*, rows: int = 64, persist: bool = True, device=None) -> int:
    """Measure the fused-plane crossover on the card: the largest square
    plane A^2 at which the fused-plane kernel (one launch a plane) beats
    the row kernel then the axis(-2) kernel, set as
    ``cuda_fft.FFT2F_MAX_ELEMS`` (never past the fused kernel's own
    envelope, 2^16 points).  ``rows`` planes of 256^2 set the work, kept
    about constant across A.  Raises :class:`RuntimeError` off the card."""
    from ..core.twiddle import FORWARD
    from ..ops import cuda_fft

    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        raise RuntimeError("tune_fused_plane measures the fused-plane kernel on the card")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    card = _card(device)
    if not _wisdom_loaded:
        load_wisdom()
    hit = PLANE_CACHE.get(card)
    if hit is not None:
        cuda_fft.FFT2F_MAX_ELEMS = hit
        return hit

    def fused(x, y):
        return cuda_fft.fft2_fused_split(x, y, FORWARD)

    def two_pass(x, y):
        return cuda_fft.fft_axis0_split(*cuda_fft.fft_batched_split(x, y, FORWARD), FORWARD)

    envelope = 1 << 16
    saved, cuda_fft.FFT2F_MAX_ELEMS = cuda_fft.FFT2F_MAX_ELEMS, envelope
    limit = 128 * 128  # the smallest plane the fused kernel takes
    try:
        for a in (128, 256):
            planes = max(rows * (256 // a) ** 2, 2)
            gen = torch.Generator(device=device).manual_seed(0)
            x, y = (torch.randn(2, a, a, generator=gen, device=device) for _ in range(2))
            got = torch.complex(*fused(x, y)).cpu().to(torch.complex128)
            want = torch.complex(*two_pass(x, y)).cpu().to(torch.complex128)
            err = float((got - want).abs().norm() / want.abs().norm())
            if not err <= _CHECK_TOL:
                raise RuntimeError(f"fused plane {a}^2 is {err:.3e} from the two passes")
            t_fused = _slope_time(fused, (planes, a, a), device)
            t_two = _slope_time(two_pass, (planes, a, a), device)
            TIMES[("plane", card, a)] = {"fused": t_fused, "two-pass": t_two}
            if t_fused < t_two:
                limit = a * a
            else:
                break
    finally:
        cuda_fft.FFT2F_MAX_ELEMS = saved
    cuda_fft.FFT2F_MAX_ELEMS = min(limit, envelope)
    PLANE_CACHE[card] = cuda_fft.FFT2F_MAX_ELEMS
    if persist:
        save_wisdom()
    return cuda_fft.FFT2F_MAX_ELEMS


def default_overlap_chunks(mesh) -> int:
    """Pipeline chunk count for a distributed FFT on ``mesh`` (``None`` or
    a ``torch.distributed.DeviceMesh``): 1 on one device, else the wisdom
    entry for (card, mesh size), else 4."""
    if mesh is None or mesh.size() <= 1:
        return 1
    if not _wisdom_loaded:
        load_wisdom()
    card = _card(torch.device(mesh.device_type, 0))
    return OVERLAP_CACHE.get((card, int(mesh.size())), 4)


def tune_overlap_chunks(mesh, shape=(256, 256, 256), candidates=(1, 2, 4, 8), repeats=3, *,
                        persist: bool = True) -> int:
    """Time ``parallel.pencil.fft3d`` of a complex64 ``shape`` on THIS mesh
    (a 2-D ``DeviceMesh``; every rank calls it) at each pipeline depth in
    ``candidates``, pin the fastest for (card, mesh size) in
    :data:`OVERLAP_CACHE`, where :func:`default_overlap_chunks` serves it,
    and keep it as wisdom (``persist``).

    Each candidate: one warm-up call, then ``repeats`` calls, each after a
    barrier, timed by CUDA events on a card (the host clock on the CPU);
    its time is the slowest rank's best (an all-reduce of the maxima), so
    every rank pins the same depth.  On a mesh of one rank every depth is
    the same schedule."""
    import time

    import torch.distributed as dist

    from ..parallel import pencil

    card = _card(torch.device(mesh.device_type, 0))
    key = (card, int(mesh.size()))
    if not _wisdom_loaded:
        load_wisdom()
    on_card = mesh.device_type == "cuda"
    device = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    local = [s // mesh.size(d) if d < 2 else s for d, s in enumerate(shape)]
    x = pencil._wrap(torch.zeros(local, dtype=torch.complex64, device=device), mesh, (0, 1),
                     tuple(shape))
    times = []
    for c in candidates:
        pencil.fft3d(x, mesh, overlap_chunks=c)  # builds what the schedule needs
        best = float("inf")
        for _ in range(repeats):
            dist.barrier()
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                pencil.fft3d(x, mesh, overlap_chunks=c)
                stop.record()
                stop.synchronize()
                t = start.elapsed_time(stop) / 1e3
            else:
                t0 = time.perf_counter()
                pencil.fft3d(x, mesh, overlap_chunks=c)
                t = time.perf_counter() - t0
            best = min(best, t)
        times.append(best)
    wire = device if dist.get_backend() == "nccl" else torch.device("cpu")
    slowest = torch.tensor(times, dtype=torch.float64, device=wire)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    slowest = slowest.tolist()
    best_c = candidates[slowest.index(min(slowest))]
    TIMES[("overlap",) + key] = dict(zip(candidates, slowest))
    OVERLAP_CACHE[key] = best_c
    if persist:
        save_wisdom()
    return best_c
