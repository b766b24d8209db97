"""Config-keyed cache of CUDA-graph-captured calls for the convenience API
(torch port of ``fft_wgpu_tpu.utils.jit_cache``).

The scipy-parity functions (welch, stft, fftconvolve, dct, ...) run a chain
of tens of launches a call, and at their users' sizes the host's work
between those launches leaves the card idle most of the time.  The JAX
package traces each such call once into an executable memoised on a
hashable config key; here the counterpart is a CUDA graph:
``cached_call(key, impl, *args)`` on CUDA tensors

- runs ``impl`` eagerly the first time a key is seen (which builds and
  loads the kernels' libraries and the device tables ``impl`` reads);
- captures ``impl`` into a ``torch.cuda.CUDAGraph`` over static copies of
  the arguments the second time, then replays it;
- from then on copies the arguments into the static inputs, replays the
  graph and returns fresh clones of its static outputs, so that a result
  the caller holds is never overwritten by a later replay.

The key is the call site's config plus the arguments' shapes and dtypes,
the device and the current stream (a graph's static tensors and
intermediates serve one stream's serial replays).  The cache pays off for
repeated calls of one shape: a key seen once costs one eager call, a key
seen twice an eager call and a capture (which synchronizes the device),
and only later calls replay.  Each graph has a memory pool of its own, so
that evicting it hands its memory back to the allocator (to other work at
once; to the device at ``torch.cuda.empty_cache``).  Up to 256 keys are
kept, and on each device graphs holding up to :data:`MAX_BYTES` (their
static inputs and their pools); past either bound the least recently used
is evicted first, dropping its graph and static tensors.  A graph larger
than the byte bound on its own is kept until the next capture there.

The call sites pass a key of None, and so run eagerly, for a route of one
kernel launch an axis and no other device work (the complex64 ``fft2`` /
``fftn``, ``rfft`` and ``irfft`` of pow2 lengths, ``stft``'s B20,
``hilbert``'s two kernels, the complex spectrogram): a replay copies its
inputs in and clones its outputs out, which costs such a call more device
time than the host work the graph saves.

``impl`` runs inline, uncached, when the key is None or unhashable, when an
argument is neither a CUDA tensor nor None (a CPU tensor computes on the
CPU), when grad mode is on and an argument requires grad (autograd stays
eager), when the current stream is already capturing, and inside another
cached call's ``impl`` (where the JAX package inlines inside an active
trace).  ``impl`` takes tensors (or None) and returns a tensor or a tuple
of tensors; it must not read the host (``.item()``, ``.cpu()``, data-
dependent shapes) or copy from host memory: such work belongs before the
call or in a per-shape, per-device table cache.  A capture or replay error
propagates: no eager path is taken instead.

Each captured call records how much the port's launch counters
(``ops.cuda_fft``, ``ops.cuda_welch``, ``ops.bigfft``) rose while it was
captured, and adds that on every replay, so the counters keep counting
the kernels that really ran.
"""

from __future__ import annotations

import collections
import threading

import torch

__all__ = ["cached_call", "cached_jit", "window_key", "shape_key", "clear"]

MAX_ENTRIES = 256  # the JAX package's bound (its cache clears past it)
# the bytes a device's graphs may hold; None: an eighth of the device's memory
MAX_BYTES = None

# key -> None (seen once, ran eagerly) or _Graph (captured); least recently
# used first
_CACHE: collections.OrderedDict = collections.OrderedDict()
_LOCK = threading.Lock()
_LOCAL = threading.local()  # .depth: cached calls running impl on this thread
_BYTES: collections.Counter = collections.Counter()  # device -> bytes its graphs hold


class CudaGraphs:
    """The capture step of the cache: on which device type it applies,
    whether the device's current stream is capturing already, where a
    graph replays (``(device index, current stream)``; the device first),
    the memory of a device and the capture itself.  The CPU tests put a
    recorder in its place (``_capture``) to run the bookkeeping."""

    device_type = "cuda"

    def __init__(self):
        self._streams: dict = {}  # device index -> capture stream

    def capturing(self, device) -> bool:
        with torch.cuda.device(device):
            return torch.cuda.is_current_stream_capturing()

    def place(self, device):
        return device.index, torch.cuda.current_stream(device).cuda_stream

    def memory(self, index) -> int:
        return torch.cuda.get_device_properties(index).total_memory

    def capture(self, impl, static_in, place):
        """Capture ``impl(*static_in)`` into a CUDA graph with a memory pool
        of its own; return its static outputs, the graph (whose ``replay``
        launches it on the current stream) and the bytes its pool holds."""
        index = place[0]
        stream = self._streams.get(index)
        if stream is None:
            stream = self._streams[index] = torch.cuda.Stream(index)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(index), torch.cuda.graph(graph, stream=stream):
            # the graph's pool is new: what the device reserves from here
            # on is its (entering the capture emptied the allocator's cache)
            start = torch.cuda.memory_reserved(index)
            out = impl(*static_in)
        return out, graph, max(0, torch.cuda.memory_reserved(index) - start)


_capture = CudaGraphs()


class _Graph:
    """One captured call: the impl it was captured from (whose closure
    keeps alive what the graph reads), its static inputs and outputs, the
    graph, the launch counts of one replay, its device and the bytes it
    holds there."""

    __slots__ = ("impl", "static_in", "static_out", "single", "graph", "launches", "device",
                 "nbytes")

    def __init__(self, impl, args, place):
        self.impl = impl
        with torch.inference_mode(False):  # later calls copy into them in any mode
            self.static_in = tuple(None if a is None else a.clone() for a in args)
        before = _counts()
        try:
            out, self.graph, pool = _capture.capture(impl, self.static_in, place)
        finally:
            after = _counts()
            for (mod, name), v in before.items():  # a capture launches nothing
                setattr(mod, name, v)
        self.single = isinstance(out, torch.Tensor)
        self.static_out = (out,) if self.single else tuple(out)
        if not all(isinstance(o, torch.Tensor) for o in self.static_out):
            raise TypeError("a cached call's impl must return a tensor or a tuple of tensors, "
                            f"not {type(out).__name__}")
        self.launches = {k: after[k] - v for k, v in before.items() if after[k] != v}
        self.device = place[0]
        self.nbytes = pool + sum(a.numel() * a.element_size() for a in self.static_in
                                 if a is not None)

    def __call__(self, args):
        for s, a in zip(self.static_in, args):
            if s is not None:
                s.copy_(a)
        self.graph.replay()
        for (mod, name), n in self.launches.items():
            setattr(mod, name, getattr(mod, name) + n)
        outs = tuple(o.clone() for o in self.static_out)
        return outs[0] if self.single else outs


def _counts() -> dict:
    """The port's launch counters, (module, name) -> value."""
    from ..ops import bigfft, cuda_fft, cuda_welch

    return {(mod, name): getattr(mod, name) for mod in (cuda_fft, cuda_welch, bigfft)
            for name in vars(mod) if name == "launches" or name.endswith("_launches")}


def _inline(args) -> bool:
    """Whether ``impl`` runs uncached for ``args`` (see the module's
    docstring)."""
    if getattr(_LOCAL, "depth", 0):
        return True
    devices = set()
    for a in args:
        if a is None:
            continue
        if not isinstance(a, torch.Tensor) or a.device.type != _capture.device_type:
            return True
        if a.requires_grad and torch.is_grad_enabled():
            return True
        devices.add(a.device)
    return len(devices) != 1 or _capture.capturing(next(iter(devices)))


def _run(impl, args):
    """``impl(*args)`` with nested cached calls inlined."""
    _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
    try:
        return impl(*args)
    finally:
        _LOCAL.depth -= 1


def cached_call(key, impl, *args):
    """``impl(*args)``: eagerly the first time ``key`` is seen on the
    arguments' device and stream, then replayed from a CUDA graph captured
    at the second call (see the module's docstring for when it runs
    inline instead)."""
    try:
        hash(key)
    except TypeError:
        key = None
    if key is None or _inline(args):
        return impl(*args)
    device = next(a.device for a in args if a is not None)
    place = _capture.place(device)
    full = (key, place, tuple(shape_key(a) for a in args))
    with _LOCK:
        if full in _CACHE:
            _CACHE.move_to_end(full)
            entry = _CACHE[full]
            if entry is None:  # the second call: capture
                entry = _CACHE[full] = _Graph(lambda *a: _run(impl, a), args, place)
                _BYTES[entry.device] += entry.nbytes
                _evict_bytes(entry)
            return entry(args)
    out = _run(impl, args)  # the first call: eager
    with _LOCK:
        if full not in _CACHE:
            _CACHE[full] = None
            while len(_CACHE) > MAX_ENTRIES:
                _drop(next(iter(_CACHE)))
    return out


def _drop(key) -> None:
    """Evict ``key``: its graph, static tensors and pool go."""
    entry = _CACHE.pop(key)
    if entry is not None:
        _BYTES[entry.device] -= entry.nbytes


def _evict_bytes(newest) -> None:
    """Evict the least recently used graphs of ``newest``'s device, never
    ``newest`` itself, until the device's graphs hold at most its bound."""
    budget = MAX_BYTES if MAX_BYTES is not None else _capture.memory(newest.device) // 8
    while _BYTES[newest.device] > budget:
        victim = next((k for k, e in _CACHE.items()
                       if e is not None and e is not newest and e.device == newest.device),
                      None)
        if victim is None:
            return
        _drop(victim)


def cached_jit(key, impl):
    """``impl`` as a function that goes through :func:`cached_call` with
    ``key`` (None or an unhashable key: no cache)."""
    return lambda *args: cached_call(key, impl, *args)


def clear() -> None:
    """Drop every cached call, its graph, static tensors and memory pool
    (``torch.cuda.empty_cache`` then returns their memory)."""
    with _LOCK:
        _CACHE.clear()
        _BYTES.clear()


def window_key(window):
    """Hashable identity of a window spec, or None (array/callable)."""
    if window is None or isinstance(window, str):
        return window
    if isinstance(window, tuple) and all(isinstance(v, (str, int, float)) for v in window):
        return window
    return None


def shape_key(a):
    """(shape, dtype name) of a tensor or array, as the JAX package's
    ``shape_key`` names it (``"float32"``, not ``"torch.float32"``)."""
    if a is None:
        return None
    return tuple(a.shape), str(a.dtype).removeprefix("torch.")
