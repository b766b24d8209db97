"""Torch port, ``utils/jit_cache``: the cache of CUDA-graph-captured calls
behind the scipy-parity convenience functions, on the CPU.

The tests of ``tests/test_jit_cache.py`` carried over: one key builds once
across fresh closures, distinct keys build apart, a None or unhashable key
never caches, grad-recording arguments (the counterpart of the JAX
package's tracers) and nested cached calls run inline, LRU eviction in
place of the JAX package's clear-all past 256 entries, and ``window_key``
and ``shape_key`` against the JAX functions on the same specs.

The bookkeeping runs on the CPU through the cache's capture step
(``jit_cache._capture``), replaced here by a recorder that applies to CPU
tensors and whose "graph" replays the captured ``impl`` on the static
inputs, writing into the static outputs as a graph's replay does.  Each of
the JAX package's 20 ``cached_call`` sites is then called three times with
one key (eager, capture, replay on other inputs) and held against its JAX
counterpart at 1e-5 relative L2.  The CUDA graphs themselves are held in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s path 12.
"""

import numpy as np
import pytest
import torch

import fft_wgpu_tpu as fj
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu.utils import jit_cache as jj
from fft_wgpu_tpu_torch.ops import cuda_fft
from fft_wgpu_tpu_torch.utils import jit_cache as jc

torch.set_num_threads(1)


class _Replay:
    """A recorded capture: replay runs ``impl`` on the static inputs and
    writes its outputs into the static outputs.  A graph's replay runs no
    Python, so the launch counters that ``impl`` moves are put back."""

    def __init__(self, impl, static_in, out):
        self.impl, self.static_in, self.out = impl, static_in, out

    def replay(self):
        counts = jc._counts()
        new = self.impl(*self.static_in)
        for (mod, name), v in counts.items():
            setattr(mod, name, v)
        pairs = ([(self.out, new)] if isinstance(self.out, torch.Tensor)
                 else list(zip(self.out, new)))
        with torch.inference_mode():  # as a graph writes its outputs: in any mode
            for s, v in pairs:
                s.copy_(v)


class Recorder:
    """The capture step for CPU tensors, recording each capture; a graph's
    pool holds its outputs' bytes, of a memory of ``memory`` bytes."""

    device_type = "cpu"

    def __init__(self, memory=1 << 40):
        self.captures = []
        self._memory = memory

    def capturing(self, device):
        return False

    def place(self, device):
        return device.type, device.index

    def memory(self, device):
        return self._memory

    def capture(self, impl, static_in, place):
        self.captures.append(place)
        out = impl(*static_in)
        outs = (out,) if isinstance(out, torch.Tensor) else out
        nbytes = sum(o.numel() * o.element_size() for o in outs if isinstance(o, torch.Tensor))
        return out, _Replay(impl, static_in, out), nbytes


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(jc, "_capture", rec)
    jc.clear()
    yield rec
    jc.clear()


def _fresh_impl(traces, delta=1.0):
    """A new closure per call, as every call site builds one."""
    def impl(x):
        traces.append(1)
        return x + delta
    return impl


def test_same_key_captures_once_across_fresh_closures(recorder):
    x = torch.zeros(4)
    traces = [[] for _ in range(4)]
    outs = [jc.cached_call(("k1",), _fresh_impl(t), x) for t in traces]
    # the first closure ran eagerly, the second was captured (and the
    # recorder's replays run it again), the later ones never ran: their
    # calls replayed the second's capture
    assert len(traces[0]) == 1 and not traces[2] and not traces[3]
    assert len(recorder.captures) == 1 and len(jc._CACHE) == 1
    for out in outs:
        torch.testing.assert_close(out, torch.ones(4), rtol=0, atol=0)


def test_distinct_keys_capture_separately(recorder):
    x = torch.zeros(4)
    for key in (("k1",), ("k2",)):
        for _ in range(2):
            jc.cached_call(key, _fresh_impl([]), x)
    assert len(recorder.captures) == 2
    assert len(jc._CACHE) == 2
    # the arguments' shapes are part of the key too
    jc.cached_call(("k1",), _fresh_impl([]), torch.zeros(5))
    assert len(jc._CACHE) == 3


def test_none_key_never_caches(recorder):
    traces = []
    x = torch.zeros(4)
    for _ in range(3):
        jc.cached_call(None, _fresh_impl(traces), x)
    assert len(traces) == 3
    assert not jc._CACHE and not recorder.captures


def test_unhashable_key_runs_uncached(recorder):
    # entry points may embed e.g. `weights` that is a numpy array: the
    # cache must run impl, neither crash nor mis-hit
    traces = []
    x = torch.zeros(4)
    key = ("mt", np.arange(3))
    jc.cached_call(key, _fresh_impl(traces), x)
    jc.cached_call(key, _fresh_impl(traces), x)
    out = jc.cached_call(key, _fresh_impl(traces, delta=2.0), x)
    assert len(traces) == 3
    assert not jc._CACHE and not recorder.captures
    # the third closure's own semantics were used (no stale-key hit)
    torch.testing.assert_close(out, 2 * torch.ones(4), rtol=0, atol=0)


def test_grad_args_and_nested_calls_run_inline(recorder):
    # grad-recording arguments stay eager, so gradients are autograd's
    x = torch.ones(4, requires_grad=True)
    for _ in range(3):
        y = jc.cached_call(("g",), lambda v: v * 3.0, x)
    y.sum().backward()
    torch.testing.assert_close(x.grad, 3 * torch.ones(4), rtol=0, atol=0)
    assert not jc._CACHE and not recorder.captures
    # under no_grad the same argument is cached
    with torch.no_grad():
        for _ in range(2):
            jc.cached_call(("g",), lambda v: v * 3.0, x)
    assert len(recorder.captures) == 1

    # a cached call inside another's impl runs inline (the JAX package
    # inlines inside an active trace): only the outer key is cached
    def outer(v):
        return jc.cached_call(("inner",), lambda u: u * 2.0, v) + 1.0

    for _ in range(3):
        out = jc.cached_call(("outer",), outer, torch.ones(4))
    torch.testing.assert_close(out, 3 * torch.ones(4), rtol=0, atol=0)
    keys = {k[0] for k in jc._CACHE}
    assert ("outer",) in keys and ("inner",) not in keys
    # and a later call of the inner key on its own caches normally
    jc.cached_call(("inner",), lambda u: u * 2.0, torch.ones(4))
    assert ("inner",) in {k[0] for k in jc._CACHE}


def test_lru_evicts_the_least_recently_used(recorder):
    x = torch.zeros(2)
    for i in range(jc.MAX_ENTRIES):
        jc.cached_call(("g", i), lambda v: v, x)
    assert len(jc._CACHE) == jc.MAX_ENTRIES
    jc.cached_call(("g", 0), lambda v: v, x)  # used again: now the newest
    jc.cached_call(("overflow",), lambda v: v, x)
    keys = [k[0] for k in jc._CACHE]
    assert len(keys) == jc.MAX_ENTRIES
    assert ("g", 1) not in keys  # the least recently used went
    assert ("g", 0) in keys and ("g", 2) in keys and keys[-1] == ("overflow",)
    assert ("g", 0) == keys[-2]


def test_graphs_are_evicted_past_the_byte_bound(recorder, monkeypatch):
    # each graph of [1024] float32 holds 8 KiB (its static input and output);
    # four fit in 32 KiB: the fifth capture evicts the least recently used
    # graph, a key used in between survives, keys seen once hold nothing
    monkeypatch.setattr(jc, "MAX_BYTES", 32 << 10)
    x = torch.zeros(1024)
    for i in range(4):
        for _ in range(2):
            jc.cached_call(("b", i), lambda v: v + 1.0, x)
    jc.cached_call(("once",), lambda v: v, x)
    assert jc._BYTES["cpu"] == 32 << 10 and len(jc._CACHE) == 5
    jc.cached_call(("b", 0), lambda v: v + 1.0, x)  # used again: now the newest
    for _ in range(2):
        jc.cached_call(("b", 4), lambda v: v + 1.0, x)
    keys = [k[0] for k in jc._CACHE]
    assert ("b", 1) not in keys and ("b", 0) in keys and ("once",) in keys
    assert keys[-1] == ("b", 4) and jc._BYTES["cpu"] == 32 << 10
    # a graph larger than the bound alone is kept, and evicts every other
    big = torch.zeros(1 << 14)
    for _ in range(2):
        jc.cached_call(("big",), lambda v: v * 2.0, big)
    graphs = [k[0] for k, e in jc._CACHE.items() if e is not None]
    assert graphs == [("big",)] and jc._BYTES["cpu"] == 128 << 10
    jc.clear()
    assert not jc._BYTES["cpu"]
    # the default bound is an eighth of the device's memory
    monkeypatch.setattr(jc, "MAX_BYTES", None)
    monkeypatch.setattr(jc, "_capture", Recorder(memory=64 << 10))
    for i in range(3):
        for _ in range(2):
            jc.cached_call(("d", i), lambda v: v + 1.0, x)
    assert [k[0] for k in jc._CACHE] == [("d", 2)] and jc._BYTES["cpu"] == 8 << 10


def test_window_key_matches_jax():
    specs = [None, "hann", ("kaiser", 8.6), ("tukey", 0.25), np.hanning(16),
             ("kaiser", np.float32(8.6), object()), len]
    for spec in specs:
        assert jc.window_key(spec) == jj.window_key(spec)
    assert jc.window_key(torch.ones(16)) is None


def test_shape_key_matches_jax():
    import jax.numpy as jnp

    assert jc.shape_key(None) is None
    for shape, dtype in (((3, 5), np.float32), ((7,), np.complex64), ((2, 3, 4), np.int32)):
        want = jj.shape_key(jnp.zeros(shape, dtype))
        assert jc.shape_key(torch.zeros(shape, dtype=getattr(torch, np.dtype(dtype).name))) \
            == want
    for dtype in (np.float32, np.float64, np.complex128):  # numpy arrays as they are
        assert jc.shape_key(np.zeros((3, 5), dtype)) == jj.shape_key(np.zeros((3, 5), dtype))


def test_cpu_tensors_run_inline_by_default(monkeypatch):
    # the capture step as shipped applies to CUDA tensors only
    monkeypatch.setattr(jc, "_capture", jc.CudaGraphs())
    traces = []
    for _ in range(3):
        jc.cached_call(("k",), _fresh_impl(traces), torch.zeros(4))
    assert len(traces) == 3 and not jc._CACHE


def test_replays_return_fresh_tensors_and_count_launches(recorder, monkeypatch):
    monkeypatch.setattr(cuda_fft, "launches", 0)

    def impl(v):
        cuda_fft.launches += 2  # as a wrapper counts the kernels it launches
        return v * 2.0, v + 1.0

    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    first = jc.cached_call(("two",), impl, a)
    assert cuda_fft.launches == 2
    second = jc.cached_call(("two",), impl, a)  # capture, then replay
    assert cuda_fft.launches == 4  # the capture itself launches nothing
    held = [t.clone() for t in second]
    third = jc.cached_call(("two",), impl, b)  # replay on other input
    assert cuda_fft.launches == 6
    for got, want in zip(second, held):  # a held result is never overwritten
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for got, want in zip(first, second):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(third[0], b * 2.0, rtol=0, atol=0)
    entry = next(iter(jc._CACHE.values()))
    assert all(t.data_ptr() != s.data_ptr() for t in third for s in entry.static_out)


def test_capture_errors_propagate(recorder):
    calls = []

    def impl(v):
        calls.append(1)
        if len(calls) == 2:  # the capture
            raise RuntimeError("operation not permitted when stream is capturing")
        return v

    x = torch.zeros(3)
    jc.cached_call(("bad",), impl, x)
    with pytest.raises(RuntimeError, match="capturing"):
        jc.cached_call(("bad",), impl, x)
    assert next(iter(jc._CACHE.values())) is None  # nothing captured
    with pytest.raises(TypeError, match="tensor"):
        for _ in range(2):
            jc.cached_call(("not tensors",), lambda v: (v, 3), x)


# ---------------------------------------------------------------------- #
# the 20 cached_call sites against the JAX package
# ---------------------------------------------------------------------- #
def _np(out):
    if isinstance(out, torch.Tensor):
        return [out.numpy()]
    return [np.asarray(o.numpy() if isinstance(o, torch.Tensor) else o) for o in out]


def _jnp(out):
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


SEG = {"nperseg": 512, "noverlap": 256}
# (site, JAX call, port call, the inputs' shapes and kinds): "r" real, "c" complex
SITES = [
    ("rfft", lambda m, v: m.rfft(v), [("r", (8, 256))]),
    ("irfft", lambda m, v: m.irfft(v), [("c", (8, 129))]),
    ("nd fft2", lambda m, v: m.fft2(v), [("c", (64, 128))]),
    ("nd ifftn s", lambda m, v: m.ifftn(v, s=(32, 100)), [("c", (64, 128))]),
    ("stft", lambda m, v: m.stft(v, 256, 64), [("r", (4096,))]),
    ("istft", lambda m, v: m.istft(v, 256, 64), [("c", (129, 65))]),
    ("csd_impl welch", lambda m, v: m.welch(v, **SEG), [("r", (8192,))]),
    ("csd_impl csd", lambda m, v, u: m.csd(v, u, **SEG), [("r", (8192,)), ("r", (8192,))]),
    ("csd_impl two-sided", lambda m, v: m.welch(v, **SEG), [("c", (8192,))]),
    ("csd_impl median", lambda m, v: m.welch(v, average="median", **SEG), [("r", (8192,))]),
    ("coherence", lambda m, v, u: m.coherence(v, u, **SEG), [("r", (8192,)), ("r", (8192,))]),
    ("multitaper", lambda m, v: m.multitaper(v, NW=4.0, K=7), [("r", (1024,))]),
    ("spectrogram", lambda m, v: m.spectrogram(v, nperseg=512), [("r", (8192,))]),
    ("spectrogram complex", lambda m, v: m.spectrogram(v, mode="complex", **SEG),
     [("r", (8192,))]),
    ("oaconvolve", lambda m, v, u: m.oaconvolve(v, u), [("r", (4096,)), ("r", (33,))]),
    ("oaconvolve complex", lambda m, v, u: m.oaconvolve(v, u), [("c", (4096,)), ("c", (33,))]),
    ("fftconvolve", lambda m, v, u: m.fftconvolve(v, u, axes=-1),
     [("r", (8, 256)), ("r", (8, 256))]),
    ("fftconvolve complex", lambda m, v, u: m.fftconvolve(v, u, axes=-1),
     [("c", (8, 256)), ("c", (8, 256))]),
    ("hilbert", lambda m, v: m.hilbert(v), [("r", (8, 256))]),
    ("dct1", lambda m, v: m.dct(v, type=1), [("r", (8, 129))]),
    ("dct4", lambda m, v: m.dct(v, type=4), [("r", (8, 256))]),
    ("dct2", lambda m, v: m.dct(v, type=2), [("r", (8, 256))]),
    ("idct2_core", lambda m, v: m.idct(v, type=2), [("r", (8, 256))]),
    ("dst1", lambda m, v: m.dst(v, type=1), [("r", (8, 255))]),
    ("apply_nd dctn", lambda m, v: m.dctn(v, type=2), [("r", (32, 64))]),
]


def _inputs(rng, specs):
    out = []
    for kind, shape in specs:
        v = rng.standard_normal(shape)
        if kind == "c":
            v = v + 1j * rng.standard_normal(shape)
        out.append(v.astype(np.complex64 if kind == "c" else np.float32))
    return out


@pytest.mark.parametrize("site", SITES, ids=[s[0] for s in SITES])
def test_site_captures_and_matches_jax(site, rng, recorder, assert_close):
    name, call, specs = site
    inputs, others = _inputs(rng, specs), _inputs(rng, specs)
    for i, arrays in enumerate((inputs, inputs, others)):
        want = _jnp(call(fj, *arrays))
        got = _np(call(ft, *(torch.from_numpy(a) for a in arrays)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape, (name, i, g.shape, w.shape)
            assert_close(g, w, what=f"{name} call {i + 1} vs JAX")
    # the second call captured each key the site's call uses (one; two for
    # coherence on the CPU, where Pxx and Pyy share a key beside Pxy's), the
    # third replayed them
    assert jc._CACHE and all(isinstance(e, jc._Graph) for e in jc._CACHE.values()), name
    assert len(recorder.captures) == len(jc._CACHE) == (2 if name == "coherence" else 1)


# the sites' routes of one launch (an axis) and no other device work, which
# run eagerly with a key of None, each with the predicate that picks it
# forced on: (site, module, predicate, JAX call and port call, inputs); on
# the CPU the kernels' wrappers run their plain versions
ONE_LAUNCH = [
    ("rfft complex64 sink", "rfft", "_rfft_c64", lambda m, v: m.rfft(v), [("r", (8, 256))]),
    ("irfft complex64 source", "rfft", "_irfft_c64", lambda m, v: m.irfft(v),
     [("c", (8, 129))]),
    ("nd complex64 route", "nd", "_c64_ok", lambda m, v: m.fft2(v), [("c", (128, 256))]),
    ("stft B20", "stft", "_on_card", lambda m, v: m.stft(v, 256, 64), [("r", (4096,))]),
    ("hilbert r2c and filtered rows", "helpers", "_on_card", lambda m, v: m.hilbert(v),
     [("r", (8, 256))]),
    ("spectrogram complex B20", "spectral_est", "_on_card",
     lambda m, v: m.spectrogram(v, mode="complex", **SEG), [("r", (8192,))]),
    ("spectrogram complex B22", "spectral_est", "_on_card",
     lambda m, v: m.spectrogram(v, mode="complex", **SEG), [("c", (8192,))]),
]


@pytest.mark.parametrize("case", ONE_LAUNCH, ids=[c[0] for c in ONE_LAUNCH])
def test_one_launch_routes_run_uncached(case, rng, recorder, monkeypatch, assert_close):
    import importlib

    name, module, predicate, call, specs = case
    monkeypatch.setattr(importlib.import_module(f"fft_wgpu_tpu_torch.ops.{module}"), predicate,
                        lambda *a: True)
    inputs = _inputs(rng, specs)
    want = _jnp(call(fj, *inputs))
    for i in range(3):
        got = _np(call(ft, *(torch.from_numpy(a) for a in inputs)))
        for g, w in zip(got, want):
            assert g.shape == w.shape, (name, i, g.shape, w.shape)
            assert_close(g, w, what=f"{name} call {i + 1} vs JAX")
    assert not jc._CACHE and not recorder.captures, name


def test_inference_mode_calls_share_the_capture(recorder):
    # the static inputs are ordinary tensors: a capture made under
    # inference_mode serves calls outside it, and the other way round
    with torch.inference_mode():
        for _ in range(2):
            jc.cached_call(("inf",), lambda v: v * 2.0, torch.ones(3))
    out = jc.cached_call(("inf",), lambda v: v * 2.0, torch.full((3,), 4.0))
    torch.testing.assert_close(out, torch.full((3,), 8.0), rtol=0, atol=0)
    with torch.inference_mode():
        out = jc.cached_call(("inf",), lambda v: v * 2.0, torch.ones(3))
    torch.testing.assert_close(out, torch.full((3,), 2.0), rtol=0, atol=0)
    assert len(recorder.captures) == 1
