"""Torch port, the serving surface (``plan/autotune.py``, ``plan/aot.py``,
``utils/{precision,io,roofline,profiling,debug}.py``, ``__main__.py``)
against the JAX package on the CPU.

The same seeded numpy inputs go through the JAX function and the port's;
tolerance 1e-5 relative L2 (the ``assert_close`` fixture).  The measured
route choice needs the card: here its timer and plain-path check are
monkeypatched, as ``tests/test_autotune.py`` does in the JAX package; the
``cuda`` tier and ``chip_smoke.py``'s path 11 measure for real.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu.plan import aot as j_aot
from fft_wgpu_tpu_torch.ops import cuda_fft, stockham
from fft_wgpu_tpu_torch.plan import aot, autotune
from fft_wgpu_tpu_torch.utils import build, debug, io, precision, profiling, roofline

torch.set_num_threads(1)

CPU = torch.device("cpu")
CUDA = torch.device("cuda", 0)


def _split(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _c(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


# ---------------------------------------------------------------------- #
# the public names
# ---------------------------------------------------------------------- #
def test_all_equals_the_jax_packages_less_interop():
    assert sorted(ft.__all__) == sorted(set(ftt.__all__) - {"from_torch", "to_torch"})
    assert len(set(ft.__all__)) == len(ft.__all__)
    for name in ft.__all__:
        assert hasattr(ft, name), name


# ---------------------------------------------------------------------- #
# AOT artifacts against the JAX package's (tests/test_aot.py's cases)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n,batch,axis", [(128, (8,), -1), (1000, (3,), -1), (16, (), 0)])
def test_aot_plan_matches_jax(n, batch, axis, rng, assert_close):
    art = ft.export_plan(ft.plan(n), batch_shape=batch, axis=axis, device="cpu")
    assert isinstance(art, bytes)
    sp = ft.load_plan(art)
    jsp = j_aot.load_plan(j_aot.export_plan(ftt.plan(n), batch_shape=batch, axis=axis))
    assert sp.n == jsp.n == n and sp.shape == jsp.shape == tuple(batch) + (n,)
    re, im = _split(rng, tuple(batch) + (n,))
    for op in ("forward_split", "inverse_split", "inverse_unnormalized_split"):
        got = getattr(sp, op)(_t(re), _t(im))
        assert got[0].dtype == torch.float32 and tuple(got[0].shape) == sp.shape
        assert_close(_c(got), _c(getattr(jsp, op)(re, im)), what=op)


def test_aot_file_meta_and_validation(rng, tmp_path, assert_close):
    p = ft.plan(64)
    path = tmp_path / "p64.ftta"
    assert ft.export_plan(p, str(path), batch_shape=(4,), device="cpu") == str(path)
    sp = ft.load_plan(str(path))
    meta = sp._meta
    assert meta["format"] == "fft_wgpu_tpu_torch-aot-v1"
    assert meta["shape"] == [4, 64] and meta["axis"] == -1 and meta["device"] == "cpu"
    assert meta["libraries"] == {} and meta["capability"] is None
    assert {r["route"] for r in meta["routes"].values()} == {"xla"}
    assert meta["torch_version"] == torch.__version__
    re, im = _split(rng, (4, 64))
    assert_close(_c(sp.forward_split(_t(re), _t(im))), np.fft.fft(re + 1j * im))
    one = ft.load_plan(ft.export_plan(p, batch_shape=(2,), ops=("forward",), device="cpu"))
    with pytest.raises(ValueError, match="exported without"):
        one.inverse_split(_t(re[:2]), _t(im[:2]))
    with pytest.raises(ValueError, match="serves shape"):
        one.forward_split(_t(re[:1]), _t(im[:1]))
    with pytest.raises(ValueError, match="unknown op"):
        ft.export_plan(p, batch_shape=(2,), ops=("nosuch",), device="cpu")


def test_aot_refuses_other_artifacts_and_libraries(tmp_path):
    import io as _io
    import zipfile

    buf = _io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("meta.json", json.dumps({"format": "fft_wgpu_tpu-aot-v1"}))
    with pytest.raises(ValueError, match="artifact"):
        ft.load_plan(buf.getvalue())
    # a library of other sources is never loaded under a kernel's name
    stale = tmp_path / "librows_fft-0000000000000000.so"
    stale.write_bytes(b"")
    with pytest.raises(ValueError, match="not built from this checkout"):
        build.preload("rows_fft", stale)


def test_aot_export_records_the_routes_libraries(monkeypatch):
    # the libraries each op loads are what the artifact ships: recorded by
    # build.load, here with a CUDA route replaced by a stand-in
    p = ft.plan(4096)
    calls = []

    def fake(re, im, sign, scale, axis, out=None, ex=None):
        for names in build._RECORDS:
            names.add("rows_fft")
        calls.append(ex)
        return re, im

    monkeypatch.setattr(p, "_execute_split_axis", fake)
    monkeypatch.setattr(p, "_route", lambda device, shape, axis: "pallas")
    monkeypatch.setattr(build, "library_path", lambda name: build.CSRC / f"{name}.cu")
    data = aot.export_plan(p, batch_shape=(2,), device="cpu")
    import io as _io
    import zipfile

    with zipfile.ZipFile(_io.BytesIO(data)) as z:
        meta = json.loads(z.read("meta.json"))
        assert meta["libraries"] == {"rows_fft": "rows_fft.cu"}
        assert "lib/rows_fft.cu" in z.namelist()
    assert all(r == {"route": "pallas", "libraries": ["rows_fft"]}
               for r in meta["routes"].values())
    assert calls == ["pallas"] * 3


def test_tuned_route_is_measured_once_a_bucket(monkeypatch):
    # a tuned plan measures once per (device, rows bucket, axis) and keeps
    # the route: a repeated call is a lookup on the plan
    calls = []

    def measure(plan, shape, axis, device):
        calls.append((shape, axis))
        return "bigfft"

    monkeypatch.setattr(autotune, "measure_executor", measure)
    p = ft.plan(1 << 17, autotune=True)
    card = torch.device("cuda", 0)
    for rows in (16, 20, 100):  # one bucket
        assert p._route(card, (rows, 1 << 17), 1) == "bigfft"
    assert calls == [((16, 1 << 17), 1)]
    assert p._route(card, (256, 1 << 17), -1) == "bigfft"  # another bucket
    assert len(calls) == 2
    # an axis before the last on the axis(-2) kernels, and the CPU: no
    # measurement
    assert ft.plan(4096, autotune=True)._route(card, (4096, 8), 0) == "axis"
    cpu = torch.device("cpu")
    assert p._route(cpu, (16, 1 << 17), 1) == p._resolve_executor(cpu)
    assert len(calls) == 2


# ---------------------------------------------------------------------- #
# dot precision
# ---------------------------------------------------------------------- #
def test_precision_mode_plumbing_and_scope(rng, assert_close):
    assert ft.get_dot_precision() == "accurate"
    with ft.dot_precision("fast"):
        assert ft.get_dot_precision() == "fast"
        x = rng.standard_normal((4, 256)).astype(np.float32)
        assert_close(ft.fft(_t(x)).numpy(), np.fft.fft(x))  # the CPU has no TF32
    assert ft.get_dot_precision() == "accurate"
    with pytest.raises(ValueError):
        ft.set_dot_precision("wat")
    try:
        ft.set_dot_precision("fast")
        assert precision.get_dot_precision() == "fast"
    finally:
        ft.set_dot_precision("accurate")
    assert ft.get_dot_precision() == ftt.get_dot_precision() == "accurate"


@pytest.mark.parametrize("mode,tf32", [("accurate", False), ("fast", True)])
def test_full_float32_reads_the_mode_inside_and_restores(mode, tf32, monkeypatch):
    # the guard sets TF32 from the mode for its block on a CUDA tensor and
    # restores the caller's setting; the mode never reaches torch.backends
    # outside it
    class Cuda:
        is_cuda = True

    seen = []
    before = torch.backends.cuda.matmul.allow_tf32
    with ft.dot_precision(mode):
        assert torch.backends.cuda.matmul.allow_tf32 == before
        with stockham.full_float32(Cuda()):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
        assert torch.backends.cuda.matmul.allow_tf32 == before
    assert seen == [tf32]
    with stockham.full_float32(torch.zeros(1)):  # the CPU: left alone
        assert torch.backends.cuda.matmul.allow_tf32 == before


# ---------------------------------------------------------------------- #
# host transfer, roofline, profiling, debug
# ---------------------------------------------------------------------- #
def test_io_round_trip(rng, tmp_path, monkeypatch):
    z = (rng.standard_normal((3, 5)) + 1j * rng.standard_normal((3, 5))).astype(np.complex128)
    t = ft.device_put_complex(z, "cpu")
    assert t.dtype == torch.complex64 and t.device == CPU
    back = ft.device_get_complex(t)
    assert back.dtype == np.complex64
    np.testing.assert_array_equal(back, z.astype(np.complex64))
    np.testing.assert_array_equal(ft.device_get_complex(t.conj()), z.astype(np.complex64).conj())
    r = ft.device_put_complex(np.arange(4.0, dtype=np.float32), "cpu")
    assert r.dtype == torch.float32
    jz = ftt.device_get_complex(ftt.device_put_complex(z.astype(np.complex64)))
    np.testing.assert_array_equal(back, jz)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.device_put_complex(z)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    assert io.enable_persistent_compilation_cache(str(tmp_path / "libs")) == \
        str(tmp_path / "libs")
    assert build.BUILD_DIR == tmp_path / "libs" and build.BUILD_DIR.is_dir()
    assert build.library_path("rows_fft").parent == tmp_path / "libs"


def test_roofline_matches_jax_arithmetic(monkeypatch):
    from fft_wgpu_tpu.utils import roofline as j_roof

    assert roofline.fft_flops(4096, 3) == j_roof.fft_flops(4096, 3)
    assert roofline.hbm_bandwidth("cpu") == j_roof.hbm_bandwidth() == 0.1e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert roofline.hbm_bandwidth(CUDA) == 3.35e12
    got = roofline.roofline(4096, 4096, 1e-4, passes=1, device="cpu")
    want = j_roof.roofline(4096, 4096, 1e-4, passes=1)
    for k in want:
        assert got[k] == pytest.approx(want[k]), k
    stats = profiling.op_stats(4096, 4096, 1e-4, device="cpu")
    from fft_wgpu_tpu.utils import profiling as j_prof

    assert stats == pytest.approx(j_prof.op_stats(4096, 4096, 1e-4))


def test_profiling_trace_and_annotate(tmp_path, rng):
    x = _t(rng.standard_normal((4, 256)).astype(np.float32))
    with profiling.trace(str(tmp_path / "tr")) as prof:
        with profiling.annotate("fft 256"):
            ft.fft(x)
    names = {e.key for e in prof.key_averages()}
    assert "fft 256" in names
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("n", [128, 1024, 4096])
def test_validate_kernel_on_cpu_matches_jax(n):
    # the plain version of B1's own passes, against the f64 naive DFT, as
    # the JAX package's interpret-mode kernel
    err = debug.validate_kernel(n, device="cpu")
    from fft_wgpu_tpu.utils import debug as j_debug

    assert err < 1e-5 and j_debug.validate_kernel(n) < 1e-5
    assert debug.validate_kernel(n, sign=1, device="cpu") < 1e-5


def test_check_finite():
    a = torch.ones(3)
    assert debug.check_finite(a, a)[0] is a
    with pytest.raises(FloatingPointError, match="in probe"):
        debug.check_finite(a, torch.tensor([1.0, float("nan"), 0.0]), "probe")


# ---------------------------------------------------------------------- #
# autotune (tests/test_autotune.py's cases, with the port's candidates)
# ---------------------------------------------------------------------- #
class TestCandidates:
    def test_row_kernel_alone(self):
        for rows in (1, 8, 4096):
            assert autotune.candidates_for(4096, rows, "cuda") == ["pallas"]

    def test_whole_row_against_two_passes(self):
        assert autotune.candidates_for(1 << 17, 16, "cuda") == ["bigfft", "fourstep:two-pass"]
        assert autotune.candidates_for(1 << 20, 4, "cuda") == ["fourstep"]

    def test_composite_long_primes(self):
        # 4097 = 17 * 241: the composite kernel against Bluestein's
        assert autotune.candidates_for(4097, 1024, "cuda") == ["general", "bluestein"]
        assert autotune.candidates_for(4095, 8, "cuda") == ["general"]

    def test_cpu_and_other_lengths(self):
        assert autotune.candidates_for(4096, 64, "cpu") == ["xla"]
        assert autotune.candidates_for(100, 4, "cuda") == ["xla"]
        assert autotune.candidates_for(8191, 4, "cuda") == ["xla"]


@pytest.fixture
def tuner(monkeypatch):
    """measure_executor with the card's name, the plain-path check and the
    timer stood in for, the wisdom kept in memory."""
    autotune.TUNE_CACHE.clear()
    monkeypatch.setattr(autotune, "_wisdom_loaded", True)
    monkeypatch.setattr(autotune, "save_wisdom", lambda *a, **k: None)
    monkeypatch.setattr(autotune, "_card", lambda device: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(autotune, "_check_against_plain", lambda *a: 0.0)
    yield monkeypatch
    autotune.TUNE_CACHE.clear()


def test_single_candidate_skips_measurement(tuner):
    calls = []
    tuner.setattr(autotune, "_slope_time", lambda *a, **k: calls.append(1) or 1.0)
    assert autotune.measure_executor(ft.plan(4095, autotune=True), (4, 4095), -1, CUDA) == "general"
    assert autotune.measure_executor(ft.plan(4096, autotune=True), (4, 4096), -1, CUDA) == "pallas"
    assert not calls


def test_picks_fastest_and_caches(tuner):
    times = {"bigfft": 3.0, "fourstep:two-pass": 1.0}
    measured = []

    def fake_slope(fn, shape, device, **kw):
        ex = fn.__defaults__[0]
        measured.append(ex)
        return times[ex]

    tuner.setattr(autotune, "_slope_time", fake_slope)
    p = ft.plan(1 << 17, autotune=True)
    assert autotune.measure_executor(p, (16, 1 << 17), -1, CUDA) == "fourstep:two-pass"
    assert set(measured) == {"bigfft", "fourstep:two-pass"}
    measured.clear()
    assert autotune.measure_executor(p, (20, 1 << 17), -1, CUDA) == "fourstep:two-pass"
    assert not measured  # cached: same bucket
    assert ("NVIDIA H100 80GB HBM3", 1 << 17, 64, -1) in autotune.TUNE_CACHE


def test_only_unsupported_is_skipped(tuner):
    def fake_check(plan, fn, shape, axis, device):
        if fn.__defaults__[0] == "bigfft":
            raise cuda_fft.Unsupported("outside the envelope")
        return 0.0

    tuner.setattr(autotune, "_check_against_plain", fake_check)
    tuner.setattr(autotune, "_slope_time", lambda fn, *a, **k: 2.0)
    p = ft.plan(1 << 17, autotune=True)
    assert autotune.measure_executor(p, (16, 1 << 17), -1, CUDA) == "fourstep:two-pass"
    autotune.TUNE_CACHE.clear()

    # a build or launch error propagates: no silent skip
    def broken(fn, *a, **k):
        raise build.CompileError("nvcc refused")

    tuner.setattr(autotune, "_check_against_plain", lambda *a: 0.0)
    tuner.setattr(autotune, "_slope_time", broken)
    with pytest.raises(build.CompileError):
        autotune.measure_executor(p, (16, 1 << 17), -1, CUDA)
    # so does a wrong result
    tuner.setattr(autotune, "_check_against_plain", lambda *a: 1e-3)
    with pytest.raises(RuntimeError, match="from the plain path"):
        autotune.measure_executor(p, (16, 1 << 17), -1, CUDA)


def test_check_against_plain_on_the_cpu():
    # the check itself: a route against the plain path on a few rows
    p = ft.plan(4097)

    def general(a, b):
        return p._execute_split_axis(a, b, -1, None, -1, ex="general")

    assert autotune._check_against_plain(p, general, (64, 4097), -1, CPU) < 1e-5

    def wrong(a, b):
        return a, b

    assert autotune._check_against_plain(p, wrong, (64, 4097), -1, CPU) > 0.5


def test_tuned_routes_match_jax(rng, assert_close):
    # each route a tuned plan may take, on CPU tensors (their plain
    # versions), against the JAX plan
    for n, routes in ((4097, ("general", "bluestein")), (1 << 15, ("bigfft", "fourstep:two-pass"))):
        x = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))).astype(np.complex64)
        want = np.asarray(ftt.plan(n).forward(x))
        p = ft.plan(n)
        for ex in routes:
            got = p._execute_split_axis(_t(x.real), _t(x.imag), -1, None, -1, ex=ex)
            assert_close(_c(got), want, what=f"{n} {ex}")


def test_wisdom_round_trip_and_stamp(tmp_path, monkeypatch):
    path = str(tmp_path / "wisdom.json")
    autotune.TUNE_CACHE.clear()
    autotune.PLANE_CACHE.clear()
    autotune.TUNE_CACHE[("NVIDIA H100 80GB HBM3", 4097, 1024, -1)] = "bluestein"
    autotune.PLANE_CACHE["NVIDIA H100 80GB HBM3"] = 1 << 16
    autotune.OVERLAP_CACHE[("NVIDIA H100 80GB HBM3", 4)] = 2
    autotune.save_wisdom(path)
    data = json.load(open(path))
    assert data["__toolchain__"].startswith(f"torch={torch.__version__};cuda=")
    assert data["__toolchain__"].endswith(f"src={build.source_stamp()}")
    autotune.TUNE_CACHE.clear()
    autotune.PLANE_CACHE.clear()
    autotune.OVERLAP_CACHE.clear()
    autotune.load_wisdom(path)
    assert autotune.TUNE_CACHE == {("NVIDIA H100 80GB HBM3", 4097, 1024, -1): "bluestein"}
    assert autotune.PLANE_CACHE == {"NVIDIA H100 80GB HBM3": 1 << 16}
    assert autotune.OVERLAP_CACHE == {("NVIDIA H100 80GB HBM3", 4): 2}
    autotune.TUNE_CACHE.clear()
    autotune.PLANE_CACHE.clear()
    autotune.OVERLAP_CACHE.clear()
    # another kernel source (or toolchain) invalidates the file
    monkeypatch.setattr(build, "source_stamp", lambda: "0" * 16)
    autotune.load_wisdom(path)
    assert not autotune.TUNE_CACHE and not autotune.PLANE_CACHE
    monkeypatch.setattr(autotune, "_WISDOM_PATH", str(tmp_path / "none.json"))
    autotune.load_wisdom()  # a missing file is no error
    assert not autotune.TUNE_CACHE


def test_tuners_without_counterpart_raise():
    for fn in (lambda: autotune.tune_balanced(4096), lambda: autotune.tune_ax0_tile(1024),
               lambda: autotune.split_candidates(4096),
               lambda: autotune.tune_fused_plane(device="cpu")):
        with pytest.raises(RuntimeError):
            fn()
    assert autotune.default_overlap_chunks(None) == 1


def test_plan_autotune_takes_the_measured_route(monkeypatch, rng, assert_close):
    # a CUDA tensor's route is measure_executor's; a CPU tensor is not tuned
    seen = []
    monkeypatch.setattr(autotune, "measure_executor",
                        lambda plan, shape, axis, device: seen.append((shape, axis)) or "bluestein")
    p = ft.plan(4097, autotune=True)
    assert p._route(CUDA, (8, 4097), -1) == "bluestein"
    assert seen == [((8, 4097), -1)]
    assert p._route(CPU, (8, 4097), -1) == "xla"
    assert ft.plan(4097)._route(CUDA, (8, 4097), -1) == "general"
    x = (rng.standard_normal((2, 4097)) + 1j * rng.standard_normal((2, 4097))).astype(np.complex64)
    assert_close(p.forward(_t(x)).numpy(), np.asarray(ftt.plan(4097, autotune=True).forward(x)))
    assert len(seen) == 1


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #
def _cli(*args, timeout=120):
    return subprocess.run([sys.executable, "-m", "fft_wgpu_tpu_torch", *args],
                          capture_output=True, text=True, timeout=timeout)


def test_cli_info_selftest_export_on_cpu(tmp_path, assert_close, rng):
    out = _cli("info", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout.strip().splitlines()[-1])
    assert info["version"] == ft.__version__ and info["backend"] == "cpu"
    assert info["hbm_bandwidth_GBps"] == 100.0
    out = _cli("selftest", "--n", "256", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "selftest: PASS" in out.stdout and out.stdout.count(" ok") == 5
    path = tmp_path / "p.ftta"
    out = _cli("export-plan", "256", str(path), "--batch", "4", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    sp = ft.load_plan(str(path))
    re, im = _split(rng, (4, 256))
    assert_close(_c(sp.forward_split(_t(re), _t(im))), np.fft.fft(re + 1j * im))
    out = _cli("tune", "4096", "--rows", "8", "--device", "cpu")
    assert out.returncode == 0 and "n=4096 rows=8: xla" in out.stdout
