"""Torch port, lengths below 1 and empty inputs: every public name that
takes a length or size argument (``n``, ``s``, ``m``, ``N``, ``num``,
``nperseg``, ``nfft``, ``up``, ``down``), called with it at 0, at a 1-bin
half spectrum and at an empty signal, where each applies.

Each case is held against a reference computed here: ``numpy.fft`` for the
numpy-named transforms, ``scipy.fft`` for the DCT/DST family and the
Hermitian N-D names, ``scipy.signal`` for the signal names.  The outcome
compared is the exception's class, or the result's shapes and values at
1e-5 relative L2.  The ``torch.fft`` names patched by
``torch_backend.accelerated()`` are held against stock ``torch.fft``, and
``scipy.fft`` served by ``scipy_backend.on("cpu")`` against ``scipy.fft``
itself.  The JAX package is no reference here: it keeps faults C6, C7 and
C9 of ROADMAP §C.

A difference the port makes by design is listed in ``ALLOWED``, with both
outcomes and the reason; any other difference fails.  Inputs are
``[3, <= 64]``, made from a seed with numpy.
"""

import numpy as np
import pytest
import scipy.fft as sf
import scipy.signal as ss
import torch

import fft_wgpu_tpu_torch as ft
import fft_wgpu_tpu_torch.scipy_backend as be
import fft_wgpu_tpu_torch.torch_backend as tb
from fft_wgpu_tpu_torch.plan.plan import Plan

torch.set_num_threads(1)

TOL = 1e-5
NORMS = (None, "ortho", "forward")
# stock torch.fft, taken before any patch
STOCK = {name: getattr(torch.fft, name) for name in tb._FUNCS}

_rng = np.random.default_rng(0)
C = (_rng.standard_normal((3, 8)) + 1j * _rng.standard_normal((3, 8))).astype(np.complex64)
R = _rng.standard_normal((3, 8)).astype(np.float32)
R64 = _rng.standard_normal(64).astype(np.float32)
TAPS = _rng.standard_normal(3).astype(np.float32)
CTAPS = (TAPS + 1j * _rng.standard_normal(3)).astype(np.complex64)

# case id -> (the port's callable, the reference's, array arguments, keywords);
# the port gets the arrays as CPU tensors, the reference as they are
CASES: dict = {}


def case(cid, port, ref, args, **kw):
    assert cid not in CASES, cid
    CASES[cid] = (port, ref, args, kw)


def _c2r(name):
    return name in ("irfft", "hfft", "irfft2", "irfftn", "hfft2", "hfftn")


# ---- the numpy.fft names (and ifft_unnormalized, numpy's ifft unscaled) ----
for name in ("fft", "ifft", "rfft", "ihfft", "irfft", "hfft"):
    x = R if name in ("rfft", "ihfft") else C
    for norm in NORMS:
        p, r = getattr(ft, name), getattr(np.fft, name)
        case(f"{name}-n0-{norm}", p, r, (x,), n=0, norm=norm)
        case(f"{name}-n-2-{norm}", p, r, (x,), n=-2, norm=norm)
        case(f"{name}-empty-{norm}", p, r, (x[:, :0],), norm=norm)
        case(f"{name}-batch0-{norm}", p, r, (x[:0],), norm=norm)
        if _c2r(name):
            case(f"{name}-bins1-{norm}", p, r, (x[:, :1],), norm=norm)
for label, x, kw in (("n0", C, {"n": 0}), ("empty", C[:, :0], {}), ("batch0", C[:0], {})):
    case(f"ifft_unnormalized-{label}", ft.ifft_unnormalized,
         lambda v, **k: np.fft.ifft(v, norm="forward", **k), (x,), **kw)

ND = {"fft2": np.fft, "ifft2": np.fft, "fftn": np.fft, "ifftn": np.fft,
      "rfft2": np.fft, "rfftn": np.fft, "irfft2": np.fft, "irfftn": np.fft,
      "hfft2": sf, "hfftn": sf, "ihfft2": sf, "ihfftn": sf}
for name, mod in ND.items():
    x = R if name.startswith(("rfft", "ihfft")) else C
    for norm in NORMS:
        p, r = getattr(ft, name), getattr(mod, name)
        for s in ((3, 0), (0, 4), (3, -1), (-1, -2)):
            case(f"{name}-s{s[0]}{s[1]}-{norm}", p, r, (x,), s=s, norm=norm)
        case(f"{name}-empty-{norm}", p, r, (x[:, :0],), norm=norm)
        if _c2r(name):
            case(f"{name}-bins1-{norm}", p, r, (x[:, :1],), norm=norm)

# ---- the DCT/DST family, against scipy.fft ---------------------------------
for name in ("dctn", "dstn", "idctn", "idstn"):
    for t in (1, 2, 3, 4):
        for norm in NORMS:
            p, r = getattr(ft, name), getattr(sf, name)
            for s in ((3, 0), (0, 4), (3, -1)):
                case(f"{name}-t{t}-s{s[0]}{s[1]}-{norm}", p, r, (R,), type=t, s=s, norm=norm)
            case(f"{name}-t{t}-empty-{norm}", p, r, (R[:, :0],), type=t, norm=norm)
            case(f"{name}-t{t}-one-{norm}", p, r, (R[:, :1],), type=t, norm=norm)
for name in ("dct", "dst", "idct", "idst"):
    for t in (1, 2, 3, 4):
        p, r = getattr(ft, name), getattr(sf, name)
        case(f"{name}-t{t}-empty", p, r, (R[:, :0],), type=t)
        case(f"{name}-t{t}-one", p, r, (R[:, :1],), type=t)
    case(f"{name}-n0", p, r, (R,), n=0)

# ---- chirp-z and zoom FFT, against scipy.signal ----------------------------
for m in (0, -1, None):
    case(f"czt-m{m}", ft.czt, ss.czt, (C,), m=m)
    case(f"zoom_fft-m{m}", ft.zoom_fft, ss.zoom_fft, (C,), fn=0.5, m=m)
    case(f"CZT-m{m}", lambda v, m: ft.CZT(v.shape[-1], m=m)(v),
         lambda v, m: ss.CZT(v.shape[-1], m=m)(v), (C,), m=m)
    case(f"ZoomFFT-m{m}", lambda v, m: ft.ZoomFFT(v.shape[-1], 0.5, m=m)(v),
         lambda v, m: ss.ZoomFFT(v.shape[-1], 0.5, m=m)(v), (C,), m=m)
case("czt-empty", ft.czt, ss.czt, (C[:, :0],))
case("zoom_fft-empty", ft.zoom_fft, ss.zoom_fft, (C[:, :0],), fn=0.5)
case("CZT-n0", lambda v: ft.CZT(0)(v), lambda v: ss.CZT(0)(v), (C[:, :0],))
case("ZoomFFT-n0", lambda v: ft.ZoomFFT(0, 0.5)(v), lambda v: ss.ZoomFFT(0, 0.5)(v), (C[:, :0],))
case("czt_points-m0", lambda: ft.czt_points(0), lambda: ss.czt_points(0), ())

# ---- the analytic signal ---------------------------------------------------
case("hilbert-N0", ft.hilbert, ss.hilbert, (R,), N=0)
case("hilbert-empty", ft.hilbert, ss.hilbert, (R[:, :0],))
for N in (0, (3, 0), (0, 4)):
    case(f"hilbert2-N{N}", ft.hilbert2, ss.hilbert2, (R,), N=N)
case("hilbert2-empty", ft.hilbert2, ss.hilbert2, (R[:, :0],))

# ---- the convolution family: an empty signal, empty taps, both ------------
OPERANDS = {"empty-signal": (R64[:0], TAPS), "empty-taps": (R64, TAPS[:0]),
            "both-empty": (R64[:0], TAPS[:0]), "empty-complex": (C[0, :0], CTAPS),
            "empty-2d": (R[:, :0], R[:, :3])}
for name in ("fftconvolve", "oaconvolve", "convolve", "correlate"):
    for label, ops in OPERANDS.items():
        for mode in ("full", "same", "valid"):
            methods = ("auto", "direct", "fft") if name in ("convolve", "correlate") else (None,)
            for method in methods:
                kw = {"mode": mode} if method is None else {"mode": mode, "method": method}
                cid = f"{name}-{label}-{mode}" + ("" if method is None else f"-{method}")
                case(cid, getattr(ft, name), getattr(ss, name), ops, **kw)

# ---- the estimators --------------------------------------------------------
for name in ("periodogram", "welch", "spectrogram"):
    p, r = getattr(ft, name), getattr(ss, name)
    case(f"{name}-empty", p, r, (R64[:0],))
    case(f"{name}-empty-batch3", p, r, (R[:, :0],))
    case(f"{name}-nfft0", p, r, (R64,), nfft=0)
    if name != "periodogram":
        case(f"{name}-nperseg0", p, r, (R64,), nperseg=0)
        case(f"{name}-nperseg16-nfft0", p, r, (R64,), nperseg=16, nfft=0)
        case(f"{name}-empty-nperseg0", p, r, (R64[:0],), nperseg=0)
for name in ("csd", "coherence"):  # two signals: the estimators' shared path
    p, r = getattr(ft, name), getattr(ss, name)
    case(f"{name}-empty", p, r, (R64[:0], R64[:0]))
    case(f"{name}-empty-batch3", p, r, (R[:, :0], R[:, :0]))
    case(f"{name}-empty-x", p, r, (R[:, :0], R))
    case(f"{name}-empty-y-broadcast", p, r, (R[:1], R[:, :0]))
# an nfft below the signal's length cuts the signal to nfft samples
case("periodogram-nfft16", ft.periodogram, ss.periodogram, (R64,), nfft=16)
case("periodogram-nfft5-complex", ft.periodogram, ss.periodogram, (C,), nfft=5)

# ---- resampling ------------------------------------------------------------
case("resample-num0", ft.resample, ss.resample, (R,), num=0, axis=-1)
case("resample-empty", ft.resample, ss.resample, (R[:, :0],), num=4, axis=-1)
case("decimate-q0", ft.decimate, ss.decimate, (R64,), q=0)
for label, kw in (("up0", {"up": 0, "down": 1}), ("down0", {"up": 1, "down": 0})):
    case(f"resample_poly-{label}", ft.resample_poly, ss.resample_poly, (R64,), axis=-1, **kw)
    case(f"upfirdn-{label}", ft.upfirdn, ss.upfirdn, (TAPS, R64), **kw)
for up, down in ((2, 3), (3, 2), (1, 1)):
    # the axis given: the port's default is the JAX package's, -1, scipy's 0
    case(f"resample_poly-empty-{up}-{down}", ft.resample_poly, ss.resample_poly, (R64[:0],),
         up=up, down=down, axis=-1)
    for axis in (-1, 0):
        case(f"resample_poly-empty-batch3-axis{axis}-{up}-{down}", ft.resample_poly,
             ss.resample_poly, (R[:, :0],), up=up, down=down, axis=axis)
for taps, up, down in ((3, 2, 3), (3, 1, 1), (5, 2, 1), (1, 1, 1), (3, 5, 1), (1, 3, 2)):
    h = np.ones(taps, np.float32)
    case(f"upfirdn-empty-h{taps}-{up}-{down}", ft.upfirdn, ss.upfirdn, (h, R64[:0]),
         up=up, down=down)
    case(f"upfirdn-empty-batch3-h{taps}-{up}-{down}", ft.upfirdn, ss.upfirdn, (h, R[:, :0]),
         up=up, down=down)
case("upfirdn-empty-complex", ft.upfirdn, ss.upfirdn, (CTAPS, C[0, :0]), up=2, down=3)
case("upfirdn-empty-taps", ft.upfirdn, ss.upfirdn, (TAPS[:0], R64), up=2, down=3)


# ---- differences by design: case id -> (the port's outcome, the
# reference's outcome, why); an outcome is an exception class or the
# result's shape
ALLOWED: dict = {}
for name in ("hfft2", "hfftn"):
    for norm in NORMS:
        ALLOWED[f"{name}-bins1-{norm}"] = (
            ValueError, (3, 1),
            "scipy.fft returns a length-1 axis for the N-D Hermitian transform of a "
            "1-bin last axis, whose output length 2 * (1 - 1) is 0; numpy.fft raises "
            "ValueError for every zero length, and the port follows numpy.fft")
for name in ("dct", "dst", "idct", "idst"):
    ALLOWED[f"{name}-n0"] = (
        TypeError, ValueError,
        "dct, dst, idct and idst take no n= (the JAX package's signature): the port "
        "refuses the keyword, where scipy.fft refuses the length")
for name in ("dctn", "idctn"):
    for norm in NORMS:
        ALLOWED[f"{name}-t1-one-{norm}"] = (
            ValueError, RuntimeError,
            "DCT-I of one point: the port raises ValueError ('DCT-I requires n >= 2'), "
            "scipy.fft a RuntimeError from pocketfft's zero-length FFT")
for name in ("dct", "idct"):
    ALLOWED[f"{name}-t1-one"] = ALLOWED["dctn-t1-one-None"]
ALLOWED["resample-num0"] = (
    ValueError, ZeroDivisionError,
    "resample(num=0): the port raises ValueError ('num must be >= 1'), scipy.signal "
    "divides by num")
ALLOWED["decimate-q0"] = (
    ValueError, ZeroDivisionError,
    "decimate(q=0): the port raises ValueError ('q must be >= 1'), scipy.signal "
    "divides by q")
for name in ("convolve", "correlate"):
    for label in OPERANDS:
        for mode in ("full", "same", "valid"):
            # the port's outcome: scipy's with method='direct'
            ALLOWED[f"{name}-{label}-{mode}-fft"] = (
                "direct", IndexError,
                "scipy.signal's method='fft' reads the first sample of its empty result "
                "(IndexError); the port answers every method as scipy's direct method does")


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def outcome(fn, args, kw, tensors):
    """fn's exception class, or its result as a list of numpy arrays."""
    if tensors:
        args = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)
    try:
        out = fn(*args, **kw)
    except Exception as err:  # noqa: BLE001 - the class is the outcome
        return type(err)
    return [_np(v) for v in (out if isinstance(out, tuple) else (out,))]


def _kind(o):
    """An outcome as ALLOWED states it: the class, or the (first) shape."""
    return o if isinstance(o, type) else o[0].shape


def assert_same_outcome(got, want, what):
    if isinstance(want, type) or isinstance(got, type):
        assert got is want, f"{what}: the port gave {_kind(got)}, the reference {_kind(want)}"
        return
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape, f"{what}: shape {g.shape} against {w.shape}"
        if w.size:
            g64, w64 = g.astype(np.complex128), w.astype(np.complex128)
            den = np.linalg.norm(w64) or 1.0
            err = np.linalg.norm(g64 - w64) / den
            assert err < TOL, f"{what}: relative L2 error {err:.3e}"


def _transformed(*args, **kwargs):
    raise AssertionError("an axis was transformed")


@pytest.mark.parametrize("cid", list(CASES))
def test_edge_matches_numpy_and_scipy(cid, monkeypatch):
    port, ref, args, kw = CASES[cid]
    got = outcome(port, args, kw, tensors=True)
    want = outcome(ref, args, kw, tensors=False)
    if cid in ALLOWED:
        port_kind, ref_kind, why = ALLOWED[cid]
        if port_kind == "direct":
            assert _kind(want) == ref_kind, why
            want = outcome(ref, args, {**kw, "method": "direct"}, tensors=False)
            assert_same_outcome(got, want, f"{cid} against method='direct'")
        else:
            assert (_kind(got), _kind(want)) == (port_kind, ref_kind), why
    else:
        assert_same_outcome(got, want, cid)
    if isinstance(got, type):
        # a call that raises does so before any axis is transformed (on a
        # CUDA tensor: before any launch); every transform runs a Plan's
        for name in ("_execute_split", "_execute_split_axis", "_execute_c64"):
            monkeypatch.setattr(Plan, name, _transformed)
        assert outcome(port, args, kw, tensors=True) is got, f"{cid}: it raised late"


# ---- torch.fft patched by torch_backend, against stock torch.fft ----------
TORCH_CASES: dict = {}
for name in tb._FUNCS:
    x = R if name.startswith(("rfft", "ihfft")) else C
    one_d = name in tb._ONE_D
    for norm in NORMS:
        if one_d:
            TORCH_CASES[f"{name}-n0-{norm}"] = (name, x, {"n": 0, "norm": norm})
        else:
            for s in ((3, 0), (0, 4), (3, -1)):
                TORCH_CASES[f"{name}-s{s[0]}{s[1]}-{norm}"] = (name, x, {"s": s, "norm": norm})
        TORCH_CASES[f"{name}-empty-{norm}"] = (name, x[:, :0], {"norm": norm})
        if _c2r(name):
            TORCH_CASES[f"{name}-bins1-{norm}"] = (name, x[:, :1], {"norm": norm})


@pytest.mark.parametrize("cid", list(TORCH_CASES))
def test_torch_backend_raises_as_stock(cid):
    name, x, kw = TORCH_CASES[cid]
    want = outcome(STOCK[name], (x,), kw, tensors=True)
    with tb.accelerated():
        got = outcome(getattr(torch.fft, name), (x,), kw, tensors=True)
    assert_same_outcome(got, want, cid)


# ---- scipy.fft through scipy_backend, against scipy.fft itself ------------
SCIPY_NAMES = ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fft2", "ifft2", "fftn",
               "ifftn", "rfft2", "irfft2", "rfftn", "irfftn", "hfft2", "ihfft2", "hfftn",
               "ihfftn", "dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn")
SCIPY_CASES: dict = {}
for name in SCIPY_NAMES:
    x = R if name.startswith(("rfft", "ihfft", "dct", "idct", "dst", "idst")) else C
    nd = name.endswith(("2", "n"))
    for norm in NORMS:
        if nd:
            for s in ((3, 0), (0, 4), (3, -1)):
                SCIPY_CASES[f"{name}-s{s[0]}{s[1]}-{norm}"] = (name, x, {"s": s, "norm": norm})
        else:
            SCIPY_CASES[f"{name}-n0-{norm}"] = (name, x, {"n": 0, "norm": norm})
        SCIPY_CASES[f"{name}-empty-{norm}"] = (name, x[:, :0], {"norm": norm})
        if _c2r(name):
            SCIPY_CASES[f"{name}-bins1-{norm}"] = (name, x[:, :1], {"norm": norm})
        if name.startswith(("dct", "idct")):
            SCIPY_CASES[f"{name}-t1-one-{norm}"] = (name, x[:, :1],
                                                    {"type": 1, "norm": norm})

SCIPY_ALLOWED: dict = {}
for norm in NORMS:
    for cid in (f"irfft-n0-{norm}", f"hfft-n0-{norm}", f"irfft2-bins1-{norm}",
                f"irfftn-bins1-{norm}", f"hfft2-bins1-{norm}", f"hfftn-bins1-{norm}"):
        SCIPY_ALLOWED[cid] = (
            ValueError, (3, 1),
            "scipy.fft returns a length-1 axis for a zero output length of irfft and "
            "hfft (n=0) and of the N-D C2R and Hermitian transforms of a 1-bin last "
            "axis; the backend raises ValueError, as scipy.fft does for every other "
            "zero length")
    for name in ("dct", "idct", "dctn", "idctn"):
        SCIPY_ALLOWED[f"{name}-t1-one-{norm}"] = ALLOWED["dctn-t1-one-None"]


@pytest.mark.parametrize("cid", list(SCIPY_CASES))
def test_scipy_backend_matches_scipy(cid, monkeypatch):
    name, x, kw = SCIPY_CASES[cid]
    fn = getattr(sf, name)
    want = outcome(fn, (x,), kw, tensors=False)
    with sf.set_backend(be.on("cpu")):
        got = outcome(fn, (x,), kw, tensors=False)
    if cid in SCIPY_ALLOWED:
        port_kind, ref_kind, why = SCIPY_ALLOWED[cid]
        assert (_kind(got), _kind(want)) == (port_kind, ref_kind), why
    else:
        assert_same_outcome(got, want, cid)
    if isinstance(got, type):  # before any axis is transformed, as above
        for method in ("_execute_split", "_execute_split_axis", "_execute_c64"):
            monkeypatch.setattr(Plan, method, _transformed)
        with sf.set_backend(be.on("cpu")):
            assert outcome(fn, (x,), kw, tensors=False) is got, f"{cid}: it raised late"


SWEPT = ("fft ifft ifft_unnormalized fft2 ifft2 fftn ifftn rfft irfft rfft2 irfft2 rfftn "
         "irfftn hfft ihfft hfft2 ihfft2 hfftn ihfftn dctn dstn idctn idstn czt zoom_fft CZT "
         "ZoomFFT hilbert hilbert2 fftconvolve oaconvolve convolve correlate periodogram "
         "welch spectrogram resample resample_poly upfirdn").split()


def test_sweep_covers_every_length_argument():
    # every name above has a case, and every allowed difference names a case
    swept = {cid.split("-")[0] for cid in CASES}
    assert set(SWEPT) <= swept, sorted(set(SWEPT) - swept)
    assert set(ALLOWED) <= set(CASES), sorted(set(ALLOWED) - set(CASES))
    assert set(SCIPY_ALLOWED) <= set(SCIPY_CASES)
    assert set(tb._FUNCS) == {cid.split("-")[0] for cid in TORCH_CASES}
