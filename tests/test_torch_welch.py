"""Torch port, the fused segment-spectrum kernels' entry points on the CPU:
``welch_accum_split`` (B16), ``spec_psd_split`` (B19), ``csd_accum_split``
(B17), ``coherence_accum_split`` (B18), ``welch_accum_c2c_split`` and
``welch_accum_c2c_c64`` (B21), ``spec_rfft_split`` (B20, with its roll
and padded output) and ``spec_c2c_split`` and ``spec_c2c_c64`` (B22, with
the plain version of its kernel's passes, ``_spec_c2c_passes``) of
``ops/cuda_welch.py``, the plain versions of B16's, B17's, B18's and
B21's kernel, ``_acc_passes`` (two real frames transformed as one complex
frame; B21 one complex frame a segment), and of B19's, ``_psd_passes``
(two segments as one complex frame), and the two-sided ``welch`` routes.

On a CPU tensor each entry point runs its plain version.  Inside the JAX
package's envelope the same numpy inputs go through its Pallas kernels in
interpret mode, as ``tests/test_pallas_welch.py`` runs them; outside it
(nfft 128 and 256, a hop that does not divide nperseg, more than 8 hops a
frame) against a float64 numpy framing.  Gradients: the JAX kernels have
none, so the port's backward is held against ``jax.grad`` of the JAX
package's composed path (``_spec_segments_split`` and the same products).
The kernels themselves need the card: ``tests/test_torch_cuda.py``.
Tolerance: 1e-5 relative L2.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

from fft_wgpu_tpu.ops import pallas_welch as j_pw
from fft_wgpu_tpu.ops import spectral_est as j_se
from fft_wgpu_tpu.ops.rfft import rfft_last_split as j_rfft_last_split
from fft_wgpu_tpu.ops.stft import _frame as j_frame
import fft_wgpu_tpu_torch as ft
from fft_wgpu_tpu_torch.ops import cuda_welch

torch.set_num_threads(1)

KINDS = ("welch", "psd", "csd", "coh")


def _t(x):
    # a CPU tensor asks the port for the CPU
    return torch.from_numpy(np.array(x))


def _np(v):
    return v.detach().numpy()


def port(kind, x, y, win, *args):
    """The port's entry point of ``kind``: its tensors as numpy, and num."""
    w = _t(win)
    if kind == "welch":
        p, num = cuda_welch.welch_accum_split(_t(x), w, *args)
        return [_np(p)], num
    if kind == "psd":
        P = cuda_welch.spec_psd_split(_t(x), w, *args)
        return [_np(P)], P.shape[-2]
    fn = cuda_welch.csd_accum_split if kind == "csd" else cuda_welch.coherence_accum_split
    *outs, num = fn(_t(x), _t(y), w, *args)
    return [_np(o) for o in outs], num


def jax_kernel(kind, x, y, win, *args):
    """The JAX package's Pallas kernel of ``kind`` in interpret mode."""
    if kind == "welch":
        p, num = j_pw.welch_accum_split(x, win, *args, interpret=True)
        return [np.asarray(p)], num
    if kind == "psd":
        P = j_pw.spec_psd_split(x, win, *args, interpret=True)
        return [np.asarray(P)], P.shape[-2]
    fn = j_pw.csd_accum_split if kind == "csd" else j_pw.coherence_accum_split
    *outs, num = fn(x, y, win, *args, interpret=True)
    return [np.asarray(o) for o in outs], num


def numpy_ref(kind, x, y, win, nperseg, hop, nfft, detrend):
    """float64 numpy framing: every segment's rfft, then the products."""
    def spectra(v):
        v = np.asarray(v, np.float64)
        num = 1 + (v.shape[-1] - nperseg) // hop
        fr = np.stack([v[..., s * hop: s * hop + nperseg] for s in range(num)], -2)
        if detrend == "constant":
            fr = fr - fr.mean(-1, keepdims=True)
        return np.fft.rfft(fr * win, n=nfft)

    X = spectra(x)
    if kind == "psd":
        return [np.abs(X) ** 2], X.shape[-2]
    if kind == "welch":
        return [(np.abs(X) ** 2).sum(-2)], X.shape[-2]
    Y = spectra(y)
    P = (np.conj(X) * Y).sum(-2)
    outs = [P.real, P.imag]
    if kind == "coh":
        outs += [(np.abs(X) ** 2).sum(-2), (np.abs(Y) ** 2).sum(-2)]
    return outs, X.shape[-2]


def check_all(got, want, assert_close, what):
    (g, gnum), (w, wnum) = got, want
    assert gnum == wnum, what
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == np.float32, what
        assert_close(a, b, what=what)


def inputs(rng, lead, t, nperseg):
    x = rng.standard_normal((*lead, t)).astype(np.float32)
    y = rng.standard_normal((*lead, t)).astype(np.float32)
    return x, y, ss.get_window("hann", nperseg).astype(np.float32)


# ---------------------------------------------------------------------- #
# the envelope
# ---------------------------------------------------------------------- #
def test_envelope_contains_jax_envelope():
    port_only = 0
    for t, nperseg, hop, nfft, detrend in itertools.product(
            (100, 512, 4096, 20000), (1, 96, 256, 512, 1000, 4096, 16384),
            (1, 3, 64, 128, 256, 384, 512, 4096), (64, 100, 128, 256, 512, 1000, 1024,
                                                   4096, 16384, 32768),
            (False, None, "constant", "linear", 0)):
        mine = cuda_welch.fused_welch_ok(t, nperseg, hop, nfft, detrend)
        if j_pw.fused_welch_ok(t, nperseg, hop, nfft, detrend):
            assert mine, (t, nperseg, hop, nfft, detrend)
        port_only += mine and not j_pw.fused_welch_ok(t, nperseg, hop, nfft, detrend)
        # one envelope for real and complex input (B21's table is the JAX c2c one)
        if j_pw.fused_welch_ok(t, nperseg, hop, nfft, detrend, c2c=True):
            assert mine, ("c2c", t, nperseg, hop, nfft, detrend)
    assert port_only > 0
    # the lifted rules: nfft from 128, any hop <= nperseg, more than 8 hops a frame
    assert cuda_welch.fused_welch_ok(4096, 256, 128, 256, "constant")
    assert cuda_welch.fused_welch_ok(4096, 512, 384, 512, False)
    assert cuda_welch.fused_welch_ok(4096, 512, 32, 512, None)
    # and what stays outside: detrend=0, "linear", hop > nperseg, nperseg > nfft, t < nperseg
    for args in ((4096, 512, 256, 512, 0), (4096, 512, 256, 512, "linear"),
                 (4096, 512, 513, 512, False), (4096, 1024, 256, 512, False),
                 (500, 512, 256, 512, False), (4096, 512, 256, 64, False),
                 (4096, 96, 32, 96, False), (40000, 512, 256, 32768, False)):
        assert not cuda_welch.fused_welch_ok(*args), args


def test_outside_envelope_raises():
    x, w = torch.zeros(4096), torch.ones(512)
    with pytest.raises(cuda_welch.Unsupported):
        cuda_welch.welch_accum_split(x, w, 512, 256, 512, "linear")
    with pytest.raises(cuda_welch.Unsupported):
        cuda_welch.spec_psd_split(x, w, 512, 256, 1000, False)
    with pytest.raises(cuda_welch.Unsupported):
        cuda_welch.csd_accum_split(x, torch.zeros(4095), w, 512, 256, 512, False)
    with pytest.raises(ValueError, match="win"):
        cuda_welch.welch_accum_split(x, torch.ones(511), 512, 256, 512, False)
    with pytest.raises(ValueError, match="float32"):
        cuda_welch.welch_accum_split(x.double(), w, 512, 256, 512, False)
    with pytest.raises(cuda_welch.Unsupported):
        cuda_welch.welch_accum_split_reference(x, w, 512, 256, 512, 0)
    with pytest.raises(cuda_welch.Unsupported):  # the planes of one complex signal
        cuda_welch.welch_accum_c2c_split(x, torch.zeros(4095), w, 512, 256, 512, False)
    with pytest.raises(cuda_welch.Unsupported):
        cuda_welch.welch_accum_c2c_split(x, x, w, 512, 256, 32768, False)


# ---------------------------------------------------------------------- #
# inside the JAX envelope: against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------- #
JAX_CASES = [((2,), 4096, 512, 256, 512, "constant"),     # batch, ragged last block
             ((), 4096, 512, 128, 1024, None)]              # nfft pad, K = 4


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: "x".join(map(str, c[1:5])))
def test_kernel_matches_jax_interpret(kind, case, rng, assert_close):
    lead, t, nperseg, hop, nfft, detrend = case
    x, y, win = inputs(rng, lead, t, nperseg)
    args = (nperseg, hop, nfft, detrend)
    got = port(kind, x, y, win, *args)
    check_all(got, jax_kernel(kind, x, y, win, *args), assert_close, f"{kind} vs JAX")
    check_all(got, numpy_ref(kind, x, y, win, *args), assert_close, f"{kind} vs numpy")
    assert (cuda_welch.welch_launches, cuda_welch.psd_launches, cuda_welch.csd_launches,
            cuda_welch.coh_launches, cuda_welch.c2c_launches) == (0, 0, 0, 0, 0)


def numpy_c2c(re, im, win, nperseg, hop, nfft, detrend):
    """float64 numpy framing of a complex signal: every segment's fft, then
    the power summed over segments."""
    v = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    num = 1 + (v.shape[-1] - nperseg) // hop
    fr = np.stack([v[..., s * hop: s * hop + nperseg] for s in range(num)], -2)
    if detrend == "constant":
        fr = fr - fr.mean(-1, keepdims=True)
    return (np.abs(np.fft.fft(fr * win, n=nfft)) ** 2).sum(-2), num


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: "x".join(map(str, c[1:5])))
def test_c2c_matches_jax_interpret(case, rng, assert_close):
    lead, t, nperseg, hop, nfft, detrend = case
    re, im, win = inputs(rng, lead, t, nperseg)
    args = (nperseg, hop, nfft, detrend)
    p, num = cuda_welch.welch_accum_c2c_split(_t(re), _t(im), _t(win), *args)
    jp, jnum = j_pw.welch_accum_c2c_split(re, im, win, *args, interpret=True)
    assert num == jnum and p.shape == (*lead, nfft) and p.dtype == torch.float32
    assert_close(_np(p), np.asarray(jp), what="c2c vs JAX")
    want, wnum = numpy_c2c(re, im, win, *args)
    assert num == wnum
    assert_close(_np(p), want, what="c2c vs numpy")
    assert cuda_welch.c2c_launches == 0


# ---------------------------------------------------------------------- #
# outside the JAX envelope: against float64 numpy and the JAX composed form
# ---------------------------------------------------------------------- #
PORT_CASES = [((), 3000, 128, 64, 128, "constant"),        # nfft 128
              ((2,), 2000, 200, 150, 256, False),          # nfft 256, hop !| nperseg
              ((), 5000, 512, 448, 512, "constant"),       # hop = nperseg - nperseg//8
              ((), 3000, 512, 32, 512, None),              # 16 hops a frame (K > 8)
              ((2, 2), 700, 100, 70, 128, "constant")]     # a 2 x 2 batch, even nperseg < nfft


@pytest.mark.parametrize("case", PORT_CASES, ids=lambda c: "x".join(map(str, c[1:5])))
def test_kernel_outside_jax_envelope(case, rng, assert_close):
    lead, t, nperseg, hop, nfft, detrend = case
    assert not j_pw.fused_welch_ok(t, nperseg, hop, nfft, detrend)
    assert cuda_welch.fused_welch_ok(t, nperseg, hop, nfft, detrend)
    x, y, win = inputs(rng, lead, t, nperseg)
    args = (nperseg, hop, nfft, detrend)
    for kind in KINDS:
        check_all(port(kind, x, y, win, *args), numpy_ref(kind, x, y, win, *args),
                  assert_close, kind)
    # the JAX package's composed per-segment spectra, the same products
    Xr, Xi = j_se._spec_segments_split(jnp.asarray(x), None, jnp.asarray(win), *args)
    want = np.asarray(Xr) ** 2 + np.asarray(Xi) ** 2
    assert_close(port("psd", x, y, win, *args)[0][0], want, what="psd vs JAX composed")
    # B21 on x + iy, against numpy and the JAX composed two-sided spectra
    assert not j_pw.fused_welch_ok(t, nperseg, hop, nfft, detrend, c2c=True)
    p, num = cuda_welch.welch_accum_c2c_split(_t(x), _t(y), _t(win), *args)
    want, wnum = numpy_c2c(x, y, win, *args)
    assert num == wnum
    assert_close(_np(p), want, what="c2c vs numpy")
    Xr, Xi = j_se._spec_segments_split(jnp.asarray(x), jnp.asarray(y), jnp.asarray(win), *args)
    assert_close(_np(p), (np.asarray(Xr) ** 2 + np.asarray(Xi) ** 2).sum(-2),
                 what="c2c vs JAX composed")


def test_plain_versions_equal_entry_points_on_cpu(rng):
    x, y, win = inputs(rng, (2,), 3000, 256)
    w, args = _t(win), (256, 100, 512, "constant")
    np.testing.assert_array_equal(
        _np(cuda_welch.welch_accum_split(_t(x), w, *args)[0]),
        _np(cuda_welch.welch_accum_split_reference(_t(x), w, *args)[0]))
    np.testing.assert_array_equal(_np(cuda_welch.spec_psd_split(_t(x), w, *args)),
                                  _np(cuda_welch.spec_psd_split_reference(_t(x), w, *args)))
    for a, b in zip(cuda_welch.coherence_accum_split(_t(x), _t(y), w, *args)[:4],
                    cuda_welch.coherence_accum_split_reference(_t(x), _t(y), w, *args)[:4]):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert cuda_welch.csd_accum_split_reference(_t(x), _t(y), w, *args)[2] == 28
    a, num = cuda_welch.welch_accum_c2c_split(_t(x), _t(y), w, *args)
    b, _ = cuda_welch.welch_accum_c2c_split_reference(_t(x), _t(y), w, *args)
    np.testing.assert_array_equal(_np(a), _np(b))
    assert a.shape == (2, 512) and num == 28


# ---------------------------------------------------------------------- #
# B16's, B17's, B18's and B21's kernel (welch_acc_fft): two real frames
# transformed as one complex frame (B21: one complex frame a segment), the
# plain version of its passes and epilogue against the JAX kernels in
# interpret mode (inside their envelope: nfft >= 512) or the JAX composed
# form, and float64 numpy
# ---------------------------------------------------------------------- #
# (nperseg, hop) of each frame layout at nfft n
ACC_FRAMES = {"hop<nperseg<nfft": lambda n: (3 * n // 4, n // 4), "hop=nperseg": lambda n: (n, n)}
# (frame layout, batch, segment count, detrend): odd and even counts (B16's
# last frame of an odd count pairs with a zero plane), batch 1 and 3
ACC_CASES = [("hop<nperseg<nfft", (3,), 7, "constant"), ("hop<nperseg<nfft", (1,), 8, False),
             ("hop=nperseg", (1,), 9, False), ("hop=nperseg", (3,), 6, "constant")]


# (the kind c2c, B21's, is in test_torch_welch_c2c.py: its cases at nfft
# 4096 take 22-29 s each, and a file of their own gives them a worker of
# their own under the test run's --dist loadfile)
@pytest.mark.parametrize("case", ACC_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("nfft", [1 << e for e in range(7, 13)])
@pytest.mark.parametrize("kind", ["welch", "coh", "csd"])
def test_acc_passes_match_jax(kind, nfft, case, rng, assert_close):
    layout, lead, num, detrend = case
    nperseg, hop = ACC_FRAMES[layout](nfft)
    t = nperseg + (num - 1) * hop + hop // 3
    x, y, win = inputs(rng, lead, t, nperseg)
    args = (nperseg, hop, nfft, detrend)
    got = ([_np(o) for o in cuda_welch._acc_passes(kind, _t(x), _t(y), _t(win), *args)], num)
    if j_pw.fused_welch_ok(t, *args):
        want = jax_kernel(kind, x, y, win, *args)
    else:  # nfft 128 and 256: the JAX package's composed form
        assert nfft < 512
        want = ([np.asarray(o) for o in _jax_outputs(kind, x, y, win, args)], num)
    check_all(got, want, assert_close, f"{kind} two frames a transform vs JAX")
    check_all(got, numpy_ref(kind, x, y, win, *args), assert_close,
              f"{kind} two frames a transform vs numpy")
    # on the CPU the entry point is the composed form, which the kernel's
    # epilogue equals
    check_all(got, port(kind, x, y, win, *args), assert_close, f"{kind} vs the entry point")


def test_acc_csd_swap_cancels_the_bias(rng, assert_close):
    # B17's design at many segments of two independent signals: the
    # transform's rounding leaks a bias into conj(X) Y that grows as the
    # segment count, while the cross spectrum grows as its square root; the
    # planes swapped on odd segments cancel it (unswapped, 3.5e-5 off
    # float64 here; at nperseg 128 the leak is smaller: 1.5e-5 at 60000
    # segments)
    nperseg, hop, num = 256, 128, 30000
    x, y, win = inputs(rng, (), nperseg + (num - 1) * hop, nperseg)
    args = (nperseg, hop, nperseg, "constant")
    got = ([_np(o) for o in cuda_welch._acc_passes("csd", _t(x), _t(y), _t(win), *args)],
           num)
    check_all(got, numpy_ref("csd", x, y, win, *args), assert_close,
              f"csd two frames a transform at {num} segments vs numpy")


@pytest.mark.parametrize("nfft", [128, 1024, 8192])
def test_acc_half_length_welch_matches_numpy(nfft, rng, assert_close):
    # B16's other design, B20's half-length transform of each frame, against
    # float64 numpy and the pairs of frames (one function, two designs), at
    # an odd segment count
    nperseg, hop = 3 * nfft // 4, nfft // 4
    x, y, win = inputs(rng, (2,), nperseg + 6 * hop + hop // 3, nperseg)
    args = (nperseg, hop, nfft, "constant")
    got = ([_np(cuda_welch._acc_passes("welch", _t(x), None, _t(win), *args, half=True)[0])], 7)
    check_all(got, numpy_ref("welch", x, y, win, *args), assert_close,
              f"half-length welch at nfft {nfft} vs numpy")
    pairs = ([_np(cuda_welch._acc_passes("welch", _t(x), None, _t(win), *args)[0])], 7)
    check_all(got, pairs, assert_close, f"half-length welch at nfft {nfft} vs pairs of frames")


# ---------------------------------------------------------------------- #
# B19's kernel (spec_fft.cu's psd_pairs): the plain version of its passes
# and epilogue (two segments as one complex frame) against the JAX kernel in
# interpret mode (inside its envelope) or the JAX composed form (nfft 128),
# and float64 numpy
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("detrend", [False, "constant"])
@pytest.mark.parametrize("nfft", [128, 1024, 8192])
def test_psd_passes_match_jax(nfft, detrend, rng, assert_close):
    # an odd hop that divides nperseg < nfft (the JAX envelope needs hop |
    # nperseg), and an odd segment count (the pairs' last with a zero plane)
    hop = nfft // 4 - 1
    nperseg = 3 * hop
    x, y, win = inputs(rng, (2,), nperseg + 6 * hop + hop // 3, nperseg)
    args = (nperseg, hop, nfft, detrend)
    if j_pw.fused_welch_ok(x.shape[-1], *args):
        want = jax_kernel("psd", x, y, win, *args)
    else:
        assert nfft < 512
        want = ([np.asarray(_jax_outputs("psd", x, y, win, args)[0])], 7)
    got = ([_np(cuda_welch._psd_passes(_t(x), _t(win), *args))], 7)
    check_all(got, want, assert_close, f"psd's passes at nfft {nfft} vs JAX")
    check_all(got, numpy_ref("psd", x, y, win, *args), assert_close,
              f"psd's passes at nfft {nfft} vs numpy")
    # on the CPU the entry point is the composed form, which the kernel's
    # epilogue equals
    check_all(got, port("psd", x, y, win, *args), assert_close, "psd vs the entry point")


# ---------------------------------------------------------------------- #
# gradients: against jax.grad of the JAX package's composed form
# ---------------------------------------------------------------------- #
def _jax_outputs(kind, x, y, win, args):
    X = j_se._spec_segments_split(x, None, win, *args)
    p = lambda a, b: a * a + b * b  # noqa: E731
    if kind == "psd":
        return [p(*X)]
    if kind == "welch":
        return [jnp.sum(p(*X), axis=-2)]
    Y = j_se._spec_segments_split(y, None, win, *args)
    outs = [jnp.sum(X[0] * Y[0] + X[1] * Y[1], axis=-2),
            jnp.sum(X[0] * Y[1] - X[1] * Y[0], axis=-2)]
    if kind == "coh":
        outs += [jnp.sum(p(*X), axis=-2), jnp.sum(p(*Y), axis=-2)]
    return outs


@pytest.mark.parametrize("kind", KINDS)
def test_gradient_matches_jax_grad(kind, rng, assert_close):
    nperseg, hop, nfft, detrend = 256, 96, 256, "constant"  # hop !| nperseg
    x, y, win = inputs(rng, (2,), 1500, nperseg)
    args = (nperseg, hop, nfft, detrend)
    num = 1 + (1500 - nperseg) // hop
    bins = nfft // 2 + 1
    shape = (2, num, bins) if kind == "psd" else (2, bins)
    ws = [rng.random(shape).astype(np.float32) for _ in range(4)]

    def jloss(a, b):
        outs = _jax_outputs(kind, a, b, jnp.asarray(win), args)
        return sum(jnp.sum(w * o) for w, o in zip(ws, outs))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt, yt = _t(x).requires_grad_(), _t(y).requires_grad_()
    if kind == "welch":
        outs = [cuda_welch.welch_accum_split(xt, _t(win), *args)[0]]
    elif kind == "psd":
        outs = [cuda_welch.spec_psd_split(xt, _t(win), *args)]
    elif kind == "csd":
        outs = cuda_welch.csd_accum_split(xt, yt, _t(win), *args)[:2]
    else:
        outs = cuda_welch.coherence_accum_split(xt, yt, _t(win), *args)[:4]
    sum((_t(w) * o).sum() for w, o in zip(ws, outs)).backward()
    assert_close(_np(xt.grad), np.asarray(want[0]), what=f"{kind} d/dx")
    if kind in ("csd", "coh"):
        assert_close(_np(yt.grad), np.asarray(want[1]), what=f"{kind} d/dy")
    else:
        assert yt.grad is None


def test_c2c_gradient_matches_jax_grad(rng, assert_close):
    nperseg, hop, nfft, detrend = 256, 96, 512, "constant"  # hop !| nperseg, zero pad
    re, im, win = inputs(rng, (2,), 1500, nperseg)
    args = (nperseg, hop, nfft, detrend)
    w = rng.random((2, nfft)).astype(np.float32)

    def jloss(a, b):
        Xr, Xi = j_se._spec_segments_split(a, b, jnp.asarray(win), *args)
        return jnp.sum(w * jnp.sum(Xr * Xr + Xi * Xi, axis=-2))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(re), jnp.asarray(im))
    rt, it = _t(re).requires_grad_(), _t(im).requires_grad_()
    p, _ = cuda_welch.welch_accum_c2c_split(rt, it, _t(win), *args)
    (_t(w) * p).sum().backward()
    assert_close(_np(rt.grad), np.asarray(want[0]), what="c2c d/dre")
    assert_close(_np(it.grad), np.asarray(want[1]), what="c2c d/dim")


# ---------------------------------------------------------------------- #
# B20 and B22: the per-segment spectra
# ---------------------------------------------------------------------- #
def numpy_spec(re, im, win, nperseg, hop, nfft, detrend, roll_s=0, pad_out=False):
    """float64 numpy framing: every segment's spectrum, complex ``[..., num,
    bins]`` (the half spectrum of real input, the two-sided one of
    complex), each zero-padded frame rolled left by roll_s; the mean is
    taken before the roll."""
    v = np.asarray(re, np.float64)
    if im is not None:
        v = v + 1j * np.asarray(im, np.float64)
    num = 1 + (v.shape[-1] - nperseg) // hop
    fr = np.stack([v[..., s * hop: s * hop + nperseg] for s in range(num)], -2)
    if detrend == "constant":
        fr = fr - fr.mean(-1, keepdims=True)
    fr = np.roll(np.pad(fr * win, [(0, 0)] * (fr.ndim - 1) + [(0, nfft - nperseg)]),
                 -roll_s, -1)
    if im is not None:
        return np.fft.fft(fr, axis=-1)
    X = np.fft.rfft(fr, axis=-1)
    if pad_out:
        X = np.pad(X, [(0, 0)] * (X.ndim - 1) + [(0, cuda_welch.cuda_fft.pad_bins(nfft)
                                                   - X.shape[-1])])
    return X


def _c(pair):
    return _np(pair[0]) + 1j * _np(pair[1])


SPEC_OPTS = [(0, False), (77, True), (300, False)]  # (roll_s, pad_out)


@pytest.mark.parametrize("opts", SPEC_OPTS, ids=lambda o: f"roll{o[0]}-pad{int(o[1])}")
@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: "x".join(map(str, c[1:5])))
def test_spec_matches_jax_interpret(case, opts, rng, assert_close):
    lead, t, nperseg, hop, nfft, detrend = case
    roll_s, pad_out = opts
    x, _, win = inputs(rng, lead, t, nperseg)
    args = (nperseg, hop, nfft, detrend)
    Xr, Xi = cuda_welch.spec_rfft_split(_t(x), _t(win), *args, pad_out=pad_out, roll_s=roll_s)
    num = 1 + (t - nperseg) // hop
    bins = cuda_welch.cuda_fft.pad_bins(nfft) if pad_out else nfft // 2 + 1
    assert Xr.shape == Xi.shape == (*lead, num, bins) and Xr.dtype == torch.float32
    jr, ji = j_pw.spec_rfft_split(x, win, *args, pad_out=pad_out, roll_s=roll_s,
                                  interpret=True)
    assert_close(_c((Xr, Xi)), np.asarray(jr) + 1j * np.asarray(ji), what="spec vs JAX")
    assert_close(_c((Xr, Xi)), numpy_spec(x, None, win, *args, roll_s, pad_out),
                 what="spec vs numpy")
    if pad_out:  # the padded form's columns are exact zeros
        assert not Xr[..., nfft // 2 + 1:].any() and not Xi[..., nfft // 2 + 1:].any()
    assert cuda_welch.spec_launches == 0


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: "x".join(map(str, c[1:5])))
def test_spec_c2c_matches_jax_interpret(case, rng, assert_close):
    lead, t, nperseg, hop, nfft, detrend = case
    re, im, win = inputs(rng, lead, t, nperseg)
    args = (nperseg, hop, nfft, detrend)
    Xr, Xi = cuda_welch.spec_c2c_split(_t(re), _t(im), _t(win), *args)
    assert Xr.shape == (*lead, 1 + (t - nperseg) // hop, nfft)
    jr, ji = j_pw.spec_c2c_split(re, im, win, *args, interpret=True)
    assert_close(_c((Xr, Xi)), np.asarray(jr) + 1j * np.asarray(ji), what="spec_c2c vs JAX")
    assert_close(_c((Xr, Xi)), numpy_spec(re, im, win, *args), what="spec_c2c vs numpy")
    assert cuda_welch.spec_c2c_launches == 0


@pytest.mark.parametrize("case", PORT_CASES, ids=lambda c: "x".join(map(str, c[1:5])))
def test_spec_outside_jax_envelope(case, rng, assert_close):
    lead, t, nperseg, hop, nfft, detrend = case
    x, y, win = inputs(rng, lead, t, nperseg)
    args = (nperseg, hop, nfft, detrend)
    for roll_s, pad_out in SPEC_OPTS:
        roll_s %= nfft
        got = cuda_welch.spec_rfft_split(_t(x), _t(win), *args, pad_out=pad_out,
                                         roll_s=roll_s)
        assert_close(_c(got), numpy_spec(x, None, win, *args, roll_s, pad_out),
                     what=f"spec roll {roll_s} pad {pad_out} vs numpy")
    got = cuda_welch.spec_c2c_split(_t(x), _t(y), _t(win), *args)
    assert_close(_c(got), numpy_spec(x, y, win, *args), what="spec_c2c vs numpy")
    # the JAX package's composed per-segment spectra, real and complex
    for im in (None, y):
        want = j_se._spec_segments_split(x, im, jnp.asarray(win), *args)
        got = (cuda_welch.spec_rfft_split(_t(x), _t(win), *args) if im is None
               else cuda_welch.spec_c2c_split(_t(x), _t(y), _t(win), *args))
        assert_close(_c(got), np.asarray(want[0]) + 1j * np.asarray(want[1]),
                     what="vs JAX composed")


def test_spec_plain_versions_equal_entry_points_on_cpu(rng):
    x, y, win = inputs(rng, (2,), 3000, 256)
    w, args = _t(win), (256, 100, 512, "constant")
    for a, b in zip(cuda_welch.spec_rfft_split(_t(x), w, *args, pad_out=True, roll_s=5),
                    cuda_welch.spec_rfft_split_reference(_t(x), w, *args, pad_out=True,
                                                         roll_s=5)):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(cuda_welch.spec_c2c_split(_t(x), _t(y), w, *args),
                    cuda_welch.spec_c2c_split_reference(_t(x), _t(y), w, *args)):
        np.testing.assert_array_equal(_np(a), _np(b))
        assert a.shape == (2, 28, 512)


def test_spec_outside_envelope_raises():
    x, w = torch.zeros(4096), torch.ones(512)
    with pytest.raises(cuda_welch.Unsupported):
        cuda_welch.spec_rfft_split(x, w, 512, 256, 512, "linear")
    with pytest.raises(cuda_welch.Unsupported):
        cuda_welch.spec_c2c_split(x, torch.zeros(4095), w, 512, 256, 512, False)
    with pytest.raises(cuda_welch.Unsupported):
        cuda_welch.spec_c2c_split(x, x, w, 512, 256, 1000, False)
    for roll_s in (-1, 512):
        with pytest.raises(ValueError, match="roll_s"):
            cuda_welch.spec_rfft_split(x, w, 512, 256, 512, False, roll_s=roll_s)


def _j_spec_rolled(x, win, nperseg, hop, nfft, detrend, roll_s, pad_out):
    """The JAX package's composed framed R2C with a roll: its framing,
    detrend, window, zero pad, jnp.roll and R2C."""
    fr = j_se._detrend_seg(j_frame(x, nperseg, hop), detrend) * win
    fr = jnp.pad(fr, [(0, 0)] * (fr.ndim - 1) + [(0, nfft - nperseg)])
    return j_rfft_last_split(jnp.roll(fr, -roll_s, axis=-1), None, pad_out=pad_out)


@pytest.mark.parametrize("opts", SPEC_OPTS[:2], ids=lambda o: f"roll{o[0]}-pad{int(o[1])}")
def test_spec_gradient_matches_jax_grad(opts, rng, assert_close):
    roll_s, pad_out = opts
    nperseg, hop, nfft, detrend = 200, 96, 256, "constant"  # hop !| nperseg, zero pad
    x, _, win = inputs(rng, (2,), 1500, nperseg)
    args = (nperseg, hop, nfft, detrend)
    num = 1 + (1500 - nperseg) // hop
    bins = cuda_welch.cuda_fft.pad_bins(nfft) if pad_out else nfft // 2 + 1
    wr, wi = (rng.random((2, num, bins)).astype(np.float32) for _ in range(2))

    def jloss(a):
        Xr, Xi = _j_spec_rolled(a, jnp.asarray(win), *args, roll_s, pad_out)
        return jnp.sum(wr * Xr * Xr + wi * Xi)

    want = jax.grad(jloss)(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    Xr, Xi = cuda_welch.spec_rfft_split(xt, _t(win), *args, pad_out=pad_out, roll_s=roll_s)
    (_t(wr) * Xr * Xr + _t(wi) * Xi).sum().backward()
    assert_close(_np(xt.grad), np.asarray(want), what="spec d/dx")


def test_spec_c2c_gradient_matches_jax_grad(rng, assert_close):
    nperseg, hop, nfft, detrend = 256, 96, 512, "constant"
    re, im, win = inputs(rng, (2,), 1500, nperseg)
    args = (nperseg, hop, nfft, detrend)
    num = 1 + (1500 - nperseg) // hop
    wr, wi = (rng.random((2, num, nfft)).astype(np.float32) for _ in range(2))

    def jloss(a, b):
        Xr, Xi = j_se._spec_segments_split(a, b, jnp.asarray(win), *args)
        return jnp.sum(wr * Xr * Xr + wi * Xi * Xr)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(re), jnp.asarray(im))
    rt, it = _t(re).requires_grad_(), _t(im).requires_grad_()
    Xr, Xi = cuda_welch.spec_c2c_split(rt, it, _t(win), *args)
    (_t(wr) * Xr * Xr + _t(wi) * Xi * Xr).sum().backward()
    assert_close(_np(rt.grad), np.asarray(want[0]), what="spec_c2c d/dre")
    assert_close(_np(it.grad), np.asarray(want[1]), what="spec_c2c d/dim")


# B20's complex64 sink (spec_rfft_c64) and the plain version of the
# kernel's own passes, against the JAX kernel in interpret mode, merged
SPEC_C64_CASES = [((2,), 4096, 512, 256, 512, "constant", 77),  # a roll, ragged last block
                  ((), 3000, 255, 85, 512, "constant", 0),      # odd nperseg < nfft
                  ((), 4096, 512, 128, 1024, None, 300)]        # nfft pad, an even roll


@pytest.mark.parametrize("case", SPEC_C64_CASES, ids=lambda c: "x".join(map(str, c[1:5])))
def test_spec_c64_matches_jax_interpret(case, rng, assert_close):
    lead, t, nperseg, hop, nfft, detrend, roll_s = case
    x, _, win = inputs(rng, lead, t, nperseg)
    args = (nperseg, hop, nfft, detrend)
    jr, ji = j_pw.spec_rfft_split(x, win, *args, roll_s=roll_s, interpret=True)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    got = cuda_welch.spec_rfft_c64(_t(x), _t(win), *args, roll_s=roll_s)
    assert got.dtype == torch.complex64 and got.shape == (*lead, 1 + (t - nperseg) // hop,
                                                          nfft // 2 + 1)
    assert_close(_np(got), want, what="spec_rfft_c64 vs JAX")
    passes = cuda_welch._spec_passes(_t(x), _t(win), *args, roll_s)
    assert_close(_np(passes), want, what="the kernel's passes vs JAX")
    plain = cuda_welch.spec_rfft_c64_reference(_t(x), _t(win), *args, roll_s=roll_s)
    np.testing.assert_array_equal(_np(plain), _np(got))
    assert cuda_welch.spec_launches == cuda_welch.spec_c64_launches == 0


@pytest.mark.parametrize("nfft,hop", [(512, 128), (256, 100)])
def test_spec_c64_reflect_pad_matches_jax_interpret(nfft, hop, rng, assert_close):
    # stft's centering: the reflect pad of nfft/2 points at each end, which
    # the kernel reads in place, against the JAX kernel on the padded signal
    x, _, win = inputs(rng, (2,), 3000, nfft)
    pad = nfft // 2
    xp = np.pad(x, [(0, 0), (pad, pad)], mode="reflect")
    args = (nfft, hop, nfft, False)
    got = cuda_welch.spec_rfft_c64(_t(x), _t(win), *args, pad=pad)
    if 512 <= nfft:
        jr, ji = j_pw.spec_rfft_split(xp, win, *args, interpret=True)
        want = np.asarray(jr) + 1j * np.asarray(ji)
    else:  # below the JAX kernel's envelope: its composed framing
        want = numpy_spec(xp, None, win, *args)
    assert_close(_np(got), want, what="padded")
    assert_close(_np(cuda_welch._spec_passes(_t(x), _t(win), *args, pad=pad)), want,
                 what="the kernel's passes, padded")
    with pytest.raises(ValueError, match="pad"):
        cuda_welch.spec_rfft_c64(_t(x), _t(win), *args, pad=3000)


def test_spec_c64_gradient_matches_jax_grad(rng, assert_close):
    nperseg, hop, nfft, detrend, roll_s = 200, 96, 256, "constant", 77
    x, _, win = inputs(rng, (2,), 1500, nperseg)
    args = (nperseg, hop, nfft, detrend)
    num = 1 + (1500 - nperseg) // hop
    wr, wi = (rng.random((2, num, nfft // 2 + 1)).astype(np.float32) for _ in range(2))

    def jloss(a):
        Xr, Xi = _j_spec_rolled(a, jnp.asarray(win), *args, roll_s, False)
        return jnp.sum(wr * Xr * Xr + wi * Xi)

    want = jax.grad(jloss)(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    X = cuda_welch.spec_rfft_c64(xt, _t(win), *args, roll_s=roll_s)
    (_t(wr) * X.real * X.real + _t(wi) * X.imag).sum().backward()
    assert_close(_np(xt.grad), np.asarray(want), what="spec_rfft_c64 d/dx")


# B22's complex64 entry (spec_c2c_c64) from each of its sources, and the
# plain version of the kernel's own passes, against the JAX kernel in
# interpret mode, merged; a real source is the JAX kernel's with a zero
# imaginary plane
C2C_SOURCES = ("c64", "planes", "real")


@pytest.mark.parametrize("scale", [None, 0.25])
@pytest.mark.parametrize("source", C2C_SOURCES)
@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: "x".join(map(str, c[1:5])))
def test_spec_c2c_c64_matches_jax_interpret(case, source, scale, rng, assert_close):
    lead, t, nperseg, hop, nfft, detrend = case
    re, im, win = inputs(rng, lead, t, nperseg)
    if source == "real":
        im = np.zeros_like(re)
    args = (nperseg, hop, nfft, detrend)
    jr, ji = j_pw.spec_c2c_split(re, im, win, *args, interpret=True)
    want = (np.asarray(jr) + 1j * np.asarray(ji)) * (1.0 if scale is None else scale)
    x, y = {"c64": (_t(re + 1j * im), None), "planes": (_t(re), _t(im)),
            "real": (_t(re), None)}[source]
    got = cuda_welch.spec_c2c_c64(x, _t(win), *args, scale=scale, im=y)
    assert got.dtype == torch.complex64 and got.shape == (*lead, 1 + (t - nperseg) // hop,
                                                          nfft)
    assert_close(_np(got), want, what=f"spec_c2c_c64 {source} vs JAX")
    assert_close(_np(cuda_welch._spec_c2c_passes(x, y, _t(win), *args, scale)), want,
                 what=f"the kernel's passes, {source}, vs JAX")
    plain = cuda_welch.spec_c2c_c64_reference(x, _t(win), *args, scale=scale, im=y)
    np.testing.assert_array_equal(_np(plain), _np(got))
    assert cuda_welch.spec_c2c_launches == cuda_welch.spec_c2c_c64_launches == 0


@pytest.mark.parametrize("case", PORT_CASES, ids=lambda c: "x".join(map(str, c[1:5])))
def test_spec_c2c_c64_outside_jax_envelope(case, rng, assert_close):
    lead, t, nperseg, hop, nfft, detrend = case
    x, y, win = inputs(rng, lead, t, nperseg)
    args = (nperseg, hop, nfft, detrend)
    want = numpy_spec(x, y, win, *args)
    for got in (cuda_welch.spec_c2c_c64(_t(x + 1j * y), _t(win), *args),
                cuda_welch.spec_c2c_c64(_t(x), _t(win), *args, im=_t(y)),
                cuda_welch._spec_c2c_passes(_t(x + 1j * y), None, _t(win), *args)):
        assert_close(_np(got), want, what="spec_c2c_c64 vs numpy")
    assert_close(_np(cuda_welch.spec_c2c_c64(_t(x), _t(win), *args)),
                 numpy_spec(x, np.zeros_like(x), win, *args), what="real source vs numpy")


def test_spec_c2c_c64_envelope_raises():
    z, w = torch.zeros(4096, dtype=torch.complex64), torch.ones(512)
    with pytest.raises(cuda_welch.Unsupported):
        cuda_welch.spec_c2c_c64(z, w, 512, 256, 512, "linear")
    with pytest.raises(cuda_welch.Unsupported):
        cuda_welch.spec_c2c_c64(z, w, 512, 256, 1000, False)
    with pytest.raises(ValueError, match="complex64"):
        cuda_welch.spec_c2c_c64(z.to(torch.complex128), w, 512, 256, 512, False)
    with pytest.raises(ValueError, match="real x"):  # an im plane beside complex input
        cuda_welch.spec_c2c_c64(z, w, 512, 256, 512, False, im=torch.zeros(4096))
    with pytest.raises(ValueError, match="real float32"):  # only B22 takes complex64
        cuda_welch.spec_c2c_split(z, torch.zeros(4096), w, 512, 256, 512, False)


@pytest.mark.parametrize("source", ["c64", "real"])
def test_spec_c2c_c64_gradient_matches_jax_grad(source, rng, assert_close):
    nperseg, hop, nfft, detrend = 256, 96, 512, "constant"
    re, im, win = inputs(rng, (2,), 1500, nperseg)
    args = (nperseg, hop, nfft, detrend)
    num = 1 + (1500 - nperseg) // hop
    wr, wi = (rng.random((2, num, nfft)).astype(np.float32) for _ in range(2))

    def jloss(a, b):
        Xr, Xi = j_se._spec_segments_split(a, b, jnp.asarray(win), *args)
        return jnp.sum(wr * (0.5 * Xr) ** 2 + wi * (0.5 * Xi) * (0.5 * Xr))

    if source == "c64":
        want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(re), jnp.asarray(im))
        xt = _t(re + 1j * im).requires_grad_()
    else:  # the real signal taken two-sided: JAX's composed form with a zero plane
        want = (jax.grad(jloss)(jnp.asarray(re), jnp.zeros_like(re)),)
        xt = _t(re).requires_grad_()
    X = cuda_welch.spec_c2c_c64(xt, _t(win), *args, scale=0.5)
    (_t(wr) * X.real * X.real + _t(wi) * X.imag * X.real).sum().backward()
    assert_close(_np(xt.grad.real), np.asarray(want[0]), what=f"spec_c2c_c64 d/dre {source}")
    if source == "c64":
        assert_close(_np(xt.grad.imag), np.asarray(want[1]), what="spec_c2c_c64 d/dim")


# ---------------------------------------------------------------------- #
# B21's complex64 entry (welch_accum_c2c_c64) from each of its sources,
# against the JAX kernel in interpret mode (a real source is the JAX
# kernel's with a zero imaginary plane) and float64 numpy, its gradient,
# and the two-sided welch's routes to it
# ---------------------------------------------------------------------- #
def _c2c_source(source, re, im):
    return {"c64": (_t(re + 1j * im), None), "planes": (_t(re), _t(im)),
            "real": (_t(re), None)}[source]


@pytest.mark.parametrize("source", C2C_SOURCES)
@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: "x".join(map(str, c[1:5])))
def test_welch_accum_c2c_c64_matches_jax_interpret(case, source, rng, assert_close):
    lead, t, nperseg, hop, nfft, detrend = case
    re, im, win = inputs(rng, lead, t, nperseg)
    if source == "real":
        im = np.zeros_like(re)
    args = (nperseg, hop, nfft, detrend)
    want, wnum = j_pw.welch_accum_c2c_split(re, im, win, *args, interpret=True)
    x, y = _c2c_source(source, re, im)
    got, num = cuda_welch.welch_accum_c2c_c64(x, _t(win), *args, im=y)
    assert num == wnum and got.shape == (*lead, nfft) and got.dtype == torch.float32
    assert_close(_np(got), np.asarray(want), what=f"welch_accum_c2c_c64 {source} vs JAX")
    plain, pnum = cuda_welch.welch_accum_c2c_c64_reference(x, _t(win), *args, im=y)
    np.testing.assert_array_equal(_np(plain), _np(got))
    assert pnum == num
    assert cuda_welch.c2c_launches == cuda_welch.c2c_c64_launches == 0


@pytest.mark.parametrize("case", PORT_CASES, ids=lambda c: "x".join(map(str, c[1:5])))
def test_welch_accum_c2c_c64_outside_jax_envelope(case, rng, assert_close):
    lead, t, nperseg, hop, nfft, detrend = case
    re, im, win = inputs(rng, lead, t, nperseg)
    args = (nperseg, hop, nfft, detrend)
    for source in C2C_SOURCES:
        x, y = _c2c_source(source, re, im)
        want, wnum = numpy_c2c(re, np.zeros_like(re) if source == "real" else im, win, *args)
        got, num = cuda_welch.welch_accum_c2c_c64(x, _t(win), *args, im=y)
        assert num == wnum
        assert_close(_np(got), want, what=f"welch_accum_c2c_c64 {source} vs numpy")


def test_welch_accum_c2c_c64_envelope_raises():
    z, w = torch.zeros(4096, dtype=torch.complex64), torch.ones(512)
    with pytest.raises(cuda_welch.Unsupported):
        cuda_welch.welch_accum_c2c_c64(z, w, 512, 256, 512, "linear")
    with pytest.raises(cuda_welch.Unsupported):
        cuda_welch.welch_accum_c2c_c64_reference(z, w, 512, 256, 1000, False)
    with pytest.raises(ValueError, match="complex64"):
        cuda_welch.welch_accum_c2c_c64(z.to(torch.complex128), w, 512, 256, 512, False)
    with pytest.raises(ValueError, match="real x"):  # an im plane beside complex input
        cuda_welch.welch_accum_c2c_c64(z, w, 512, 256, 512, False, im=torch.zeros(4096))
    with pytest.raises(cuda_welch.Unsupported):  # planes of two shapes
        cuda_welch.welch_accum_c2c_c64(z.real, w, 512, 256, 512, False, im=torch.zeros(4095))


@pytest.mark.parametrize("source", ["c64", "real"])
def test_welch_accum_c2c_c64_gradient_matches_jax_grad(source, rng, assert_close):
    nperseg, hop, nfft, detrend = 256, 96, 512, "constant"  # hop !| nperseg, zero pad
    re, im, win = inputs(rng, (2,), 1500, nperseg)
    args = (nperseg, hop, nfft, detrend)
    w = rng.random((2, nfft)).astype(np.float32)

    def jloss(a, b):
        Xr, Xi = j_se._spec_segments_split(a, b, jnp.asarray(win), *args)
        return jnp.sum(w * jnp.sum(Xr * Xr + Xi * Xi, axis=-2))

    if source == "c64":
        want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(re), jnp.asarray(im))
        xt = _t(re + 1j * im).requires_grad_()
    else:  # the real signal taken two-sided: JAX's composed form with a zero plane
        want = (jax.grad(jloss)(jnp.asarray(re), jnp.zeros_like(re)),)
        xt = _t(re).requires_grad_()
    p, _ = cuda_welch.welch_accum_c2c_c64(xt, _t(win), *args)
    (_t(w) * p).sum().backward()
    assert_close(_np(xt.grad.real), np.asarray(want[0]), what=f"c2c_c64 d/dre {source}")
    if source == "c64":
        assert_close(_np(xt.grad.imag), np.asarray(want[1]), what="c2c_c64 d/dim")


@pytest.mark.parametrize("card", [False, True], ids=["composed", "kernel route"])
@pytest.mark.parametrize("source", ["c64", "real"])
def test_two_sided_welch_matches_jax(source, card, rng, monkeypatch, assert_close):
    """ft.welch of a complex64 signal and of a real one with
    return_onesided=False equals the JAX package's on the CPU, by the
    composed route and by the card's (CPU tensors taken for card ones):
    B21's complex64 entry, on the caller's complex64 tensor as it lies or
    on the real signal with no imaginary plane."""
    from fft_wgpu_tpu_torch.ops import spectral_est

    calls = []
    entry = cuda_welch.welch_accum_c2c_c64
    monkeypatch.setattr(spectral_est, "_on_card", lambda t: card)
    monkeypatch.setattr(cuda_welch, "welch_accum_c2c_c64", lambda x, *a, **k: calls.append(
        (x.dtype, k.get("im") is None)) or entry(x, *a, **k))
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    if source == "c64":
        x = (x + 1j * rng.standard_normal((2, 3000))).astype(np.complex64)
    kw = {"nperseg": 512, "noverlap": 384, "return_onesided": False}
    f, P = ft.welch(_t(x), **kw)
    jf, jP = j_se.welch(x, **kw)
    assert P.dtype == torch.float32 and P.shape == (2, 512)
    assert_close(_np(f), np.asarray(jf), what="frequencies")
    assert_close(_np(P), np.asarray(jP), what=f"two-sided welch {source}")
    dtype = torch.complex64 if source == "c64" else torch.float32
    assert calls == ([(dtype, True)] if card else [])

