"""Torch port, the interop backends: ``scipy_backend`` against
``fft_wgpu_tpu.scipy_backend`` (``tests/test_helpers.py``'s calls) and
``torch_backend`` against ``fft_wgpu_tpu.jnp_backend`` (stock
``torch.fft`` patched, values taken outside the scope), on the CPU.
Tolerance 1e-5 relative L2 (the ``assert_close`` fixture).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft as sf
import torch

import fft_wgpu_tpu.jnp_backend as jb
import fft_wgpu_tpu.scipy_backend as j_be
import fft_wgpu_tpu_torch.scipy_backend as be
import fft_wgpu_tpu_torch.torch_backend as tb

torch.set_num_threads(1)


def test_scipy_backend_matches_jax(rng, assert_close):
    x = rng.standard_normal((4, 64)).astype(np.float32)
    z = (rng.standard_normal(32) + 1j * rng.standard_normal(32)).astype(np.complex64)
    want_dct_o = sf.dct(np.asarray(x, np.float64), type=2, norm="ortho",
                        orthogonalize=False).astype(np.float32)
    with sf.set_backend(j_be):
        jax_out = (sf.fft(z), sf.rfft(x), sf.dct(x, type=2, norm="ortho"),
                   sf.ifft2(x.astype(np.complex64)), sf.irfft(sf.rfft(x), n=64))
    cpu = be.on("cpu")
    with sf.set_backend(cpu):
        got = (sf.fft(z), sf.rfft(x), sf.dct(x, type=2, norm="ortho"),
               sf.ifft2(x.astype(np.complex64)), sf.irfft(sf.rfft(x), n=64))
        # an unsupported keyword falls back to pocketfft instead of raising
        assert_close(sf.dct(x, type=2, norm="ortho", orthogonalize=False), want_dct_o)
        # advisory keywords are ignored
        assert_close(sf.fft(z, workers=4, overwrite_x=True), np.fft.fft(z))
    for g, w in zip(got, jax_out):
        assert isinstance(g, np.ndarray) and g.shape == np.shape(w)
        assert_close(g, w)
    assert_close(got[0], np.fft.fft(z))
    assert repr(cpu) == "scipy_backend.on('cpu')"


def test_scipy_backend_module_uses_the_card(rng, monkeypatch):
    # the module itself computes on the current CUDA device: with none it
    # raises rather than running on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with sf.set_backend(be, only=True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sf.fft(np.ones(16, np.complex64))
    assert be.__ua_domain__ == j_be.__ua_domain__ == "numpy.scipy.fft"


def test_torch_backend_install_uninstall_balance():
    stock = torch.fft.fft
    tb.install()
    assert torch.fft.fft is not stock
    assert getattr(torch.fft.fft, "__wrapped_by_fft_wgpu_tpu_torch__", False)
    tb.install()  # nested: refcounted
    tb.uninstall()
    assert getattr(torch.fft.fft, "__wrapped_by_fft_wgpu_tpu_torch__", False)
    tb.uninstall()
    assert torch.fft.fft is stock
    tb.uninstall()  # over-release is a no-op
    assert torch.fft.fft is stock
    tb.install()
    with tb.accelerated():
        pass
    assert getattr(torch.fft.fft, "__wrapped_by_fft_wgpu_tpu_torch__", False)
    tb.uninstall()
    assert torch.fft.fft is stock
    assert len(tb._FUNCS) == len(jb._FUNCS) == 14 and set(tb._FUNCS) == set(jb._FUNCS)


def test_torch_backend_matches_jnp_backend(rng, assert_close, monkeypatch):
    x = (rng.standard_normal((4, 256)) + 1j * rng.standard_normal((4, 256))).astype(np.complex64)
    r = rng.standard_normal((3, 128)).astype(np.float32)
    p = rng.standard_normal((16, 32)).astype(np.float32)
    with jb.accelerated():
        want = [np.asarray(jnp.fft.fft(x)), np.asarray(jnp.fft.rfft(r)),
                np.asarray(jnp.fft.fft2(p)), np.asarray(jnp.fft.irfft(jnp.fft.rfft(r), n=128)),
                np.asarray(jnp.fft.ifft(x, norm="ortho")), np.asarray(jnp.fft.rfftn(p))]
    launched = []
    import fft_wgpu_tpu_torch as ft

    real_fft = ft.fft
    monkeypatch.setattr(ft, "fft", lambda *a, **k: launched.append(1) or real_fft(*a, **k))
    with tb.accelerated():
        got = [torch.fft.fft(torch.from_numpy(x)), torch.fft.rfft(torch.from_numpy(r)),
               torch.fft.fft2(torch.from_numpy(p)),
               torch.fft.irfft(torch.fft.rfft(torch.from_numpy(r)), n=128),
               torch.fft.ifft(torch.from_numpy(x), norm="ortho"),
               torch.fft.rfftn(torch.from_numpy(p))]
    assert launched  # fft went through the package
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        assert_close(g, w)


def test_torch_backend_falls_back_to_stock(rng, monkeypatch):
    import fft_wgpu_tpu_torch as ft

    def boom(*a, **k):
        raise AssertionError("the package was called")

    x64 = torch.from_numpy(rng.standard_normal((2, 64)))  # float64: stock
    want = torch.fft.fft(x64)
    with tb.accelerated():
        monkeypatch.setattr(ft, "fft", boom)
        tb.uninstall()
        tb.install()  # re-wrap with the patched function
        got = torch.fft.fft(x64)
        assert got.dtype == torch.complex128 and torch.equal(got, want)
        out = torch.empty(2, 64, dtype=torch.complex64)
        torch.fft.fft(x64.float(), out=out)  # out=: stock
        with pytest.raises(TypeError):
            torch.fft.fft(x64.float(), 64, -1, None, 5)  # stock raises too
    assert not getattr(torch.fft.fft, "__wrapped_by_fft_wgpu_tpu_torch__", False)


def test_torch_backend_propagates_the_package_s_errors(rng, monkeypatch):
    # a TypeError raised inside the package's own call reaches the caller:
    # only a signature the package cannot express goes to stock torch.fft
    import fft_wgpu_tpu_torch as ft

    def broken(*a, **k):
        raise TypeError("raised by the package")

    x = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    with tb.accelerated():
        monkeypatch.setattr(ft, "rfft", broken)
        tb.uninstall()
        tb.install()  # re-wrap with the patched function
        with pytest.raises(TypeError, match="raised by the package"):
            torch.fft.rfft(x)
        with pytest.raises(TypeError, match="raised by the package"):
            torch.fft.rfft(x, n=64, dim=-1, norm="ortho")
    assert not getattr(torch.fft.rfft, "__wrapped_by_fft_wgpu_tpu_torch__", False)


def test_torch_backend_gradient(rng, assert_close):
    x = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((2, 129)).astype(np.float32))
    with tb.accelerated():
        (torch.fft.rfft(x).abs() ** 2 * w).sum().backward()
    got = x.grad.clone()
    x.grad = None
    (torch.fft.rfft(x.double()).abs() ** 2 * w.double()).sum().backward()
    assert_close(got.numpy(), x.grad.numpy())


# C6 (ROADMAP §C) through the backends: a zero output length raises what the
# library it stands in for raises, and never returns where that raises
ZERO_LENGTH_CALLS = [("irfft", {}, (3, 1)), ("irfft", {"norm": "forward"}, (3, 1)),
                     ("hfft", {}, (3, 1)), ("irfft2", {}, (3, 1)),
                     ("irfftn", {"s": (3, 0)}, (3, 4)), ("fftn", {"s": (3, 0)}, (3, 4)),
                     ("fftn", {"s": (3, 0), "norm": "forward"}, (3, 4))]


@pytest.mark.parametrize("name,kw,shape", ZERO_LENGTH_CALLS)
def test_torch_backend_zero_length_raises_as_stock(name, kw, shape, rng):
    # under accelerated(), torch.fft.irfft of a [3, 1] complex64 raised
    # ZeroDivisionError, and returned [3, 1] with norm="forward"; stock
    # torch.fft raises RuntimeError for each
    x = torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
                          ).astype(np.complex64))
    with pytest.raises(RuntimeError) as stock:
        getattr(torch.fft, name)(x, **kw)
    with tb.accelerated():
        with pytest.raises(RuntimeError) as got:
            getattr(torch.fft, name)(x, **kw)
    assert str(got.value) == str(stock.value)
    assert isinstance(got.value.__cause__, ValueError)  # the package's own check


def test_torch_backend_keeps_the_package_error_where_stock_returns(monkeypatch):
    # a fault of the package is never hidden behind stock torch.fft: where
    # stock would return, the package's error propagates as it is
    import fft_wgpu_tpu_torch as ft

    def broken(*a, **k):
        raise ZeroDivisionError("a fault")

    monkeypatch.setattr(ft, "fft", broken)
    with tb.accelerated():
        with pytest.raises(ZeroDivisionError, match="a fault"):
            torch.fft.fft(torch.ones(3, 8, dtype=torch.complex64))


# (scipy.fft itself returns [3, 1] for irfft2 of one bin: test_torch_edges.py
# lists that difference)
@pytest.mark.parametrize("name,kw,shape", [c for c in ZERO_LENGTH_CALLS if c[0] != "irfft2"])
def test_scipy_backend_zero_length_raises_as_scipy(name, kw, shape, rng):
    # scipy.fft raises ValueError for these; through the backend they raised
    # ZeroDivisionError or returned [3, 1]
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    with pytest.raises(ValueError):
        getattr(sf, name)(x, **kw)
    with sf.set_backend(be.on("cpu")):
        with pytest.raises(ValueError, match="fft length must be >= 1, got 0"):
            getattr(sf, name)(x, **kw)
