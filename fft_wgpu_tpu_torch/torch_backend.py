"""Opt-in ``torch.fft`` acceleration: route ``torch.fft.*`` through this
package's kernels (the port's counterpart of ``fft_wgpu_tpu.jnp_backend``,
which patches ``jax.numpy.fft``).  Usage::

    import fft_wgpu_tpu_torch.torch_backend as tb

    tb.install()          # process-global: torch.fft.fft etc. now route here
    tb.uninstall()        # restore stock torch.fft

    with tb.accelerated():  # scoped
        X = torch.fft.fft(x)

The 14 names of ``jnp_backend`` are patched: ``fft``, ``ifft``, ``fft2``,
``ifft2``, ``fftn``, ``ifftn``, ``rfft``, ``irfft``, ``rfft2``,
``irfft2``, ``rfftn``, ``irfftn``, ``hfft`` and ``ihfft``; torch's
``dim`` is the package's ``axis``/``axes``.  A call falls back to stock
``torch.fft`` when its input is 64-bit (the package computes in float32),
when it passes ``out=``, or when it uses a signature the package does not
express.  A call the package refuses (a length below 1, a bad norm or axis)
raises what stock ``torch.fft`` raises for it: stock's own error, found by
running stock on a ``meta`` copy of the input (shapes only: no data is read
and nothing launches).  Where stock would not raise, the package's error
propagates, so a fault of a kernel is never hidden behind stock.
Gradients flow through the package's kernels.  Nothing in the
package itself calls ``torch.fft``, so an installed patch never feeds back
into it.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["install", "uninstall", "accelerated"]

_FUNCS = (
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft",
)
_ONE_D = ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft")
_C2R = ("irfft2", "irfftn")

_originals: dict[str, object] = {}
_install_count = 0  # nesting refcount: uninstall only at zero


def _wide(a) -> bool:
    dt = a.dtype if isinstance(a, torch.Tensor) else torch.as_tensor(a).dtype
    return dt in (torch.float64, torch.complex128)


def _bind(args, kwargs, names, defaults) -> dict:
    """torch.fft's positional and keyword arguments after the input, by
    name; TypeError for any it does not take."""
    if len(args) > len(names):
        raise TypeError("too many arguments")
    vals = dict(zip(names, defaults))
    vals.update(zip(names, args))
    for k, v in kwargs.items():
        if k not in names[len(args):]:
            raise TypeError(f"unexpected keyword {k!r}")
        vals[k] = v
    return vals


def _stock_error(orig, input, args, kwargs):
    """The exception stock ``torch.fft`` raises for the call, from a ``meta``
    copy of ``input``; None where it would not raise."""
    if not isinstance(input, torch.Tensor):
        return None
    try:
        orig(torch.empty_like(input, device="meta"), *args, **kwargs)
    except Exception as err:  # noqa: BLE001 - stock's error, whatever its class
        return err
    return None


def _wrap(name, ours, orig):
    if name in _ONE_D:
        names, defaults = ("n", "dim", "norm"), (None, -1, None)
    else:
        names = ("s", "dim", "norm")
        defaults = (None, (-2, -1) if name.endswith("2") else None, None)

    @functools.wraps(orig)
    def accelerated_fn(input, *args, **kwargs):
        if _wide(input) or kwargs.get("out") is not None:
            return orig(input, *args, **kwargs)
        kw = {k: v for k, v in kwargs.items() if k != "out"}
        try:
            a = _bind(args, kw, names, defaults)
        except TypeError:
            # a signature the package doesn't express: stock fallback
            return orig(input, *args, **kwargs)
        s = a.get("s")
        if name in _C2R and s is not None and s[-1] == -1:
            # torch.fft's -1 here is the default length 2 * (bins - 1), where
            # numpy's (and the package's) is the axis's length as it lies
            s = [*s[:-1], None]
        try:
            if name in _ONE_D:
                return ours(input, n=a["n"], axis=a["dim"], norm=a["norm"])
            return ours(input, s=s, axes=a["dim"], norm=a["norm"])
        except Exception as err:
            stock = _stock_error(orig, input, args, kwargs)
            if stock is None:  # stock would return: the package's error stands
                raise
            raise stock from err

    accelerated_fn.__wrapped_by_fft_wgpu_tpu_torch__ = True
    return accelerated_fn


def install() -> None:
    """Patch ``torch.fft`` so the listed transforms route through
    fft_wgpu_tpu_torch.  Nestable: each install() must be balanced by one
    uninstall(); the patch is removed only when the count reaches zero (so
    an inner accelerated() block cannot strip an outer install())."""
    global _install_count
    import fft_wgpu_tpu_torch as ft

    _install_count += 1
    for name in _FUNCS:
        cur = getattr(torch.fft, name)
        if getattr(cur, "__wrapped_by_fft_wgpu_tpu_torch__", False):
            continue  # already installed
        _originals[name] = cur
        setattr(torch.fft, name, _wrap(name, getattr(ft, name), cur))


def uninstall() -> None:
    """Balance one install(); restore stock torch.fft at zero."""
    global _install_count
    if _install_count == 0:
        return
    _install_count -= 1
    if _install_count > 0:
        return
    for name, orig in list(_originals.items()):
        setattr(torch.fft, name, orig)
        del _originals[name]


@contextlib.contextmanager
def accelerated():
    """Scoped install()/uninstall() (exception-safe)."""
    install()
    try:
        yield
    finally:
        uninstall()
