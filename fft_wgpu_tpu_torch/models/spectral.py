"""Spectral models built on the FFT stack (torch port of
``fft_wgpu_tpu.models.spectral``): Fourier Neural Operator style spectral
convolution layers in 1-D, 2-D and 3-D, and one SGD training step by
autograd through the transforms.

Each model is an ``nn.Module`` whose parameters carry the JAX pytree's
names and shapes: ``lift [in, width]``, ``proj [width, out]`` and
``blocks[i].{wr, wi, pw, b}``, the spectral weights as split real tensors.
A model is the lift, then ``depth`` x (spectral conv + pointwise + bias,
GELU), then the projection.  GELU is the tanh form (``jax.nn.gelu``'s
default, which the JAX model uses), not torch's exact erf form.

The spectral convs are the JAX model's own: FNO1d multiplies the first
``modes`` bins of ``rfft`` along the sequence and returns ``irfft``;
FNO2d and FNO3d keep only the low corner ``[:m1, :m2(, :m3)]`` of the full
``fft2`` / ``fftn`` spectrum of the real field and take the real part of
the inverse.  On a CUDA tensor FNO1d runs the R2C kernel's complex64 sink
and the C2R kernel's complex64 source; FNO2d and FNO3d the fused-plane
kernel (planar forward, the real field promoted; complex64 inverse) and,
in 3-D, the axis(-3) kernel each way.  The backward runs the kernels'
adjoints.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.complex_utils import host_table, to_device
from ..ops.nd import fftn, ifftn
from ..ops.rfft import irfft, rfft
from ._plan import resolve_device

__all__ = ["FNO1d", "FNO2d", "FNO3d", "from_numpy", "init_fno1d", "fno1d_apply", "init_fno2d",
           "fno2d_apply", "init_fno3d", "fno3d_apply", "mse_loss", "train_step"]


class _Block(nn.Module):
    """One spectral block's parameters: the spectral weights ``wr``, ``wi``
    ``[*modes, width, width]``, the pointwise ``pw [width, width]`` and the
    bias ``b [width]``."""

    def __init__(self, wr, wi, pw, b):
        super().__init__()
        self.wr, self.wi = nn.Parameter(wr), nn.Parameter(wi)
        self.pw, self.b = nn.Parameter(pw), nn.Parameter(b)


def _spectral_conv1d(block, x, modes):
    """x [batch, seq, ch] -> spectral multiply on the first ``modes`` bins."""
    n = x.shape[1]
    X = rfft(x, axis=1)  # [b, n//2+1, c] complex64
    Xr, Xi = X.real[:, :modes, :], X.imag[:, :modes, :]
    wr, wi = block.wr, block.wi
    # complex einsum 'bkc,kco->bko' with split arithmetic
    Yr = torch.einsum("bkc,kco->bko", Xr, wr) - torch.einsum("bkc,kco->bko", Xi, wi)
    Yi = torch.einsum("bkc,kco->bko", Xr, wi) + torch.einsum("bkc,kco->bko", Xi, wr)
    pad = (0, 0, 0, n // 2 + 1 - modes)
    Y = torch.complex(nn.functional.pad(Yr, pad), nn.functional.pad(Yi, pad))
    return irfft(Y, n=n, axis=1)


# the einsum of each rank: channels c -> o at every kept mode
_EQ = {2: "bcij,ijco->boij", 3: "bcijk,ijkco->boijk"}


def _low_corner(x, modes):
    """x [batch, *grid, ch] -> the low corner [:m1, :m2(, :m3)] of the full
    complex spectrum over the grid axes, channels second: [b, c, *modes]
    (a view)."""
    axes = tuple(range(-len(modes), 0))
    X = fftn(x.movedim(-1, 1), axes=axes)  # [b, c, *grid]
    return X[(slice(None), slice(None)) + tuple(slice(0, m) for m in modes)]


def _corner_conv(block, Xc, grid):
    """The corner ``Xc`` [b, c, *modes] times the spectral weights (channels
    c -> o at every kept mode), zero-padded to ``grid`` and inverse
    transformed: the real part [b, o, *grid]."""
    d = len(grid)
    Xr, Xi = Xc.real, Xc.imag
    wr, wi, eq = block.wr, block.wi, _EQ[d]
    Yr = torch.einsum(eq, Xr, wr) - torch.einsum(eq, Xi, wi)
    Yi = torch.einsum(eq, Xr, wi) + torch.einsum(eq, Xi, wr)
    pad = sum(((0, n - m) for n, m in zip(reversed(grid), reversed(Xc.shape[2:]))), ())
    Y = torch.complex(nn.functional.pad(Yr, pad), nn.functional.pad(Yi, pad))
    return ifftn(Y, axes=tuple(range(-d, 0))).real


def _spectral_convnd(block, x, modes):
    """x [batch, *grid, ch]: multiply the low corner [:m1, :m2(, :m3)] of the
    full spectrum over the grid axes, and take the real part of the inverse."""
    return _corner_conv(block, _low_corner(x, modes), x.shape[1:-1]).movedim(1, -1)


class _FNO(nn.Module):
    """lift -> depth x (spectral conv + pointwise + bias, GELU) -> project,
    over fields ``[batch, *grid, in_ch]`` of ``ndim`` grid axes."""

    ndim = 0

    def __init__(self, lift, proj, blocks):
        super().__init__()
        self.lift, self.proj = nn.Parameter(lift), nn.Parameter(proj)
        self.blocks = nn.ModuleList(_Block(**b) for b in blocks)

    @property
    def modes(self):
        return tuple(self.blocks[0].wr.shape[:self.ndim])

    def forward(self, x):
        """x: [batch, *grid, in_ch] float32 (non-tensor input on the
        model's device)."""
        x = to_device(x, None if isinstance(x, torch.Tensor) else self.lift.device)
        conv = _spectral_conv1d if self.ndim == 1 else _spectral_convnd
        modes = self.modes[0] if self.ndim == 1 else self.modes
        return self._layers(x, lambda blk, h: conv(blk, h, modes))

    def _layers(self, x, conv):
        """The model on ``x`` with ``conv(block, h)`` as each block's spectral
        conv."""
        h = x @ self.lift
        for blk in self.blocks:
            h = nn.functional.gelu(conv(blk, h) + h @ blk.pw + blk.b, approximate="tanh")
        return h @ self.proj


class FNO1d(_FNO):
    """1-D FNO over [batch, seq, ch] fields."""

    ndim = 1


class FNO2d(_FNO):
    """2-D FNO over [batch, H, W, ch] fields."""

    ndim = 2


class FNO3d(_FNO):
    """3-D FNO over [batch, X, Y, Z, ch] fields."""

    ndim = 3


_CLASSES = {1: FNO1d, 2: FNO2d, 3: FNO3d}


def _init(cls, generator, modes, width, depth, in_ch, out_ch, device):
    """The JAX initialiser's scales, drawn in its order (lift, proj, then
    each block's wr, wi, pw) from ``generator`` on its own device, on
    ``device`` (the current CUDA device by default)."""
    device = resolve_device(device)
    draw_on = generator.device if generator is not None else device

    def glorot(shape, scale):
        w = torch.randn(shape, generator=generator, device=draw_on, dtype=torch.float32)
        return (scale * w).to(device)

    s = 1.0 / (width * int(np.prod(modes))) ** 0.5
    lift = glorot((in_ch, width), (2.0 / (in_ch + width)) ** 0.5)
    proj = glorot((width, out_ch), (2.0 / (width + out_ch)) ** 0.5)
    blocks = [{"wr": glorot((*modes, width, width), s), "wi": glorot((*modes, width, width), s),
               "pw": glorot((width, width), (1.0 / width) ** 0.5),
               "b": torch.zeros(width, device=device)} for _ in range(depth)]
    return cls(lift, proj, blocks)


def init_fno1d(generator=None, *, modes=64, width=32, depth=2, in_ch=1, out_ch=1, device=None):
    """A 1-D FNO: lift -> depth x (spectral + pointwise) -> project, drawn
    from ``generator`` (a ``torch.Generator``, where the JAX function takes
    a key; the streams differ)."""
    return _init(FNO1d, generator, (modes,), width, depth, in_ch, out_ch, device)


def init_fno2d(generator=None, *, modes=(16, 16), width=32, depth=2, in_ch=1, out_ch=1,
               device=None):
    """A 2-D FNO over [batch, H, W, ch] fields (see :func:`init_fno1d`)."""
    return _init(FNO2d, generator, tuple(modes), width, depth, in_ch, out_ch, device)


def init_fno3d(generator=None, *, modes=(8, 8, 8), width=16, depth=2, in_ch=1, out_ch=1,
               device=None):
    """A 3-D FNO over [batch, X, Y, Z, ch] fields (see :func:`init_fno1d`)."""
    return _init(FNO3d, generator, tuple(modes), width, depth, in_ch, out_ch, device)


def from_numpy(tree, device=None):
    """The FNO of a JAX parameter pytree as numpy arrays
    (``jax.tree.map(np.asarray, params)``), on ``device`` (the current CUDA
    device by default); the rank of ``wr`` picks FNO1d, FNO2d or FNO3d."""
    device = resolve_device(device)
    cls = _CLASSES[np.ndim(tree["blocks"][0]["wr"]) - 2]

    def t(a):
        return host_table(np.asarray(a), device)

    return cls(t(tree["lift"]), t(tree["proj"]),
               [{k: t(v) for k, v in blk.items()} for blk in tree["blocks"]])


def fno1d_apply(params: FNO1d, x):
    """Forward pass. x: [batch, seq, in_ch] float32."""
    return params(x)


def fno2d_apply(params: FNO2d, x):
    """Forward pass. x: [batch, H, W, in_ch] float32."""
    return params(x)


def fno3d_apply(params: FNO3d, x):
    """Forward pass. x: [batch, X, Y, Z, in_ch] float32."""
    return params(x)


def mse_loss(params, x, y):
    """The mean squared error of the model's prediction, a 0-d tensor."""
    pred = params(x)
    y = to_device(y, None if isinstance(y, torch.Tensor) else params.lift.device)
    return torch.mean((pred - y) ** 2)


def train_step(params, x, y, lr=1e-3):
    """One SGD step by autograd through the transforms: the parameters are
    updated in place (p - lr * grad, under ``torch.no_grad()``).  Returns
    ``(params, loss)``, the loss before the step as a 0-d tensor on the
    model's device (no host read)."""
    loss = mse_loss(params, x, y)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    _sgd(params, grads, lr)
    return params, loss.detach()


def _sgd(params, grads, lr):
    """p - lr * grad for every parameter, in place."""
    with torch.no_grad():
        for p, g in zip(params.parameters(), grads):
            p.sub_(lr * g)
