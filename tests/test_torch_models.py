"""Torch port, the FNO family and the Poisson solve on the CPU
(``fft_wgpu_tpu_torch.models.spectral`` and ``models.poisson``).

The same weights, drawn with numpy from a seed in the JAX initialiser's
layout and scales and carried across with ``from_numpy``, and the same
numpy inputs, made from a seed, go through the
JAX package on the CPU and through the port on CPU tensors: each FNO's
forward, its loss and every parameter's gradient (``jax.value_and_grad``
against autograd), and one SGD step of each package.  Beside them the
oracles of the JAX package's own tests (``tests/test_models.py``,
``tests/test_poisson.py``).  Tolerance: 1e-5 relative L2 against the JAX
package; the Poisson oracles at their JAX tests' bars (2-D analytic 1e-4,
3-D round trip 1e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_wgpu_tpu.models import poisson as j_poisson
from fft_wgpu_tpu.models import spectral as j_spectral
from fft_wgpu_tpu_torch import models
from fft_wgpu_tpu_torch.models import spectral

torch.set_num_threads(1)

TOL = 1e-5
POISSON_2D_BAR = 1e-4  # tests/test_poisson.py
POISSON_3D_BAR = 1e-3  # tests/test_poisson.py
CPU = torch.device("cpu")

# rank -> (JAX init, JAX apply, port apply, small config, input shape)
SMALL = {
    1: (j_spectral.init_fno1d, j_spectral.fno1d_apply, spectral.fno1d_apply,
        dict(modes=16, width=8, depth=2), (4, 128, 1)),
    2: (j_spectral.init_fno2d, j_spectral.fno2d_apply, spectral.fno2d_apply,
        dict(modes=(8, 8), width=8, depth=2), (2, 32, 32, 1)),
    3: (j_spectral.init_fno3d, j_spectral.fno3d_apply, spectral.fno3d_apply,
        dict(modes=(4, 4, 4), width=6, depth=2), (2, 8, 8, 16, 1)),
}
LR = 1e-2


def _t(x):
    # a CPU tensor asks the port for the CPU
    return torch.from_numpy(np.array(x))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _leaf(tree, name):
    """The pytree leaf of a port parameter name (``blocks.1.wr``)."""
    parts = name.split(".")
    return tree[parts[0]] if len(parts) == 1 else tree["blocks"][int(parts[1])][parts[2]]


def _numpy_tree(init, seed, **cfg):
    """A parameter pytree of the JAX initialiser's layout (its shapes by
    ``jax.eval_shape``) and scales, drawn with numpy from ``seed``; the
    biases nonzero too.  (The JAX initialiser itself takes seconds to
    compile on the CPU; the port's weights come from the tree either way.)"""
    shapes = jax.eval_shape(functools.partial(init, **cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    in_ch, width = shapes["lift"].shape
    out_ch = shapes["proj"].shape[1]
    s = 1.0 / (width * int(np.prod(shapes["blocks"][0]["wr"].shape[:-2]))) ** 0.5
    scale = {"lift": (2.0 / (in_ch + width)) ** 0.5, "proj": (2.0 / (width + out_ch)) ** 0.5,
             "wr": s, "wi": s, "pw": (1.0 / width) ** 0.5, "b": 0.1}

    def draw(path, leaf):
        return (scale[path[-1].key] * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _jax_case(rank):
    """The JAX side of a rank's small case, computed once: its weights as
    numpy, the inputs, the forward, and the loss and gradients of the mean
    squared error (one jitted program)."""
    init, apply, _, cfg, shape = SMALL[rank]
    tree = _numpy_tree(init, rank, **cfg)
    params = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(rank + 10)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32)

    def loss(p):
        pred = apply(p, x)
        return jnp.mean((pred - y) ** 2), pred

    (loss, pred), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return tree, x, y, np.asarray(pred), float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_fno_forward_matches_jax(rank, assert_close):
    tree, x, _, want, _, _ = _jax_case(rank)
    model = spectral.from_numpy(tree, device=CPU)
    assert type(model) is {1: models.FNO1d, 2: models.FNO2d, 3: models.FNO3d}[rank]
    got = SMALL[rank][2](model, _t(x))
    assert got.shape == x.shape and got.device.type == "cpu"
    assert_close(_np(got), want, tol=TOL, what=f"FNO{rank}d forward")


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_fno_loss_and_every_gradient_match_jax(rank, assert_close):
    tree, x, y, _, want_loss, want_grads = _jax_case(rank)
    model = spectral.from_numpy(tree, device=CPU)
    loss = models.mse_loss(model, _t(x), _t(y))
    loss.backward()
    assert loss.ndim == 0
    assert_close(loss.item(), want_loss, tol=TOL, what=f"FNO{rank}d loss")
    names = [name for name, _ in model.named_parameters()]
    assert len(names) == 2 + 4 * len(tree["blocks"])
    for name, p in model.named_parameters():
        want = _leaf(want_grads, name)
        assert p.shape == want.shape, name
        assert_close(_np(p.grad), want, tol=TOL, what=f"FNO{rank}d d/d{name}")


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_fno_train_step_matches_jax(rank, assert_close):
    tree, x, y, _, want_loss, grads = _jax_case(rank)
    if rank == 1:  # the JAX package's own jitted step
        stepped, loss_j = j_spectral.train_step(jax.tree.map(jnp.asarray, tree), x, y, lr=LR)
        want_tree, want_loss = jax.tree.map(np.asarray, stepped), float(loss_j)
    else:  # its step rule, p - lr * g, on the JAX gradients
        want_tree = jax.tree.map(lambda p, g: p - LR * g, tree, grads)
    model = spectral.from_numpy(tree, device=CPU)
    same, loss = models.train_step(model, _t(x), _t(y), lr=LR)
    assert same is model and loss.ndim == 0 and not loss.requires_grad
    assert_close(loss.item(), want_loss, tol=TOL, what=f"FNO{rank}d step loss")
    for name, p in model.named_parameters():
        assert p.grad is None, name  # the step leaves no gradient behind
        assert_close(_np(p), _leaf(want_tree, name), tol=TOL, what=f"FNO{rank}d stepped {name}")


def test_flagship_fno1d_matches_jax(assert_close):
    # the repo's flagship workload (__graft_entry__.py): modes 64, width 32,
    # depth 2 on x [8, 1024, 1]
    tree = _numpy_tree(j_spectral.init_fno1d, 9, modes=64, width=32, depth=2)
    params = jax.tree.map(jnp.asarray, tree)
    x = np.random.default_rng(9).standard_normal((8, 1024, 1)).astype(np.float32)
    model = spectral.from_numpy(tree, device=CPU)
    assert model.modes == (64,)
    assert_close(_np(model(_t(x))), np.asarray(jax.jit(j_spectral.fno1d_apply)(params, x)),
                 tol=TOL, what="flagship FNO1d")


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_init_has_the_jax_layout_and_scales(rank):
    init, _, _, cfg, _ = SMALL[rank]
    want = jax.eval_shape(functools.partial(init, **cfg), jax.random.PRNGKey(0))
    port_init = {1: models.init_fno1d, 2: models.init_fno2d, 3: spectral.init_fno3d}[rank]
    a = port_init(torch.Generator().manual_seed(0), device=CPU, **cfg)
    b = port_init(torch.Generator().manual_seed(0), device=CPU, **cfg)
    width = cfg["width"]
    s = 1.0 / (width * int(np.prod(cfg["modes"]))) ** 0.5
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert p.shape == _leaf(want, name).shape and p.dtype == torch.float32, name
        assert torch.equal(p, q), name  # one seed, one draw
        if name.endswith(".b"):
            assert not p.any(), name
    for name in ("wr", "wi"):
        w = torch.cat([getattr(blk, name).detach().reshape(-1) for blk in a.blocks])
        assert abs(float(w.std()) / s - 1.0) < 0.1, (name, float(w.std()), s)
    assert abs(float(a.lift.detach().std()) - (2.0 / (1 + width)) ** 0.5) < 0.5


def test_fno_training_reduces_loss():
    # tests/test_models.py's check, on the port: 20 SGD steps at lr 1e-2
    model = models.init_fno1d(torch.Generator().manual_seed(0), modes=16, width=16, depth=2,
                              device=CPU)
    x = torch.randn(8, 128, 1, generator=torch.Generator().manual_seed(1))
    y = x * 0.5
    l0 = float(models.mse_loss(model, x, y).detach())
    for _ in range(20):
        model, loss = models.train_step(model, x, y, lr=1e-2)
    assert float(loss) < l0


def test_fno3d_training_reduces_loss():
    model = spectral.init_fno3d(torch.Generator().manual_seed(0), modes=(4, 4, 4), width=6,
                                depth=1, device=CPU)
    g = torch.Generator().manual_seed(2)
    x, y = torch.randn(2, 8, 8, 8, 1, generator=g), torch.randn(2, 8, 8, 8, 1, generator=g)
    losses = [float(models.train_step(model, x, y, lr=5e-3)[1]) for _ in range(5)]
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------- #
# the Poisson solve
# ---------------------------------------------------------------------- #
def _analytic_case_2d(n=64):
    # u = sin(x)cos(2y) -> laplacian u = -(1+4) u
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    X, Y = np.meshgrid(x, x, indexing="ij")
    u = np.sin(X) * np.cos(2 * Y)
    return (-5.0 * u).astype(np.float32), u


def test_poisson_2d_analytic(assert_close):
    f, u = _analytic_case_2d()
    got = _np(models.solve_poisson(_t(f)))
    assert_close(got, u, tol=POISSON_2D_BAR, what="2-D analytic")
    assert_close(got, np.asarray(j_poisson.solve_poisson(f)), tol=TOL, what="2-D vs JAX")


def test_poisson_3d_roundtrip(assert_close):
    rng = np.random.default_rng(0)
    n = 32
    u = rng.standard_normal((n, n, n)).astype(np.float32)
    u -= u.mean()
    # build f = laplacian(u) spectrally, then solve back
    ku = np.fft.fftfreq(n) * n
    KX, KY, KZ = np.meshgrid(ku, ku, ku, indexing="ij")
    F = -(KX**2 + KY**2 + KZ**2) * np.fft.fftn(u)
    f = np.real(np.fft.ifftn(F)).astype(np.float32)
    got = _np(models.solve_poisson(_t(f), lengths=(2 * np.pi,) * 3))
    assert_close(got, u, tol=POISSON_3D_BAR, what="3-D round trip")
    assert_close(got, np.asarray(j_poisson.solve_poisson(f, lengths=(2 * np.pi,) * 3)),
                 tol=TOL, what="3-D vs JAX")


@pytest.mark.parametrize("shape,lengths", [((48, 20), (3.0, 5.0)), ((6, 16, 9), None),
                                           ((130,), None)])
def test_poisson_matches_jax(shape, lengths, assert_close):
    f = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    got = models.solve_poisson(_t(f), lengths=lengths)
    assert got.shape == shape and got.device.type == "cpu"
    assert_close(_np(got), np.asarray(j_poisson.solve_poisson(f, lengths=lengths)), tol=TOL,
                 what=f"{shape} {lengths}")
    # zero mean, and the residual of the spectral Laplacian
    assert abs(float(got.mean())) < 1e-6
    L = lengths or (2 * np.pi,) * len(shape)
    ks = np.meshgrid(*[2 * np.pi / ln * np.fft.fftfreq(n) * n for n, ln in zip(shape, L)],
                     indexing="ij")
    lap = np.real(np.fft.ifftn(-sum(k**2 for k in ks) * np.fft.fftn(_np(got).astype(np.float64))))
    assert_close(lap, f - f.mean(), tol=POISSON_2D_BAR, what=f"{shape} residual")


# ---------------------------------------------------------------------- #
# devices
# ---------------------------------------------------------------------- #
def test_numpy_input_needs_a_card(monkeypatch):
    # numpy input and the size-only constructors go to the current CUDA
    # device, and raise with none; CPU tensors and device="cpu" compute here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = np.ones((8, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.solve_poisson(f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.init_fno1d(torch.Generator().manual_seed(0), modes=4, width=4)
    tree, x, *_ = _jax_case(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spectral.from_numpy(tree)
    model = spectral.from_numpy(tree, device="cpu")
    assert model(x).device.type == "cpu"  # numpy input on the model's device
    assert models.solve_poisson(_t(f)).device.type == "cpu"
