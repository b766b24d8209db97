"""Torch port, the FNO-3D training step sharded over a dp x tp mesh
(``fft_wgpu_tpu_torch.parallel.fno``) against the JAX package on its 8
virtual CPU devices.

The port's side runs on a real 8-rank gloo process group: one module
fixture spawns the ranks once (``tests/torch_dist_cases.py``'s ``fno_tp``
suite, which imports no jax), every case runs there on the same numpy
inputs (from a seed) and the gathered results come back.  The JAX side is
``tests/test_distributed.py``'s ``test_fno3d_dp_tp_training_step``: the
unsharded ``fno3d_apply`` / ``value_and_grad`` step, and the same step
jitted over ``NamedSharding`` annotations on the (2, 4) mesh, from
``init_fno3d(PRNGKey(0), modes=(4, 4, 4), width=16, depth=2)``.  Losses,
every gradient and every updated parameter at 1e-5 relative L2.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from fft_wgpu_tpu.models.spectral import fno3d_apply, init_fno3d
from fft_wgpu_tpu.parallel import mesh as jmesh
from fft_wgpu_tpu_torch.models import spectral
from fft_wgpu_tpu_torch.parallel import fno

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_cases as cases  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
LR = 1e-3
MESHES = ("m81", "m18", "m42")


def _rrand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _named(tree) -> dict:
    """A JAX FNO pytree as numpy arrays under the port's parameter names."""
    out = {"lift": np.asarray(tree["lift"]), "proj": np.asarray(tree["proj"])}
    for i, blk in enumerate(tree["blocks"]):
        for k, v in blk.items():
            out[f"blocks.{i}.{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def params():
    return init_fno3d(jax.random.PRNGKey(0), modes=(4, 4, 4), width=16, depth=2)


@pytest.fixture(scope="module")
def inputs(params):
    # the JAX test's batch on the (2, 4) mesh is 2 * dp; 16 divides over
    # every dp of the other meshes
    return {"x": _rrand(1, 4, 8, 8, 8, 1), "y": _rrand(2, 4, 8, 8, 8, 1),
            "x16": _rrand(3, 16, 8, 8, 8, 1), "y16": _rrand(4, 16, 8, 8, 8, 1),
            **{f"p/{k}": v for k, v in _named(params).items()}}


@pytest.fixture(scope="module")
def port(tmp_path_factory, inputs):
    return cases.run_suite("fno_tp", tmp_path_factory.mktemp("fno_tp"), inputs)


def _loss(p, xv, yv):
    return jnp.mean((fno3d_apply(p, xv) - yv) ** 2)


@jax.jit
def _step(p, xv, yv):
    lv, g = jax.value_and_grad(_loss)(p, xv, yv)
    return jax.tree.map(lambda a, gg: a - LR * gg, p, g), lv, g


@pytest.fixture(scope="module")
def ref(params, inputs):
    """The JAX steps: unsharded on the (2, 4) case's batch (two steps) and
    on the 16-batch, and sharded on the (2, 4) mesh."""
    x, y = jnp.asarray(inputs["x"]), jnp.asarray(inputs["y"])
    p1, l1, g1 = _step(params, x, y)
    p2, l2, _ = _step(p1, x, y)
    x16, y16 = jnp.asarray(inputs["x16"]), jnp.asarray(inputs["y16"])
    p16, l16, g16 = _step(params, x16, y16)

    mesh = jmesh.make_pencil_mesh(axis_names=("dp", "tp"))
    assert mesh.devices.shape == (2, 4)

    def shard(path, leaf):
        name = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        spec = P(None, None, None, None, "tp") if name in ("wr", "wi") else P()
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    ps = jax.tree_util.tree_map_with_path(shard, params)
    psh, lsh, _ = _step(ps, jax.device_put(x, NamedSharding(mesh, P("dp"))),
                        jax.device_put(y, NamedSharding(mesh, P("dp"))))
    return {"m24": (float(l1), _named(g1), _named(p1)), "m24/two": (float(l2), _named(p2)),
            "b16": (float(l16), _named(g16), _named(p16)),
            "sharded": (float(lsh), _named(psh))}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_mesh_is_the_jax_tests(port):
    assert tuple(port["mesh24/shape"]) == (2, 4)
    assert port["default/mesh"].tolist() == ["2", "4", "dp", "tp"]


def test_jax_tests_case_loss_and_wr(port, ref):
    """tests/test_distributed.py's own check: the loss and the updated
    blocks[0].wr against the unsharded and the GSPMD-sharded JAX step."""
    loss, _, upd = ref["m24"]
    lsh, psh = ref["sharded"]
    got_l = float(port["m24/step0/loss"])
    got_wr = port["m24/param/blocks.0.wr"]
    for want_l, want_wr in ((loss, upd["blocks.0.wr"]), (lsh, psh["blocks.0.wr"])):
        assert abs(got_l - want_l) <= TOL * abs(want_l)
        assert rel(got_wr, want_wr) < TOL


@pytest.mark.parametrize("name", cases.FNO_NAMES)
def test_every_gradient_against_jax_grad(port, ref, name):
    _, grads, _ = ref["m24"]
    assert abs(float(port["m24/loss"]) - ref["m24"][0]) <= TOL * ref["m24"][0]
    assert rel(port[f"m24/grad/{name}"], grads[name]) < TOL


@pytest.mark.parametrize("name", cases.FNO_NAMES)
def test_every_updated_parameter_after_two_steps(port, ref, name):
    """Two steps on the (2, 4) mesh against two unsharded JAX steps."""
    loss, upd = ref["m24/two"]
    assert abs(float(port["m24/step1/loss"]) - loss) <= TOL * loss
    assert rel(port[f"m24/param/{name}"], upd[name]) < TOL
    assert port["m24/gathered_equal"]


def test_replicated_parameters_bit_identical_across_ranks(port):
    assert port["m24/replicated_bits"].shape == (8,) and port["m24/replicated_bits"].all()
    shapes = port["m24/slice_shapes"]
    assert shapes.shape == (8, 4, 5)
    assert (shapes == np.array([4, 4, 4, 16, 4])).all()


@pytest.mark.parametrize("name", cases.FNO_NAMES)
def test_dtensor_input_takes_the_same_step(port, ref, name):
    """x and y as DTensors in [Shard(0) on dp, Replicate() on tp]: the
    same loss as the global arrays' step, the unsharded JAX step's
    parameters."""
    assert port["dtensor/loss"] == port["m24/step0/loss"]
    assert rel(port[f"dtensor/param/{name}"], ref["m24"][2][name]) < TOL


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", cases.FNO_NAMES)
def test_other_meshes_against_the_unsharded_step(port, ref, mesh, name):
    """(8, 1), (1, 8) and (4, 2) on a batch of 16: each gradient and each
    updated parameter against the unsharded JAX step."""
    loss, grads, upd = ref["b16"]
    assert abs(float(port[f"{mesh}/loss"]) - loss) <= TOL * loss
    assert abs(float(port[f"{mesh}/step0/loss"]) - loss) <= TOL * loss
    assert rel(port[f"{mesh}/grad/{name}"], grads[name]) < TOL
    assert rel(port[f"{mesh}/param/{name}"], upd[name]) < TOL
    assert port[f"{mesh}/gathered_equal"]


@pytest.mark.parametrize("what", ["width", "batch", "mesh_names", "one_dim_mesh"])
def test_errors_raise(port, what):
    assert port[f"raises/{what}"]


def _cpu_model(inputs):
    return spectral.from_numpy({"lift": inputs["p/lift"], "proj": inputs["p/proj"], "blocks": [
        {k: inputs[f"p/blocks.{i}.{k}"] for k in ("wr", "wi", "pw", "b")} for i in range(2)]},
        device="cpu")


def test_no_process_group_is_spectral_train_step(inputs):
    """With no process group the sharded step is the unsharded one: the
    same loss and the same parameters, bit for bit, and gather_params
    gives the model back."""
    model = _cpu_model(inputs)
    ref = copy.deepcopy(model)
    x, y = torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["y"])
    sh = fno.shard_params(model)
    assert sh.dp.size == sh.tp.size == 1 and sh.mesh is None
    back = fno.gather_params(sh)
    for (n, p), q in zip(back.named_parameters(), model.parameters()):
        assert torch.equal(p, q), n
    _, loss = fno.train_step(sh, x, y, lr=LR)
    _, want = spectral.train_step(ref, x, y, lr=LR)
    assert loss.ndim == 0 and not loss.requires_grad and torch.equal(loss, want)
    for (n, p), q in zip(sh.named_parameters(), ref.parameters()):
        assert torch.equal(p, q), n


def test_no_process_group_errors(inputs):
    model = _cpu_model(inputs)
    sh = fno.shard_params(model)
    with pytest.raises(TypeError):
        fno.shard_params(spectral.init_fno2d(torch.Generator().manual_seed(0), modes=(4, 4),
                                             width=4, device="cpu"))
    x = torch.from_numpy(inputs["x"])
    loss, grads = fno.value_and_grad(sh, x, torch.from_numpy(inputs["y"]))
    assert len(grads) == len(list(sh.parameters())) and loss.ndim == 0
