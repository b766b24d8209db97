"""Torch port, the distributed layer (``fft_wgpu_tpu_torch.parallel``)
against the JAX package on its 8 virtual CPU devices.

The port's side runs on a real 8-rank gloo process group: one module
fixture spawns the ranks once (``tests/torch_dist_cases.py``, which imports
no jax), every case runs there on the same numpy inputs (from a seed) and
the gathered results come back; each case is then its own test here,
against the JAX function on ``make_pencil_mesh()`` = (2, 4) or
``make_mesh()`` = 8 and against numpy, at 1e-5 relative L2 (the bf16
turns at the JAX test's 2e-2).  Gradients cross the process boundary and
are held against ``jax.grad`` (conjugated: JAX's complex gradient is the
conjugate of torch's).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_wgpu_tpu.parallel import batched as jbatched
from fft_wgpu_tpu.parallel import mesh as jmesh
from fft_wgpu_tpu.parallel import pencil as jpencil

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_cases as cases  # noqa: E402

torch.set_num_threads(1)


def _crand(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rrand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


INPUTS = {
    "pencil": _crand(1, 16, 32, 64), "transposed_out": _crand(2, 8, 16, 32),
    "cube32": _crand(3, 32, 32, 32), "slab": _crand(4, 64, 128),
    "d4096": _crand(5, 4096), "d65536": _crand(6, 1 << 16), "d1024": _crand(7, 1024),
    "d320": _crand(8, 320), "d48": _crand(9, 48), "norms": _crand(10, 8, 16, 16),
    "rfft3d": _rrand(11, 16, 16, 32), "real": _rrand(12, 8, 16, 32),
    "batch": _crand(13, 64, 256), "overlap": _crand(14, 16, 16, 32),
    "allnorms": _rrand(15, 8, 8, 16), "lead3": _crand(16, 3, 8, 16, 32),
    "lead2": _crand(17, 2, 5, 16, 32), "rlead": _rrand(18, 2, 8, 16, 32),
    "slab_bf16": _crand(19, 32, 64), "tround": _crand(20, 16, 16, 32),
    "tround_lead": _crand(21, 2, 8, 16, 32), "oddz": _rrand(22, 8, 16, 15),
    "schedule": _crand(23, 16, 16, 32),
    "grad_x": _crand(24, 8, 16, 16), "grad_w": _rrand(25, 8, 16, 16) ** 2,
    "grad_v": _crand(26, 1024), "grad_wv": _rrand(27, 1024) ** 2,
}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return cases.run_suite("parallel", tmp_path_factory.mktemp("parallel"), INPUTS)


@pytest.fixture(scope="module")
def pm():
    return jmesh.make_pencil_mesh()


@pytest.fixture(scope="module")
def fm():
    return jmesh.make_mesh()


def rel(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def close(got, want, tol=1e-5):
    err = rel(got, want)
    assert err < tol, f"relative L2 {err:.3e} >= {tol:.0e}"


def test_make_pencil_mesh_shape(port, pm):
    assert tuple(port["mesh/shape"]) == pm.devices.shape == (2, 4)
    assert tuple(port["mesh/names"]) == pm.axis_names == ("px", "py")


@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_fft3d_pencil_matches_jax(port, pm, direction):
    x = INPUTS["pencil"]
    jfn, npfn = ((jpencil.fft3d, np.fft.fftn) if direction == "fwd"
                 else (jpencil.ifft3d, np.fft.ifftn))
    close(port[f"pencil/{direction}"], np.asarray(jfn(x, pm)))
    close(port[f"pencil/{direction}"], npfn(x))


def test_fft3d_transposed_output(port, pm):
    x = INPUTS["transposed_out"]
    close(port["transposed_out"], np.asarray(jpencil.fft3d(x, pm, transposed_output=True)))
    close(port["transposed_out"], np.fft.fftn(x))


def test_fft3d_roundtrip_32_cube(port):
    close(port["cube32"], INPUTS["cube32"])


@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_fft2d_slab(port, fm, direction):
    x = INPUTS["slab"]
    jfn, npfn = ((jpencil.fft2d, np.fft.fft2) if direction == "fwd"
                 else (jpencil.ifft2d, np.fft.ifft2))
    close(port[f"slab/{direction}"], np.asarray(jfn(x, fm)))
    close(port[f"slab/{direction}"], npfn(x))


@pytest.mark.parametrize("key", ["d4096", "d65536"])
def test_fft1d_distributed(port, fm, key):
    x = INPUTS[key]
    close(port[key], np.asarray(jpencil.fft1d_distributed(x, fm)))
    close(port[key], np.fft.fft(x))
    assert tuple(port[f"{key}/placements"]) == ("Shard:0",)


def test_fft1d_distributed_inverse(port, fm):
    x = INPUTS["d4096"]
    close(port["d4096/inv"], np.asarray(jpencil.fft1d_distributed(x, fm, inverse=True)))
    close(port["d4096/inv"], np.fft.ifft(x))


@pytest.mark.parametrize("direction", ["fwd", "inv"])
@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_fft3d_norms(port, pm, direction, norm):
    x = INPUTS["norms"]
    jfn, npfn = ((jpencil.fft3d, np.fft.fftn) if direction == "fwd"
                 else (jpencil.ifft3d, np.fft.ifftn))
    got = port[f"norms/{direction}/{norm}"]
    close(got, np.asarray(jfn(x, pm, norm=norm)))
    close(got, npfn(x, norm=norm or "backward"))


def test_rfft3d_pencil(port, pm):
    x = INPUTS["rfft3d"]
    close(port["rfft3d"], np.asarray(jpencil.rfft3d(x, pm)))
    close(port["rfft3d"], np.fft.rfftn(x))


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_irfft3d_roundtrip_and_norms(port, pm, norm):
    x = INPUTS["real"]
    got = port["irfft3d" if norm is None else f"irfft3d/{norm}"]
    want = jpencil.irfft3d(jpencil.rfft3d(x, pm, norm=norm), n_last=32, mesh=pm, norm=norm)
    close(got, np.asarray(want))
    close(got, x)


@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_fft_batch_sharded(port, fm, direction):
    x = INPUTS["batch"]
    jfn, npfn = ((jbatched.fft_batch_sharded, np.fft.fft) if direction == "fwd"
                 else (jbatched.ifft_batch_sharded, np.fft.ifft))
    close(port[f"batch/{direction}"], np.asarray(jfn(x, fm)))
    close(port[f"batch/{direction}"], npfn(x, axis=-1))


@pytest.mark.parametrize("key", ["d1024", "d320", "d48"])
def test_fft1d_distributed_replan_and_replicated(port, fm, key):
    # 1024 keeps choose_factors' pair, 320 re-plans to a pair divisible by
    # 8, 48 has none: the replicated whole transform on every rank
    x = INPUTS[key]
    close(port[key], np.asarray(jpencil.fft1d_distributed(x, fm)))
    close(port[key], np.fft.fft(x))
    want = "Replicate:" if key == "d48" else "Shard:0"
    assert tuple(port[f"{key}/placements"]) == (want,)


@pytest.mark.parametrize("chunks", [1, 2, 4, 16])
def test_fft3d_overlap_chunks(port, pm, chunks):
    x = INPUTS["overlap"]
    close(port[f"overlap/{chunks}"], np.asarray(jpencil.fft3d(x, pm, overlap_chunks=chunks)))
    close(port[f"overlap/{chunks}"], port["overlap/1"])
    close(port[f"overlap/{chunks}"], np.fft.fftn(x))


def test_fft3d_overlap_roundtrip(port):
    close(port["overlap/roundtrip"], INPUTS["overlap"])


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_rfft3d_irfft3d_all_norms(port, pm, norm):
    x = INPUTS["allnorms"]
    close(port[f"allnorms/{norm}"], np.asarray(jpencil.rfft3d(x, pm, norm=norm)))
    close(port[f"allnorms/{norm}"], np.fft.rfftn(x, norm=norm or "backward"))
    close(port[f"allnorms/back/{norm}"], x)


def test_fft3d_batched_leading_dims(port, pm):
    x = INPUTS["lead3"]
    close(port["lead3/fwd"], np.asarray(jpencil.fft3d(x, pm)))
    close(port["lead3/fwd"], np.fft.fftn(x, axes=(-3, -2, -1)))
    close(port["lead3/inv"], np.asarray(jpencil.ifft3d(x, pm, norm="ortho")))
    close(port["lead3/inv"], np.fft.ifftn(x, axes=(-3, -2, -1), norm="ortho"))


def test_fft2d_batched_leading_dims(port, fm):
    x = INPUTS["lead2"]
    close(port["lead2"], np.asarray(jpencil.fft2d(x, fm)))
    close(port["lead2"], np.fft.fftn(x, axes=(-2, -1)))


def test_rfft3d_batched_roundtrip(port, pm):
    x = INPUTS["rlead"]
    assert tuple(port["rlead/shape"]) == (2, 8, 16, 17)
    close(port["rlead/fwd"], np.asarray(jpencil.rfft3d(x, pm)))
    close(port["rlead/fwd"], np.fft.rfftn(x, axes=(-3, -2, -1)))
    close(port["rlead/back"], x)


def test_fft3d_bf16_comm_dtype(port):
    x = INPUTS["overlap"]
    want = np.fft.fftn(x)
    assert rel(port["bf16/exact"], want) < 1e-5
    assert rel(port["bf16/got"], want) < 2e-2
    assert np.linalg.norm(port["bf16/got"] - port["bf16/exact"]) > 0.0  # the bf16 wire ran
    assert rel(port["bf16/back"], x) < 2e-2
    assert port["bf16/float16_raises"] and port["bf16/torch_float16_raises"]


def test_rfft3d_bf16_comm_dtype(port):
    x = INPUTS["real"]
    assert rel(port["rbf16/got"], np.fft.rfftn(x)) < 2e-2
    assert rel(port["rbf16/back"], x) < 3e-2


def test_fft1d_distributed_bf16_comm(port):
    assert rel(port["d1bf16"], np.fft.fft(INPUTS["d4096"])) < 2e-2


def test_fft2d_bf16_comm(port):
    want = np.fft.fft2(INPUTS["slab_bf16"])
    assert rel(port["slab_bf16/got"], want) < 2e-2
    assert np.linalg.norm(port["slab_bf16/got"] - port["slab_bf16/exact"]) > 0.0


def test_fft3d_transposed_roundtrip(port, pm):
    x = INPUTS["tround"]
    assert tuple(port["tround/placements"]) == ("Shard:1", "Shard:2")
    close(port["tround/spec"], np.asarray(jpencil.fft3d(x, pm, transposed_output=True)))
    close(port["tround/spec"], np.fft.fftn(x))
    close(port["tround/back"], x)
    xb = INPUTS["tround_lead"]
    assert rel(port["tround/lead_bf16"], xb) < 2e-2
    assert port["tround/exclusive_raises"]


def test_rfft3d_transposed_roundtrip(port, pm):
    # nb = 17 bins on py = 4: the padded half-spectrum axis, uneven shards
    x = INPUTS["real"]
    assert tuple(port["rtround/shape"]) == (8, 16, 17)
    close(port["rtround/spec"], np.asarray(jpencil.rfft3d(x, pm, transposed_output=True)))
    close(port["rtround/spec"], np.fft.rfftn(x))
    close(port["rtround/back"], x)
    for norm in ("ortho", "forward"):
        close(port[f"rtround/{norm}"], x)


def test_rfft3d_odd_z_both_layouts(port, pm):
    x = INPUTS["oddz"]
    for key, t in (("oddz/spec", False), ("oddz/tspec", True)):
        close(port[key], np.asarray(jpencil.rfft3d(x, pm, transposed_output=t)))
        close(port[key], np.fft.rfftn(x))
    want = np.asarray(jpencil.irfft3d(jpencil.rfft3d(x, pm), 15, pm))
    for key in ("oddz/back", "oddz/tback", "oddz/global_t"):
        close(port[key], want)
        close(port[key], x)


def test_turns_count_their_copies(port):
    # natural fft3d, chunks 1: 4 turns, at most one pack and one unpack
    # copy each; the Y->X turn's unpack (concat on the shard's first axis)
    # is a view.  (The restoring X turn's pack, split on the first axis,
    # is a view of a contiguous shard, as the card's axis(-3) entry leaves
    # it; the CPU's plain route leaves a transposed view, which it copies.)
    turns, packs, unpacks, chunk_copies = port["stats/natural"]
    assert turns == 4 and packs <= 4 and unpacks == 3 and chunk_copies == 0


def test_fft3d_overlap_schedule_structure(port):
    """chunks = 4: each pipelined FFT -> turn pair issues 4 separate async
    exchanges, and chunk i's is waited on only after chunk i+1's FFT was
    issued (the counterpart of the JAX test's HLO structure check)."""
    ev = list(port["schedule/4"])
    one = list(port["schedule/1"])
    assert sum(e.startswith("a2a") for e in one) == 4
    a2a = [e for e in ev if e.startswith("a2a")]
    assert len(a2a) == 2 * 4 + 2 and all(e.endswith(":1") for e in a2a)
    for pair in range(2):
        for c in range(3):
            i = pair * 4 + c
            issued = ev.index(f"a2a:{i}:1")
            waited = ev.index(f"wait:{i}")
            ffts = [k for k, e in enumerate(ev) if e.startswith("fft") and issued < k < waited]
            assert len(ffts) == 1, ev  # chunk i+1's FFT between them
            assert ev.index(f"a2a:{i + 1}:1") < waited  # and its exchange issued
    assert [e for e in ev if e.startswith("fft")] == (["fft:2"] * 4 + ["fft:1"] * 4 + ["fft:0"])


def test_tune_overlap_chunks_smoke(port):
    best, served, alone = port["tune"]
    assert best in (1, 2) and served == best and alone == 1


def test_fft3d_gradient_across_ranks(port, pm):
    x, w = INPUTS["grad_x"], INPUTS["grad_w"]

    def loss(v):
        return jnp.sum(jnp.abs(jpencil.fft3d(v, pm, overlap_chunks=2)) ** 2 * w)

    g = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    close(port["grad3d/grad"], np.conj(g))
    # the adjoint written out: 2 F^H (w * F x) = 2 N ifftn(w * fftn(x))
    close(port["grad3d/grad"], 2 * x.size * np.fft.ifftn(w * np.fft.fftn(x)))
    close(port["grad3d/loss"], float(loss(jnp.asarray(x))))


def test_fft1d_distributed_gradient_across_ranks(port, fm):
    v, w = INPUTS["grad_v"], INPUTS["grad_wv"]

    def loss(a):
        return jnp.sum(jnp.abs(jpencil.fft1d_distributed(a, fm)) ** 2 * w)

    close(port["grad1d/grad"], np.conj(np.asarray(jax.grad(loss)(jnp.asarray(v)))))
    close(port["grad1d/grad"], 2 * v.size * np.fft.ifft(w * np.fft.fft(v)))


def test_pencil_model_comm_bytes():
    """The interconnect model halves its wire floor for bf16 turns and
    leaves the compute floor alone, as the JAX model does."""
    from fft_wgpu_tpu_torch.utils.roofline import pencil_fft3d_model

    f32 = pencil_fft3d_model(512, (4, 2), hbm_bw=3.35e12, ici_bw=9e11)
    bf16 = pencil_fft3d_model(512, (4, 2), hbm_bw=3.35e12, ici_bw=9e11, comm_bytes=4.0)
    assert abs(bf16["ici_s"] - f32["ici_s"] / 2) < 1e-12
    assert bf16["compute_s"] == f32["compute_s"]


def test_pencil_model_formula():
    """The port's model: 3 passes of the card's slice through device
    memory; each turn sends (m-1)/m of the slice at one direction's NVLink
    rate (half the aggregate), every turn with all of it (NVSwitch)."""
    from fft_wgpu_tpu_torch.utils.roofline import ici_bandwidth, pencil_fft3d_model

    n, (px, py), hbm, ici = 256, (2, 4), 3.35e12, 9e11
    m = pencil_fft3d_model(n, (px, py), hbm_bw=hbm, ici_bw=ici)
    local = 8.0 * n ** 3 / (px * py)
    assert m["compute_s"] == pytest.approx(6 * local / hbm, rel=1e-12)
    wire = local * (2 * (py - 1) / py + 2 * (px - 1) / px)
    assert m["ici_bytes_per_chip"] == pytest.approx(wire, rel=1e-12)
    assert m["ici_s"] == pytest.approx(wire / (ici / 2), rel=1e-12)
    t = pencil_fft3d_model(n, (px, py), hbm_bw=hbm, ici_bw=ici, transposed_output=True)
    assert t["ici_s"] == pytest.approx(local * ((py - 1) / py + (px - 1) / px) / (ici / 2))
    # one card: no turns, and config 5's floor: 3 x 2 x 8 GiB at 3.35 TB/s
    one = pencil_fft3d_model(1024, (1, 1), hbm_bw=hbm, ici_bw=ici)
    assert one["ici_s"] == 0.0
    assert one["overlapped_s"] == pytest.approx(6 * 8 * 1024 ** 3 / hbm)
    assert ici_bandwidth(torch.device("cpu")) == 9e11


def test_no_group_path_runs_here():
    """With no mesh and no process group every turn is the identity: the
    transforms run in this process, on the CPU tensor's device, against
    the JAX functions on their default meshes."""
    import torch.distributed as dist

    from fft_wgpu_tpu_torch.parallel import pencil

    assert not dist.is_initialized()
    x, r = INPUTS["overlap"], INPUTS["real"]
    got = pencil.fft3d(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    close(got.numpy(), np.asarray(jpencil.fft3d(x)))
    X = pencil.rfft3d(torch.from_numpy(r), transposed_output=True)
    close(X.numpy(), np.asarray(jpencil.rfft3d(r, transposed_output=True)))
    close(pencil.irfft3d(X, 32, transposed_input=True).numpy(), r)
    close(pencil.fft1d_distributed(torch.from_numpy(INPUTS["d4096"])).numpy(),
          np.asarray(jpencil.fft1d_distributed(INPUTS["d4096"])))
