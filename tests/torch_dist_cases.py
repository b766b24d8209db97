"""The rank side of the distributed CPU tests of the torch port
(``tests/test_torch_parallel.py``, ``test_torch_ns3d.py``,
``test_torch_multihost.py``, ``test_torch_fno_tp.py``).

A test module calls :func:`run_suite` once (a module-scoped fixture): it
writes the test's numpy inputs to ``inputs.npz`` in a fresh directory and
spawns ``world`` ranks of

    python tests/torch_dist_cases.py <suite> <rank> <world> <directory>

each of which joins one gloo process group through a ``file://`` store in
that directory, runs every case of the suite on CPU tensors and, on rank 0,
writes the whole (gathered) results to ``results.npz``.  The ranks import
torch, numpy and the port only: no jax and nothing of the JAX package.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------- #
# the test process's side
# --------------------------------------------------------------------- #
def run_suite(suite: str, workdir, inputs: dict, world: int = 8,
              timeout: float = 300.0) -> dict:
    """Spawn the ranks of ``suite`` on ``inputs``; return rank 0's results.
    A rank that fails ends the others and raises with its log."""
    workdir = str(workdir)
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    env.pop("LOCAL_WORLD_SIZE", None)
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, str(r),
                               str(world), workdir], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        t0 = time.monotonic()
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad or time.monotonic() - t0 > timeout:
                r = bad[0] if bad else 0
                with open(os.path.join(workdir, f"rank{r}.log")) as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(f"suite {suite}: rank {r} "
                                   f"{'failed' if bad else 'timed out'}:\n{tail}")
            time.sleep(0.05)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(workdir, f"rank{r}.log")) as f:
                    raise RuntimeError(f"suite {suite}: rank {r} failed:\n{f.read()[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    with np.load(os.path.join(workdir, "results.npz")) as z:
        return dict(z)


# --------------------------------------------------------------------- #
# the ranks' side
# --------------------------------------------------------------------- #
def _whole(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy()


def _placements(t) -> np.ndarray:
    return np.array([f"{type(p).__name__}:{getattr(p, 'dim', '')}" for p in t.placements])


def _raises(fn, exc) -> np.ndarray:
    try:
        fn()
    except exc:
        return np.array(True)
    return np.array(False)


def _t(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def parallel_cases(inp, wd):
    """Every case of tests/test_distributed.py but the FNO-3D dp x tp step
    (``fno_tp_cases``), and the port's own."""
    import torch
    import torch.distributed as dist

    from fft_wgpu_tpu_torch.parallel import batched, pencil
    from fft_wgpu_tpu_torch.parallel import mesh as meshlib
    from fft_wgpu_tpu_torch.plan import autotune as at

    pm = meshlib.make_pencil_mesh()
    fm = meshlib.make_mesh()
    bf = torch.bfloat16
    out = {"mesh/shape": np.array(pm.shape), "mesh/names": np.array(pm.mesh_dim_names)}

    x = _t(inp["pencil"])
    out["pencil/fwd"] = _whole(pencil.fft3d(x, pm))
    out["pencil/inv"] = _whole(pencil.ifft3d(x, pm))
    out["transposed_out"] = _whole(pencil.fft3d(_t(inp["transposed_out"]), pm,
                                                transposed_output=True))
    x = _t(inp["cube32"])
    out["cube32"] = _whole(pencil.ifft3d(pencil.fft3d(x, pm), pm))
    x = _t(inp["slab"])
    out["slab/fwd"] = _whole(pencil.fft2d(x, fm))
    out["slab/inv"] = _whole(pencil.ifft2d(x, fm))
    for k in ("d4096", "d65536", "d1024", "d320", "d48"):
        y = pencil.fft1d_distributed(_t(inp[k]), fm)
        out[f"{k}/placements"] = _placements(y)
        out[k] = _whole(y)
    out["d4096/inv"] = _whole(pencil.fft1d_distributed(_t(inp["d4096"]), fm, inverse=True))
    x = _t(inp["norms"])
    for norm in (None, "ortho", "forward"):
        out[f"norms/fwd/{norm}"] = _whole(pencil.fft3d(x, pm, norm=norm))
        out[f"norms/inv/{norm}"] = _whole(pencil.ifft3d(x, pm, norm=norm))
    out["rfft3d"] = _whole(pencil.rfft3d(_t(inp["rfft3d"]), pm))
    X = pencil.rfft3d(_t(inp["real"]), pm)
    out["irfft3d"] = _whole(pencil.irfft3d(X, n_last=32, mesh=pm))
    for norm in ("ortho", "forward"):
        Xn = pencil.rfft3d(_t(inp["real"]), pm, norm=norm)
        out[f"irfft3d/{norm}"] = _whole(pencil.irfft3d(Xn, n_last=32, mesh=pm, norm=norm))
    x = _t(inp["batch"])
    out["batch/fwd"] = _whole(batched.fft_batch_sharded(x, fm))
    out["batch/inv"] = _whole(batched.ifft_batch_sharded(x, fm))
    x = _t(inp["overlap"])
    for chunks in (1, 2, 4, 16):
        out[f"overlap/{chunks}"] = _whole(pencil.fft3d(x, pm, overlap_chunks=chunks))
    out["overlap/roundtrip"] = _whole(pencil.ifft3d(pencil.fft3d(x, pm, overlap_chunks=4), pm,
                                                    overlap_chunks=4))
    x = _t(inp["allnorms"])
    for norm in (None, "ortho", "forward"):
        got = pencil.rfft3d(x, pm, norm=norm)
        out[f"allnorms/{norm}"] = _whole(got)
        out[f"allnorms/back/{norm}"] = _whole(pencil.irfft3d(got, n_last=16, mesh=pm, norm=norm))
    x = _t(inp["lead3"])
    out["lead3/fwd"] = _whole(pencil.fft3d(x, pm))
    out["lead3/inv"] = _whole(pencil.ifft3d(x, pm, norm="ortho"))
    out["lead2"] = _whole(pencil.fft2d(_t(inp["lead2"]), fm))
    X = pencil.rfft3d(_t(inp["rlead"]), pm)
    out["rlead/shape"] = np.array(X.shape)
    out["rlead/fwd"] = _whole(X)
    out["rlead/back"] = _whole(pencil.irfft3d(X, 32, pm))

    # bf16 wire turns
    x = _t(inp["overlap"])
    out["bf16/exact"] = _whole(pencil.fft3d(x, pm))
    out["bf16/got"] = _whole(pencil.fft3d(x, pm, comm_dtype=bf))
    out["bf16/back"] = _whole(pencil.ifft3d(pencil.fft3d(x, pm, comm_dtype="bfloat16"), pm,
                                            comm_dtype="bfloat16"))
    out["bf16/float16_raises"] = _raises(lambda: pencil.fft3d(x, pm, comm_dtype=np.float16),
                                         ValueError)
    out["bf16/torch_float16_raises"] = _raises(
        lambda: pencil.fft3d(x, pm, comm_dtype=torch.float16), ValueError)
    r = _t(inp["real"])
    got = pencil.rfft3d(r, pm, comm_dtype=bf)
    out["rbf16/got"] = _whole(got)
    out["rbf16/back"] = _whole(pencil.irfft3d(got, n_last=32, mesh=pm, comm_dtype=bf))
    out["d1bf16"] = _whole(pencil.fft1d_distributed(_t(inp["d4096"]), fm, comm_dtype=bf))
    x = _t(inp["slab_bf16"])
    out["slab_bf16/exact"] = _whole(pencil.fft2d(x, fm))
    out["slab_bf16/got"] = _whole(pencil.fft2d(x, fm, comm_dtype=bf))

    # transposed round trips (4 turns), a DTensor spectrum fed back
    x = _t(inp["tround"])
    X = pencil.fft3d(x, pm, transposed_output=True)
    out["tround/placements"] = _placements(X)
    out["tround/spec"] = _whole(X)
    out["tround/back"] = _whole(pencil.ifft3d(X, pm, transposed_input=True))
    Xb = pencil.fft3d(_t(inp["tround_lead"]), pm, transposed_output=True, comm_dtype=bf)
    out["tround/lead_bf16"] = _whole(pencil.ifft3d(Xb, pm, transposed_input=True, comm_dtype=bf))
    out["tround/exclusive_raises"] = _raises(
        lambda: pencil.fft3d(x, pm, transposed_output=True, transposed_input=True), ValueError)
    r = _t(inp["real"])
    X = pencil.rfft3d(r, pm, transposed_output=True)
    out["rtround/shape"] = np.array(X.shape)
    out["rtround/local_widths"] = np.array(X.to_local().shape[-1])
    out["rtround/spec"] = _whole(X)
    out["rtround/back"] = _whole(pencil.irfft3d(X, n_last=32, mesh=pm, transposed_input=True))
    for norm in ("ortho", "forward"):
        Xn = pencil.rfft3d(r, pm, norm=norm, transposed_output=True)
        out[f"rtround/{norm}"] = _whole(pencil.irfft3d(Xn, n_last=32, mesh=pm, norm=norm,
                                                       transposed_input=True))
    # odd Z: the C2C route of a zero imaginary plane, both layouts
    r = _t(inp["oddz"])
    X = pencil.rfft3d(r, pm)
    out["oddz/spec"] = _whole(X)
    out["oddz/back"] = _whole(pencil.irfft3d(X, n_last=15, mesh=pm))
    X = pencil.rfft3d(r, pm, transposed_output=True)
    out["oddz/tspec"] = _whole(X)
    out["oddz/tback"] = _whole(pencil.irfft3d(X, n_last=15, mesh=pm, transposed_input=True))
    # a global array given to the transposed input: each rank slices it
    out["oddz/global_t"] = _whole(pencil.irfft3d(_t(_whole(X)), n_last=15, mesh=pm,
                                                 transposed_input=True))

    # the turns' copies: 4 turns, one pack and one unpack each but where
    # the split (concat) axis is the shard's first (a view)
    pencil.reset_stats()
    pencil.fft3d(_t(inp["pencil"]), pm, overlap_chunks=1)
    out["stats/natural"] = np.array([pencil.STATS[k] for k in
                                     ("turns", "pack_copies", "unpack_copies", "chunk_copies")])

    # the pipeline's schedule, recorded: exchanges issued, waited, FFTs
    events = []
    real_a2a, real_fft = dist.all_to_all_single, pencil._fft_axis_local

    class Work:
        def __init__(self, work, i):
            self.work, self.i = work, i

        def wait(self):
            events.append(f"wait:{self.i}")
            return self.work.wait()

    def a2a(*args, async_op=False, **kw):
        i = sum(e.startswith("a2a") for e in events)
        events.append(f"a2a:{i}:{int(async_op)}")
        work = real_a2a(*args, async_op=async_op, **kw)
        return Work(work, i) if async_op else work

    def fft(x, axis, sign, scale):
        events.append(f"fft:{axis}")
        return real_fft(x, axis, sign, scale)

    for chunks in (4, 1):
        events.clear()
        dist.all_to_all_single, pencil._fft_axis_local = a2a, fft
        try:
            pencil.fft3d(_t(inp["schedule"]), pm, overlap_chunks=chunks)
        finally:
            dist.all_to_all_single, pencil._fft_axis_local = real_a2a, real_fft
        out[f"schedule/{chunks}"] = np.array(events)

    # tune_overlap_chunks on this gloo group, its wisdom in this directory
    at._WISDOM_PATH = os.path.join(wd, f"wisdom{dist.get_rank()}.json")
    at.OVERLAP_CACHE.clear()
    best = at.tune_overlap_chunks(pm, shape=(32, 32, 64), candidates=(1, 2), repeats=1)
    at.OVERLAP_CACHE.clear()
    at.load_wisdom(at._WISDOM_PATH)
    out["tune"] = np.array([best, at.default_overlap_chunks(pm), at.default_overlap_chunks(None)])

    # gradients across the process boundary: the loss sum(|F(x)|^2 w) of
    # the global x; each rank's backward fills its shard's slice, summed
    x = _t(inp["grad_x"]).requires_grad_(True)
    w = pencil._local(_t(inp["grad_w"]), pm, (0, 1), torch.float32)
    y = pencil.fft3d(x, pm, overlap_chunks=2).to_local()
    loss = ((y.real ** 2 + y.imag ** 2) * w).sum()
    loss.backward()
    g = x.grad.clone()
    dist.all_reduce(g)
    loss = loss.detach()
    dist.all_reduce(loss)
    out["grad3d/grad"], out["grad3d/loss"] = g.numpy(), loss.numpy()
    v = _t(inp["grad_v"]).requires_grad_(True)
    y = pencil.fft1d_distributed(v, fm).to_local()
    wv = pencil._local(_t(inp["grad_wv"]), fm, (0,), torch.float32)
    loss = ((y.real ** 2 + y.imag ** 2) * wv).sum()
    loss.backward()
    g = v.grad.clone()
    dist.all_reduce(g)
    out["grad1d/grad"] = g.numpy()
    return out


def ns3d_cases(inp, wd):
    """tests/test_ns3d.py's cases at n = 16 and the distributed Poisson
    solve, on the (2, 4) pencil mesh."""
    import torch
    import torch.distributed as dist

    from fft_wgpu_tpu_torch.models import ns3d, poisson

    n = 16
    cpu = torch.device("cpu")
    out = {}
    c = ns3d.ns3d_init(n, 0.05, 0.1)
    out["abc"] = _whole(ns3d.ns3d_rollout(c, ns3d.abc_flow(n, device=cpu), 6))
    c = ns3d.ns3d_init(n, 0.02, 0.05)
    out["random"] = _whole(ns3d.ns3d_rollout(c, _t(inp["u7"]), 3))
    c = ns3d.ns3d_init(n, 0.02, 0.05, transposed_spectra=False)
    out["natural"] = _whole(ns3d.ns3d_rollout(c, _t(inp["u7"]), 3))
    c = ns3d.ns3d_init(n, 0.05, 0.05)
    out["div/u1"] = _whole(ns3d.ns3d_rollout(c, _t(inp["u3"]), 2))
    out["div/u2"] = _whole(ns3d.ns3d_rollout(c, _t(inp["u3"]), 5))
    c = ns3d.ns3d_init(n, 0.05, 0.05)
    u0 = ns3d.abc_flow(n, device=cpu)
    out["cache/a"] = _whole(ns3d.ns3d_rollout(c, u0, 2))
    out["cache/cached"] = np.array(bool(c._jit_cache))
    out["cache/b"] = _whole(ns3d.ns3d_rollout(c, u0, 2))
    exact = ns3d.ns3d_init(n, nu=0.01, dt=1e-3)
    bf16 = ns3d.ns3d_init(n, nu=0.01, dt=1e-3, comm_dtype=torch.bfloat16)
    out["bf16/exact"] = _whole(ns3d.ns3d_rollout(exact, u0, 2))
    out["bf16/got"] = _whole(ns3d.ns3d_rollout(bf16, u0, 2))
    # the projection leaves each rank's shard of a random spectrum
    # solenoidal: max |k . P(F)| over max |F|, across the ranks
    t = c.tables(cpu)
    F = torch.randn((3,) + torch.broadcast_shapes(t["kx"].shape, t["ky"].shape, t["kz"].shape),
                    dtype=torch.complex64, generator=torch.Generator().manual_seed(dist.get_rank()))
    P = ns3d.project_divergence_free(c, *(F * t["mask"]))
    div = (t["kx"] * P[0] + t["ky"] * P[1] + t["kz"] * P[2]).abs().max()
    top = F.abs().max()
    dist.all_reduce(div, op=dist.ReduceOp.MAX)
    dist.all_reduce(top, op=dist.ReduceOp.MAX)
    out["project"] = (div / top).numpy()
    f = _t(inp["poisson"])
    out["poisson"] = _whole(poisson.solve_poisson_distributed(f))
    out["poisson/lengths"] = _whole(poisson.solve_poisson_distributed(
        f, lengths=(2 * np.pi, 4 * np.pi, np.pi)))
    out["poisson/bf16"] = _whole(poisson.solve_poisson_distributed(
        f, comm_dtype=torch.bfloat16))
    return out


def multihost_cases(inp, wd):
    """Bring-up: initialize's idempotence, the global pencil mesh, the
    hybrid mesh over real and faked nodes."""
    import socket

    import torch.distributed as dist

    from fft_wgpu_tpu_torch.parallel import mesh as meshlib
    from fft_wgpu_tpu_torch.parallel import pencil
    from fft_wgpu_tpu_torch.parallel.multihost import global_pencil_mesh, initialize

    out = {"initialize": np.array(initialize("file:///nonexistent", 8, 0))}
    g = global_pencil_mesh()
    out["global/shape"] = np.array(g.shape)
    h = meshlib.make_hybrid_mesh()  # one host: one node
    out["hybrid/shape"] = np.array(h.shape)
    out["hybrid/names"] = np.array(h.mesh_dim_names)
    os.environ["LOCAL_WORLD_SIZE"] = "4"  # torchrun's ranks a node, faked
    try:
        h4 = meshlib.make_hybrid_mesh()
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    out["lws/mesh"] = h4.mesh.numpy()
    # corner turns on the hybrid mesh's ranks, relabelled as a pencil mesh
    m = meshlib.make_mesh((2, 4), ("px", "py"), h.mesh.flatten().tolist())
    x = _t(inp["hybrid"])
    out["hybrid/roundtrip"] = _whole(pencil.ifft3d(pencil.fft3d(x, m), m))
    # faked nodes through the host-name all-gather: each rank reports the
    # host it would be on
    rank, real_host = dist.get_rank(), socket.gethostname
    try:
        socket.gethostname = lambda: f"h{int(rank >= 5)}"  # 5 ranks and 3
        out["uneven_raises"] = _raises(meshlib.make_hybrid_mesh, ValueError)
        socket.gethostname = lambda: f"h{rank % 2}"  # interleaved
        out["two/mesh"] = meshlib.make_hybrid_mesh().mesh.numpy()
    finally:
        socket.gethostname = real_host
    out["decreasing_raises"] = _raises(
        lambda: meshlib.make_mesh((2, 4), ("px", "py"), list(range(7, -1, -1))), ValueError)
    out["not_divisible_raises"] = _raises(
        lambda: pencil.fft3d(_t(inp["ragged"]), g), ValueError)
    return out


FNO_NAMES = ("lift", "proj") + tuple(f"blocks.{i}.{k}" for i in range(2)
                                     for k in ("wr", "wi", "pw", "b"))


def _fno_model(inp, prefix="p/"):
    """The FNO3d of the JAX pytree stored as numpy under ``prefix``, on
    the CPU."""
    from fft_wgpu_tpu_torch.models.spectral import from_numpy

    tree = {"lift": inp[prefix + "lift"], "proj": inp[prefix + "proj"],
            "blocks": [{k: inp[f"{prefix}blocks.{i}.{k}"] for k in ("wr", "wi", "pw", "b")}
                       for i in range(2)]}
    return from_numpy(tree, device="cpu")


def fno_tp_cases(inp, wd):
    """tests/test_distributed.py's FNO-3D dp x tp training step on the
    (2, 4) mesh, every gradient and updated parameter, the meshes (8, 1),
    (1, 8) and (4, 2), two steps, DTensor input and the errors."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from fft_wgpu_tpu_torch.models.spectral import init_fno3d
    from fft_wgpu_tpu_torch.parallel import fno
    from fft_wgpu_tpu_torch.parallel import mesh as meshlib

    out = {}

    def whole(sh, vals, tp):
        """Each of this rank's ``vals`` (parameters or gradients, in
        ``sh.named_parameters()`` order) made whole: a weight slice
        all-gathered over the ``tp`` dimension's group."""
        got = {}
        for (name, _), v in zip(sh.named_parameters(), vals):
            v = v.detach()
            if name.endswith(("wr", "wi")) and tp.size() > 1:
                parts = [torch.empty_like(v) for _ in range(tp.size())]
                dist.all_gather(parts, v.contiguous(), group=tp)
                v = torch.cat(parts, dim=-1)
            got[name] = v.numpy()
        return got

    def run(key, mesh, x, y, steps=1):
        sh = fno.shard_params(_fno_model(inp), mesh)
        tp = mesh.get_group("tp")
        loss, grads = fno.value_and_grad(sh, x, y)
        out[f"{key}/loss"] = loss.numpy()
        for name, g in whole(sh, grads, tp).items():
            out[f"{key}/grad/{name}"] = g
        for s in range(steps):
            _, loss = fno.train_step(sh, x, y, lr=1e-3)
            out[f"{key}/step{s}/loss"] = loss.numpy()
        for name, v in whole(sh, list(sh.parameters()), tp).items():
            out[f"{key}/param/{name}"] = v
        full = fno.gather_params(sh)
        out[f"{key}/gathered_equal"] = np.array(all(
            np.array_equal(p.detach().numpy(), out[f"{key}/param/{n}"])
            for n, p in full.named_parameters()))
        return sh

    m24 = meshlib.make_pencil_mesh(axis_names=("dp", "tp"))
    out["mesh24/shape"] = np.array(m24.shape)
    # no mesh with a process group: the pencil mesh over every rank
    default = fno.shard_params(_fno_model(inp)).mesh
    out["default/mesh"] = np.array([*default.shape, *default.mesh_dim_names])
    x, y = _t(inp["x"]), _t(inp["y"])
    sh = run("m24", m24, x, y, steps=2)
    # after two steps the replicated parameters are the same bits on every
    # rank, and each weight slice has width/tp output channels
    rep = torch.cat([p.detach().reshape(-1) for n, p in sh.named_parameters()
                     if not n.endswith(("wr", "wi"))])
    reps = [torch.empty_like(rep) for _ in range(dist.get_world_size())]
    dist.all_gather(reps, rep)
    out["m24/replicated_bits"] = np.array([torch.equal(reps[0], r) for r in reps])
    shapes = [None] * dist.get_world_size()
    dist.all_gather_object(shapes, [tuple(p.shape) for n, p in sh.named_parameters()
                                    if n.endswith(("wr", "wi"))])
    out["m24/slice_shapes"] = np.array(shapes)
    # DTensor input in [Shard(0) on dp, Replicate() on tp]: the same step
    place = [Shard(0), Replicate()]
    sd = fno.shard_params(_fno_model(inp), m24)
    _, loss = fno.train_step(sd, distribute_tensor(x, m24, place),
                             distribute_tensor(y, m24, place), lr=1e-3)
    out["dtensor/loss"] = loss.numpy()
    for name, v in whole(sd, list(sd.parameters()), m24.get_group("tp")).items():
        out[f"dtensor/param/{name}"] = v

    x16, y16 = _t(inp["x16"]), _t(inp["y16"])
    for shape in ((8, 1), (1, 8), (4, 2)):
        m = meshlib.make_mesh(shape, ("dp", "tp"))
        run(f"m{shape[0]}{shape[1]}", m, x16, y16)

    # the errors, raised on every rank before any collective
    m18 = meshlib.make_mesh((1, 8), ("dp", "tp"))
    narrow = init_fno3d(torch.Generator().manual_seed(0), modes=(4, 4, 4), width=12, depth=2,
                        device="cpu")
    out["raises/width"] = _raises(lambda: fno.shard_params(narrow, m18), ValueError)
    out["raises/batch"] = _raises(lambda: fno.train_step(
        fno.shard_params(_fno_model(inp), m24), x[:3], y[:3]), ValueError)
    out["raises/mesh_names"] = _raises(
        lambda: fno.shard_params(_fno_model(inp), meshlib.make_pencil_mesh()), ValueError)
    out["raises/one_dim_mesh"] = _raises(
        lambda: fno.shard_params(_fno_model(inp), meshlib.make_mesh(axis_names=("dp",))),
        ValueError)
    return out


SUITES = {"parallel": parallel_cases, "ns3d": ns3d_cases, "multihost": multihost_cases,
          "fno_tp": fno_tp_cases}


def _rank_main(suite: str, rank: int, world: int, workdir: str) -> None:
    import torch
    import torch.distributed as dist

    from fft_wgpu_tpu_torch.parallel.multihost import initialize

    torch.set_num_threads(1)
    initialize(f"file://{workdir}/store", world, rank, backend="gloo")
    with np.load(os.path.join(workdir, "inputs.npz")) as z:
        inputs = dict(z)
    out = SUITES[suite](inputs, workdir)
    bad = [k for k in ("jax", "fft_wgpu_tpu") if k in sys.modules]
    if bad:
        raise RuntimeError(f"a rank imported {bad}")
    if rank == 0:
        np.savez(os.path.join(workdir, "results.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
