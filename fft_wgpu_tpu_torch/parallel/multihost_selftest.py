"""Real multi-process bring-up self-test (torch port of
``fft_wgpu_tpu.parallel.multihost_selftest``).

Spawns ``num_processes`` OS processes, one rank each, joins them into one
process group through ``parallel.multihost.initialize`` (a ``file://``
store in a fresh temporary directory), builds the GLOBAL pencil mesh and
runs ``fft3d`` and ``fft1d_distributed`` across the process boundary, with
parity against numpy asserted in every process.  Each child prints
``MULTIHOST_SELFTEST_OK`` with its rank and the world size.

    python -c "from fft_wgpu_tpu_torch.parallel.multihost_selftest import \\
        launch_cluster; print(launch_cluster(4))"

With ``backend="gloo"`` (the default) the ranks compute on the CPU; with
``backend="nccl"`` each takes a card.  ``MultihostUnavailable`` is raised
when the children hang past the timeout (a cluster that never formed).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import threading

__all__ = ["MultihostUnavailable", "launch_cluster", "child_main"]

_OK_MARK = "MULTIHOST_SELFTEST_OK"


class MultihostUnavailable(RuntimeError):
    """The cluster never formed: the children hung past the timeout."""


def _child_env() -> dict:
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo, env.get("PYTHONPATH")) if p)
    return env


def launch_cluster(num_processes: int = 2, backend: str = "gloo",
                   timeout: float = 420.0) -> list[str]:
    """Run the cluster self-test, on the CPU over gloo or on the cards over
    NCCL (one card a rank); returns each process's stdout.  Raises
    ``MultihostUnavailable`` if the children hang past ``timeout`` seconds,
    ``RuntimeError`` if one fails."""
    store = tempfile.mkdtemp(prefix="fft_multihost_")
    try:
        env = _child_env()
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "fft_wgpu_tpu_torch.parallel.multihost_selftest",
                 str(i), str(num_processes), f"file://{store}/store", backend],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(num_processes)
        ]
        # drain every child concurrently: a child blocked on a full pipe
        # would hold its peers in a collective
        results = [None] * num_processes

        def drain(i, p):
            try:
                out, err = p.communicate(timeout=timeout)
                results[i] = (p.returncode, out, err)
            except subprocess.TimeoutExpired:
                results[i] = None

        threads = [threading.Thread(target=drain, args=(i, p), daemon=True)
                   for i, p in enumerate(procs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout + 30)
        if any(r is None for r in results):
            for p in procs:
                p.kill()
                p.wait()
            raise MultihostUnavailable(
                f"the {num_processes}-process cluster did not finish in {timeout} s")
        for rc, out, err in results:
            if rc != 0:
                raise RuntimeError(f"multihost child failed (rc={rc}):\n{out[-1000:]}\n"
                                   f"{err[-3000:]}")
            if _OK_MARK not in out:
                raise RuntimeError(f"child exited 0 without the OK mark:\n{out}")
        return [out for _, out, _ in results]
    finally:
        shutil.rmtree(store, ignore_errors=True)


def child_main(process_id: int, num_processes: int, address: str,
               backend: str = "gloo") -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from .mesh import make_mesh
    from .multihost import global_pencil_mesh, initialize
    from .pencil import fft1d_distributed, fft3d

    torch.set_num_threads(1)
    idx, cnt = initialize(address, num_processes, process_id, backend=backend)
    if (idx, cnt) != (process_id, num_processes):
        raise RuntimeError(f"joined as {idx}/{cnt}, expected {process_id}/{num_processes}")
    dev = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else \
        torch.device("cpu")
    try:
        # --- 3-D pencil FFT across the process boundary -----------------
        mesh = global_pencil_mesh(device_type=dev.type)
        px, py = mesh.shape
        rng = np.random.default_rng(0)  # identical in every process
        x3 = rng.standard_normal((2 * px * py, 2 * px * py, 8)).astype(np.float32)
        y3 = fft3d(torch.from_numpy(x3).to(dev), mesh).full_tensor()
        ref3 = np.fft.fftn(x3)
        err3 = float(np.linalg.norm(y3.cpu().numpy() - ref3) / np.linalg.norm(ref3))
        if not err3 < 1e-5:
            raise RuntimeError(f"fft3d parity across processes: {err3:.3e}")

        # --- distributed four-step 1-D FFT on the flat global mesh ------
        lmesh = make_mesh(axis_names=("seq",), device_type=dev.type)
        v = rng.standard_normal(4096).astype(np.float32)
        w = fft1d_distributed(torch.from_numpy(v).to(dev), lmesh).full_tensor()
        ref1 = np.fft.fft(v)
        err1 = float(np.linalg.norm(w.cpu().numpy() - ref1) / np.linalg.norm(ref1))
        if not err1 < 1e-5:
            raise RuntimeError(f"fft1d_distributed parity: {err1:.3e}")
        print(f"{_OK_MARK} proc={idx}/{cnt} devices={cnt} backend={backend} "
              f"err3d={err3:.3e} err1d={err1:.3e}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    child_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], *sys.argv[4:5])
