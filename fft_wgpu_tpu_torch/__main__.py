"""Command-line entry: ``python -m fft_wgpu_tpu_torch <cmd>`` (torch port
of ``fft_wgpu_tpu.__main__``).

    info         device/backend/roofline summary (one JSON line)
    selftest     quick oracle check of the core paths on this device
    export-plan  serialize a plan's routes and kernels to an AOT artifact
    tune         measure the routes of each n on this card and persist the
                 winners (plan/autotune.measure_executor; with --extras
                 also the fused-plane crossover, tune_fused_plane)

Every command runs on the current CUDA device; ``--device cpu`` runs it
on the CPU (the plain path).  The JAX CLI's ``bench`` waits for the port's
benchmark harness.
"""

from __future__ import annotations

import argparse
import json
import sys


def _device(args):
    import torch

    from fft_wgpu_tpu_torch.core.complex_utils import default_device

    return torch.device(args.device) if args.device else default_device()


def _cmd_info(args) -> int:
    import torch

    import fft_wgpu_tpu_torch as ft
    from fft_wgpu_tpu_torch.utils.roofline import hbm_bandwidth

    dev = _device(args)
    on_card = dev.type == "cuda"
    info = {
        "version": ft.__version__,
        "backend": dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 1,
        "hbm_bandwidth_GBps": round(hbm_bandwidth(dev) / 1e9, 1),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    print(json.dumps(info))
    return 0


def _cmd_selftest(args) -> int:
    import numpy as np
    import scipy.fft
    import scipy.signal as sig
    import torch

    import fft_wgpu_tpu_torch as ft

    dev = _device(args)
    rng = np.random.default_rng(0)
    ok = True

    def check(tag, got, want, tol=1e-5):
        nonlocal ok
        got = ft.device_get_complex(got)
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        good = rel < tol
        ok &= good
        print(f"  {tag}: rel={rel:.2e} {'ok' if good else 'FAIL'}")

    n = args.n
    x = (rng.standard_normal((8, n)) + 1j * rng.standard_normal((8, n))).astype(np.complex64)
    xt = ft.device_put_complex(x, dev)
    p = ft.plan(n)
    check("plan.forward", p.forward(xt), np.fft.fft(x, axis=-1))
    check("plan roundtrip", p.inverse(p.forward(xt)), x)
    xr = rng.standard_normal((8, n)).astype(np.float32)
    xrt = torch.from_numpy(xr).to(dev)
    check("rfft", ft.rfft(xrt), np.fft.rfft(xr, axis=-1))
    check("dct-II", ft.dct(xrt), scipy.fft.dct(xr), tol=1e-4)
    sperseg = min(512, n)
    sx = rng.standard_normal(16 * sperseg).astype(np.float32)
    _, p1 = ft.welch(torch.from_numpy(sx).to(dev), nperseg=sperseg)
    _, p2 = sig.welch(sx, nperseg=sperseg)
    check("welch", p1, p2, tol=1e-4)
    print("selftest:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def _cmd_export_plan(args) -> int:
    import fft_wgpu_tpu_torch as ft

    p = ft.plan(args.n)
    ft.export_plan(p, args.out, batch_shape=(args.batch,), device=_device(args))
    print(f"exported plan(n={args.n}, batch={args.batch}) -> {args.out}")
    return 0


def _cmd_tune(args) -> int:
    import fft_wgpu_tpu_torch as ft
    from fft_wgpu_tpu_torch.plan import autotune

    dev = _device(args)
    rc = 0
    for n in args.n:
        before = set(autotune.TIMES)
        best = autotune.measure_executor(ft.plan(n, autotune=True), (args.rows, n), -1, dev)
        times = [t for k, t in autotune.TIMES.items() if k not in before]
        timed = "" if not times else " (" + ", ".join(
            f"{ex} {s * 1e3:.4f} ms" for ex, s in times[0].items()) + ")"
        print(f"n={n} rows={args.rows}: {best}{timed}")
    if args.extras:
        try:
            print(f"fused-plane envelope: {autotune.tune_fused_plane(device=dev)}")
        except RuntimeError as e:
            print(f"extras: {e}", file=sys.stderr)
            rc = 1
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fft_wgpu_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def command(name, help):
        sp = sub.add_parser(name, help=help)
        sp.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA device)")
        return sp

    command("info", help="device/backend summary (JSON)")
    st = command("selftest", help="quick oracle check")
    st.add_argument("--n", type=int, default=1024)
    ep = command("export-plan", help="AOT plan artifact")
    ep.add_argument("n", type=int)
    ep.add_argument("out")
    ep.add_argument("--batch", type=int, default=8)
    tn = command("tune", help="measure + persist the routes of each n on this card")
    tn.add_argument("n", type=int, nargs="+")
    tn.add_argument("--rows", type=int, default=1024)
    tn.add_argument("--extras", action="store_true",
                    help="also tune the fused-plane crossover for this card")
    args = ap.parse_args(argv)
    return {"info": _cmd_info, "selftest": _cmd_selftest,
            "export-plan": _cmd_export_plan, "tune": _cmd_tune}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
