"""Where the device time of the port's driven paths goes.

    python -m mpc_verde_tpu_torch.utils.profile_paths [--backend NAME] [--fleet] [--ipm] [--out FILE]

Runs the streaming solve of the bench queue (16384 problems, N = 40, 1024
slots, ``backend="cuda_fused"`` or with ``--backend cuda`` the eager
derivatives and K1, 60 iterations + 2 restarts) once warm and
unprofiled for its wall time, then once under ``torch.profiler``, and prints
the number of device kernels, their summed time, the device's busy share of
the unprofiled wall, and the time and launches of the hand-written kernels
by name.  With ``--fleet`` it does the same for the closed-loop fleet at
``scenarios.fleet.SPEC``, with ``--ipm`` for the streaming interior-point
solver (cold: mu 1e-2, 1e-4 and the crossover, ``inexact_kappa`` 10) on the
same queue.  Needs a CUDA device; one JSON line per path, also appended to
``--out`` when given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# substrings of the hand-written kernels' names as the profiler reports them
KERNELS = {"K1": ("riccati_warps_kernel", "riccati_thread_kernel"),
           "K2": ("linesearch_lanes_kernel", "linesearch_thread_kernel"),
           "K3": ("fused_staged_kernel", "fused_thread_kernel")}


def _profile(run):
    """(unprofiled wall s, profiled wall s, device-kernel rows) of ``run``."""
    from torch.profiler import ProfilerActivity, profile

    run()                                   # warm: builds, allocator, caches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    profiled = time.perf_counter() - t0
    rows = [(e.key, e.count, e.device_time_total) for e in prof.key_averages()
            if e.device_time_total > 0
            and str(e.device_type).endswith("CUDA")]
    return wall, profiled, rows


def _report(path, wall, profiled, rows, launches):
    n_kernels = sum(c for _, c, _ in rows)
    device_s = sum(t for _, _, t in rows) * 1e-6
    if n_kernels == 0 or device_s == 0.0:
        raise RuntimeError("the profiler recorded no device kernel")
    out = {"path": path, "wall_unprofiled_s": wall, "wall_profiled_s": profiled,
           "device_kernels": n_kernels, "device_kernel_s": device_s,
           "busy_share_of_unprofiled_wall": device_s / wall,
           "launches": launches}
    for tag, parts in KERNELS.items():
        mine = [(c, t) for k, c, t in rows if any(p in k for p in parts)]
        out[tag] = {"launches": sum(c for c, _ in mine),
                    "device_ms": sum(t for _, t in mine) * 1e-3}
    out["top"] = [{"name": k[:80], "count": c, "device_ms": t * 1e-3}
                  for k, c, t in sorted(rows, key=lambda r: -r[2])[:8]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="cuda_fused",
                    choices=("cuda", "cuda_fused"))
    ap.add_argument("--fleet", action="store_true")
    ap.add_argument("--ipm", action="store_true")
    ap.add_argument("--out")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_paths: no CUDA device", file=sys.stderr)
        return 1
    from .. import (ILQROptions, make_streaming_barrier_solver,
                    make_streaming_solver)
    from ..interop import bench_ocp
    from ..ops.cuda import fused_backward, linesearch_forward, riccati_backward
    from ..scenarios import build_fleet, run_fleet
    from .platform import gpu_info

    dev = torch.device("cuda", 0)
    gpu = gpu_info()["nvidia_smi"]
    M, W, N = 16384, 1024, 40
    rng = np.random.default_rng(0)
    x0q = rng.uniform(-2.0, 2.0, (M, 3)).astype(np.float32)
    psq = np.broadcast_to(np.array([10.0, 10.0, 0.0], np.float32),
                          (M, N + 1, 3)).copy()
    us0q = np.zeros((M, N, 2), np.float32)
    opts = ILQROptions(max_iters=60, tol_grad=1e-4, tol_cost=1e-6,
                       n_alphas=8, alpha_decay=0.4)
    ocp = bench_ocp(N, dev, torch.float32)
    solve = make_streaming_solver(ocp, opts, backend=ns.backend,
                                  batch_width=W, restarts=2)
    paths = [(f"streaming 16384 x N=40 {ns.backend}", lambda: solve(
        x0q, psq, us0q, max_iters=60, restarts_n=2))]
    if ns.ipm:
        ipm = make_streaming_barrier_solver(ocp, opts, backend=ns.backend,
                                            batch_width=W, restarts=2)
        paths.append((f"streaming IPM cold 16384 x N=40 {ns.backend}",
                      lambda: ipm(x0q, psq, us0q, max_iters=60, restarts_n=2)))
    if ns.fleet:
        built = build_fleet(device=dev, backend=ns.backend)
        paths.append((f"fleet SPEC {ns.backend}", lambda: run_fleet(built)))
    for name, run in paths:
        wall, profiled, rows = _profile(run)
        wrappers = {"K1": riccati_backward, "K2": linesearch_forward,
                    "K3": fused_backward}
        before = {k: f.launches for k, f in wrappers.items()}
        run()
        launches = {k: f.launches - before[k] for k, f in wrappers.items()}
        line = json.dumps({"gpu": gpu, **_report(name, wall, profiled, rows,
                                                 launches)})
        print(line, flush=True)
        if ns.out:
            with open(ns.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
