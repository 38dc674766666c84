"""Time the line-search and fused kernels under other launch plans.

    python -m mpc_verde_tpu_torch.utils.tune_launch_plans [--out FILE]

The launch plans (``linesearch_launch_plan``, ``fused_launch_plan``) hold a
few constants: the threads of a line-search block, the problems of a fused
block.  This script times each kernel with those constants varied, at the
bench shape (B = 1024, N = 40, A = 8), the fleet's (B = 1024, N = 10,
A = 12) and the pre-rolls' (B = 16384, N = 40 and B = 1024, N = 10, A = 1),
and times each kernel's variants against each other around the horizons
where the plans change variant (N = 150 to 2000) and over batches of one
to many waves of blocks (B = 1024 to 16384), so that the plans' rules rest
on a measurement.
Times are CUDA events over back-to-back launches (``device_time_ms``).
Needs a CUDA device; prints one JSON line per case, also appended to
``--out`` when given.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _k2_args(dev, B, N, A, seed=3):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    target = np.broadcast_to(np.array([10.0, 10.0, 0.0]), (B, N + 1, 3)).copy()
    gain = 0.0 if A == 1 else 1.0
    feedback = gain if N <= 100 else 0.0   # a long clipped loop blows up
    return (t(rng.uniform(-2, 2, (B, 3))), t(rng.uniform(-2, 2, (B, N + 1, 3))),
            t(rng.uniform(-0.8, 0.8, (B, N, 2))), t(target),
            t(gain * 0.3 * rng.normal(size=(B, N, 2))),
            t(feedback * 0.2 * rng.normal(size=(B, N, 2, 3))),
            tuple(0.5 ** i for i in range(A)))


def _k3_args(dev, ocp, B, N, seed=6):
    from ..ops.cuda.rollout import linesearch_forward

    x0, xs, us, ps, kffs, Ks, _ = _k2_args(dev, B, N, 1, seed)
    xs, us, _, _ = linesearch_forward(x0, xs, 0.5 * us, ps, kffs, Ks, (1.0,),
                                      ocp=ocp)
    return (xs, us, ps, torch.full((B,), 1e-6, device=dev),
            torch.ones((B,), device=dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_launch_plans: no CUDA device", file=sys.stderr)
        return 1
    from ..interop import bench_ocp
    from ..ops.cuda import fused, rollout
    from .platform import gpu_info
    from .timing import device_time_ms

    dev = torch.device("cuda", 0)
    gpu = gpu_info()["nvidia_smi"]

    def emit(**row):
        line = json.dumps({"gpu": gpu, **row})
        print(line, flush=True)
        if ns.out:
            with open(ns.out, "a") as f:
                f.write(line + "\n")

    def k2(B, N, A, reps=50, **kw):
        ocp = bench_ocp(N, dev, torch.float32)
        args = _k2_args(dev, B, N, A)
        ms = device_time_ms(
            lambda: rollout.linesearch_forward(*args, ocp=ocp, **kw), reps)
        plan = rollout.linesearch_launch_plan(N, A, 3, kw.get("variant"))
        return {"kernel": "K2", "B": B, "N": N, "A": A, "ms": ms,
                "plan": plan[:4]}

    def k3(B, N, reps=50, **kw):
        ocp = bench_ocp(N, dev, torch.float32)
        args = _k3_args(dev, ocp, B, N)
        ms = device_time_ms(
            lambda: fused.fused_backward(*args, ocp=ocp, **kw), reps)
        plan = fused.fused_launch_plan(N, True, kw.get("variant"), B)
        return {"kernel": "K3", "B": B, "N": N, "ms": ms,
                "plan": plan[:4]}

    shapes = ((1024, 40, 8), (1024, 10, 12), (16384, 40, 1), (1024, 10, 1))
    threads0 = rollout._BLOCK_THREADS
    for threads in (32, 64, 128, 256):
        rollout._BLOCK_THREADS = threads
        for shape in shapes:
            emit(block_threads=threads, **k2(*shape))
    rollout._BLOCK_THREADS = threads0

    problems0 = fused._BLOCK_PROBLEMS
    for problems in (1, 2, 4, 8, 16, 32):
        fused._BLOCK_PROBLEMS = problems
        for B, N in ((1024, 40), (1024, 10)):
            emit(block_problems=problems, **k3(B, N))
    fused._BLOCK_PROBLEMS = problems0

    # every variant that fits, forced: around the horizons where the plans
    # change variant, and over batches of one to many waves of blocks
    batches = (1024, 2048, 4096, 8192, 16384)
    k2_cases = [(1024, 250, 8), (1024, 600, 8), (1024, 2000, 8), (1024, 600, 1)]
    k2_cases += [(B, N, A) for N, A in ((40, 8), (10, 12), (40, 1), (10, 1))
                 for B in batches]
    for B, N, A in k2_cases:
        for variant in rollout.LINESEARCH_VARIANTS:
            try:
                rollout.linesearch_launch_plan(N, A, 3, variant)
            except ValueError:
                continue
            emit(variant=variant, **k2(B, N, A, reps=3, variant=variant))
    k3_cases = [(1024, 150), (1024, 160), (1024, 300), (1024, 600)]
    k3_cases += [(B, N) for N in (40, 10) for B in batches]
    for B, N in k3_cases:
        for variant in fused.FUSED_VARIANTS:
            emit(variant=variant, **k3(B, N, reps=3, variant=variant))
    return 0


if __name__ == "__main__":
    sys.exit(main())
