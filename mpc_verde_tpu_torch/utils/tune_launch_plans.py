"""Time the three kernels under other launch plans.

    python -m mpc_verde_tpu_torch.utils.tune_launch_plans [--out FILE] [--only K1,K2,K3] [--terms] [--widths]

The launch plans (``riccati_launch_plan``, ``linesearch_launch_plan``,
``fused_launch_plan``) hold a few constants: the problems of a Riccati
block and whether its slabs' strides are padded, the threads of a
line-search block, the problems of a fused block.  This script times each
kernel with those constants varied, at the
bench shape (B = 1024, N = 40, A = 8), the fleet's (B = 1024, N = 10,
A = 12) and the pre-rolls' (B = 16384, N = 40 and B = 1024, N = 10, A = 1),
and times each kernel's variants against each other around the horizons
where the plans change variant (N = 150 to 2000) and over batches of one
to many waves of blocks (B = 1024 to 16384), so that the plans' rules rest
on a measurement.  K1 is timed on the bench OCP's derivatives for (nx, nu) =
(3, 2), at N = 10 / 40 / 160 / 600, with the cycles of its ``"warps"``
variant's parts, and on random problems at the bench shape for the other
instantiated sizes.
With ``--widths`` it times instead K2's variants where the benchmark's cells
run them: the line search at 1,024 to 131,072 problems (N = 40, A = 8) on
the unicycle and on the traced planar quadrotor, the pre-roll over up to
a call's 1,048,576 rows, the fleet's N = 10 at 524,288, each beside its
registers and the blocks an SM holds (the CUDA runtime's count), and the
ring's block size varied there.
With ``--terms`` it times instead K2's and K3's variants on the OCPs that
the interior-point and state-bound solvers derive (the barrier, npar 4; AL,
npar 10; both, npar 11), whose params the line search stages with its
slabs, at the bench shape and the pre-roll's.
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


def _k1_args(dev, ocp, B, N):
    """The bench OCP's stage derivatives along ``_k3_args``'s trajectories,
    as ``riccati_backward`` takes them."""
    from ..ops.linearize import linearize_trajectory

    xs, us, ps, reg, ddp = _k3_args(dev, ocp, B, N)
    d = linearize_trajectory(ocp.dynamics, ocp.stage_cost, xs[:, :N], us,
                             ps[:, :N], second_order=True)
    lb, ub = ocp.control_bounds(None, None, 0)
    return ({k: v.contiguous() for k, v in d.items()}, (lb - us).contiguous(),
            (ub - us).contiguous(), torch.zeros((B, 3), device=dev),
            torch.zeros((B, 3, 3), device=dev), reg, ddp)


def _k1_random_args(dev, B, N, nx, nu, seed=8):
    """Random well-conditioned stage data of any (nx, nu)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    eye = lambda n: np.tile(np.eye(n), (B, N, 1, 1))
    r = lambda *shape: rng.normal(size=(B, N, *shape))
    d = {"fx": 0.9 * eye(nx) + 0.02 * r(nx, nx), "fu": 0.3 * r(nx, nu),
         "lx": r(nx), "lu": r(nu), "lxx": 2 * eye(nx), "luu": eye(nu),
         "lux": 0.1 * r(nu, nx), "fxx": 0.01 * r(nx, nx, nx),
         "fux": 0.01 * r(nx, nu, nx), "fuu": 0.01 * r(nx, nu, nu)}
    return ({k: t(v) for k, v in d.items()}, t(np.full((B, N, nu), -0.7)),
            t(np.full((B, N, nu), 0.5)), t(rng.normal(size=(B, nx))),
            t(np.tile(np.eye(nx), (B, 1, 1))), t(np.full((B,), 1e-6)),
            t(np.ones((B,))))


def _quadrotor_ocp(N, dev):
    """The benchmark's planar quadrotor (``portbench/programs/quadrotor2d.py``
    on its cell's configuration) at horizon ``N``, from callables: K2 runs
    on the model traced from them, at N = 40 the cell's own program."""
    import importlib.util
    from pathlib import Path

    bench = Path(__file__).resolve().parents[2] / "portbench"
    spec = importlib.util.spec_from_file_location(
        "quadrotor2d_program", bench / "programs" / "quadrotor2d.py")
    program = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(program)
    with open(bench / "configs" / "quadrotor2d_n40.json") as fh:
        cfg = json.load(fh)
    return program.build_ocp(dict(cfg, N=N), torch.device(dev))


def _width_args(dev, model, B, N, A, seed=9):
    """K2's inputs for ``model`` ("unicycle": the bench OCP's, npar 3;
    "quadrotor": states in +-1, thrusts about hover, npar 6), zero gains
    for the pre-roll (A = 1)."""
    if model == "unicycle":
        return _k2_args(dev, B, N, A, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.rand(shape, generator=g, device=dev)
    n = lambda *shape: torch.randn(shape, generator=g, device=dev)
    gain = 0.0 if A == 1 else 1.0
    return (2 * r(B, 6) - 1, 2 * r(B, N + 1, 6) - 1, 4.76766 * r(B, N, 2),
            torch.zeros((B, N + 1, 6), device=dev), gain * 0.3 * n(B, N, 2),
            gain * 0.05 * n(B, N, 2, 6), tuple(0.4 ** i for i in range(A)))


def _time_widths(dev, emit, device_time_ms):
    """K2's variants at the benchmark cells' widths and below, on the
    unicycle and on the traced quadrotor, each beside its registers and the
    blocks an SM holds by the CUDA runtime; then the ring's block size
    varied at the cells' widths."""
    from ..interop import bench_ocp
    from ..ops.cuda import rollout

    ocps = {}
    of = lambda model, N: ocps.setdefault((model, N), (
        bench_ocp(N, dev, torch.float32) if model == "unicycle"
        else _quadrotor_ocp(N, dev)))

    def run(model, B, N, A, variant=None, reps=5, ring_threads=None):
        ocp = of(model, N)
        args = _width_args(dev, model, B, N, A)
        nx, nu, npar = args[0].shape[-1], args[2].shape[-1], args[3].shape[-1]
        saved = rollout._RING_THREADS
        rollout._RING_THREADS = ring_threads or saved
        try:
            plan = rollout.linesearch_launch_plan(N, A, npar, variant, nx=nx,
                                                  nu=nu, B=B)
            ms = device_time_ms(lambda: rollout.linesearch_forward(
                *args, ocp=ocp, variant=variant), reps)
        finally:
            rollout._RING_THREADS = saved
        occ = rollout.linesearch_occupancy(rollout.kernel_model(ocp),
                                           plan.variant, plan.threads,
                                           plan.smem_bytes, dev)
        return dict(kernel="K2", model=model, B=B, N=N, A=A, npar=npar,
                    variant=plan.variant, ms=ms, plan=plan[:4],
                    layout=plan.layout, **occ,
                    planned=rollout.linesearch_launch_plan(
                        N, A, npar, nx=nx, nu=nu, B=B).variant)

    batches = (1024, 2048, 4096, 16384, 32768, 65536, 131072)
    cases = [(m, 40, 8, batches) for m in ("quadrotor", "unicycle")]
    cases += [(m, 40, 1, (1024, 16384, 131072, 1048576))
              for m in ("quadrotor", "unicycle")]
    cases += [("unicycle", 10, 12, (1024, 131072, 524288)),
              ("unicycle", 10, 1, (1024, 524288))]
    for model, N, A, bs in cases:
        for B in bs:
            for variant in rollout.LINESEARCH_VARIANTS:
                emit(**run(model, B, N, A, variant))
            torch.cuda.empty_cache()
    for model, N, A, B in (("quadrotor", 40, 8, 131072),
                           ("unicycle", 40, 8, 131072),
                           ("quadrotor", 40, 1, 1048576),
                           ("unicycle", 40, 1, 1048576),
                           ("unicycle", 10, 1, 524288)):
        for threads in (32, 64, 128, 256):
            emit(ring_threads=threads, **run(model, B, N, A, "lanes_ring",
                                             reps=3, ring_threads=threads))
        torch.cuda.empty_cache()


def _time_terms(dev, emit, device_time_ms):
    """K2's and K3's variants on the derived OCPs at npar 4, 10 and 11."""
    from ..interop import bench_ocp, derived_ocps, derived_params
    from ..ops.cuda import fused, rollout

    box = dict(x_lb=[-1.5, -1.0, -np.inf], x_ub=[np.inf, 1.0, np.inf])
    for B, N, A in ((1024, 40, 8), (16384, 40, 1), (1024, 10, 12)):
        ocps = derived_ocps(bench_ocp(N, dev, torch.float32, **box))
        x0, xs, us, ps, kff, K, alphas = _k2_args(dev, B, N, A)
        lam = torch.full((B, N + 1, 6), 0.5, device=dev)
        for name in ("barrier", "al", "barrier_al"):
            ocp = ocps[name]
            p = derived_params(name, ps, lam=lam)
            npar = p.shape[-1]
            for variant in rollout.LINESEARCH_VARIANTS:
                try:
                    plan = rollout.linesearch_launch_plan(N, A, npar, variant,
                                                          B=B)
                except ValueError:
                    continue
                ms = device_time_ms(lambda: rollout.linesearch_forward(
                    x0, xs, us, p, kff, K, alphas, ocp=ocp, variant=variant), 20)
                emit(kernel="K2", case=name, npar=npar, B=B, N=N, A=A,
                     variant=variant, ms=ms, plan=plan[:4],
                     planned=rollout.linesearch_launch_plan(N, A, npar,
                                                            B=B)[0])
            if A == 1:
                continue
            xs3, us3, _, reg, ddp = _k3_args(dev, bench_ocp(N, dev), B, N)
            args = (xs3, us3, p, reg, ddp)
            for variant in fused.FUSED_VARIANTS:
                ms = device_time_ms(lambda: fused.fused_backward(
                    *args, ocp=ocp, variant=variant), 20)
                emit(kernel="K3", case=name, npar=npar, B=B, N=N,
                     variant=variant, ms=ms,
                     planned=fused.fused_launch_plan(N, True, None, B)[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--only", default="K1,K2,K3",
                    help="kernels to time, e.g. K1 or K2,K3")
    ap.add_argument("--terms", action="store_true",
                    help="K2 and K3 on the barrier and AL OCPs only")
    ap.add_argument("--widths", action="store_true",
                    help="K2's variants at the benchmark cells' widths only")
    ns = ap.parse_args(argv)
    only = set(ns.only.split(","))
    if not torch.cuda.is_available():
        print("tune_launch_plans: no CUDA device", file=sys.stderr)
        return 1
    from ..interop import bench_ocp
    from ..ops.cuda import fused, riccati, rollout
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
        plan = rollout.linesearch_launch_plan(N, A, 3, kw.get("variant"), B=B)
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

    def k1(args, nx, nu, reps=50, **kw):
        B, N = args[0]["fx"].shape[:2]
        ms = device_time_ms(
            lambda: riccati.riccati_backward(*args, nx=nx, nu=nu, **kw), reps)
        plan = riccati.riccati_launch_plan(N, nx, nu, True, B, kw.get("variant"))
        return {"kernel": "K1", "B": B, "N": N, "nx": nx, "nu": nu, "ms": ms,
                "plan": plan[:4]}

    if ns.terms:
        _time_terms(dev, emit, device_time_ms)
        return 0
    if ns.widths:
        _time_widths(dev, emit, device_time_ms)
        return 0

    if "K1" in only:
        # problems a block and padded strides, with the cycles of the parts
        bench = {N: _k1_args(dev, bench_ocp(N, dev, torch.float32), 1024, N)
                 for N in (40, 10)}
        problems0, pad0 = riccati._BLOCK_PROBLEMS, riccati._PAD_BANKS
        for pad in (True, False):
            for problems in (1, 2, 4, 8, 16, 32):
                riccati._PAD_BANKS, riccati._BLOCK_PROBLEMS = pad, problems
                for N, args in bench.items():
                    cycles = riccati.riccati_stage_clocks(*args).double().mean(0)
                    emit(block_problems=problems, pad_banks=pad,
                         block_cycles=dict(zip(riccati.CLOCK_PARTS,
                                               cycles.tolist())),
                         **k1(args, 3, 2, variant="warps"))
        riccati._BLOCK_PROBLEMS, riccati._PAD_BANKS = problems0, pad0
        del bench
        # every variant that fits, forced, over horizons and batches
        for N in (10, 40, 160, 600):
            ocp = bench_ocp(N, dev, torch.float32)
            for B in (1024, 2048, 4096, 16384):
                if B * N > 16384 * 160:
                    continue        # derivatives of 10 M stages: not needed
                args = _k1_args(dev, ocp, B, N)
                for variant in riccati.RICCATI_VARIANTS:
                    try:
                        riccati.riccati_launch_plan(N, 3, 2, True, B, variant)
                    except ValueError:
                        continue
                    emit(variant=variant, **k1(args, 3, 2, reps=5, variant=variant))
        for nx, nu in sorted(set(riccati.HELD_SIZES) - {(3, 2)}):
            args = _k1_random_args(dev, 1024, 40, nx, nu)
            for variant in riccati.RICCATI_VARIANTS:
                emit(variant=variant, **k1(args, nx, nu, reps=20, variant=variant))

    shapes = ((1024, 40, 8), (1024, 10, 12), (16384, 40, 1), (1024, 10, 1))
    threads0 = rollout._BLOCK_THREADS
    for threads in (32, 64, 128, 256) if "K2" in only else ():
        rollout._BLOCK_THREADS = threads
        for shape in shapes:
            emit(block_threads=threads, **k2(*shape))
    rollout._BLOCK_THREADS = threads0

    problems0 = fused._BLOCK_PROBLEMS
    for problems in (1, 2, 4, 8, 16, 32) if "K3" in only else ():
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
    for B, N, A in k2_cases if "K2" in only else ():
        for variant in rollout.LINESEARCH_VARIANTS:
            try:
                rollout.linesearch_launch_plan(N, A, 3, variant)
            except ValueError:
                continue
            emit(variant=variant, **k2(B, N, A, reps=3, variant=variant))
    k3_cases = [(1024, 150), (1024, 160), (1024, 300), (1024, 600)]
    k3_cases += [(B, N) for N in (40, 10) for B in batches]
    for B, N in k3_cases if "K3" in only else ():
        for variant in fused.FUSED_VARIANTS:
            emit(variant=variant, **k3(B, N, reps=3, variant=variant))
    return 0


if __name__ == "__main__":
    sys.exit(main())
