"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device:  needs CUDA (no CPU path); prints the card and toolchain.
  2. build:   compiles the CUDA kernels from mpc_verde_tpu_torch/csrc.
  3. K1:      Riccati backward kernel vs its PyTorch twin, float32 on the
              card: random problems for every instantiated (nx, nu), and the
              bench OCP's derivatives at B=1024, N=40.
  4. K2:      line-search kernel vs its twin on the bench OCP, random gains.
  5. main:    the streaming solver, backend="cuda", batch width 1024, over a
              16384-problem N=40 queue (60 iterations + 2 restarts).  Every
              kernel launch count is reset just before and read just after.
  6. cross:   256 problems, f32 "cuda" backend vs f64 "torch" backend.
Then one JSON line of kernel results, the nvidia-smi name/power-limit line,
and last the JSON status line.  Imports torch, numpy and
mpc_verde_tpu_torch only.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SOURCES = {
    "riccati_backward": ("mpc_verde_tpu_torch/csrc/riccati.cuh",
                         "mpc_verde_tpu/ops/pallas/riccati.py:336"),
    "linesearch_forward": ("mpc_verde_tpu_torch/csrc/rollout.cu",
                           "mpc_verde_tpu/ops/pallas/rollout.py:351"),
}
BENCH_N, WIDTH, QUEUE, CROSS = 40, 1024, 16384, 256
# JAX full-mode quality band on the same workload (TPU run, BENCH_r05.json)
JAX_BAND = {"converged_frac": 1.0, "mean_iterations": 15.14}


def _opts():
    from mpc_verde_tpu_torch import ILQROptions

    return ILQROptions(max_iters=60, tol_grad=1e-4, tol_cost=1e-6,
                       n_alphas=8, alpha_decay=0.4)


def _queue(M, N, seed=0):
    """Random starts in [-2, 2]^3 toward (10, 10, 0), as bench.py seeds them."""
    rng = np.random.default_rng(seed)
    x0q = rng.uniform(-2.0, 2.0, (M, 3)).astype(np.float32)
    psq = np.broadcast_to(np.array([10.0, 10.0, 0.0], np.float32),
                          (M, N + 1, 3)).copy()
    return x0q, psq, np.zeros((M, N, 2), np.float32)


def _time_ms(fn, reps, warmup=2):
    """Mean device time of one call, by CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rel_err(a, ref):
    """max |a - ref| / max(1, |ref|)."""
    a, ref = a.double(), ref.double()
    return float(((a - ref).abs() / ref.abs().clamp(min=1.0)).max())


def _abs_err(a, ref):
    return float((a.double() - ref.double()).abs().max())


def _random_riccati(rng, B, N, nx, nu, dev):
    """Random stage data as tests/test_pallas_riccati.py makes it."""
    d = {
        "fx": rng.normal(size=(B, N, nx, nx)) * 0.3 + np.eye(nx),
        "fu": rng.normal(size=(B, N, nx, nu)) * 0.3,
        "lx": rng.normal(size=(B, N, nx)),
        "lu": rng.normal(size=(B, N, nu)),
        "lxx": np.tile(2 * np.eye(nx), (B, N, 1, 1))
        + 0.1 * rng.normal(size=(B, N, nx, nx)),
        "luu": np.tile(np.eye(nu), (B, N, 1, 1)),
        "lux": 0.1 * rng.normal(size=(B, N, nu, nx)),
        "fxx": 0.05 * rng.normal(size=(B, N, nx, nx, nx)),
        "fux": 0.05 * rng.normal(size=(B, N, nx, nu, nx)),
        "fuu": 0.05 * rng.normal(size=(B, N, nx, nu, nu)),
    }
    d["lxx"] = 0.5 * (d["lxx"] + d["lxx"].transpose(0, 1, 3, 2))
    dlb = np.full((B, N, nu), -0.7)
    dub = np.full((B, N, nu), 0.5)
    dlb[:, -1, :] = 0.0   # an equality (move-blocked) stage
    dub[:, -1, :] = 0.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    return ({k: t(v) for k, v in d.items()}, t(dlb), t(dub),
            t(rng.normal(size=(B, nx))), t(np.tile(np.eye(nx), (B, 1, 1))),
            t(np.full((B,), 1e-6)), t(np.ones((B,))))


def _bench_backward_inputs(ocp, B, dev):
    """Bench-OCP derivatives along pre-rolled trajectories (twin pre-roll)."""
    from mpc_verde_tpu_torch.ops.cuda.rollout import linesearch_forward_torch
    from mpc_verde_tpu_torch.ops.linearize import linearize_trajectory

    N = ocp.N
    x0, ps, us = (torch.as_tensor(a, device=dev) for a in _queue(B, N, 1))
    f = dict(dtype=torch.float32, device=dev)
    xs, us, _, _ = linesearch_forward_torch(
        x0, torch.zeros((B, N + 1, 3), **f), us, ps,
        torch.zeros((B, N, 2), **f), torch.zeros((B, N, 2, 3), **f), (1.0,),
        ocp=ocp)
    d = linearize_trajectory(ocp.dynamics, ocp.stage_cost, xs[:, :N], us,
                             ps[:, :N], second_order=True)
    d = {k: v.contiguous() for k, v in d.items()}
    lb, ub = ocp.control_bounds(None, None, 0)
    return (d, (lb - us).contiguous(), (ub - us).contiguous(),
            torch.zeros((B, 3), **f), torch.zeros((B, 3, 3), **f),
            torch.full((B,), 1e-6, **f), torch.ones((B,), **f))


def phase_k1(dev, B_rand=1000, N_rand=6, B=WIDTH, N=BENCH_N):
    from mpc_verde_tpu_torch.interop import bench_ocp
    from mpc_verde_tpu_torch.ops.cuda.riccati import (
        SUPPORTED, riccati_backward, riccati_backward_torch)

    tol = {"kff": 2e-4, "K": 2e-3, "dV1": 1e-3, "gmax": 1e-4}
    names = ("kff", "K", "dV1", "dV2", "gmax")
    rng = np.random.default_rng(7)

    def compare(args, nx, nu, label):
        out = riccati_backward(*args, nx=nx, nu=nu)
        ref = riccati_backward_torch(*args, nx=nx, nu=nu)
        errs = {n: _rel_err(o, r) for n, o, r in zip(names, out, ref)}
        bad = {n: e for n, e in errs.items() if n in tol and e > tol[n]}
        print(f"[k1] {label} (nx,nu)=({nx},{nu}) rel err (vs max(1,|ref|)) "
              + " ".join(f"{n}={e:.2e}" for n, e in errs.items()), flush=True)
        if bad:
            raise AssertionError(f"K1 {label} ({nx},{nu}) out of tolerance "
                                 f"{tol}: {bad}")
        return max(_abs_err(o, r) for o, r in zip(out, ref))

    for nx, nu in sorted(SUPPORTED):
        compare(_random_riccati(rng, B_rand, N_rand, nx, nu, dev), nx, nu,
                f"random B={B_rand} N={N_rand}")
    ocp = bench_ocp(N, dev, torch.float32)
    args = _bench_backward_inputs(ocp, B, dev)
    err = compare(args, 3, 2, f"bench B={B} N={N}")
    ms = _time_ms(lambda: riccati_backward(*args, nx=3, nu=2), reps=50)
    plain_ms = _time_ms(lambda: riccati_backward_torch(*args, nx=3, nu=2),
                        reps=5, warmup=1)
    print(f"[k1] bench B={B} N={N}: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms",
          flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_k2(dev, B=WIDTH, N=BENCH_N, A=8):
    from mpc_verde_tpu_torch.interop import bench_ocp
    from mpc_verde_tpu_torch.ops.cuda.rollout import (
        linesearch_forward, linesearch_forward_torch)

    ocp = bench_ocp(N, dev, torch.float32)
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    x0 = t(rng.uniform(-2, 2, (B, 3)))
    xs = t(rng.uniform(-2, 2, (B, N + 1, 3)))
    us = t(rng.uniform(-0.8, 0.8, (B, N, 2)))
    ps = t(np.broadcast_to(np.array([10.0, 10.0, 0.0]), (B, N + 1, 3)).copy())
    kffs = t(0.3 * rng.normal(size=(B, N, 2)))
    Ks = t(0.2 * rng.normal(size=(B, N, 2, 3)))
    alphas = tuple(0.4 ** i for i in range(A))
    args = (x0, xs, us, ps, kffs, Ks, alphas)

    xs_k, us_k, c_k, b_k = linesearch_forward(*args, ocp=ocp)
    xs_t, us_t, c_t, b_t = linesearch_forward_torch(*args, ocp=ocp)
    cost_rel = float(((c_k.double() - c_t.double()).abs()
                      / c_t.double().abs()).max())
    same = b_k == b_t
    same_frac = float(same.float().mean())
    traj = max(_rel_err(xs_k[same], xs_t[same]), _rel_err(us_k[same], us_t[same]))
    print(f"[k2] bench B={B} N={N} A={A}: cost rel err {cost_rel:.2e}, "
          f"same alpha {same_frac:.4f}, traj err (same alpha, vs max(1,|ref|)) "
          f"{traj:.2e}", flush=True)
    if cost_rel > 1e-5 or same_frac < 0.999 or traj > 1e-4:
        raise AssertionError(f"K2 out of tolerance: cost rel {cost_rel}, "
                             f"same alpha {same_frac}, traj {traj}")
    err = max(_abs_err(c_k, c_t), _abs_err(xs_k[same], xs_t[same]),
              _abs_err(us_k[same], us_t[same]))
    ms = _time_ms(lambda: linesearch_forward(*args, ocp=ocp), reps=50)
    plain_ms = _time_ms(lambda: linesearch_forward_torch(*args, ocp=ocp),
                        reps=5, warmup=1)
    print(f"[k2] bench B={B} N={N} A={A}: kernel {ms:.4f} ms, twin "
          f"{plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _check_result(res, M, N):
    shapes = {"xs": (M, N + 1, 3), "us": (M, N, 2), "cost": (M,)}
    for name, shape in shapes.items():
        v = getattr(res, name)
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"result {name}: shape {tuple(v.shape)} "
                                 f"(expected {shape}) or non-finite values")


def phase_main(dev, gpu, M=QUEUE, W=WIDTH, N=BENCH_N):
    from mpc_verde_tpu_torch import make_streaming_solver
    from mpc_verde_tpu_torch.interop import bench_ocp
    from mpc_verde_tpu_torch.ops.cuda.riccati import (
        riccati_backward, riccati_backward_torch)
    from mpc_verde_tpu_torch.ops.cuda.rollout import (
        linesearch_forward, linesearch_forward_torch)

    ocp = bench_ocp(N, dev, torch.float32)
    solve = make_streaming_solver(ocp, _opts(), backend="cuda",
                                  batch_width=W, restarts=2)
    x0q, psq, us0q = _queue(M, N)
    solve(x0q[:W], psq[:W], us0q[:W], max_iters=60, restarts_n=2)  # warm-up
    torch.cuda.synchronize()

    kernels = (riccati_backward, linesearch_forward)
    twins = (riccati_backward_torch, linesearch_forward_torch)
    for f in kernels:
        f.launches = 0
    for f in twins:
        f.cuda_calls = 0
    t0 = time.perf_counter()
    res = solve(x0q, psq, us0q, max_iters=60, restarts_n=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in kernels}
    twin_calls = {f.__name__: f.cuda_calls for f in twins}

    _check_result(res, M, N)
    conv = float(res.converged.float().mean())
    mean_it = float(res.iterations.double().mean())
    print(f"[main] streaming backend=cuda W={W} M={M} N={N}: "
          f"{M / wall:.1f} solves/s ({wall:.3f} s), converged_frac {conv:.4f}, "
          f"mean_iterations {mean_it:.3f}, launches {launches}, twin calls "
          f"on CUDA {twin_calls} | JAX band (TPU run) {JAX_BAND} | GPU {gpu}",
          flush=True)
    if conv < 0.99:
        raise AssertionError(f"converged_frac {conv} < 0.99")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never ran: {launches}")
    if max(twin_calls.values()) > 0:
        raise AssertionError(f"a twin ran on CUDA tensors: {twin_calls}")
    return launches


def phase_cross(dev, M=CROSS, N=BENCH_N):
    from mpc_verde_tpu_torch import make_streaming_solver
    from mpc_verde_tpu_torch.interop import bench_ocp

    x0q, psq, us0q = _queue(QUEUE, N)
    x0q, psq, us0q = x0q[:M], psq[:M], us0q[:M]
    res = {}
    for backend, dtype in (("cuda", torch.float32), ("torch", torch.float64)):
        solve = make_streaming_solver(bench_ocp(N, dev, dtype), _opts(),
                                      backend=backend, batch_width=M,
                                      restarts=2)
        res[backend] = solve(x0q, psq, us0q, max_iters=60, restarts_n=2)
        _check_result(res[backend], M, N)
    ck, ct = res["cuda"], res["torch"]
    agree = float((ck.converged == ct.converged).float().mean())
    both = ck.converged & ct.converged
    rel = float(((ck.cost.double() - ct.cost).abs() / ct.cost.abs())[both].max())
    print(f"[cross] M={M} N={N}: converged agree {agree:.4f} (cuda "
          f"{float(ck.converged.float().mean()):.4f}, torch f64 "
          f"{float(ct.converged.float().mean()):.4f}), cost rel err where "
          f"both converged {rel:.2e}", flush=True)
    if agree < 0.99 or rel > 1e-3:
        raise AssertionError(f"cross-check failed: agree {agree}, rel {rel}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    from mpc_verde_tpu_torch.ops.cuda.build import build, load_library
    from mpc_verde_tpu_torch.utils import gpu_info

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    info = gpu_info()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: "
          f"{info['nvidia_smi']} | torch {torch.__version__} CUDA "
          f"{info['torch_cuda']} | {info['nvcc']}", flush=True)

    t0 = time.perf_counter()
    built = build()
    load_library()
    print(f"[build] {built.path.name}: nvcc {built.seconds:.1f} s, load "
          f"{time.perf_counter() - t0:.1f} s total", flush=True)

    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    launches = phase_main(dev, info["nvidia_smi"])
    phase_cross(dev)

    kernels = []
    for name, meas in (("riccati_backward", k1), ("linesearch_forward", k2)):
        source, replaces = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **meas})
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
