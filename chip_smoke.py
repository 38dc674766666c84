"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --first-build   # after a run: phase 23 (e)'s
                                          # first use, cold and warm

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device:  needs CUDA (no CPU path); prints the card and toolchain.
  2. build:   compiles the CUDA kernels from mpc_verde_tpu_torch/csrc: the
              kernels library (K2, K3 on the unicycle), K1's library at
              each size of HELD_SIZES and the library of each program that
              phase 23 and the rate-form families (phases 10, 15-17, 21)
              trace (K2 and K3 on a device model generated from an OCP's
              callables, traced on the CPU first), one nvcc process a unit,
              all started together; phase 20, which launches no kernel, runs
              meanwhile.  The script's wall time is printed against its
              1300 s limit, and the traced libraries built after this phase
              (0 when it built every program the phases run).
  3. K1:      Riccati backward kernel vs its PyTorch twin, float32 on the
              card: random problems at every (nx, nu) of HELD_SIZES (the
              seven sizes of the package's models and the JAX kernel's
              tests, and (2, 1), (6, 2), (6, 3)), DDP on
              and off, and the bench OCP's derivatives at B=1024, N=40 (DDP
              on and off, half the problems with ddp_scale 0, infinite
              bounds), B=1000, N=10 and B=16384; each under the planned
              variant and under the other ("warps" / "thread"), the two
              against each other, and the cycles of the "warps" variant's
              parts; then random problems at B=1024, N=40 at every size of
              HELD_SIZES under both variants, held to the float64 twin and
              timed.
  4. K2:      line-search kernel vs its twin on the bench OCP, random gains,
              at B=1024, N=40, A=8 (the plan's "lanes" variant), and at A=5,
              A=1 (the pre-roll, "lanes_ring"), B=1000 and an all-ties
              input; at the shapes the driven paths give it: the streaming
              pre-roll of phases 5 and 8 (B=16384, N=40, A=1), the fleet's
              line search on the fleet's own OCP (B=1024, N=10, A=12: groups
              of 16 lanes, 4 of them idle) and the fleet's pre-roll; the
              "lanes_ring" variant forced against "lanes" (the same bits);
              both variants at the stream cell's width (B=131072), timed
              beside their registers and blocks an SM.
  5. main:    the streaming solver, backend="cuda", batch width 1024, over a
              16384-problem N=40 queue (60 iterations + 2 restarts).  Every
              kernel launch count is reset just before and read just after.
  6. cross:   256 problems, f32 "cuda" backend vs f64 "torch" backend.
  7. K3:      fused derivs+backward kernel vs its twin, float32 on the card:
              the bench OCP at B=1024, N=40 along pre-rolled trajectories
              (DDP on and off), the same with a terminal cost (Qf = 2Q),
              random trajectories, B=1000 and N=10 (the fleet's horizon);
              the "staged" variant against the "thread" one, and the cycles
              of its two phases.
  8. main-fused: phase 5's queue and options on backend="cuda_fused"; its
              results are held against phase 5's.
  9. fleet:   the closed-loop fleet (scenarios/fleet.py SPEC: B=1024, N=10,
              Nsim=150, RK4 controller, Euler plant) on "cuda_fused", with
              the JAX package's own gates.
 10. terms:   K2 and K3 vs their twins at B=1024, N=40 on the OCPs the
              interior-point and state-bound solvers derive
              (interop.derived_ocps): the streaming barrier at mu 1e-2, 1e-4
              and 0 (npar 4), the batched barrier without a clip box, the AL
              penalty with nonzero multipliers and states on both sides of
              the box (npar 10), and barrier + AL (npar 11); random gains,
              so that candidates clip onto the box (+inf) or leave it (NaN);
              and the terms of the circular-track and diff-drive families:
              the control reference (the circular track's OCP, npar 5), the
              circular track's derived AL OCP (npar 12), the RK4 quadrature
              cost at M = 1 and M = 4 under RK4 and under Euler dynamics;
              every variant; each case's times and bounds.  Then the linear
              rate-form families on the models traced from their callables
              (K1, K2 and K3, held to the float64 twin; the bounds from the
              program's instructions): the lane change's v1 shape (nx 4, N
              20, move blocking after Ntu 3, npar 4), LTV (N 5, npar 16),
              the dynamic bicycle (nx 5, N 10, npar 25) and the pendulum (N
              50, npar 0 and padded to 1); then the path-frame families,
              held to the float64 twin as well: the Frenet OCP ((5, 2), N
              20, npar 4: sin, cos, tan and a reciprocal on K3's dual
              numbers, K1 at (5, 2)) and the curvature cost on the LTV model
              ((4, 1), N 20, npar 16).
 11. ipm:     make_streaming_barrier_solver on phase 5's queue on
              "cuda_fused": cold (mu 1e-2, 1e-4, then the mu = 0 crossover,
              inexact_kappa 10) and hybrid (warmstart="ddp", mu 1e-4); final
              costs against phase 5's DDP answers; the cold path on "cuda"
              (K1, K2, torch.func derivatives) on the first 2048 problems,
              held against the fused run.
 12. al:      state bounds at full width: make_streaming_solver with
              al_iters=6 on the bench OCP with the box y <= 5 (the target
              lies at y = 10; without the box every problem's trajectory
              passes y = 5), phase 5's queue on "cuda_fused", and the
              streaming barrier + AL composition on its first 2048 problems;
              the JAX tests' gate, max_violation < 1e-2.
 13. circular: the circular track (scenarios/circular.py SPEC: N=10, 500
              MPC steps at B=1, two AL rounds a step over the state box, the
              control reference in the params, a 10-substep RK4 plant)
              through make_ilqr_solver on its default backend, "cuda_fused";
              gates converged_frac >= 0.99 and rmse_xy < 0.2; its first 30
              steps held against the float64 "torch" run on the CPU and
              against the same 30 steps on "cuda" (K1 at B=1).
 14. diffdrive: the diff-drive family (scenarios/diffdrive.py: B=1, 100
              steps) on "cuda_fused" in three variants, RK4 + discrete cost,
              Euler + discrete, RK4 quadrature cost (M=4) with an RK4 plant;
              gates steps_to_target in 1..84 and ss_error < 0.1; then
              compare_diffdrive_methods (Euler against RK4, 90 steps).
 15. lanechange: the lane-change families at B=1 on "cuda_fused" (like
              phases 16, 17 and 21, on the models traced from their
              callables: backend=None must resolve there) with the
              JAX tests' gates: LTI 250 steps, v1 (N=20, Ntu=3) 300 steps,
              LTV and leitura 250 steps; the exact pin of move blocking in
              v1's open-loop plan at B=1 and over 301 problems; 30 steps of
              the maneuver held against the float64 "torch" run on the CPU
              and against "cuda" (K1 at (4, 1)).
 16. pendulum + dynamic: the cart pendulum at its SPEC (1000 steps, N=50,
              npar 0) with max_angle < 1.2 and final_pos_error < 0.25, its
              first 20 steps held against CPU float64 and "cuda" (K1 at
              (5, 1)); the dynamic bicycle 200 steps (mse_y within 1% of
              JAX's 15.85) and corrected=True 300 steps.
 17. frenet + curvature: the Frenet family at B=1 on "cuda_fused" on the
              synthetic lane change (120 steps; mse_y < 1e-3, |delta| <=
              0.384, |rate| <= 0.1225), over the whole 500-step course (mse_y
              within 1% of the port's CPU float64 run) and on the double
              lane change (60 steps, max_iters 80); the curvature family
              (300 steps; mse_y < 1.0, mse_phi < 0.2); 30 steps of each from
              the maneuver held against CPU float64 and "cuda" (K1 at (5, 2)
              and (4, 1)).
 18. scan:    the associative-scan backward (ops/parallel_riccati.py): its
              doubling form against its sequential fold in float32 on
              random LQT problems at B=1024, N=40, 512, 2048 (W6;
              tolerance 1e-4 of max(1, |fold|)); lq_backward_parallel
              against K1's twin (bench derivatives, infinite bounds) and
              against K1 at N=40, 128, 512, 2048, each timed beside K1 (the
              crossover table); backend="scan" (torch.func derivatives, the
              scan backward, K2) in make_barrier_solver without crossover on
              phase 5's first 1024 problems against the same call on "cuda"
              (converged_frac >= 0.99 on each, costs to 1e-3), and on the
              bench OCP without its box at N=512 over 256 starts against
              "cuda" (at most 800 iterations: converged_frac >= 0.99 on
              each, converged agree >= 0.99, median cost gap <= 1e-4, and
              each converged "scan" answer a float64 optimum: a float64
              "torch" solve from it converges and lowers its cost by at
              most 1e-4 of it).
 19. solvers: FDDP (make_batched_ms_solver, plain PyTorch) on the bench OCP
              over 1024 starts from the constant-x0 lifted guess (final gaps
              < 1e-5, costs against phase 8's DDP answers: median gap <=
              1e-4 and a share >= 0.99 within 1e-4); solve_condensed (float64) at the pendulum's SPEC over
              1024 starts against the batched solver's first control on
              "cuda_fused" (5e-2 of max(1, |u0|)) and on "torch" in float64
              (1e-5); make_lqr_warm_start over phase 5's queue (K1 and K2 at
              A=1, one launch each; controls inside the box; its first 256
              within 1e-3 of CPU float64), then the streaming solve from it
              (iterations printed, not gated); make_nlpsol over 1024 bounded
              Rosenbrock problems in float64 against CPU float64.
 20. compat:  the mpctools pendulum script (tests/test_compat.py, its
              constants; 200 of its 400 steps) and the CasADi
              single-shooting v1 loop at N=10 (until 0.1 from the target, at
              most 100 steps) on the card in float64, with the JAX tests'
              gates, and the ms per nlpsol call (the node graph evaluated
              eagerly); run beside the build (phase 2), and after phase 19
              their first steps held within 1e-6 of the same scripts in
              float64 on the CPU.
 21. host:    the tools and the scale-out layer.  (a) K2 and K3 on the
              weight term (Q[0, 0] = p[4]: linear_rate_ocp's q_param)
              at (3, 1), N 20, npar 5, B 1024 against the float64 twin, as
              phase 10 holds the linear cases; then the tuning sweep
              (sweep.py) at the JAX package's defaults: five Q_y at B = 5,
              horizons 3-20, 300 steps, max_iters 30 on "cuda_fused", each
              row printed, converged_frac >= 0.9, the rows at horizons 3 and
              20 within 2% of the port's float64 CPU sweep.  (b) One horizon
              of it under utils.device_trace (torch.profiler): the Chrome
              trace names K2's and K3's kernels as often as their wrappers
              counted launches.  (c) make_sharded_solver at world size 1
              over NCCL (a FileStore) on the bench OCP at B = 1024, N = 40
              on "cuda_fused" and "cuda": equal to the bit to the unsharded
              solve, BatchStats equal to the local reductions.  (d) The
              diff-drive family's 84 steps in SegmentedRun segments of 28,
              cut off on the third and resumed from its checkpoint, against
              the monolithic run (1e-6), which records its predicted
              horizons (each starts at its step's state); (e) that run
              exported to .csv and .xlsx and read back exactly.
 22. bw:      backend="cuda_bw", named (torch.func derivatives, K1, the
              line search's plain PyTorch version on the OCP's callables; the
              counterpart of JAX's "pallas_bw", which backend=None takes on a
              card only in float64 or for callables that do not lower), on
              OCPs without a device model or in float64: (a) the bench OCP
              built from its callables, make_streaming_solver over the first
              2048 starts of phase 5's queue at width 1024 with phase 5's
              options, converged_frac >= 0.99, held against phase 5's
              answers; (b) three user OCPs written here from plain callables
              at B=1024, N=40 through make_batched_ilqr_solver: the double
              integrator (2, 1), Drake's planar quadrotor (6, 2), the 3-D
              point mass (6, 3), each converged_frac >= JAX float32's on
              the CPU less 0.01 and within 1e-3 relative cost of CPU float64
              on its first 64 where both converged, and K1 under both
              variants on the derivatives along its answers, held to the
              float64 twin on the float64 derivatives; (c) the bench OCP in
              float64 at B=1024, K1 on float32 copies (where backend=None
              resolves to "cuda_bw"), within 1e-4 relative cost of a float64
              "torch" solve on the card.  Each path launches K1 and neither
              K2 nor K3.
 23. traced:  K2 and K3 on the device model generated from the trace of an
              OCP's own callables (ops/cuda/trace.py, ops/cuda/codegen.py;
              the counterpart of JAX's "pallas" / "pallas_fused" on such an
              OCP), at B=1024, N=40 in float32: (a) on the bench OCP built
              from its callables against the hand-written unicycle model
              and against the twin on the same inputs (random gains and the
              pre-roll; DDP on and off), at phase 4's and 7's tolerances,
              each timed beside the hand-written one; (b)
              make_streaming_solver on that OCP with backend=None, which
              resolves to "cuda_fused" (K3 and K2; (e1) below), and "cuda"
              (K1 and K2) over the first 2048 starts of phase 5's queue,
              converged_frac >= 0.99, held against phase 5's answers by
              phase 22's rule; (c) the three user OCPs
              on "cuda_fused" through make_batched_ilqr_solver with phase
              22 (b)'s band and CPU float64 hold, and K2 (every variant)
              and K3 (DDP on and off, both variants) along their answers
              against the float64 twins; (d) the state box y <= 5 on the
              bench OCP from its callables on "cuda_fused" (its AL-derived
              OCP, traced), phase 12's setup over the first 2048 starts,
              max_violation < 1e-2, and K2 and K3 on that AL-derived
              program along its answers, held and timed as in (c); (e) the
              default path, backend=None, which must resolve to "cuda_fused"
              and launch K3 and K2 with no call of the plain line search:
              (e1) is (b); (e2) make_streaming_solver over 1024 random
              windows of the LTI lane change at N=40 with a box on its
              lateral error (its AL-derived OCP, traced); (e3)
              make_streaming_barrier_solver on the rate form of the double
              integrator with a constant rate box over 1024 starts (its
              barrier-derived OCP, traced); each converged_frac >= 0.99 (or
              JAX float32's on the CPU less 0.01), max_violation < 1e-2,
              held against CPU float64 on its first 64 problems by phase
              22's rule, and K2 and K3 on its derived program held and
              timed as in (c); (e4) make_streaming_solver over the first
              2048 starts of phase 5's queue on the bench OCP with speed
              saturation (tanh) in its dynamics and a soft obstacle
              (softplus) in its stage cost, converged_frac >= 0.99, held
              against CPU float64 on its first 64 problems by its optima
              (it may pass the obstacle on either side), K2 and K3 along its
              answers as in (c).  (f) K2 and K3 on an OCP whose callables
              use every other op the traced model lowers since the table
              holds Mosaic's primitives (the sigmoid, log1p, exp2, erfinv,
              floor, ceil, round, sign, pow, fmod, remainder, the max / min
              reductions, hypot, logaddexp, the Huber and smooth L1 costs,
              silu), held and timed as in (c) on random trajectories and
              gains.  No path calls a twin on CUDA tensors, and none
              launches the other backward kernel.
Phases 5, 8, 9 and 11 to 23 each set every kernel launch count to 0 just
before and read it just after, and check that the launches were of the
variants the launch plans choose for the shape (18: K2 only on "scan"; 19:
K1 and K2 once each for the warm start, none for FDDP, the condensed QP and
the NLP solver; 20: none; 22: K1 alone; 23: K3 and K2 on "cuda_fused", K1
and K2 on "cuda").  Then one JSON line of
kernel results (each kernel's time beside its roofline bound, computed from
this run's shapes, and beside its one-thread-per-problem variant's time),
the nvidia-smi name/power-limit line, and last the JSON status line.
Imports torch, numpy and mpc_verde_tpu_torch only.
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing
import re
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

SOURCES = {
    "riccati_backward": ("mpc_verde_tpu_torch/csrc/riccati.cuh",
                         "mpc_verde_tpu/ops/pallas/riccati.py:336"),
    "linesearch_forward": ("mpc_verde_tpu_torch/csrc/rollout.cuh",
                           "mpc_verde_tpu/ops/pallas/rollout.py:351"),
    "fused_backward": ("mpc_verde_tpu_torch/csrc/fused.cuh",
                       "mpc_verde_tpu/ops/pallas/fused.py:135"),
}
BENCH_N, WIDTH, QUEUE, CROSS = 40, 1024, 16384, 256
# the wall-clock limit the script is given on one H100 (1300 s)
WALL_LIMIT_S = 1300
# kernel vs twin, float32, relative to max(1, |ref|): the Pallas Riccati
# kernel's own test tolerances (tests/test_pallas_riccati.py)
K1_TOL = {"kff": 2e-4, "K": 2e-3, "dV1": 1e-3, "gmax": 1e-4}
BACKWARD_OUT = ("kff", "K", "dV1", "dV2", "gmax")
# JAX full-mode quality band on the same workload (TPU run, BENCH_r05.json)
JAX_BAND = {"converged_frac": 1.0, "mean_iterations": 15.14}
# Published peaks of one H100 SXM: device memory bytes/s, float32 FLOP/s
# outside the tensor cores.
HBM_BYTES_S, FP32_FLOP_S = 3.35e12, 67e12
# Operations per unit of work, counted from the kernels' arithmetic with a
# full-precision sinf, cosf or logf taken as 16: one clipped closed-loop RK4
# step with its stage cost (K2); one stage QP of the Riccati recursion,
# nx = 3, nu = 2 (K1); the same plus the stage's dual-number derivatives
# (K3).  The optional terms add per step (K2) or stage (K3): the barrier's
# four logs, 80 and on second-order duals over z = [x; u] (21 numbers) 400;
# the AL penalty's six rows, 60 and 900.
K2_STEP_FLOPS, K1_STAGE_FLOPS, K3_STAGE_FLOPS = 250, 1000, 4000
# The circular track's control reference adds 2 subtractions (on duals,
# value only).  The quadrature cost adds per RK4 substep 4 unicycle
# right-hand sides (a sinf and a cosf each) and 4 running costs, 300 on
# floats and on second-order duals 7,500 (a dual product is about 120
# operations, a sum 21).
TERM_FLOPS = {"barrier": (80, 400), "al": (60, 900), "u_ref": (2, 2),
              "quadrature_substep": (300, 7500)}   # (K2 step, K3 stage)
# the variants the launch plans choose at the bench and the fleet shapes:
# K1 at 1024, K2's line search at 1024 and its pre-roll (the ring), K3 at
# 1024
PLANNED = {"riccati_backward": ("warps",),
           "linesearch_forward": ("lanes", "lanes_ring"),
           "fused_backward": ("staged",)}


def _k2_plan(data, alphas, variant=None):
    """The plan ``linesearch_forward`` takes for ``data`` (x0, xs, us, ps,
    ...) and ``alphas``: the batch's included."""
    from mpc_verde_tpu_torch.ops.cuda.rollout import linesearch_launch_plan

    x0, us, ps = data[0], data[2], data[3]
    B, N, nu = us.shape
    return linesearch_launch_plan(N, len(alphas), ps.shape[-1], variant,
                                  nx=x0.shape[-1], nu=nu, B=B)


def _bound(n_bytes, flops):
    """The least time the card could take: each input byte read once and
    each output byte written once at the memory rate, or the operations at
    the float32 peak, whichever is larger."""
    t_bytes, t_flops = n_bytes / HBM_BYTES_S, flops / FP32_FLOP_S
    return {"bound_ms": 1e3 * max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "library_ms": None}   # no single PyTorch call computes any of them


def _opts(**kw):
    from mpc_verde_tpu_torch import ILQROptions

    return ILQROptions(**{**dict(max_iters=60, tol_grad=1e-4, tol_cost=1e-6,
                                 n_alphas=8, alpha_decay=0.4), **kw})


def _queue(M, N, seed=0):
    """Random starts in [-2, 2]^3 toward (10, 10, 0), as bench.py seeds them."""
    rng = np.random.default_rng(seed)
    x0q = rng.uniform(-2.0, 2.0, (M, 3)).astype(np.float32)
    psq = np.broadcast_to(np.array([10.0, 10.0, 0.0], np.float32),
                          (M, N + 1, 3)).copy()
    return x0q, psq, np.zeros((M, N, 2), np.float32)


PTXAS_SOURCES = ("riccati_", "rollout.cu", "fused.cu", "traced_")


def _kernel_name(mangled):
    """kernel<args> from a kernel template's mangled name: the model (the
    unicycle, or a model traced from an OCP's callables) and the int and
    bool arguments; the mangled name where it does not parse."""
    t = re.search(r"\d([a-z_]+_kernel)I(.+)", mangled)
    if not t:
        return mangled
    targs = t.group(2).split("Ev")[0]
    args = []
    model = re.search(r"UnicycleModel|TracedModel", targs)
    if model:
        args.append(model.group(0))
        targs = targs.replace(model.group(0), "")
    args += re.findall(r"L[ib](\d+)E", targs)
    return f"{t.group(1)}<{','.join(args)}>"


def _ptxas_summary(log, sources=PTXAS_SOURCES):
    """Registers, stack and spills of each kernel of `sources`, from the
    build's `ptxas -v` output (build.py's log, one "== file" part a source)."""
    lines = []
    for part in log.split("== ")[1:]:
        if not part.startswith(sources):
            continue
        for m in re.finditer(
                r"Compiling entry function '(\w+)'.*?(\d+) bytes stack frame, "
                r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
                r"Used (\d+) registers", part, re.S):
            name, stack, st, ld, regs = m.groups()
            lines.append(f"{part.split()[0]} {_kernel_name(name)}: {regs} "
                         f"registers, stack {stack} B, spill stores {st} B, "
                         f"loads {ld} B")
    return lines


def _time_ms(fn, reps, warmup=2, queued=True):
    """Mean device time of one call: back-to-back launches behind a device
    spin for a kernel, the host's own pace (`queued=False`) for a twin,
    which is many launches."""
    from mpc_verde_tpu_torch.utils import device_time_ms

    return device_time_ms(fn, reps, warmup, queued)


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


def _bench_trajectories(ocp, B, dev):
    """Bench-OCP trajectories (xs, us, ps), pre-rolled by the twin from zero
    controls: what the main path's first iteration sees."""
    from mpc_verde_tpu_torch.ops.cuda.rollout import linesearch_forward_torch

    N = ocp.N
    x0, ps, us = (torch.as_tensor(a, device=dev) for a in _queue(B, N, 1))
    f = dict(dtype=torch.float32, device=dev)
    xs, us, _, _ = linesearch_forward_torch(
        x0, torch.zeros((B, N + 1, 3), **f), us, ps,
        torch.zeros((B, N, 2), **f), torch.zeros((B, N, 2, 3), **f), (1.0,),
        ocp=ocp)
    return xs, us, ps


def _bench_backward_inputs(ocp, B, dev):
    """Bench-OCP derivatives along pre-rolled trajectories (twin pre-roll)."""
    from mpc_verde_tpu_torch.ops.linearize import linearize_trajectory

    N = ocp.N
    f = dict(dtype=torch.float32, device=dev)
    xs, us, ps = _bench_trajectories(ocp, B, dev)
    d = linearize_trajectory(ocp.dynamics, ocp.stage_cost, xs[:, :N], us,
                             ps[:, :N], second_order=True)
    d = {k: v.contiguous() for k, v in d.items()}
    lb, ub = ocp.control_bounds(None, None, 0)
    return (d, (lb - us).contiguous(), (ub - us).contiguous(),
            torch.zeros((B, 3), **f), torch.zeros((B, 3, 3), **f),
            torch.full((B,), 1e-6, **f), torch.ones((B,), **f))


def _active_sets(kff, K, dlb, dub):
    """The winning active-set pattern of every (problem, stage, control),
    read off the outputs: 0 free (a K row that is not all zero), 1 at the
    lower bound, 2 at the upper."""
    clamped = (K == 0).all(-1)
    return torch.where(clamped, torch.where(kff == dlb, 1, 2), 0)


def phase_k1(dev, B_rand=1000, N_rand=6, B=WIDTH, N=BENCH_N, B_ragged=1000,
             N_fleet=10, B_wide=QUEUE):
    from mpc_verde_tpu_torch.interop import bench_ocp
    from mpc_verde_tpu_torch.ops.cuda.riccati import (
        CLOCK_PARTS, HELD_SIZES, RICCATI_VARIANTS, riccati_backward,
        riccati_backward_torch, riccati_launch_plan, riccati_stage_clocks)

    rng = np.random.default_rng(7)
    worst = {"err": 0.0, "diff": 0.0, "same": 1.0}
    # Every variant runs the same stage functions on the same floats.  For
    # nu <= 2 the compiled arithmetic is the same too and the variants agree
    # to the bit; for nu = 3, 4 nvcc fuses the multiply-adds of the larger
    # elimination code differently in the two kernels, which moves results by
    # float32 round-off (relative to max(1, |ref|)).
    diff_bound = lambda nu: 0.0 if nu <= 2 else 1e-5

    def compare(args, nx, nu, label, use_ddp=True):
        """The planned variant and every other that fits, each against the
        twin at K1_TOL and against the planned one; returns the planned
        variant's outputs."""
        B_, N_ = args[0]["fx"].shape[:2]
        kw = dict(nx=nx, nu=nu, use_ddp=use_ddp)
        ref = riccati_backward_torch(*args, **kw)
        planned = riccati_launch_plan(N_, nx, nu, use_ddp, B_).variant
        outs = {}
        for variant in (None, *(v for v in RICCATI_VARIANTS if v != planned)):
            try:
                riccati_launch_plan(N_, nx, nu, use_ddp, B_, variant)
            except ValueError:
                continue   # a forced "warps" that does not fit
            used, out = _variants_used(
                riccati_backward,
                lambda: riccati_backward(*args, variant=variant, **kw))
            if used != {variant or planned}:
                raise AssertionError(f"K1 {label} ran variants {used}")
            err = _hold(out, ref, "k1", f"{label} (nx,nu)=({nx},{nu}) "
                        f"DDP={use_ddp} variant {sorted(used)}")
            if (nx, nu) == (3, 2):   # the size the main path gives it
                worst["err"] = max(worst["err"], err)
            outs[variant or planned] = out
        if len(outs) == 2:
            a, b = outs.values()
            diff = max(_rel_err(x, y) for x, y in zip(a, b))
            same = float((_active_sets(a[0], a[1], args[1], args[2])
                          == _active_sets(b[0], b[1], args[1], args[2])
                          ).all(-1).float().mean())
            print(f"[k1] {label} ({nx},{nu}) DDP={use_ddp}: max |"
                  + " - ".join(outs) + f"| {diff:.2e} over kff, K, dV1, dV2, "
                  f"gmax (vs max(1,|ref|)); same winning pattern in {same:.6f} of "
                  f"the stages",
                  flush=True)
            if not diff <= diff_bound(nu) or same < 1.0:
                raise AssertionError(f"K1 {label} ({nx},{nu}): variants differ "
                                     f"by {diff}, same pattern in {same}")
            if (nx, nu) == (3, 2):
                worst["diff"] = max(worst["diff"], diff)
            worst["same"] = min(worst["same"], same)
        return outs[planned]

    for nx, nu in sorted(HELD_SIZES):
        for use_ddp in (True, False):
            compare(_random_riccati(rng, B_rand, N_rand, nx, nu, dev), nx, nu,
                    f"random B={B_rand} N={N_rand}", use_ddp)
    by_size = {}
    for nx, nu in sorted(HELD_SIZES):   # every size at the bench shape
        by_size[f"{nx}x{nu}"] = _time_k1(
            _random_riccati(rng, B, N, nx, nu, dev), nx, nu,
            f"random B={B} N={N}")
    ocp = bench_ocp(N, dev, torch.float32)
    args = _bench_backward_inputs(ocp, B, dev)
    out = compare(args, 3, 2, f"bench B={B} N={N}")
    compare(args, 3, 2, f"bench B={B} N={N}", use_ddp=False)
    half = args[6].clone()
    half[::2] = 0.0
    compare((*args[:6], half), 3, 2, f"bench B={B} N={N} half ddp_scale 0")
    # no box: Gauss-Newton, whose Quu is positive definite without one (with
    # DDP the bench's Quu is indefinite and only the box bounds the step)
    compare((args[0], torch.full_like(args[1], -torch.inf),
             torch.full_like(args[2], torch.inf), *args[3:]), 3, 2,
            f"bench B={B} N={N} infinite bounds", use_ddp=False)
    compare(_bench_backward_inputs(ocp, B_ragged, dev), 3, 2,
            f"bench B={B_ragged} N={N}")
    compare(_bench_backward_inputs(bench_ocp(N_fleet, dev, torch.float32), B,
                                   dev), 3, 2, f"bench B={B} N={N_fleet}")
    compare(_bench_backward_inputs(ocp, B_wide, dev), 3, 2,
            f"bench B={B_wide} N={N}")
    run = lambda **kw: riccati_backward(*args, nx=3, nu=2, **kw)
    plan = riccati_launch_plan(N, 3, 2, True, B)
    ms = _time_ms(run, reps=50)
    thread_ms = _time_ms(lambda: run(variant="thread"), reps=50)
    plain_ms = _time_ms(lambda: riccati_backward_torch(*args, nx=3, nu=2),
                        reps=5, warmup=1, queued=False)
    cycles = dict(zip(CLOCK_PARTS,
                      riccati_stage_clocks(*args).double().mean(0).tolist()))
    per_stage = sum(cycles[k] for k in CLOCK_PARTS[1:7]) / N
    print(f"[k1] bench B={B} N={N} DDP: kernel {ms:.4f} ms, \"thread\" variant "
          f"{thread_ms:.4f} ms, twin {plain_ms:.4f} ms; {plan[:4]}; mean "
          f"cycles a block: "
          + ", ".join(f"{k} {v:.0f}" for k, v in cycles.items())
          + f"; {per_stage:.0f} a stage", flush=True)
    n_in = sum(a.numel() for a in args[1:]) + sum(v.numel() for v in args[0].values())
    n_out = sum(o.numel() for o in out)
    return {"max_abs_err": worst["err"], "ms": ms, "plain_ms": plain_ms,
            **_bound(4 * (n_in + n_out), B * N * K1_STAGE_FLOPS),
            "variant": plan.variant, "thread_variant_ms": thread_ms,
            "max_abs_diff_vs_thread": worst["diff"],
            "same_pattern_share": worst["same"],
            "block_cycles": cycles, "cycles_per_stage": per_stage,
            "by_size": by_size}


def _k1_flops(B, N, nx, nu):
    """K1's operations: K1_STAGE_FLOPS a stage at (3, 2), scaled by the
    stage's nx^2 (nx + nu) products."""
    return B * N * K1_STAGE_FLOPS * (nx * nx * (nx + nu)) // (9 * 5)


def _time_k1(args, nx, nu, label):
    """K1 on ``args`` (DDP) under the planned variant and under "thread",
    each held against the float64 twin (``_hold_f64``: the recursion over N
    = 40 stages moves the float32 twin too); their times, the twin's and the
    bound: one row of phase 3's table."""
    from mpc_verde_tpu_torch.ops.cuda.riccati import (
        riccati_backward, riccati_backward_torch, riccati_launch_plan)

    B, N = args[0]["fx"].shape[:2]
    kw = dict(nx=nx, nu=nu)
    plan = riccati_launch_plan(N, nx, nu, True, B)
    ref = riccati_backward_torch(*args, **kw)
    ref64 = riccati_backward_torch(
        {k: v.double() for k, v in args[0].items()}, *_to64(*args[1:]), **kw)
    for variant in dict.fromkeys((plan.variant, "thread")):
        used, out = _variants_used(
            riccati_backward,
            lambda: riccati_backward(*args, variant=variant, **kw))
        if used != {variant}:
            raise AssertionError(f"K1 {label} ran variants {used}")
        _hold_f64(out, ref, ref64, "k1",
                  f"{label} ({nx},{nu}) DDP variant {variant}")
    ms = _time_ms(lambda: riccati_backward(*args, **kw), reps=50)
    thread_ms = ms if plan.variant == "thread" else _time_ms(
        lambda: riccati_backward(*args, variant="thread", **kw), reps=50)
    plain_ms = _time_ms(lambda: riccati_backward_torch(*args, **kw), reps=3,
                        warmup=1, queued=False)
    n_in = sum(a.numel() for a in args[1:]) + sum(
        v.numel() for v in args[0].values())
    row = {"nx": nx, "nu": nu, "ms": ms, "plain_ms": plain_ms,
           "variant": plan.variant, "problems": plan.problems,
           "thread_variant_ms": thread_ms,
           **_bound(4 * (n_in + sum(o.numel() for o in out)),
                    _k1_flops(B, N, nx, nu))}
    print(f"[k1] {label} ({nx},{nu}) DDP: kernel {ms:.4f} ms "
          f"({plan.variant}, {plan.problems} a block), \"thread\" "
          f"{thread_ms:.4f} ms, twin {plain_ms:.2f} ms, bound "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']}", flush=True)
    return row


def _k2_inputs(dev, B, N, seed=3):
    """Random nominal trajectories and gains on the bench OCP's target."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    return (t(rng.uniform(-2, 2, (B, 3))), t(rng.uniform(-2, 2, (B, N + 1, 3))),
            t(rng.uniform(-0.8, 0.8, (B, N, 2))),
            t(np.broadcast_to(np.array([10.0, 10.0, 0.0]), (B, N + 1, 3)).copy()),
            t(0.3 * rng.normal(size=(B, N, 2))),
            t(0.2 * rng.normal(size=(B, N, 2, 3))))


def _variants_used(fn, run):
    """The variants `fn` launched while `run()` ran, and run's result."""
    before = dict(fn.launches_by_variant)
    out = run()
    return {v for v, n in fn.launches_by_variant.items() if n > before[v]}, out


# the benchmark's queue cells' slots (pointstab_n40.stream-w131072,
# quadrotor2d_n40.hover-w131072): K2's line search runs at this width; the
# variants the plan takes there, by alpha count (8: the line search, 1: the
# pre-roll), on the unicycle and on the quadrotor cell's traced model
CELL_WIDTH = 131072
UNICYCLE_AT_WIDTH = {8: "lanes_ring", 1: "lanes_ring"}
QUADROTOR_AT_WIDTH = {8: "lanes_ring", 1: "lanes_ring"}


def _k2_at_width(label, ocp, data, alphas, step_flops, expect):
    """K2's variants at a benchmark cell's width: each one's time beside
    its registers and local memory, the blocks an SM holds (the CUDA
    runtime's ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the
    bound; the plan must take ``expect``, and "lanes_ring" must give the
    bits of "lanes".  Returns the row."""
    from mpc_verde_tpu_torch.ops.cuda.rollout import (
        LINESEARCH_VARIANTS, kernel_model, linesearch_forward,
        linesearch_occupancy)

    x0, us = data[0], data[2]
    B, N, _ = us.shape
    if not x0.is_cuda:   # a rehearsal on the CPU: no kernel to ask or time
        return {"case": label, "B": B, "N": N, "A": len(alphas)}
    A, model = len(alphas), kernel_model(ocp)
    rows, outs = {}, {}
    for variant in LINESEARCH_VARIANTS:
        plan = _k2_plan(data, alphas, variant)
        run = lambda: linesearch_forward(*data, alphas, ocp=ocp, variant=variant)
        outs[variant] = run()
        occ = linesearch_occupancy(model, variant, plan.threads,
                                   plan.smem_bytes, x0.device)
        rows[variant] = {"ms": _time_ms(run, reps=5), "plan": plan[:4], **occ}
        print(f"[k2] {label} B={B} N={N} A={A} {variant}: "
              f"{rows[variant]['ms']:.4f} ms, {plan.threads} threads and "
              f"{plan.smem_bytes} B a block, {occ['registers']} registers, "
              f"local {occ['local_bytes']} B, {occ['blocks_per_sm']} blocks an "
              f"SM", flush=True)
    n_io = sum(a.numel() for a in data) + sum(
        o.numel() for o in outs["lanes_ring"])
    bound = _bound(4 * n_io, B * A * N * step_flops)
    planned = _k2_plan(data, alphas).variant
    used, _ = _variants_used(linesearch_forward,
                             lambda: linesearch_forward(*data, alphas, ocp=ocp))
    print(f"[k2] {label} B={B} N={N} A={A}: planned {planned}, bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}", flush=True)
    if planned != expect or used != {expect}:
        raise AssertionError(f"K2 {label} at B={B}: planned {planned}, ran "
                             f"{used}, expected {expect}")
    if not all(_same_bits(a, b) for a, b in zip(outs["lanes_ring"],
                                                 outs["lanes"])):
        raise AssertionError(f"K2 {label}: lanes_ring and lanes differ")
    return {"case": label, "B": B, "N": N, "A": A, "planned": planned,
            "variants": rows, **bound}


def phase_k2(dev, B=WIDTH, N=BENCH_N, A=8, B_ragged=1000, M=QUEUE):
    from mpc_verde_tpu_torch import ILQROptions
    from mpc_verde_tpu_torch.interop import bench_ocp
    from mpc_verde_tpu_torch.ops.cuda.rollout import (
        linesearch_forward, linesearch_forward_torch)
    from mpc_verde_tpu_torch.scenarios import build_fleet

    bench = bench_ocp(N, dev, torch.float32)
    alphas_of = lambda n: tuple(0.4 ** i for i in range(n))

    def compare(data, alphas, label, variant=None, ocp=bench):
        """Kernel vs twin at phase 4's tolerances; returns (max abs err,
        the kernel's outputs).  Unless one is forced, the variant must be
        the plan's for the shape and the batch."""
        args = (*data, alphas)
        used, out = _variants_used(
            linesearch_forward,
            lambda: linesearch_forward(*args, ocp=ocp, variant=variant))
        xs_k, us_k, c_k, b_k = out
        xs_t, us_t, c_t, b_t = linesearch_forward_torch(*args, ocp=ocp)
        cost_rel = float(((c_k.double() - c_t.double()).abs()
                          / c_t.double().abs()).max())
        same = b_k == b_t
        same_frac = float(same.float().mean())
        traj = max(_rel_err(xs_k[same], xs_t[same]),
                   _rel_err(us_k[same], us_t[same]))
        print(f"[k2] {label} variant {sorted(used)}: cost rel err "
              f"{cost_rel:.2e}, same alpha {same_frac:.4f}, traj err (same "
              f"alpha, vs max(1,|ref|)) {traj:.2e}", flush=True)
        if cost_rel > 1e-5 or same_frac < 0.999 or traj > 1e-4:
            raise AssertionError(f"K2 {label} out of tolerance: cost rel "
                                 f"{cost_rel}, same alpha {same_frac}, traj {traj}")
        if used != {variant or _k2_plan(data, alphas).variant}:
            raise AssertionError(f"K2 {label} ran variants {used}")
        return max(_abs_err(c_k, c_t), _abs_err(xs_k[same], xs_t[same]),
                   _abs_err(us_k[same], us_t[same])), out

    data = _k2_inputs(dev, B, N)
    err, out_lanes = compare(data, alphas_of(A), f"bench B={B} N={N} A={A}")
    err = max(err, compare(data, alphas_of(5), f"B={B} N={N} A=5")[0])
    ragged = _k2_inputs(dev, B_ragged, N, seed=4)
    err = max(err, compare(ragged, alphas_of(A), f"B={B_ragged} N={N} A={A}")[0])
    zero = lambda d: (*d[:4], torch.zeros_like(d[4]), torch.zeros_like(d[5]))
    err = max(err, compare(zero(ragged), (1.0,),
                           f"pre-roll B={B_ragged} N={N} A=1")[0])
    e, out_ties = compare(zero(data), alphas_of(A),
                          f"all ties B={B} N={N} A={A}")
    err = max(err, e)
    if int(out_ties[3].abs().max()) != 0:
        raise AssertionError("K2: on all-tied costs alpha 0 must win")

    # the shapes the driven paths give the kernel: the streaming pre-roll of
    # the whole queue, and the fleet's line search and pre-roll on its OCP
    # with the solver's default alphas
    err = max(err, compare(zero(_k2_inputs(dev, M, N, seed=5)), (1.0,),
                           f"streaming pre-roll B={M} N={N} A=1")[0])
    fleet = build_fleet(n_steps=1, device=dev)
    o = ILQROptions()
    fleet_alphas = tuple(float(o.alpha_decay) ** i for i in range(o.n_alphas))
    B_f, N_f, A_f = fleet["spec"]["B"], fleet["spec"]["N"], len(fleet_alphas)
    fleet_data = _k2_inputs(dev, B_f, N_f, seed=6)
    print(f"[k2] fleet shape: {_k2_plan(fleet_data, fleet_alphas)}",
          flush=True)
    err = max(err,
              compare(fleet_data, fleet_alphas,
                      f"fleet B={B_f} N={N_f} A={A_f}", ocp=fleet["ocp"])[0],
              compare(zero(fleet_data), (1.0,),
                      f"fleet pre-roll B={B_f} N={N_f} A=1", ocp=fleet["ocp"])[0])

    # the ring, forced, against its twin and against "lanes": the same bits
    e, out_ring = compare(data, alphas_of(A), f"bench B={B} N={N} A={A}",
                          variant="lanes_ring")
    err = max(err, e)
    same = all(_same_bits(a, b) for a, b in zip(out_lanes, out_ring))
    print(f"[k2] bench B={B} N={N} A={A}: lanes_ring and lanes give the same "
          f"bits over xs, us, cost, best: {same}", flush=True)
    if not same:
        raise AssertionError("K2: lanes_ring and lanes differ")

    args = (*data, alphas_of(A))
    ms = _time_ms(lambda: linesearch_forward(*args, ocp=bench), reps=50)
    ring_ms = _time_ms(
        lambda: linesearch_forward(*args, ocp=bench, variant="lanes_ring"),
        reps=50)
    plain_ms = _time_ms(lambda: linesearch_forward_torch(*args, ocp=bench),
                        reps=5, warmup=1, queued=False)
    print(f"[k2] bench B={B} N={N} A={A}: kernel {ms:.4f} ms, \"lanes_ring\" "
          f"variant {ring_ms:.4f} ms, twin {plain_ms:.4f} ms", flush=True)
    n_io = sum(a.numel() for a in data) + sum(o.numel() for o in out_lanes)

    # the stream cell's width: the line search and the pre-roll
    wide = _k2_inputs(dev, CELL_WIDTH, N, seed=7)
    width = [_k2_at_width("bench", bench, wide, alphas_of(A), K2_STEP_FLOPS,
                          UNICYCLE_AT_WIDTH[A]),
             _k2_at_width("bench pre-roll", bench, zero(wide), (1.0,),
                          K2_STEP_FLOPS, UNICYCLE_AT_WIDTH[1])]
    del wide
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **_bound(4 * n_io, B * A * N * K2_STEP_FLOPS),
            "variant": "lanes", "ring_variant_ms": ring_ms, "at_width": width}


def _same_bits(a, b):
    """Whether two float32 tensors hold the same bits (NaNs included)."""
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _refill_bytes(B, n_fin, n_load, W, Q, fsize):
    """Bytes the refill must move, each read once and each written once:
    the scan's flags and problem ids; each finished slot's trajectory, cost,
    gradient, counters and flags read and its row of ``out`` written; each
    loaded problem's packed row read and written into the slot with a fresh
    state; the rest of the finished slots' ``prob``."""
    scan = B * (1 + 4) + 4 * (n_fin + 2)
    fin = n_fin * (fsize * (W - 2) + 4 + 4 + 4 + 2 + fsize * W)
    load = n_load * (fsize * Q + fsize * (Q - 1) + 3 * fsize + 6 * 4 + 4)
    return scan + fin + load + 4 * (n_fin - n_load)


def phase_refill(dev, B=131072, M=1048576, N=BENCH_N, share=0.042):
    """The streaming refill (``refill_slots``) at the stream cell's shapes
    (the unicycle, npar 3, float32): a seeded ``share`` of the slots
    finished, in mid-queue (each loads a problem) and in the drain tail
    (none does), and every slot finished.  The kernel must give the twin's
    bits; it is timed by CUDA events around its call alone, the slots
    restored before each, against its byte bound and the twin (the solver's
    refill before the kernel)."""
    from mpc_verde_tpu_torch.ops.cuda.refill import (SLOT_STATE, refill_slots,
                                                     refill_slots_torch)

    nx, nu, npar = 3, 2, 3
    sx, su, sp = (N + 1) * nx, N * nu, (N + 1) * npar
    W, Q = sx + su + 4, nx + sp + su + sx + 1
    rng = np.random.default_rng(23)
    g = torch.Generator(device=dev).manual_seed(23)
    f = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    rand = lambda *shape: torch.rand(shape, generator=g, **f)
    qpk, out = rand(M, Q), rand(M + 1, W)
    out_keep = out[M].clone()
    base = dict(xs=rand(B, N + 1, nx), us=rand(B, N, nu), cost=rand(B),
                reg=rand(B), it=torch.randint(0, 40, (B,), generator=g, **i32),
                gnorm=rand(B), stall=torch.zeros(B, **i32),
                fail=rand(B) < 0.01, ddp_on=rand(B) < 0.5, x0s=rand(B, nx),
                ps=rand(B, N + 1, npar), capped=rand(B) < 0.01,
                rst=torch.zeros(B, **i32), iacc=torch.zeros(B, **i32),
                alr=torch.zeros(B, **i32))
    res = {}
    for label, frac, nq0 in ((f"{100 * share:g}% mid-queue", share, M // 2),
                             (f"{100 * share:g}% drain tail", share, M),
                             ("100% mid-queue", 1.0, M // 4)):
        # the slots hold distinct problems below nq0
        prob = torch.as_tensor(rng.choice(nq0, B, replace=False), **i32)
        done = torch.as_tensor(rng.uniform(size=B) < frac, device=dev)
        state = tuple({**base, "done": done, "prob": prob}[k]
                      for k in SLOT_STATE)
        nq = torch.tensor(nq0, **i32)
        kw = dict(reg_init=1e-3, use_ddp=True)
        want_out = out.clone()
        want, want_nq = refill_slots_torch(state, nq.clone(), want_out, qpk,
                                           **kw)
        mine = tuple(t.clone() for t in state)
        got, got_nq = refill_slots(mine, nq.clone(), out, qpk, **kw)
        torch.cuda.synchronize()
        ok = (all(_same_bits(a, b) if a.is_floating_point()
                  else torch.equal(a, b) for a, b in zip(got, want))
              and torch.equal(got_nq, want_nq)
              and _same_bits(out[:M], want_out[:M])
              and _same_bits(out[M], out_keep))
        if not ok:
            raise AssertionError(f"refill {label}: the kernel is not the twin")
        n_fin = int(done.sum())
        n_load = min(n_fin, M - nq0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(32):
            for t, t0 in zip(mine, state):
                t.copy_(t0)
            nq_k = nq.clone()
            # a device spin, so that the call is queued before the start
            # event runs and the events time the two kernels alone
            torch.cuda._sleep(20_000_000)
            start.record()
            refill_slots(mine, nq_k, out, qpk, **kw)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = sum(times[2:]) / len(times[2:])
        plain_ms = _time_ms(lambda: refill_slots_torch(
            state, nq, want_out, qpk, **kw), reps=5, warmup=1, queued=False)
        bound = _bound(_refill_bytes(B, n_fin, n_load, W, Q, 4), 0)
        print(f"[refill] B={B} M={M} N={N} {label} ({n_fin} finished, "
              f"{n_load} loaded): kernel {ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms (bytes), twin {plain_ms:.4f} ms; "
              "the twin's bits", flush=True)
        res[label] = {"ms": ms, "plain_ms": plain_ms, "finished": n_fin,
                      "loaded": n_load, **bound}
    return res


def phase_rebase(dev, B=131072, N=BENCH_N, share=0.04):
    """The rounds' cost re-base (``trajectory_cost``) at the interior-point
    cell's width, on the barrier-derived bench OCP (npar 4, mu 1e-2): the
    trajectories are K2's pre-roll of interior controls, some with a control
    on the box edge (priced +inf); a seeded ``share`` of the slots masked,
    then all of them.  The masked costs must be K2's bit for bit and within
    1e-5 of the float32 twin, the others ``cost_in`` bit for bit; the kernel
    is timed against its byte bound and the twin (the solver's plain
    re-base, every slot priced)."""
    from mpc_verde_tpu_torch.interop import (bench_ocp, derived_ocps,
                                             derived_params)
    from mpc_verde_tpu_torch.ops.cuda.rollout import (
        linesearch_forward, trajectory_cost, trajectory_cost_torch)

    ocp = derived_ocps(bench_ocp(N, dev, torch.float32))["barrier"]
    rng = np.random.default_rng(21)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    z = dict(dtype=torch.float32, device=dev)
    us = rng.uniform(-0.6, 0.6, (B, N, 2))
    us[rng.uniform(size=B) < 0.01, N // 2, 0] = 1.0     # on the box edge
    x0 = t(rng.uniform(-2, 2, (B, 3)))
    ps = derived_params("barrier", t(np.broadcast_to(
        np.array([10.0, 10.0, 0.0]), (B, N + 1, 3)).copy()), mu=1e-2)
    xs, us, c_k, _ = linesearch_forward(
        x0, torch.zeros((B, N + 1, 3), **z), t(us), ps,
        torch.zeros((B, N, 2), **z), torch.zeros((B, N, 2, 3), **z), (1.0,),
        ocp=ocp)
    cost_in = t(rng.normal(size=B))
    cost_in[:3] = torch.tensor([np.nan, np.inf, -np.inf])
    twin = trajectory_cost_torch(xs, us, ps, ocp=ocp)
    out = {}
    for label, mask in ((f"{100 * share:g}%", t(rng.uniform(size=B)) < share),
                        ("100%", torch.ones(B, dtype=torch.bool, device=dev))):
        run = lambda: trajectory_cost(xs, us, ps, mask, cost_in, ocp=ocp)
        got = run()
        torch.cuda.synchronize()
        fin = mask & torch.isfinite(twin)
        rel = float(((got - twin).abs() / twin.abs().clamp(min=1.0))[fin].max())
        exact = _same_bits(got[mask], c_k[mask])
        kept = _same_bits(got[~mask], cost_in[~mask])
        if not (exact and kept and rel <= 1e-5 and bool(
                torch.equal(got[mask & ~torch.isfinite(twin)],
                            twin[mask & ~torch.isfinite(twin)]))):
            raise AssertionError(f"re-base {label}: K2's bits {exact}, "
                                 f"cost_in kept {kept}, twin rel err {rel}")
        n = int(mask.sum())
        n_bytes = 4 * (n * ((N + 1) * 3 + N * 2 + (N + 1) * 4)
                       + (B - n) + B) + B      # rows or cost_in, out; mask
        ms = _time_ms(run, reps=50)
        plain_ms = _time_ms(
            lambda: torch.where(mask, trajectory_cost_torch(xs, us, ps, ocp=ocp),
                                cost_in), reps=5, warmup=1, queued=False)
        bound = _bound(n_bytes, 0)
        print(f"[rebase] B={B} N={N} npar=4 mask {label} ({n} slots): kernel "
              f"{ms:.4f} ms, bound {bound['bound_ms']:.4f} ms (bytes), twin "
              f"{plain_ms:.4f} ms; K2's cost bit for bit, twin rel err "
              f"{rel:.2e}", flush=True)
        out[label] = {"ms": ms, "plain_ms": plain_ms, **bound}
    return out


def _hold(out, ref, tag, label):
    """Hold backward-pass outputs against the twin's at K1_TOL; max abs err."""
    errs = {n: _rel_err(o, r) for n, o, r in zip(BACKWARD_OUT, out, ref)}
    bad = {n: e for n, e in errs.items()
           if n in K1_TOL and not e <= K1_TOL[n]}   # a NaN fails
    print(f"[{tag}] {label} rel err (vs max(1,|ref|)) "
          + " ".join(f"{n}={e:.2e}" for n, e in errs.items()), flush=True)
    if bad:
        raise AssertionError(f"{tag.upper()} {label} out of tolerance "
                             f"{K1_TOL}: {bad}")
    return max(_abs_err(o, r) for o, r in zip(out, ref))


def _check_result(res, M, N, nx=3, nu=2):
    shapes = {"xs": (M, N + 1, nx), "us": (M, N, nu), "cost": (M,)}
    for name, shape in shapes.items():
        v = getattr(res, name)
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"result {name}: shape {tuple(v.shape)} "
                                 f"(expected {shape}) or non-finite values")


def _path_counters():
    """Every kernel wrapper (launch counts) and every twin (CUDA calls)."""
    from mpc_verde_tpu_torch.ops.cuda import (
        fused_backward, fused_backward_torch, linesearch_forward,
        linesearch_forward_torch, riccati_backward, riccati_backward_torch)

    return ((riccati_backward, linesearch_forward, fused_backward),
            (riccati_backward_torch, linesearch_forward_torch,
             fused_backward_torch))


def _drive(run):
    """Run one path with every count set to 0 just before and read just
    after; returns (result, wall s, launches, twin calls on CUDA).  A
    kernel with variants also reports its launches of each, under
    "<name>.<variant>"."""
    kernels, twins = _path_counters()
    for f in kernels:
        f.launches = 0
        if hasattr(f, "launches_by_variant"):
            f.launches_by_variant = dict.fromkeys(f.launches_by_variant, 0)
    for f in twins:
        f.cuda_calls = 0
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in kernels}
    for f in kernels:
        for v, n in getattr(f, "launches_by_variant", {}).items():
            launches[f"{f.__name__}.{v}"] = n
    return res, wall, launches, {f.__name__: f.cuda_calls for f in twins}


def _check_path(launches, twin_calls, path_kernels):
    if min(launches[k] for k in path_kernels) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    if max(twin_calls.values()) > 0:
        raise AssertionError(f"a twin ran on CUDA tensors: {twin_calls}")
    for k in path_kernels:   # every planned variant ran, and no other
        if k in PLANNED:
            ran = [launches[f"{k}.{v}"] for v in PLANNED[k]]
            if min(ran) < 1 or sum(ran) != launches[k]:
                raise AssertionError(f"{k} left its planned variants: {launches}")


def _streaming_path(tag, gpu, solve, queue, path_kernels, warm=WIDTH,
                    check=None, note=""):
    """Drive one streaming entry point over ``queue`` (60 iterations + 2
    restarts) after a warm-up on its first ``warm`` problems, with the
    path's checks; returns (launches, result)."""
    x0q, psq, us0q = queue
    M, N = x0q.shape[0], psq.shape[1] - 1
    if warm:
        solve(x0q[:warm], psq[:warm], us0q[:warm], max_iters=60, restarts_n=2)
        torch.cuda.synchronize()
    res, wall, launches, twin_calls = _drive(
        lambda: solve(x0q, psq, us0q, max_iters=60, restarts_n=2))
    _check_result(res, M, N, x0q.shape[-1], us0q.shape[-1])
    conv = float(res.converged.float().mean())
    print(f"[{tag}] {note}M={M} N={N}: {M / wall:.1f} solves/s ({wall:.3f} s), "
          f"converged_frac {conv:.4f}, mean_iterations "
          f"{float(res.iterations.double().mean()):.3f}, max_violation "
          f"{float(res.max_violation.max()):.3e}, launches {launches}, twin "
          f"calls on CUDA {twin_calls} | GPU {gpu}", flush=True)
    if conv < 0.99:
        raise AssertionError(f"{tag}: converged_frac {conv} < 0.99")
    if check is not None:
        check(res)
    _check_path(launches, twin_calls, path_kernels)
    return launches, res


def _hold_paths(tag, res, ref):
    """Two float32 paths' answers to one queue: converged agree >= 0.99,
    cost rel err <= 1e-3 where both converged."""
    agree = float((res.converged == ref.converged).float().mean())
    both = res.converged & ref.converged
    rel = float(((res.cost.double() - ref.cost.double()).abs()
                 / ref.cost.double().abs())[both].max())
    print(f"[{tag}] converged agree {agree:.4f}, cost rel err where both "
          f"converged {rel:.2e}", flush=True)
    if agree < 0.99 or rel > 1e-3:
        raise AssertionError(f"{tag}: agree {agree}, rel {rel}")


def _streaming(dev, gpu, backend, path_kernels, tag, M, W, N):
    """Phase 5's streaming solve of the bench queue on ``backend``."""
    from mpc_verde_tpu_torch import make_streaming_solver
    from mpc_verde_tpu_torch.interop import bench_ocp

    solve = make_streaming_solver(bench_ocp(N, dev, torch.float32), _opts(),
                                  backend=backend, batch_width=W, restarts=2)
    return _streaming_path(
        tag, gpu, solve, _queue(M, N), path_kernels, warm=W,
        note=f"streaming backend={backend} W={W}, JAX band (TPU run) "
        f"{JAX_BAND}: ")


def phase_main(dev, gpu, M=QUEUE, W=WIDTH, N=BENCH_N):
    return _streaming(dev, gpu, "cuda",
                      ("riccati_backward", "linesearch_forward"), "main",
                      M, W, N)


def phase_main_fused(dev, gpu, ref, M=QUEUE, W=WIDTH, N=BENCH_N):
    """Phase 5's queue on "cuda_fused", held against phase 5's result
    ``ref``: the two float32 paths differ only in how the stage derivatives
    are computed (dual numbers in the kernel, torch.func in phase 5)."""
    launches, res = _streaming(dev, gpu, "cuda_fused",
                               ("fused_backward", "linesearch_forward"),
                               "main-fused", M, W, N)
    _hold_paths("main-fused vs phase 5", res, ref)
    return launches, res


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


def phase_k3(dev, B=WIDTH, N=BENCH_N, B_rand=1000, N_rand=6, N_fleet=10):
    from mpc_verde_tpu_torch.interop import BENCH_DT, bench_ocp, unicycle_ocp
    from mpc_verde_tpu_torch.ops.cuda.fused import (
        fused_backward, fused_backward_torch, fused_launch_plan,
        fused_phase_clocks)

    def compare(ocp, args, use_ddp, label, variant=None):
        used, out = _variants_used(
            fused_backward,
            lambda: fused_backward(*args, ocp=ocp, use_ddp=use_ddp,
                                   variant=variant))
        ref = fused_backward_torch(*args, ocp=ocp, use_ddp=use_ddp)
        if used != {variant or "staged"}:
            raise AssertionError(f"K3 {label} ran variants {used}")
        return _hold(out, ref, "k3", f"{label} variant {sorted(used)}"), out

    def terminal_ocp(n):   # tests/test_pallas_fused.py's terminal cost 2 e'Qe
        Q = np.diag([1.0, 5.0, 0.1])
        return unicycle_ocp(n, dev, dt=BENCH_DT, Q=Q, R=np.diag([0.5, 0.05]),
                            lb=[-1.0, -np.pi / 4], ub=[1.0, np.pi / 4],
                            Qf=2.0 * Q)

    f = dict(dtype=torch.float32, device=dev)
    bench_args = lambda ocp, b: (*_bench_trajectories(ocp, b, dev),
                                 torch.full((b,), 1e-6, **f),
                                 torch.ones((b,), **f))
    ocp = bench_ocp(N, dev, torch.float32)
    args = bench_args(ocp, B)
    e_ddp, out_staged = compare(ocp, args, True, f"bench B={B} N={N} DDP")
    e_gn, out_staged_gn = compare(ocp, args, False,
                                  f"bench B={B} N={N} Gauss-Newton")
    err = max(e_ddp, e_gn,
              compare(terminal_ocp(N), args, True,
                      f"terminal Qf=2Q B={B} N={N} DDP")[0],
              compare(ocp, bench_args(ocp, B_rand), True,
                      f"bench B={B_rand} N={N} DDP")[0])
    ocp_fleet = bench_ocp(N_fleet, dev, torch.float32)
    err = max(err, compare(ocp_fleet, bench_args(ocp_fleet, B), True,
                           f"bench B={B} N={N_fleet} DDP")[0])
    rng = np.random.default_rng(9)
    t = lambda a: torch.as_tensor(a, **f).contiguous()
    ps = np.zeros((B_rand, N_rand + 1, 3))
    ps[..., :2] = rng.uniform(-5, 5, (B_rand, 1, 2))
    ddp = np.ones(B_rand)
    ddp[::2] = 0.0
    rand = (t(rng.uniform(-2, 2, (B_rand, N_rand + 1, 3))),
            t(rng.uniform(-0.7, 0.7, (B_rand, N_rand, 2))), t(ps),
            t(np.full(B_rand, 1e-4)), t(ddp))
    err = max(err, compare(terminal_ocp(N_rand), rand, True,
                           f"random B={B_rand} N={N_rand} DDP/GN mixed")[0])

    # the "thread" variant, forced, against its twin and against "staged"
    diff = 0.0
    for use_ddp, staged in ((True, out_staged), (False, out_staged_gn)):
        e, out_thread = compare(ocp, args, use_ddp,
                                f"bench B={B} N={N} DDP={use_ddp}",
                                variant="thread")
        err = max(err, e)
        diff = max(diff, *(_abs_err(a, b) for a, b in zip(staged, out_thread)))
    print(f"[k3] bench B={B} N={N}: max |staged - thread| {diff:.2e} over "
          f"kff, K, dV1, dV2, gmax (DDP on and off)", flush=True)
    if diff > 1e-4:
        raise AssertionError(f"K3 variants disagree: {diff}")

    run = lambda fn, **kw: fn(*args, ocp=ocp, use_ddp=True, **kw)
    ms = _time_ms(lambda: run(fused_backward), reps=50)
    thread_ms = _time_ms(lambda: run(fused_backward, variant="thread"), reps=50)
    plain_ms = _time_ms(lambda: run(fused_backward_torch), reps=5, warmup=1,
                        queued=False)
    plan = fused_launch_plan(N, True)
    cycles = fused_phase_clocks(*args, ocp=ocp).double().mean(0).tolist()
    print(f"[k3] bench B={B} N={N} DDP: kernel {ms:.4f} ms, \"thread\" variant "
          f"{thread_ms:.4f} ms, twin {plain_ms:.4f} ms; {plan}; mean cycles a "
          f"block: phase 1 {cycles[0]:.0f}, phase 2 {cycles[1]:.0f}, write-out "
          f"{cycles[2]:.0f}", flush=True)
    n_io = sum(a.numel() for a in args) + sum(o.numel() for o in out_staged)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **_bound(4 * n_io, B * N * K3_STAGE_FLOPS),
            "variant": "staged",
            "thread_variant_ms": thread_ms, "max_abs_diff_vs_thread": diff,
            "phase_cycles": dict(zip(("phase1", "phase2", "write_out"), cycles))}


def phase_fleet(dev, gpu, B=None, n_steps=None):
    """The closed-loop fleet on "cuda_fused" at scenarios/fleet.py's SPEC,
    with the gates of the JAX package's tests/test_closed_loop.py."""
    from mpc_verde_tpu_torch.scenarios import build_fleet, run_fleet

    kw = dict(device=dev, dtype=torch.float32, backend="cuda_fused")
    run_fleet(build_fleet(B=B, n_steps=2, **kw))   # warm-up
    built = build_fleet(B=B, n_steps=n_steps, **kw)
    s = built["spec"]
    m, wall, launches, twin_calls = _drive(lambda: run_fleet(built))
    xs = m["result"].xs
    shape = (s["Nsim"] + 1, s["B"], 3)
    if tuple(xs.shape) != shape or not bool(torch.isfinite(xs).all()):
        raise AssertionError(f"fleet xs: shape {tuple(xs.shape)} (expected "
                             f"{shape}) or non-finite values")
    fe = m["final_err"]
    iters = m["result"].iterations.double()
    print(f"[fleet] backend=cuda_fused B={s['B']} N={s['N']} "
          f"Nsim={s['Nsim']}: {s['B'] * s['Nsim'] / wall:.1f} MPC steps/s "
          f"({wall:.3f} s), final_err p50 {np.percentile(fe, 50):.2e} "
          f"p99 {m['final_err_p99']:.2e} max {m['final_err_max']:.2e} mean "
          f"{m['final_err_mean']:.2e}, frac_reached {m['frac_reached']:.4f}, "
          f"steps_to_ball mean {m['steps_to_ball_mean']:.2f} max "
          f"{m['steps_to_ball_max']}, converged_frac {m['converged_frac']:.4f}, "
          f"solver iterations per step mean {float(iters.mean()):.3f}, "
          f"launches {launches}, twin calls on CUDA {twin_calls} | GPU {gpu}",
          flush=True)
    gates = {"frac_reached": m["frac_reached"] == 1.0,
             "final_err_max": m["final_err_max"] < 0.1,
             "final_err_p99": m["final_err_p99"] < 0.1,
             "final_err_mean": m["final_err_mean"] < 0.05,
             "converged_frac": m["converged_frac"] > 0.8}
    if not all(gates.values()):
        raise AssertionError(f"fleet gates failed: {gates}")
    _check_path(launches, twin_calls, ("fused_backward", "linesearch_forward"))
    return launches


# phase 10's state box: the starts lie in [-2, 2]^3, so the trajectories
# run on both sides of x >= -1.5 and |y| <= 1
TERM_BOX = ([-1.5, -1.0, -np.inf], [np.inf, 1.0, np.inf])
# Phase 12's: the target (10, 10, 0) lies outside y <= 5, and without the
# box every problem's trajectory passes y = 5, so the box binds for every
# problem (the phase prints the share at the bound).  Six AL rounds, not the
# JAX tests' three: their gate, max_violation < 1e-2, was set on a milder
# problem (N = 12, target 1.1 beyond the box); on this one three rounds left
# a largest violation of 0.115 on the H100 (box y <= 8); each round cuts the
# largest violation several times, and the largest grows with the queue.
AL_Y_MAX, AL_ITERS = 5.0, 6


def _term_inputs(dev, B, N, seed=12):
    """Phase 10's inputs: nominal trajectories of interior controls (us in
    [-0.6, 0.6]^2 and xs their rollout), random gains as phase 4's, the
    bench target, and AL multipliers (lam in [0, 2] on about half the rows,
    mu_al one of 10, 100, 1000 a problem)."""
    from mpc_verde_tpu_torch.interop import bench_ocp
    from mpc_verde_tpu_torch.ops.cuda.rollout import linesearch_forward_torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    x0 = t(rng.uniform(-2, 2, (B, 3)))
    us = t(rng.uniform(-0.6, 0.6, (B, N, 2)))
    ps = t(np.broadcast_to(np.array([10.0, 10.0, 0.0]), (B, N + 1, 3)).copy())
    z = dict(dtype=torch.float32, device=dev)
    xs, us, _, _ = linesearch_forward_torch(
        x0, torch.zeros((B, N + 1, 3), **z), us, ps,
        torch.zeros((B, N, 2), **z), torch.zeros((B, N, 2, 3), **z), (1.0,),
        ocp=bench_ocp(N, dev))
    lam = rng.uniform(0, 2, (B, N + 1, 6)) * (rng.uniform(size=(B, N + 1, 6)) < 0.5)
    return (x0, xs, us, ps, t(0.3 * rng.normal(size=(B, N, 2))),
            t(0.2 * rng.normal(size=(B, N, 2, 3))), t(lam),
            t(rng.choice([10.0, 100.0, 1000.0], B)))


def _term_cases(dev, N, inputs):
    """(label, OCP, its params) of phase 10: the OCPs the interior-point and
    state-bound solvers derive from the bench OCP, then the circular track's
    OCP (the control reference in p[3:5], random around the circle's
    (1, 1)) and its derived AL OCP, and the diff-drive quadrature OCPs."""
    from mpc_verde_tpu_torch.interop import (bench_ocp, derived_ocps,
                                             derived_params)
    from mpc_verde_tpu_torch.scenarios.circular import circular_ocp
    from mpc_verde_tpu_torch.scenarios.diffdrive import diffdrive_ocp

    ocps = derived_ocps(bench_ocp(N, dev, torch.float32, x_lb=TERM_BOX[0],
                                  x_ub=TERM_BOX[1]))
    ps, lam, mu_al = inputs[3], inputs[6], inputs[7]
    cases = [(f"barrier mu={mu:g}", "barrier", dict(mu=mu))
             for mu in (1e-2, 1e-4, 0.0)]
    cases += [("barrier_batched mu=0.01", "barrier_batched", dict(mu=1e-2)),
              ("al", "al", dict(lam=lam, mu_al=mu_al)),
              ("barrier_al mu=0.01", "barrier_al",
               dict(mu=1e-2, lam=lam, mu_al=mu_al))]
    out = [(label, ocps[name], derived_params(name, ps, **kw))
           for label, name, kw in cases]
    u_ref = torch.as_tensor(
        np.random.default_rng(13).uniform(0.5, 1.5, (*ps.shape[:2], 2)),
        dtype=torch.float32, device=dev)
    ps_c = torch.cat([ps, u_ref], dim=-1).contiguous()
    circ = circular_ocp(N, dev)
    out += [("u_ref", dataclasses.replace(circ, x_lb=None, x_ub=None), ps_c),
            ("circular_al", derived_ocps(circ)["al"],
             derived_params("al", ps_c, lam=lam, mu_al=mu_al))]
    out += [(f"quadrature M={M} {integ}",
             diffdrive_ocp(N, dev, integrator=integ, cost="quadrature", M=M), ps)
            for integ in ("rk4", "euler") for M in (1, 4)]
    return out


def _k2_kernel_rule(data, alphas, ocp):
    """The twin's candidates one alpha at a time, and the winner under the
    kernel's rule (the Pallas kernel's): the first minimum among the costs
    below FLT_MAX, else alpha 0.  A candidate the barrier prices +inf or NaN
    loses to every finite one; the twin's own argmin (jnp.argmin's rule)
    would pick a NaN.  Returns the winner's (index, xs, us, cost) and the
    share of problems with a non-finite candidate."""
    from mpc_verde_tpu_torch.ops.cuda.rollout import linesearch_forward_torch

    outs = [linesearch_forward_torch(*data, (a,), ocp=ocp) for a in alphas]
    costs = torch.stack([o[2] for o in outs])                  # (A, B)
    valid = costs < torch.finfo(costs.dtype).max
    best = torch.where(valid, costs, torch.inf).argmin(0)      # first minimum
    rows = torch.arange(costs.shape[1], device=costs.device)
    pick = lambda i: torch.stack([o[i] for o in outs])[best, rows]
    return (best.to(torch.int32), pick(0), pick(1), pick(2),
            float((~valid).any(0).float().mean()))


def _program_flops(ocp):
    """(K2 step, K3 stage) operations of the model traced from ``ocp``'s
    callables, counted from its program's instructions (``_traced_flops``):
    K2 adds the feedback and the clip, K3 K1's stage QP at (nx, nu)."""
    from mpc_verde_tpu_torch.ops.cuda.rollout import traced_device_model

    program = traced_device_model(ocp).program
    nx, nu = program.nx, program.nu
    return (_traced_flops(program, False) + 2 * nu * nx + 3 * nu,
            _traced_flops(program, True) + _k1_flops(1, 1, nx, nu))


# Phase 10's linear cases: (label, builder, its keywords, state scale, rate
# scale): the lane change's v1 shape (N 20, move blocking after Ntu 3, npar
# 4), LTV (N 5, npar 16), the dynamic bicycle (N 10, npar 25, nx 5) and the
# pendulum (N 50, Ntu 5, npar 0 and padded to 1).
LINEAR_CASES = [
    ("lti N=20 Ntu=3", "build_lane_change_lti", dict(N=20, Ntu=3, n_steps=300),
     0.5, 0.35),
    ("ltv", "build_lane_change_ltv", dict(n_steps=500), 0.5, 0.35),
    ("dynamic", "build_dynamic_bicycle", dict(n_steps=500), 0.5, 0.35),
    ("pendulum", "build_pendulum", dict(n_steps=1), 1.0, 60.0),
    ("pendulum padded", "build_pendulum", dict(n_steps=1), 1.0, 60.0),
]


def _linear_inputs(ocp, table, B, x_scale, u_scale, dev, seed=31, npar=None):
    """Inputs of one linear case: starts z0 with u_prev on both sides of
    the control box (|u_prev| up to 1.3 times the rate scale, past the lane
    change's steering limit), nominal rates, xs their rollout by the twin,
    random gains that clip candidates, and params drawn from the scenario's
    own table (zeros of width ``npar`` for a model that reads none)."""
    from mpc_verde_tpu_torch.ops.cuda.rollout import linesearch_forward_torch

    rng = np.random.default_rng(seed)
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    z0 = rng.uniform(-x_scale, x_scale, (B, nx))
    z0[:, -nu:] = rng.uniform(-1.3 * u_scale, 1.3 * u_scale, (B, nu))
    if table is None:
        ps = np.zeros((B, N + 1, ocp.npar if npar is None else npar))
    else:
        ps = np.asarray(table)[rng.integers(0, len(table), B)]
    z = dict(dtype=torch.float32, device=dev)
    x0, ps = t(z0), t(ps)
    xs, us, _, _ = linesearch_forward_torch(
        x0, torch.zeros((B, N + 1, nx), **z),
        t(rng.uniform(-u_scale, u_scale, (B, N, nu))), ps,
        torch.zeros((B, N, nu), **z), torch.zeros((B, N, nu, nx), **z), (1.0,),
        ocp=ocp)
    kff = t(0.5 * u_scale * rng.normal(size=(B, N, nu)))
    K = t(0.3 * u_scale / x_scale * rng.normal(size=(B, N, nu, nx)))
    return (x0, xs, us, kff, K), ps


def _linear_ocp(dev, label, dtype=torch.float32):
    """The OCP of phase 10's linear case ``label`` and its params table; in
    float64 (on "torch": the kernels take float32) for the reference."""
    from mpc_verde_tpu_torch import scenarios

    _, builder, kw, _, _ = next(c for c in LINEAR_CASES if c[0] == label)
    built = getattr(scenarios, builder)(
        device=dev, dtype=dtype,
        backend=None if dtype == torch.float32 else "torch", **kw)
    return built["ocp"], built.get("params_seq")


def _linear_case(dev, B, label, seed=31):
    """(OCP, its float64 twin, (x0, xs, us, kff, K), ps) of phase 10's
    linear case ``label``, float32 on ``dev``."""
    _, _, _, x_scale, u_scale = next(c for c in LINEAR_CASES if c[0] == label)
    ocp, table = _linear_ocp(dev, label)
    npar = 1 if label.endswith("padded") else None
    data, ps = _linear_inputs(ocp, table, B, x_scale, u_scale, dev, seed=seed,
                              npar=npar)
    return ocp, _linear_ocp(dev, label, torch.float64)[0], data, ps


def _linear_cases(dev, B):
    """(label, OCP, float64 OCP, (x0, xs, us, kff, K), ps) of phase 10's
    linear cases."""
    return [(c[0], *_linear_case(dev, B, c[0])) for c in LINEAR_CASES]


# Phase 10's path-frame cases, the Frenet OCP ((5, 2), N 20, npar 4) and
# the curvature cost on the LTV model ((4, 1), N 20, move blocking after Ntu
# 3, npar 16): (label, builder, its keywords, scales of (y, phi, v or r)
# about the stage's reference, rate scale).  |y - y_t| <= 0.4
# and the courses' kappa <= 1 keep |(y - y_t) kappa| below 0.5 at the start,
# away from the Frenet OCP's pole at 1; the curvature case's steering
# (u_prev up to 0.65, three free rates of 0.1) stays below 1.2 rad, away
# from the poles of its tan.
PATH_CASES = [
    ("frenet", "build_frenet", dict(n_steps=500), (0.4, 0.3, 0.5), 0.15),
    ("curvature", "build_curvature_ltv", dict(n_steps=500), (0.4, 0.3, 0.5),
     0.1),
]


def _path_case(dev, B, label, seed=33):
    """(OCP, its float64 twin, (x0, xs, us, kff, K), ps) of phase 10's
    path-frame case ``label``, float32 on ``dev``: params drawn from the
    scenario's own table, starts about the first stage's reference (u_prev
    on both sides of the steering box, its scale capped at 0.5), random
    rates and xs their rollout by the twin, random gains."""
    from mpc_verde_tpu_torch import scenarios
    from mpc_verde_tpu_torch.ops.cuda.rollout import linesearch_forward_torch

    _, builder, kw, scales, u_scale = next(
        c for c in PATH_CASES if c[0] == label)
    build = lambda dtype: getattr(scenarios, builder)(
        device=dev, dtype=dtype,
        backend=None if dtype == torch.float32 else "torch", **kw)
    built = build(torch.float32)
    ocp = built["ocp"]
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    rng = np.random.default_rng(seed)
    table = np.asarray(built["params_seq"])
    ps = table[rng.integers(0, len(table), B)]
    z0 = np.zeros((B, nx))
    z0[:, 0] = ps[:, 0, 0] + rng.uniform(-scales[0], scales[0], B)
    z0[:, 1] = ps[:, 0, 1] + rng.uniform(-scales[1], scales[1], B)
    z0[:, 2] = (ps[:, 0, 3] if nu == 2 else 0.0) + rng.uniform(
        -scales[2], scales[2], B)
    spec = built["spec"]
    u_max = np.minimum([spec["delta_max"], spec.get("a_max", 0.0)][:nu], 0.5)
    z0[:, 3:] = rng.uniform(-1.3 * u_max, 1.3 * u_max, (B, nu))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    z = dict(dtype=torch.float32, device=dev)
    x0, ps = t(z0), t(ps)
    xs, us, _, _ = linesearch_forward_torch(
        x0, torch.zeros((B, N + 1, nx), **z),
        t(rng.uniform(-u_scale, u_scale, (B, N, nu))), ps,
        torch.zeros((B, N, nu), **z), torch.zeros((B, N, nu, nx), **z), (1.0,),
        ocp=ocp)
    kff = t(0.5 * u_scale * rng.normal(size=(B, N, nu)))
    K = t(0.1 * u_scale * rng.normal(size=(B, N, nu, nx)))
    return ocp, build(torch.float64)["ocp"], (x0, xs, us, kff, K), ps


# The linear cases are held against the float64 twin.  Their plants are
# open-loop unstable (the pendulum) or their costs large (forces up to 200),
# so float32 round-off grows along the horizon: on the pendulum at N = 50
# the float32 twin and the kernel, each float32 in its own order, differ by
# 1e-4 in the cost and 3e-4 in kff (relative), above phase 4's and K1_TOL's
# bounds, which were set on the unicycle.  So each output is held to the
# float64 twin within the larger of that bound and F32_MARGIN times the
# float32 twin's own distance from it: the kernel must be as accurate as
# the plain float32 version, give or take its order of operations.
F32_MARGIN = 4.0


def _k2_candidates(data, alphas, ocp):
    """The twin's candidates one alpha at a time: xs (A, B, N+1, nx), us
    (A, B, N, nu), cost (A, B), float64."""
    from mpc_verde_tpu_torch.ops.cuda.rollout import linesearch_forward_torch

    outs = [linesearch_forward_torch(*data, (a,), ocp=ocp) for a in alphas]
    return tuple(torch.stack([o[i] for o in outs]).double() for i in range(3))


def _rate_boxes(ocp, zs):
    """The rate-form OCP's stage boxes at the states zs (B, N(+1), nx), as
    its callables give them: (lo, hi), each (B, N, nu)."""
    from torch.func import vmap

    B, N = zs.shape[0], ocp.N
    p = torch.zeros((B, ocp.npar), dtype=zs.dtype, device=zs.device)
    box = vmap(ocp.control_bounds, in_dims=(0, 0, None))
    lo, hi = zip(*(box(zs[:, k], p, k) for k in range(N)))
    return torch.stack(lo, 1), torch.stack(hi, 1)


def _pinned(ocp):
    """The move-blocked stages of a rate-form OCP (N,): where its box at
    u_prev = 0 is the point 0, for the first control."""
    z0 = torch.zeros((1, ocp.N, ocp.nx), dtype=ocp.dtype, device=ocp.device)
    lo, hi = _rate_boxes(ocp, z0)
    return ((lo[0, :, 0] == 0) & (hi[0, :, 0] == 0)).cpu().numpy()


def _hold_k2_f64(label, out, cand32, cand64, ocp):
    """K2's outputs against the float64 twin's candidates: the picked
    alpha's cost and trajectory within the bounds above, the pick a first
    minimum within the cost bound, and on the move-blocked stages of
    ``ocp`` (a rate-form OCP, or None for no move blocking) the rates
    exactly 0 wherever the rolled u_prev lies inside the control box: there
    the blocked stage's box is the point 0.  (Where a free stage's rate
    clipped to the box's edge, u_prev + w may round past it in float32; the
    blocked stage's box [0, u_ub - u_prev] then pulls it back by that
    rounding, in the kernel as in the twin.)  Returns the max abs error
    against float64."""
    xs_k, us_k, c_k, b_k = out
    blocked = (np.zeros(us_k.shape[1], bool) if ocp is None
               else _pinned(ocp))
    pinned = torch.as_tensor(blocked, device=us_k.device)
    if ocp is None:
        inside = torch.zeros((us_k.shape[0], 0, us_k.shape[2]), dtype=torch.bool,
                             device=us_k.device)
    else:
        lo, hi = _rate_boxes(ocp, xs_k)
        inside = (lo[:, pinned] == 0) & (hi[:, pinned] == 0)
    b = b_k.long()
    rows = torch.arange(b.shape[0], device=b.device)
    c64 = cand64[2]
    rel = lambda a, r: float(((a - r).abs() / r.abs().clamp(min=1.0)).max())

    def rel_finite(a, r):   # the float32 twin's distance where both are finite
        ok = torch.isfinite(a) & torch.isfinite(r)
        return rel(a[ok], r[ok]) if bool(ok.any()) else 0.0

    tol_c = max(1e-5, F32_MARGIN * rel_finite(cand32[2], c64))
    tol_t = max(1e-4, F32_MARGIN * max(rel_finite(cand32[0], cand64[0]),
                                       rel_finite(cand32[1], cand64[1])))
    # a candidate that leaves the model's domain (+inf or NaN cost) never
    # wins (the kernel's rule), so the first minimum is over the finite ones
    c64 = torch.where(torch.isfinite(c64), c64, torch.inf)
    pick = c64[b, rows]
    cmin = c64.min(0).values
    # where every candidate left the domain the kernel's cost does too
    fin = torch.isfinite(pick)
    cost = rel(c_k.double()[fin], pick[fin]) if bool(fin.any()) else 0.0
    first_min = (bool((pick[fin] <= cmin[fin] + tol_c * cmin[fin].abs().clamp(
        min=1.0)).all()) and not bool(torch.isfinite(cmin[~fin]).any())
        and not bool(torch.isfinite(c_k[~fin]).any()))
    xs_p, us_p = cand64[0][b, rows], cand64[1][b, rows]
    traj = max(rel(xs_k.double(), xs_p), rel(us_k.double(), us_p))
    same = float((b == c64.argmin(0)).float().mean())
    zero = bool((us_k[:, pinned][inside] == 0.0).all())
    print(f"[terms] K2 {label}: cost rel err vs float64 {cost:.2e} (bound "
          f"{tol_c:.2e}), traj {traj:.2e} (bound {tol_t:.2e}), a first "
          f"minimum {first_min}, the float64 argmin in {same:.4f}, pinned "
          f"rates 0 {zero} (u_prev inside the box at "
          f"{float(inside.float().mean()) if inside.numel() else 1.0:.4f} of "
          f"the pinned stages)", flush=True)
    if not (cost <= tol_c and traj <= tol_t and first_min and zero):
        raise AssertionError(f"K2 {label} against float64: cost {cost} "
                             f"(bound {tol_c}), traj {traj} (bound {tol_t}), "
                             f"first minimum {first_min}, pinned 0 {zero}")
    return max(_abs_err(c_k[fin], pick[fin]) if bool(fin.any()) else 0.0,
               _abs_err(xs_k, xs_p), _abs_err(us_k, us_p))


def _hold_f64(out, ref32, ref64, tag, label):
    """Backward-pass outputs against the float64 twin: each output of
    K1_TOL within the larger of its bound and F32_MARGIN times the float32
    twin's distance from float64.  Returns the max abs error."""
    errs, bounds = {}, {}
    for n, o, r32, r64 in zip(BACKWARD_OUT, out, ref32, ref64):
        errs[n] = _rel_err(o, r64)
        bounds[n] = max(K1_TOL.get(n, 0.0), F32_MARGIN * _rel_err(r32, r64))
    bad = {n: e for n, e in errs.items() if n in K1_TOL and not e <= bounds[n]}
    print(f"[{tag}] {label} rel err vs float64 (vs max(1,|ref|)) "
          + " ".join(f"{n}={e:.2e}/{bounds[n]:.1e}" for n, e in errs.items()),
          flush=True)
    if bad:
        raise AssertionError(f"{tag.upper()} {label} out of tolerance: {bad}")
    return max(_abs_err(o, r) for o, r in zip(out, ref64))


def _to64(*ts):
    return tuple(t.double() for t in ts)


def _k1_on_case(label, ocp, ocp64, data, ps):
    """K1 at the case's (nx, nu) on its derivatives (the twin's, along the
    case's trajectories, with its move-blocked stages' lo == hi) against the
    float64 twin on the float64 derivatives, under the planned variant and
    "thread"; the time of each and the bound."""
    from mpc_verde_tpu_torch.ops.cuda.riccati import (
        riccati_backward, riccati_backward_torch, riccati_launch_plan)
    from mpc_verde_tpu_torch.ops.linearize import trajectory_derivatives

    _, xs, us, _, _ = data
    B, N, nu = us.shape
    nx = xs.shape[-1]
    d, gN, HN, dlb, dub = trajectory_derivatives(ocp, xs, us, ps, True)
    f = dict(dtype=torch.float32, device=xs.device)
    args = (d, dlb.contiguous(), dub.contiguous(), gN, HN,
            torch.full((B,), 1e-6, **f), torch.ones((B,), **f))
    kw = dict(nx=nx, nu=nu)
    ref = riccati_backward_torch(*args, **kw)
    d64, gN64, HN64, dlb64, dub64 = trajectory_derivatives(
        ocp64, *_to64(xs, us, ps), True)
    ref64 = riccati_backward_torch(d64, dlb64, dub64, gN64, HN64,
                                   *_to64(*args[5:]), **kw)
    plan = riccati_launch_plan(N, nx, nu, True, B)
    for variant in (None, "thread"):
        used, out = _variants_used(
            riccati_backward,
            lambda: riccati_backward(*args, variant=variant, **kw))
        if used != {variant or plan.variant}:
            raise AssertionError(f"K1 {label} ran variants {used}")
        _hold_f64(out, ref, ref64, "terms",
                  f"K1 {label} ({nx},{nu}) variant {sorted(used)}")
    ms = _time_ms(lambda: riccati_backward(*args, **kw), reps=50)
    thread_ms = _time_ms(lambda: riccati_backward(*args, variant="thread", **kw),
                         reps=50)
    plain_ms = _time_ms(lambda: riccati_backward_torch(*args, **kw), reps=3,
                        warmup=1, queued=False)
    n_in = sum(a.numel() for a in args[1:]) + sum(v.numel() for v in d.values())
    n_out = sum(o.numel() for o in out)
    flops = _k1_flops(B, N, nx, nu)
    row = {"case": label, "nx": nx, "nu": nu, "ms": ms, "plain_ms": plain_ms,
           "variant": plan.variant, "thread_variant_ms": thread_ms,
           **_bound(4 * (n_in + n_out), flops)}
    print(f"[terms] K1 {label} ({nx},{nu}) B={B} N={N}: kernel {ms:.4f} ms, "
          f"\"thread\" variant {thread_ms:.4f} ms, twin {plain_ms:.2f} ms, "
          f"bound {row['bound_ms']:.4f} by "
          f"{row['bound_by']}; {plan[:4]}", flush=True)
    return row


def _hold_case(label, ocp, data, ps, alphas, err, flops):
    """K2 (every variant, against the twin's candidates under the kernel's
    winner rule) and K3 (DDP on and off, "staged" and "thread", at K1_TOL)
    against their twins on one OCP; updates ``err`` and returns the case's
    (K2 row, K3 row) of times and bounds.  ``data`` is (x0, xs, us, kff, K)
    and ``ps`` the OCP's params; ``flops`` (K2 a step, K3 a stage)."""
    from mpc_verde_tpu_torch.ops.cuda.fused import (
        fused_backward, fused_backward_torch)
    from mpc_verde_tpu_torch.ops.cuda.rollout import (
        LINESEARCH_VARIANTS, linesearch_forward, linesearch_forward_torch)

    x0, xs, us, kff, K = data
    B, npar = us.shape[0], ps.shape[-1]
    f = dict(dtype=torch.float32, device=xs.device)
    reg, ones = torch.full((B,), 1e-6, **f), torch.ones((B,), **f)
    data = (x0, xs, us, ps, kff, K)
    best, xs_r, us_r, c_r, nonfinite = _k2_kernel_rule(data, alphas, ocp)
    twin_best = linesearch_forward_torch(*data, alphas, ocp=ocp)[3]
    planned = _k2_plan(data, alphas).variant
    for variant in (None, *(v for v in LINESEARCH_VARIANTS if v != planned)):
        used, (xs_k, us_k, c_k, b_k) = _variants_used(
            linesearch_forward,
            lambda: linesearch_forward(*data, alphas, ocp=ocp,
                                       variant=variant))
        same = b_k == best
        fin = same & torch.isfinite(c_r)
        cost_rel = float(((c_k - c_r).abs() / c_r.abs())[fin].max())
        nonfin_ok = bool((~torch.isfinite(c_k[same & ~torch.isfinite(c_r)])
                          ).all())
        same_frac = float(same.float().mean())
        traj = max(_rel_err(xs_k[same], xs_r[same]),
                   _rel_err(us_k[same], us_r[same]))
        print(f"[terms] K2 {label} npar={npar} variant {sorted(used)}: cost "
              f"rel err {cost_rel:.2e}, same alpha {same_frac:.4f}, traj err "
              f"{traj:.2e}; problems with a +inf/NaN candidate "
              f"{nonfinite:.4f}, twin argmin elsewhere "
              f"{float((twin_best != best).float().mean()):.4f}", flush=True)
        if (not cost_rel <= 1e-5 or same_frac < 0.999 or not traj <= 1e-4
                or not nonfin_ok):
            raise AssertionError(f"K2 {label} out of tolerance: cost rel "
                                 f"{cost_rel}, same {same_frac}, traj {traj}, "
                                 f"non-finite winners kept {nonfin_ok}")
        if used != {variant or planned}:
            raise AssertionError(f"K2 {label} ran variants {used}")
        err["linesearch_forward"] = max(
            err["linesearch_forward"], _abs_err(c_k[fin], c_r[fin]),
            _abs_err(xs_k[same], xs_r[same]), _abs_err(us_k[same], us_r[same]))

    # Without a clip box the stage QP is a plain Newton step, and with
    # DDP these far-from-target trajectories make Quu indefinite: the
    # recursion then amplifies float32 round-off along the horizon
    # (kernel and twin differed by 1e2 relative at N = 40, as the bench
    # OCP's DDP derivatives with infinite bounds turn NaN), so that case
    # is held on Gauss-Newton only.  DDP and Gauss-Newton share the
    # cost's derivatives, the barrier's among them.
    for use_ddp in ((False,) if ocp.control_bounds is None
                    else (True, False)):
        args = (xs, us, ps, reg, ones)
        ref = fused_backward_torch(*args, ocp=ocp, use_ddp=use_ddp)
        for variant in (None, "thread"):
            used, out = _variants_used(
                fused_backward,
                lambda: fused_backward(*args, ocp=ocp, use_ddp=use_ddp,
                                       variant=variant))
            if used != {variant or "staged"}:
                raise AssertionError(f"K3 {label} ran variants {used}")
            err["fused_backward"] = max(err["fused_backward"], _hold(
                out, ref, "terms", f"K3 {label} npar={npar} DDP={use_ddp} "
                f"variant {sorted(used)}"))

    return _time_case(label, ocp, data, alphas, flops)


def _time_case(label, ocp, data, alphas, flops, twin=None):
    """One case's K2 and K3 times beside their twins' (on ``twin``'s
    callables, ``ocp``'s by default) and their bounds: (K2 row, K3 row)."""
    from mpc_verde_tpu_torch.ops.cuda.fused import (
        fused_backward, fused_backward_torch, fused_launch_plan)
    from mpc_verde_tpu_torch.ops.cuda.rollout import (
        linesearch_forward, linesearch_forward_torch)

    xs, us, ps = data[1], data[2], data[3]
    B, N, nu = us.shape
    nx, npar, A = xs.shape[-1], ps.shape[-1], len(alphas)
    f = dict(dtype=torch.float32, device=xs.device)
    reg, ones = torch.full((B,), 1e-6, **f), torch.ones((B,), **f)
    sizes = dict(nx=nx, nu=nu)
    planned = _k2_plan(data, alphas).variant
    twin = twin or ocp
    k2 = lambda: linesearch_forward(*data, alphas, ocp=ocp)
    k3 = lambda: fused_backward(xs, us, ps, reg, ones, ocp=ocp)
    out2, out3 = k2(), k3()
    n2 = sum(a.numel() for a in data) + sum(o.numel() for o in out2)
    n3 = xs.numel() + us.numel() + ps.numel() + 2 * B + sum(
        o.numel() for o in out3)
    row2 = {"case": label, "ms": _time_ms(k2, reps=50),
            "plain_ms": _time_ms(
                lambda: linesearch_forward_torch(*data, alphas, ocp=twin),
                reps=3, warmup=1, queued=False),
            "variant": planned, **_bound(4 * n2, B * A * N * flops[0])}
    row3 = {"case": label, "ms": _time_ms(k3, reps=50),
            "plain_ms": _time_ms(
                lambda: fused_backward_torch(xs, us, ps, reg, ones, ocp=twin),
                reps=3, warmup=1, queued=False),
            "variant": fused_launch_plan(N, True, None, B, **sizes).variant,
            **_bound(4 * n3, B * N * flops[1])}
    print(f"[terms] {label} npar={npar}: K2 {row2['ms']:.4f} ms "
          f"(twin {row2['plain_ms']:.2f}, bound {row2['bound_ms']:.4f} "
          f"by {row2['bound_by']}), K3 {row3['ms']:.4f} ms (twin "
          f"{row3['plain_ms']:.2f}, bound {row3['bound_ms']:.4f} by "
          f"{row3['bound_by']}); plan K2 "
          f"{_k2_plan(data, alphas)[:4]}, K3 "
          f"{fused_launch_plan(N, True, None, B, **sizes)[:4]}", flush=True)
    return row2, row3


def _hold_linear_case(label, ocp, ocp64, data, ps, alphas, err):
    """K2 (every variant) and K3 (DDP on and off, both variants) on a
    rate-form case (its model traced from its callables) against the
    float64 twin (``_hold_k2_f64``, ``_hold_f64``); then the case's times
    and bounds (``_program_flops``)."""
    from mpc_verde_tpu_torch.ops.cuda.fused import (
        fused_backward, fused_backward_torch)
    from mpc_verde_tpu_torch.ops.cuda.rollout import (
        LINESEARCH_VARIANTS, linesearch_forward)

    x0, xs, us, kff, K = data
    B = us.shape[0]
    _resolves_fused(label, ocp)
    full = (x0, xs, us, ps, kff, K)
    full64 = _to64(*full)
    cand32 = _k2_candidates(full, alphas, ocp)
    cand64 = _k2_candidates(full64, alphas, ocp64)
    planned = _k2_plan(full, alphas).variant
    for variant in (None, *(v for v in LINESEARCH_VARIANTS if v != planned)):
        used, out = _variants_used(
            linesearch_forward,
            lambda: linesearch_forward(*full, alphas, ocp=ocp, variant=variant))
        if used != {variant or planned}:
            raise AssertionError(f"K2 {label} ran variants {used}")
        err["linesearch_forward"] = max(err["linesearch_forward"], _hold_k2_f64(
            f"{label} variant {sorted(used)}", out, cand32, cand64, ocp))
    f = dict(dtype=torch.float32, device=xs.device)
    args = (xs, us, ps, torch.full((B,), 1e-6, **f), torch.ones((B,), **f))
    for use_ddp in (True, False):
        ref = fused_backward_torch(*args, ocp=ocp, use_ddp=use_ddp)
        ref64 = fused_backward_torch(*_to64(*args), ocp=ocp64, use_ddp=use_ddp)
        for variant in (None, "thread"):
            used, out = _variants_used(
                fused_backward,
                lambda: fused_backward(*args, ocp=ocp, use_ddp=use_ddp,
                                       variant=variant))
            if used != {variant or "staged"}:
                raise AssertionError(f"K3 {label} ran variants {used}")
            err["fused_backward"] = max(err["fused_backward"], _hold_f64(
                out, ref, ref64, "terms", f"K3 {label} DDP={use_ddp} "
                f"variant {sorted(used)}"))
    return _time_case(label, ocp, full, alphas, _program_flops(ocp))


def phase_terms(dev, B=WIDTH, N=BENCH_N, A=8):
    """K2 and K3 against their twins on the barrier and AL terms and the
    scenario terms of the unicycle, then on the rate-form families' traced
    models."""
    inputs = _term_inputs(dev, B, N)
    x0, xs, us, _, kff, K = inputs[:6]
    alphas = tuple(0.4 ** i for i in range(A))
    err = {"linesearch_forward": 0.0, "fused_backward": 0.0}
    by_case = {"linesearch_forward": {}, "fused_backward": {}}
    for label, ocp, ps in _term_cases(dev, N, inputs):
        # every case's terms for its bound
        model = ocp.device_model
        terms = [t for t, on in (("barrier", model.barrier is not None),
                                 ("al", model.al),
                                 ("u_ref", model.u_ref is not None)) if on]
        terms += (["quadrature_substep"] * model.quad_substeps
                  if model.cost == "quadrature" else [])
        flops = (K2_STEP_FLOPS + sum(TERM_FLOPS[t][0] for t in terms),
                 K3_STAGE_FLOPS + sum(TERM_FLOPS[t][1] for t in terms))
        row2, row3 = _hold_case(label, ocp, (x0, xs, us, kff, K), ps, alphas,
                                err, flops)
        by_case["linesearch_forward"][label] = row2
        by_case["fused_backward"][label] = row3
    k1_rows = {}
    cases = _linear_cases(dev, B)
    cases += [(c[0], *_path_case(dev, B, c[0])) for c in PATH_CASES]
    for label, ocp, ocp64, data, ps in cases:
        row2, row3 = _hold_linear_case(label, ocp, ocp64, data, ps, alphas,
                                       err)
        by_case["linesearch_forward"][label] = row2
        by_case["fused_backward"][label] = row3
        k1_rows[label] = _k1_on_case(label, ocp, ocp64, data, ps)
    out = {k: {"max_abs_err": err[k], "by_case": by_case[k]} for k in err}
    out["riccati_backward"] = {"by_case": k1_rows}
    return out


def _cost_gap(res, ref):
    """(p50, p99, max of |relative cost gap|, share within 1e-4) of ``res``
    against the DDP answers ``ref`` on the same problems."""
    gap = ((res.cost.double() - ref.cost.double()) / ref.cost.double().abs()
           ).abs().cpu().numpy()
    return (float(np.percentile(gap, 50)), float(np.percentile(gap, 99)),
            float(gap.max()), float((gap <= 1e-4).mean()))


def phase_ipm(dev, gpu, ref, M=QUEUE, N=BENCH_N, M_cuda=2048):
    """The streaming interior-point solver on phase 5's queue; ``ref`` is
    phase 5's DDP result."""
    from mpc_verde_tpu_torch import make_streaming_barrier_solver
    from mpc_verde_tpu_torch.interop import bench_ocp

    ocp = bench_ocp(N, dev, torch.float32)
    queue = _queue(M, N)
    fused_path = ("fused_backward", "linesearch_forward")
    by_path, results = {}, {}
    for tag, kw in (("ipm_cold", {}),
                    ("ipm_hybrid", dict(mu_schedule=(1e-4,), warmstart="ddp"))):
        solve = make_streaming_barrier_solver(
            ocp, _opts(), backend="cuda_fused", batch_width=WIDTH, restarts=2,
            inexact_kappa=10.0, **kw)
        by_path[tag], results[tag] = _streaming_path(tag, gpu, solve, queue,
                                                     fused_path)
        p50, p99, worst, share = _cost_gap(results[tag], ref)
        print(f"[{tag}] cost vs phase 5's DDP answers: |relative gap| p50 "
              f"{p50:.2e} p99 {p99:.2e} max {worst:.2e}, share within 1e-4 "
              f"{share:.4f}", flush=True)
        if not p50 <= 1e-4:
            raise AssertionError(f"{tag}: median cost gap {p50} to DDP")
    solve = make_streaming_barrier_solver(ocp, _opts(), backend="cuda",
                                          batch_width=WIDTH, restarts=2,
                                          inexact_kappa=10.0)
    sub = tuple(a[:M_cuda] for a in queue)
    by_path["ipm_cold_cuda"], res = _streaming_path(
        "ipm_cold_cuda", gpu, solve, sub,
        ("riccati_backward", "linesearch_forward"), warm=0)
    cold = results["ipm_cold"]
    _hold_paths("ipm_cold_cuda vs ipm_cold", res, type(cold)(**{
        k: v[:M_cuda] for k, v in cold.__dict__.items()}))
    return by_path


def _al_gate(res, tag="al"):
    """The JAX tests' gate on a state-bounded solve: max_violation < 1e-2."""
    viol = res.max_violation.double().cpu().numpy()
    y_max = res.xs[..., 1].amax(-1)
    bound = float((y_max >= AL_Y_MAX - 1e-2).float().mean())
    print(f"[{tag}] y max {float(y_max.max()):.4f} against the box's "
          f"{AL_Y_MAX}, at the bound in {bound:.4f} of the problems; "
          f"max_violation p50 {np.percentile(viol, 50):.3e} p99 "
          f"{np.percentile(viol, 99):.3e} max {viol.max():.3e}", flush=True)
    if not viol.max() < 1e-2:
        raise AssertionError(f"{tag}: max_violation {viol.max()} >= 1e-2")


def phase_al(dev, gpu, M=QUEUE, N=BENCH_N, M_ipm=2048):
    """State bounds at full width: the box y <= 8 binds for every problem."""
    from mpc_verde_tpu_torch import (make_streaming_barrier_solver,
                                     make_streaming_solver)
    from mpc_verde_tpu_torch.interop import bench_ocp

    ocp = bench_ocp(N, dev, torch.float32, x_ub=[np.inf, AL_Y_MAX, np.inf])
    queue = _queue(M, N)
    fused_path = ("fused_backward", "linesearch_forward")
    gate = _al_gate
    by_path = {}
    solve = make_streaming_solver(ocp, _opts(al_iters=AL_ITERS),
                                  backend="cuda_fused", batch_width=WIDTH,
                                  restarts=2)
    by_path["al"], _ = _streaming_path("al", gpu, solve, queue, fused_path,
                                       check=gate)
    solve = make_streaming_barrier_solver(ocp, _opts(al_iters=AL_ITERS),
                                          backend="cuda_fused",
                                          batch_width=WIDTH, restarts=2)
    by_path["barrier_al"], _ = _streaming_path(
        "barrier_al", gpu, solve, tuple(a[:M_ipm] for a in queue), fused_path,
        check=gate)
    return by_path


# Phase 13's hold of the card's float32 closed loop against the float64 CPU
# run and against the "cuda" path, max |x difference| over the first
# CIRC_HOLD_STEPS steps.  A float32 solve stops where its line search stalls,
# not at tol_grad = 1e-7 (JAX float32 takes 4x float64's iterations on this
# track), so each applied control carries that solve's stopping error; the
# tracking loop is stable and does not let it grow.
# 30 steps since phase 23 came (60 before): the "cuda" run's eager
# derivatives take about 1.6 s a step
CIRC_HOLD_STEPS, CIRC_STATE_TOL = 30, 1e-2
# JAX float32's share of converged steps on the diff-drive variants (CPU,
# committed tree): its float64 gate converged_all does not hold in float32.
DIFFDRIVE_JAX_F32_CONVERGED = {"rk4": 0.94, "euler": 0.85, "quadrature_m4": 0.87}
DIFFDRIVE_VARIANTS = {"rk4": {}, "euler": dict(integrator="euler"),
                      "quadrature_m4": dict(cost="quadrature", M=4, plant="rk4")}
FUSED_PATH = ("fused_backward", "linesearch_forward")


def _closed_loop(tag, gpu, run, n_steps, path_kernels, nx=3):
    """Drive one closed loop with the path's counts; returns (metrics,
    wall s, launches)."""
    m, wall, launches, twin_calls = _drive(run)
    res = m["result"]
    if tuple(res.xs.shape) != (n_steps + 1, nx) or not bool(
            torch.isfinite(res.xs).all()):
        raise AssertionError(f"{tag}: xs shape {tuple(res.xs.shape)} or "
                             "non-finite values")
    iters = res.iterations.double()
    print(f"[{tag}] {n_steps} steps: {1e3 * wall / n_steps:.2f} ms a step "
          f"({wall:.3f} s), mean iterations {float(iters.mean()):.3f} (max "
          f"{int(iters.max())}), "
          + ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in m.items()
                      if isinstance(v, (int, float, bool)))
          + f", launches {launches}, twin calls on CUDA {twin_calls} | GPU "
          f"{gpu}", flush=True)
    _check_path(launches, twin_calls, path_kernels)
    return m, wall, launches


def phase_circular(dev, gpu, refs, n_steps=None, hold=CIRC_HOLD_STEPS):
    """The circular track at B = 1 on make_ilqr_solver's default backend;
    its first ``hold`` steps held against the CPU float64 run of ``refs``
    (a ``CpuReferences`` of as many steps)."""
    from mpc_verde_tpu_torch.scenarios import (build_circular_tracking,
                                               run_circular_tracking)

    run_circular_tracking(build_circular_tracking(n_steps=10, device=dev))
    built = build_circular_tracking(n_steps=n_steps, device=dev)
    Nsim = built["spec"]["n_steps"]
    m, _, launches = _closed_loop(
        "circular", gpu, lambda: run_circular_tracking(built), Nsim,
        FUSED_PATH)
    print("[circular] JAX reference (CPU, SPEC): rmse_xy 0.08211, max_err_xy "
          "0.11612, converged_frac 1.0, mean iterations 5.17 (float64) / "
          "20.88 (float32)", flush=True)
    if not (m["converged_frac"] >= 0.99 and m["rmse_xy"] < 0.2):
        raise AssertionError(f"circular gates failed: converged_frac "
                             f"{m['converged_frac']}, rmse_xy {m['rmse_xy']}")
    xs = m["result"].xs[:hold + 1].double().cpu()
    us = m["result"].us[:hold].double().cpu()

    built_c = build_circular_tracking(n_steps=hold, device=dev, backend="cuda")
    m_c, _, launches_c = _closed_loop(
        "circular_cuda", gpu, lambda: run_circular_tracking(built_c), hold,
        ("riccati_backward", "linesearch_forward"))
    m_64 = refs.get("circular", "circular")
    for label, other in (("CPU float64", m_64), ('"cuda"', m_c)):
        dx = float((xs - other["result"].xs.double().cpu()).abs().max())
        du = float((us - other["result"].us.double().cpu()).abs().max())
        print(f"[circular] first {hold} steps, \"cuda_fused\" against "
              f"{label}: max |x diff| {dx:.3e} (tolerance {CIRC_STATE_TOL}), "
              f"max |u diff| {du:.3e}", flush=True)
        if not dx <= CIRC_STATE_TOL:
            raise AssertionError(f"circular against {label}: {dx}")
    return {"circular": launches, "circular_cuda": launches_c}


def phase_diffdrive(dev, gpu, n_steps=100, compare_steps=90):
    """The diff-drive family at B = 1 on "cuda_fused" (the default)."""
    from mpc_verde_tpu_torch.scenarios import (build_diffdrive,
                                               compare_diffdrive_methods,
                                               run_diffdrive)

    by_path = {}
    for name, kw in DIFFDRIVE_VARIANTS.items():
        built = build_diffdrive(n_steps=n_steps, device=dev, **kw)
        m, _, by_path[f"diffdrive_{name}"] = _closed_loop(
            f"diffdrive_{name}", gpu, lambda: run_diffdrive(built), n_steps,
            FUSED_PATH)
        print(f"[diffdrive_{name}] converged_frac {m['converged_frac']:.4f} "
              f"against JAX float32's {DIFFDRIVE_JAX_F32_CONVERGED[name]} "
              "(JAX float64: 1.0); reference steps_to_target 84", flush=True)
        if not (1 <= m["steps_to_target"] <= 84 and m["ss_error"] < 0.1):
            raise AssertionError(
                f"diffdrive {name} gates failed: steps_to_target "
                f"{m['steps_to_target']}, ss_error {m['ss_error']}")
    out, wall, launches, twin_calls = _drive(
        lambda: compare_diffdrive_methods(n_steps=compare_steps, device=dev))
    print(f"[diffdrive] compare_diffdrive_methods({compare_steps} steps, "
          f"{wall:.3f} s): runs {out['runs']}, deltas {out['deltas']}",
          flush=True)
    _check_path(launches, twin_calls, FUSED_PATH)
    if any(r["steps_to_target"] < 1 for r in out["runs"].values()):
        raise AssertionError(f"compare: a method missed the target: {out}")
    by_path["diffdrive_compare"] = launches
    return by_path


# The lane-change and pendulum runs that are held against the port's CPU
# float64 run and against "cuda" (K1 at B = 1): the lane change over 60
# steps of the course from sample 110, where the maneuver begins (the first
# 110 steps track a straight line), and the pendulum's first 20 steps.
# Tolerances on the states: absolute 1e-2 for the lane change (meters and
# radians), and relative to max(1, |x|) 5e-2 for the pendulum, whose open-
# loop unstable plant and forces up to 77 make float32 drift more: over
# these 20 steps JAX's own float32 run leaves its float64 run by 9.6e-3
# (the applied force, 0.25 N apart), the port's float32 run on the CPU by
# 2.6e-2.
# 30 steps since phase 23 came (60 before), from sample LC_START, where the
# maneuver begins within 8 samples
LC_HOLD, LC_START, LC_STATE_TOL = 30, 110, 1e-2
PEND_HOLD, PEND_STATE_TOL = 20, 5e-2
K1_PATH = ("riccati_backward", "linesearch_forward")


def _hold_states(tag, label, m, other, tol, relative=False):
    """Max |x diff| (relative to max(1, |x|) when ``relative``) and |u
    diff| of two closed loops over ``other``'s steps; raises past ``tol``."""
    n = other["result"].us.shape[0]
    xs = m["result"].xs[:n + 1].double().cpu()
    xo = other["result"].xs.double().cpu()
    us = m["result"].us[:n].double().cpu()
    du = float((us - other["result"].us.double().cpu()).abs().max())
    dx = (xs - xo).abs()
    if relative:
        dx = dx / xo.abs().clamp(min=1.0)
    dx = float(dx.max())
    print(f"[{tag}] first {n} steps against {label}: max |x diff| "
          f"{dx:.3e}{' (vs max(1,|x|))' if relative else ''} (tolerance "
          f"{tol}), max |u diff| {du:.3e}", flush=True)
    if not dx <= tol:
        raise AssertionError(f"{tag} against {label}: {dx}")


def _cpu64_references(queue, hold_circ, hold_path, lc_start):
    """In a child process: the float64 "torch" runs on the CPU that phases
    13 and 17 hold the card's closed loops against (the circular track's
    first ``hold_circ`` steps, the Frenet and curvature families' first
    ``hold_path`` steps from sample ``lc_start`` of the lane change), and
    the float64 CPU runs of phases 19, 20 and 21 (the warm start, the NLP
    batch, the compat scripts' first steps, the sweep at horizons 3 and 20),
    of phase 22 (the user OCPs' first USER_HOLD problems) and of phase 23
    (e2), (e3) and (e4) (their first USER_HOLD problems).  They need no
    card, so they run beside phases 3-18; puts {name: (xs, us, mean iterations, seconds)} and
    {name: {array name: array, "seconds": s}} on ``queue``, or the error's
    traceback."""
    try:
        torch.set_num_threads(2)
        from mpc_verde_tpu_torch.refgen import synthetic_lane_change
        from mpc_verde_tpu_torch import scenarios as sc
        from mpc_verde_tpu_torch.sweep import sweep_lane_change

        path = {k: np.asarray(v)[lc_start:]
                for k, v in synthetic_lane_change(n=500, dt=0.05).items()}
        cpu = dict(device="cpu", dtype=torch.float64)
        runs = {
            "circular": lambda: sc.run_circular_tracking(
                sc.build_circular_tracking(n_steps=hold_circ, **cpu)),
            "frenet": lambda: sc.run_frenet(sc.build_frenet(
                path=path, n_steps=hold_path, **cpu)),
            "curvature": lambda: sc.run_curvature_ltv(sc.build_curvature_ltv(
                path=path, n_steps=hold_path, **cpu)),
        }
        out = {}
        for name, run in runs.items():
            t0 = time.perf_counter()
            res = run()["result"]
            out[name] = (res.xs.numpy(), res.us.numpy(),
                         float(res.iterations.double().mean()),
                         time.perf_counter() - t0)
        f64 = torch.float64
        raw = {   # phases 19 and 20
            "warm": lambda: {"us": _warm_start_us(
                WARM_HOLD, "cpu", f64, backend="torch").numpy()},
            "nlp": lambda: _numpy_fields(_rosenbrock(NLP_B, "cpu"),
                                         ("x", "converged")),
            "compat_pendulum": lambda: {
                "xcl": _compat_pendulum("cpu", COMPAT_PEND_HOLD)[0]},
            "casadi_v1": lambda: dict(zip(
                ("states", "secs"),
                _casadi_v1("cpu", CASADI_N, CASADI_HOLD)[::5])),
            "sweep": lambda: {"rows": sweep_lane_change(
                SWEEP_Q_Y, SWEEP_HOLD_HORIZONS, n_steps=SWEEP_STEPS,
                max_iters=SWEEP_ITERS, device="cpu", dtype=f64)},
            **{f"user_{name}": (lambda name=name: _user_f64(name))
               for name in USER_OCPS},   # phase 22
            "lane_al": lambda: _rate_f64("lane_al"),   # phase 23 (e)
            "rate_barrier": lambda: _rate_f64("rate_barrier"),
            "obstacle": _obstacle_f64,
        }
        for name, run in raw.items():
            t0 = time.perf_counter()
            out[name] = {**run(), "seconds": time.perf_counter() - t0}
        queue.put(out)
    except Exception:   # the parent raises it where it reads the result
        queue.put(traceback.format_exc())


def _user_f64(name):
    """The float64 "torch" solve on the CPU of the first USER_HOLD problems
    of user OCP ``name`` (phase 22 (b))."""
    from mpc_verde_tpu_torch import make_batched_ilqr_solver

    x0, ps, us0 = (a[:USER_HOLD] for a in user_queue(name, USER_B))
    res = make_batched_ilqr_solver(user_ocp(name, "cpu", torch.float64),
                                   _opts(), backend="torch")(x0, ps, us0)
    return {"converged": res.converged.numpy(), "cost": res.cost.numpy()}


def _rate_f64(name):
    """Phase 23 (e2) / (e3) in float64 on "torch" on the CPU over the first
    USER_HOLD problems of its queue."""
    from mpc_verde_tpu_torch import (make_streaming_barrier_solver,
                                     make_streaming_solver)

    f64 = torch.float64
    if name == "lane_al":
        queue = lane_box_queue(WIDTH, BENCH_N)
        solve = make_streaming_solver(
            lane_box_ocp("cpu", f64, BENCH_N), _opts(al_iters=AL_ITERS),
            backend="torch", batch_width=USER_HOLD, restarts=2)
    else:
        queue = rate_di_queue(WIDTH, BENCH_N)
        solve = make_streaming_barrier_solver(
            rate_di_ocp(BENCH_N, "cpu", f64), _opts(), backend="torch",
            batch_width=USER_HOLD, restarts=2)
    res = solve(*(a[:USER_HOLD] for a in queue), max_iters=60, restarts_n=2)
    return {k: getattr(res, k).numpy() for k in ("converged", "cost", "us")}


def _obstacle_f64():
    """Phase 23 (e4) in float64 on "torch" on the CPU over the first
    USER_HOLD starts of its queue."""
    from mpc_verde_tpu_torch import make_streaming_solver

    queue = tuple(a[:USER_HOLD] for a in _queue(QUEUE, BENCH_N))
    solve = make_streaming_solver(
        obstacle_ocp("cpu", torch.float64, BENCH_N), _opts(), backend="torch",
        batch_width=USER_HOLD, restarts=2)
    res = solve(*queue, max_iters=60, restarts_n=2)
    return {k: getattr(res, k).numpy() for k in ("converged", "cost", "us")}


class CpuReferences:
    """The child process of ``_cpu64_references``: ``get(name)`` waits for
    its results and returns one run as a metrics dict with a ``result``
    (xs, us, iterations as tensors), ``stop()`` ends the child."""

    def __init__(self, hold_circ, hold_path, lc_start):
        ctx = multiprocessing.get_context("spawn")
        self._queue = ctx.Queue()
        self._proc = ctx.Process(target=_cpu64_references, daemon=True,
                                 args=(self._queue, hold_circ, hold_path,
                                       lc_start))
        self._proc.start()
        self._out = None

    def _wait(self, timeout=1200):
        if self._out is None:
            self._out = self._queue.get(timeout=timeout)
        if isinstance(self._out, str):
            raise AssertionError(f"the CPU float64 references failed: "
                                 f"{self._out}")
        return self._out

    def raw(self, tag, name):
        """One of phases 19 and 20's references: a dict of numpy arrays."""
        out = self._wait()[name]
        print(f"[{tag}] float64 on the CPU (a child process beside the card's "
              f"phases): {out['seconds']:.1f} s", flush=True)
        return out

    def get(self, tag, name):
        xs, us, iters, seconds = self._wait()[name]
        print(f"[{tag}] float64 \"torch\" on the CPU (a child process beside "
              f"the card's phases): {seconds:.1f} s, mean iterations "
              f"{iters:.3f}", flush=True)
        return {"result": SimpleNamespace(xs=torch.as_tensor(xs),
                                          us=torch.as_tensor(us))}

    def stop(self):
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join()


def _cpu64(tag, run):
    t0 = time.perf_counter()
    m = run()
    print(f"[{tag}] float64 \"torch\" on the CPU: {time.perf_counter() - t0:.1f} "
          f"s, mean iterations {float(m['result'].iterations.double().mean()):.3f}",
          flush=True)
    return m


def phase_lanechange(dev, gpu, n_lti=250, n_v1=300, n_ltv=250):
    """The lane-change families at B = 1 on "cuda_fused" with the JAX
    tests' gates (tests/test_scenarios.py), the exact pin of move blocking,
    and LC_HOLD steps held against CPU float64 and against "cuda"."""
    from mpc_verde_tpu_torch.refgen import synthetic_lane_change
    from mpc_verde_tpu_torch.scenarios import (build_lane_change_lti,
                                               build_lane_change_ltv,
                                               build_leitura,
                                               run_lane_change_lti,
                                               run_lane_change_ltv)

    run_lane_change_lti(build_lane_change_lti(n_steps=5, device=dev))  # warm-up
    by_path, ms = {}, {}
    runs = {
        "lti": (lambda: build_lane_change_lti(n_steps=n_lti, device=dev),
                run_lane_change_lti, n_lti, dict(mean_y=1e-3, mean_phi=1e-3),
                "mean_y 5.063e-4, mean_phi 5.39e-5, conv 0.968, 4.344 it"),
        "lti_v1": (lambda: build_lane_change_lti(N=20, Ntu=3, n_steps=n_v1,
                                                 device=dev),
                   run_lane_change_lti, n_v1,
                   dict(mean_y=1e-3, mean_delta=1e-3),
                   "mean_y 5.031e-5, mean_delta 2.687e-5, conv 0.9967, 7.013 it"),
        "ltv": (lambda: build_lane_change_ltv(n_steps=n_ltv, device=dev),
                run_lane_change_ltv, n_ltv, dict(mse=1e-2, mean_path_dist=0.1),
                "mse 1.619e-3, mean_path_dist 0.06209, conv 0.952, 6.056 it"),
        "leitura": (lambda: build_leitura(n_steps=n_ltv, device=dev),
                    run_lane_change_ltv, n_ltv,
                    dict(mse=2e-2, mean_path_dist=0.1),
                    "mse 1.619e-3, mean_path_dist 0.06209, conv 0.952, "
                    "6.056 it"),
    }
    built_v1 = None
    for name, (build, run, n, gates, jax_ref) in runs.items():
        built = build()
        _resolves_fused(name, built["ocp"])
        if name == "lti_v1":
            built_v1 = built
        m, wall, by_path[name] = _closed_loop(
            name, gpu, lambda: run(built), n, FUSED_PATH, nx=4)
        ms[name] = 1e3 * wall / n
        print(f"[{name}] JAX float32 (CPU): {jax_ref}; converged_frac "
              f"{m['converged_frac']:.4f} printed, not gated", flush=True)
        bad = {k: m[k] for k, b in gates.items() if not m[k] < b}
        if bad:
            raise AssertionError(f"{name} gates {gates} failed: {bad}")

    # the exact pin: the v1 plan's rates after Ntu = 3 are 0 (the rollout's
    # clip on the box [0, 0]), at B = 1 and over 301 problems at once
    from mpc_verde_tpu_torch import ILQROptions, make_batched_ilqr_solver

    ocp = built_v1["ocp"]
    res = built_v1["solve"](torch.zeros(4, device=dev),
                            built_v1["params_seq"][min(150, n_v1 - 1)],
                            torch.zeros((ocp.N, ocp.nu), device=dev))
    dus = res.us.double().cpu()
    tail, head = float(dus[3:].abs().max()), float(dus[:3].abs().max())
    solve_b = make_batched_ilqr_solver(ocp, ILQROptions(max_iters=30))
    rng = np.random.default_rng(41)
    z0 = torch.zeros((301, 4), device=dev)
    z0[:, :3] = torch.as_tensor(rng.uniform(-0.5, 0.5, (301, 3)), device=dev)
    res_b = solve_b(z0, built_v1["params_seq"][rng.integers(0, n_v1, 301)],
                    None)
    tail_b = float(res_b.us[:, 3:].abs().max())
    print(f"[lti_v1] move blocking: |w[3:]| max {tail:.1e} at B=1 and "
          f"{tail_b:.1e} over B=301 (must be 0), |w[:3]| max {head:.3e}",
          flush=True)
    if tail != 0.0 or tail_b != 0.0 or not head > 0.0:
        raise AssertionError(f"move blocking: tail {tail}, {tail_b}, head {head}")

    # LC_HOLD steps of the maneuver: "cuda_fused", "cuda" (K1 at (4, 1), B = 1)
    # and the CPU float64 run
    path = {k: np.asarray(v)[LC_START:]
            for k, v in synthetic_lane_change(n=500, dt=0.05).items()}
    hold = lambda **kw: run_lane_change_lti(build_lane_change_lti(
        path=path, n_steps=LC_HOLD, **kw))
    m_f, _, by_path["lti_hold"] = _closed_loop(
        "lti_hold", gpu, lambda: hold(device=dev), LC_HOLD, FUSED_PATH, nx=4)
    m_c, _, by_path["lti_cuda"] = _closed_loop(
        "lti_cuda", gpu, lambda: hold(device=dev, backend="cuda"), LC_HOLD,
        K1_PATH, nx=4)
    m_64 = _cpu64("lti_hold", lambda: hold(device="cpu", dtype=torch.float64))
    for label, other in (("CPU float64", m_64), ('"cuda"', m_c)):
        _hold_states("lti_hold", label, m_f, other, LC_STATE_TOL)
    return by_path, ms


def phase_pendulum_dynamic(dev, gpu, n_dyn=200, n_dyn_c=300):
    """The cart pendulum at its SPEC and the dynamic bicycle in both modes,
    at B = 1 on "cuda_fused"; the pendulum's first 20 steps held against CPU
    float64 and against "cuda" (K1 at (5, 1))."""
    from mpc_verde_tpu_torch.scenarios import (build_dynamic_bicycle,
                                               build_pendulum,
                                               run_dynamic_bicycle,
                                               run_pendulum)

    run_pendulum(build_pendulum(n_steps=3, device=dev))   # warm-up
    by_path, ms = {}, {}
    built = build_pendulum(device=dev)
    _resolves_fused("pendulum", built["ocp"])
    n = built["spec"]["n_steps"]
    m, wall, by_path["pendulum"] = _closed_loop(
        "pendulum", gpu, lambda: run_pendulum(built), n, FUSED_PATH, nx=5)
    ms["pendulum"] = 1e3 * wall / n
    print(f"[pendulum] JAX (CPU, SPEC): final_pos_error 0.1593 / 0.1620, "
          f"max_angle 0.3697 / 0.3690, max_force 77.26 / 77.07, conv 1.0 / "
          f"0.988, 3.0 / 13.17 it (float64 / float32); max_force "
          f"{m['max_force']:.4f}", flush=True)
    if not (m["max_angle"] < 1.2 and m["final_pos_error"] < 0.25):
        raise AssertionError(f"pendulum gates failed: max_angle "
                             f"{m['max_angle']}, final_pos_error "
                             f"{m['final_pos_error']}")
    m_c, _, by_path["pendulum_cuda"] = _closed_loop(
        "pendulum_cuda", gpu, lambda: run_pendulum(build_pendulum(
            n_steps=PEND_HOLD, device=dev, backend="cuda")), PEND_HOLD,
        K1_PATH, nx=5)
    m_64 = _cpu64("pendulum", lambda: run_pendulum(build_pendulum(
        n_steps=PEND_HOLD, device="cpu", dtype=torch.float64)))
    for label, other in (("CPU float64", m_64), ('"cuda"', m_c)):
        _hold_states("pendulum", label, m, other, PEND_STATE_TOL, relative=True)

    for name, kw, n_d in (("dynamic", {}, n_dyn),
                          ("dynamic_corrected", dict(corrected=True), n_dyn_c)):
        built = build_dynamic_bicycle(n_steps=n_d, device=dev, **kw)
        _resolves_fused(name, built["ocp"])
        m, wall, by_path[name] = _closed_loop(
            name, gpu, lambda: run_dynamic_bicycle(built), n_d, FUSED_PATH,
            nx=5)
        ms[name] = 1e3 * wall / n_d
        if name == "dynamic":
            print("[dynamic] JAX (CPU): mse_y 15.85, max_err_y 7.396, conv "
                  "1.0, 2.675 / 9.01 it (float64 / float32)", flush=True)
            ok = (m["converged_frac"] >= 0.99 and np.isfinite(m["mse_y"])
                  and abs(m["mse_y"] - 15.85) <= 0.01 * 15.85)
        else:
            print("[dynamic_corrected] JAX (CPU): mse_y 0.5732, max_err_y "
                  "1.820, conv 1.0, 1.613 it", flush=True)
            ok = m["mse_y"] < 1.0 and m["max_err_y"] < 2.5
        if not ok:
            raise AssertionError(f"{name} gates failed: {m}")
    return by_path, ms


# Phase 17's reference: the port's float64 run on the CPU over the whole
# 500-step Frenet course (python -m mpc_verde_tpu_torch.scenarios.run_all
# --family frenet --cpu), against which the card's float32 mse_y is held
# within 1%.  The reference's own controller saturates its steering there
# and leaves the lane (JAX float64 5.30991, float32 5.30990).
FRENET_COURSE_MSE_Y = 5.309911592974794
FRENET_DELTA_MAX, FRENET_RATE_MAX = 0.384, 0.1225


def _frenet_gates(m):
    """The JAX tests' Frenet gates (tests/test_scenarios.py:106) with
    float32's 1e-6 of slack on the bounds; converged_frac is printed, not
    gated, as JAX's own float32 run fails the float64 gate."""
    return (m["mse_y"] < 1e-3 and m["max_delta"] <= FRENET_DELTA_MAX + 1e-6
            and m["max_delta_rate"] <= FRENET_RATE_MAX + 1e-6)


def phase_frenet_curvature(dev, gpu, refs, n_frenet=120, n_dlc=60,
                           n_curv=300, n_course=500, hold=LC_HOLD):
    """The Frenet and curvature families at B = 1 on "cuda_fused" with the
    JAX tests' gates; the first LC_HOLD steps of each on the lane change's
    maneuver held against CPU float64 and against "cuda" (K1 at (5, 2) and
    (4, 1)) within the lane change's LC_STATE_TOL: over 60 steps the port's
    own float32 run on the CPU leaves its float64 run by 2.0e-6 (Frenet) and
    7.6e-5 (curvature).  The CPU float64 runs come from
    ``refs`` (a ``CpuReferences`` of ``hold`` steps)."""
    from mpc_verde_tpu_torch.refgen import (double_lane_change_course,
                                            synthetic_lane_change)
    from mpc_verde_tpu_torch.scenarios import (build_curvature_ltv,
                                               build_frenet,
                                               run_curvature_ltv, run_frenet)

    run_frenet(build_frenet(n_steps=3, device=dev))                # warm-up
    run_curvature_ltv(build_curvature_ltv(n_steps=3, device=dev))
    by_path, ms = {}, {}
    course_ref = FRENET_COURSE_MSE_Y
    runs = {   # name -> (build, run, steps, gate, JAX's numbers on the CPU)
        "frenet": (lambda: build_frenet(n_steps=n_frenet, device=dev),
                   run_frenet, n_frenet, _frenet_gates,
                   "mse_y 2.7867e-5, conv 0.9917, 2.375 it (float32); "
                   "mse_y 2.7878e-5, max_delta 0.245, max_delta_rate "
                   "0.1225 (float64)"),
        "frenet_course": (
            lambda: build_frenet(n_steps=n_course, device=dev), run_frenet,
            n_course,
            lambda m: abs(m["mse_y"] - course_ref) <= 0.01 * course_ref,
            f"mse_y 5.30990, conv 0.996, 7.014 it (float32); the port's "
            f"CPU float64 mse_y {course_ref}"),
        "frenet_double_lane_change": (
            lambda: build_frenet(path=double_lane_change_course(),
                                 n_steps=n_dlc, max_iters=80, device=dev),
            run_frenet, n_dlc, _frenet_gates,
            "mse_y 5.3107e-6, conv 0.9833, 2.317 it (float32)"),
        "curvature": (
            lambda: build_curvature_ltv(n_steps=n_curv, device=dev),
            run_curvature_ltv, n_curv,
            lambda m: m["mse_y"] < 1.0 and m["mse_phi"] < 0.2,
            "mse_y 0.228506, conv 0.9933, 13.99 it (float32)"),
    }
    for name, (build, run, n, gate, jax_ref) in runs.items():
        built = build()
        _resolves_fused(name, built["ocp"])
        m, wall, by_path[name] = _closed_loop(
            name, gpu, lambda: run(built), n, FUSED_PATH, nx=built["ocp"].nx)
        ms[name] = 1e3 * wall / n
        print(f"[{name}] JAX (CPU): {jax_ref}; converged_frac "
              f"{m['converged_frac']:.4f} printed, not gated", flush=True)
        if not gate(m):
            raise AssertionError(f"{name} gates failed: {m}")

    # LC_HOLD steps of the maneuver: "cuda_fused", "cuda" (K1 at B = 1) and the
    # CPU float64 run
    path = {k: np.asarray(v)[LC_START:]
            for k, v in synthetic_lane_change(n=500, dt=0.05).items()}
    for name, build, run, nx in (
            ("frenet", build_frenet, run_frenet, 5),
            ("curvature", build_curvature_ltv, run_curvature_ltv, 4)):
        go = lambda **kw: run(build(path=path, n_steps=hold, **kw))
        m_f, _, by_path[f"{name}_hold"] = _closed_loop(
            f"{name}_hold", gpu, lambda: go(device=dev), hold, FUSED_PATH,
            nx=nx)
        m_c, _, by_path[f"{name}_cuda"] = _closed_loop(
            f"{name}_cuda", gpu, lambda: go(device=dev, backend="cuda"), hold,
            K1_PATH, nx=nx)
        m_64 = refs.get(f"{name}_hold", name)
        for label, other in (("CPU float64", m_64), ('"cuda"', m_c)):
            _hold_states(f"{name}_hold", label, m_f, other, LC_STATE_TOL)
    return by_path, ms


# --- phases 18-20: the "scan" backend, the other solvers, the front ends ---

SCAN_B, SCAN_NS, SCAN_W6_NS = 1024, (40, 128, 512, 2048), (40, 512, 2048)
# Phase 18 (d): at N = 512 about half the starts need more than the 60
# iterations of _opts on either path; SCAN_LONG_ITERS lets both converge.
# Without its box the problem has many local optima and float32 round-off
# decides which one a start reaches (the two paths part from the first
# iterations on some starts), so the "scan" answers are held one by one to
# the float64 problem: a float64 "torch" solve with the same options from
# an answer must converge and lower its cost by at most
# SCAN_LONG_POLISH_TOL of it (on the card 2.7e-5 at most).
SCAN_LONG_N, SCAN_LONG_B, SCAN_LONG_ITERS = 512, 256, 800
SCAN_LONG_POLISH_TOL = 1e-4
# Phase 18 (a): the float32 doubling form against the float32 sequential
# fold of the same combine, max |diff| / max(1, |fold|) over J and eta.  The
# two orders of the same products differ by float32 round-off, which grows
# with the span a combine covers; on the card the worst was 4.1e-6, at
# N = 2048.
SCAN_W6_TOL = 1e-4
# Phase 19: the warm start's first WARM_HOLD problems against the float64
# twin on the CPU, max |u diff| (the controls are within [-1, 1]); the card
# was 3.3e-6 from it
WARM_HOLD, WARM_U_TOL = 256, 1e-3
# the condensed QP (float64 on the card) against the batched solver's first
# control, |u0 diff| / max(1, |u0|): on "cuda_fused" (float32) at phase 16's
# pendulum tolerance (float32 round-off on the unstable plant; the card was
# 1.26e-2 off), and on "torch" in float64, where both are exact (the card:
# 2.5e-6)
COND_B, COND_U0_TOL, COND_U0_TOL64 = 1024, 5e-2, 1e-5
# the NLP solver in float64 on the card against the same solve on the CPU:
# max |x diff|, and the converged shares within NLP_CONV_GAP.  From random
# starts in the box about 8% of the problems end, after 500 inner
# iterations, at a few times the 1e-8 stationarity tolerance (the JAX solver
# too), and on which side of it one lands depends on the summation order:
# the flags of single problems differ between devices, the answers do not.
NLP_B, NLP_X_TOL, NLP_CONV_GAP = 1024, 1e-6, 0.02
# Phase 20: the mpctools pendulum script's 400 steps and the CasADi
# single-shooting loop at N = 10, each held for its first steps against the
# same script in float64 on the CPU (max |x diff|).
# The pendulum script runs 200 of the JAX test's 400 steps (0.64 s a step on
# the card, float64, the plain solvers): at step 200 the cart stood at 3.59
# on the card, past the test's gate of 3.
COMPAT_PEND_STEPS, COMPAT_PEND_HOLD, CASADI_N, CASADI_HOLD = 200, 10, 10, 3
CASADI_STEPS = 100   # the reference loop: until 0.1 from the target or 20 s
COMPAT_X_TOL = 1e-6


def _random_lqt(rng, B, N, nx, nu, dev, dtype=torch.float32):
    """Random LQT problems as tests/test_parallel_riccati.py makes them."""
    eye = lambda n: np.eye(n)[None, None]
    a = (eye(nx) + 0.05 * rng.normal(size=(B, N, nx, nx)),
         0.1 * rng.normal(size=(B, N, nx)),
         0.3 * rng.normal(size=(B, N, nx, nu)),
         eye(nx) * rng.uniform(0.1, 2.0, (B, N, 1, 1)),
         rng.normal(size=(B, N, nx)),
         eye(nu) * rng.uniform(0.5, 2.0, (B, N, 1, 1)),
         np.broadcast_to(2.0 * np.eye(nx), (B, nx, nx)),
         rng.normal(size=(B, nx)))
    return tuple(torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                 device=dev) for x in a)


def _random_lq(rng, B, N, nx, nu, dev, dtype=torch.float32):
    """Random LQ stage data as tests/test_parallel_riccati.py's
    lq_backward test makes it: (derivs, gN, HN, reg)."""
    lxx = 2 * np.eye(nx) + 0.1 * rng.normal(size=(B, N, nx, nx))
    d = {"fx": np.eye(nx) + 0.05 * rng.normal(size=(B, N, nx, nx)),
         "fu": 0.3 * rng.normal(size=(B, N, nx, nu)),
         "lx": rng.normal(size=(B, N, nx)), "lu": rng.normal(size=(B, N, nu)),
         "lxx": 0.5 * (lxx + lxx.transpose(0, 1, 3, 2)),
         "luu": np.broadcast_to(np.eye(nu), (B, N, nu, nu)),
         "lux": 0.2 * rng.normal(size=(B, N, nu, nx))}
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                  device=dev)
    return ({k: t(v) for k, v in d.items()}, t(rng.normal(size=(B, nx))),
            t(np.broadcast_to(1.5 * np.eye(nx), (B, nx, nx))),
            torch.full((B,), 1e-6, dtype=dtype, device=dev))


def _check_variants(tag, launches, twin_calls, expect, counts=None,
                    twins=False):
    """Each kernel of ``expect`` ({name: variants}) launched, in those
    variants only (and ``counts`` {name: n} times where given); no other
    kernel launched, and no twin ran on CUDA unless ``twins`` (a path that
    runs the plain versions by request: backend="torch")."""
    if counts and any(launches[k] != n for k, n in counts.items()):
        raise AssertionError(f"{tag}: launches {launches}, expected {counts}")
    kernels, _ = _path_counters()
    for f in kernels:
        k = f.__name__
        want = expect.get(k, set())
        ran = {v for v in f.launches_by_variant if launches[f"{k}.{v}"]}
        if (launches[k] < 1) if want else (launches[k] != 0):
            raise AssertionError(f"{tag}: {k} launched {launches[k]} times "
                                 f"(expected {'some' if want else 'none'})")
        if want and not ran <= want:
            raise AssertionError(f"{tag}: {k} ran variants {ran}, the plans "
                                 f"give {want}")
    if not twins and max(twin_calls.values()) > 0:
        raise AssertionError(f"{tag}: a twin ran on CUDA tensors: {twin_calls}")


def _solver_variants(N, npar, A, B, k1=True):
    """The variants the plans give a Gauss-Newton batched solve's K1 (if
    ``k1``) and K2 (line search over ``A`` alphas and the pre-roll)."""
    from mpc_verde_tpu_torch.ops.cuda.riccati import riccati_launch_plan
    from mpc_verde_tpu_torch.ops.cuda.rollout import linesearch_launch_plan

    out = {"linesearch_forward": {linesearch_launch_plan(N, a, npar, B=B).variant
                                  for a in (A, 1)}}
    if k1:
        out["riccati_backward"] = {
            riccati_launch_plan(N, 3, 2, False, B).variant}
    return out


def _solve_paths(tag, gpu, solvers, args, check=None):
    """Drive each (label, solve, expected variants) of ``solvers`` on
    ``args`` with its counts; returns {label: (result, launches)}."""
    out = {}
    for label, solve, expect in solvers:
        res, wall, launches, twin_calls = _drive(lambda: solve(*args))
        conv = float(res.converged.float().mean())
        print(f"[{tag}] {label}: B={res.cost.shape[0]} "
              f"N={res.us.shape[1]}: {wall:.3f} s, converged_frac "
              f"{conv:.4f}, mean_iterations "
              f"{float(res.iterations.double().mean()):.3f}, launches "
              f"{launches}, twin calls on CUDA {twin_calls} | GPU {gpu}",
              flush=True)
        _check_result(res, res.cost.shape[0], res.us.shape[1])
        _check_variants(f"{tag} {label}", launches, twin_calls, expect)
        if check is not None:
            check(label, res)
        out[label] = (res, launches)
    return out


def _polish_f64(ocp, res, x0, ps):
    """A float64 "torch" solve from the answers of ``res`` with phase 18
    (d)'s options; returns (cost drop relative to the float64 cost,
    converged)."""
    from mpc_verde_tpu_torch import make_batched_ilqr_solver
    from mpc_verde_tpu_torch.interop import bench_ocp

    f64 = torch.float64
    solve = make_batched_ilqr_solver(
        bench_ocp(ocp.N, ocp.device, f64, box=False),
        _opts(use_ddp=False, max_iters=50), backend="torch")
    pol = solve(x0.astype(np.float64), ps.astype(np.float64), res.us.to(f64))
    return (res.cost.to(f64) - pol.cost) / pol.cost.abs(), pol.converged


def phase_scan(dev, gpu, queue):
    """Phase 18: the associative-scan backward on the card (W6: the doubling
    form against the sequential fold, float32), its time against K1's on the
    same derivatives, and backend="scan" in the barrier solver and on the
    unboxed bench OCP at N = 512, each against "cuda"."""
    from mpc_verde_tpu_torch import make_barrier_solver, make_batched_ilqr_solver
    from mpc_verde_tpu_torch.interop import bench_ocp
    from mpc_verde_tpu_torch.ops.cuda.riccati import (
        riccati_backward, riccati_backward_torch, riccati_launch_plan)
    from mpc_verde_tpu_torch.ops.parallel_riccati import (
        _assoc_fold, _lqt_elements, _value_functions, lq_backward_parallel)

    t_phase = time.perf_counter()
    rng = np.random.default_rng(41)
    for N in SCAN_W6_NS:
        elems, term = _lqt_elements(*_random_lqt(rng, SCAN_B, N, 3, 2, dev))
        t0 = time.perf_counter()
        J, eta = _value_functions(elems, term, 1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        Jf, etaf = _value_functions(elems, term, 1, prefix=_assoc_fold)
        torch.cuda.synchronize()
        err = max(_rel_err(J, Jf), _rel_err(eta, etaf))
        print(f"[scan] W6 B={SCAN_B} N={N} float32: doubling form against "
              f"the sequential fold, max |diff| / max(1, |fold|) {err:.3e} "
              f"(tolerance {SCAN_W6_TOL}); doubling {t1 - t0:.3f} s, fold "
              f"{time.perf_counter() - t1:.3f} s (wall, first call)",
              flush=True)
        if not err <= SCAN_W6_TOL:
            raise AssertionError(f"scan W6 N={N}: {err}")

    args = _bench_backward_inputs(bench_ocp(BENCH_N, dev), SCAN_B, dev)
    d, inf = args[0], torch.full_like(args[1], torch.inf)
    lq = lambda d, gN, HN, reg: lq_backward_parallel(
        d["fx"], d["fu"], d["lx"], d["lu"], d["lxx"], d["luu"], d["lux"], gN,
        HN, reg)
    _hold(lq(d, *args[3:6]), riccati_backward_torch(
        d, -inf, inf, *args[3:6], nx=3, nu=2, use_ddp=False), "scan",
          f"lq_backward_parallel vs K1's twin, bench B={SCAN_B} N={BENCH_N} "
          "infinite bounds")

    table = []
    for N in SCAN_NS:
        d, gN, HN, reg = _random_lq(rng, SCAN_B, N, 3, 2, dev)
        inf = torch.full((SCAN_B, N, 2), torch.inf, device=dev)
        k1 = lambda: riccati_backward(d, -inf, inf, gN, HN, reg, nx=3, nu=2,
                                      use_ddp=False)
        _hold(lq(d, gN, HN, reg), k1(), "scan",
              f"lq_backward_parallel vs K1, random B={SCAN_B} N={N}")
        scan_ms = _time_ms(lambda: lq(d, gN, HN, reg), reps=3, warmup=1,
                           queued=False)
        k1_ms = _time_ms(k1, reps=10)
        variant = riccati_launch_plan(N, 3, 2, False, SCAN_B).variant
        table.append({"N": N, "scan_ms": scan_ms, "k1_ms": k1_ms,
                      "k1_variant": variant})
        print(f"[scan] backward B={SCAN_B} N={N} (nx, nu) = (3, 2): "
              f"lq_backward_parallel {scan_ms:.4f} ms, K1 \"{variant}\" "
              f"{k1_ms:.4f} ms, ratio {scan_ms / k1_ms:.2f} | GPU {gpu}",
              flush=True)

    x0q, psq, us0q = (a[:SCAN_B] for a in queue)
    ocp = bench_ocp(BENCH_N, dev)
    solvers = [(b, make_barrier_solver(ocp, _opts(use_ddp=False), backend=b,
                                       crossover=False),
                _solver_variants(BENCH_N, 4, 8, SCAN_B, k1=b == "cuda"))
               for b in ("scan", "cuda")]

    def converged(label, res):
        conv = float(res.converged.float().mean())
        if conv < 0.99:
            raise AssertionError(f"scan {label}: converged_frac {conv}")

    by_path = {}
    out = _solve_paths("scan_barrier", gpu, solvers, (x0q, psq, us0q),
                       converged)
    _hold_paths("scan_barrier scan vs cuda", out["scan"][0], out["cuda"][0])
    by_path["scan_barrier"] = out["scan"][1]
    ocp = bench_ocp(SCAN_LONG_N, dev, box=False)
    solvers = [(b, make_batched_ilqr_solver(
                    ocp, _opts(use_ddp=False, max_iters=SCAN_LONG_ITERS),
                    backend=b),
                _solver_variants(SCAN_LONG_N, 3, 8, SCAN_LONG_B,
                                 k1=b == "cuda"))
               for b in ("scan", "cuda")]
    x0l, psl, us0l = _queue(SCAN_LONG_B, SCAN_LONG_N)
    out = _solve_paths("scan_long", gpu, solvers, (x0l, psl, us0l),
                       converged)
    rs, rc = out["scan"][0], out["cuda"][0]
    agree = float((rs.converged == rc.converged).float().mean())
    p50, p99, worst, share = _cost_gap(rs, rc)
    print(f"[scan_long] scan vs cuda: converged agree {agree:.4f}; |relative "
          f"cost gap| p50 {p50:.2e} p99 {p99:.2e} max {worst:.2e}, share "
          f"within 1e-4 {share:.4f} (the local optimum a start reaches)",
          flush=True)
    t0 = time.perf_counter()
    drop, conv = _polish_f64(ocp, rs, x0l, psl)
    ok = (conv & (drop <= SCAN_LONG_POLISH_TOL))[rs.converged]
    print(f"[scan_long] scan's answers polished in float64 (\"torch\", the "
          f"same options): {time.perf_counter() - t0:.1f} s, converged "
          f"{float(conv.float().mean()):.4f}, cost lowered by max "
          f"{float(drop.max()):.2e} p99 {float(drop.quantile(0.99)):.2e} of "
          f"itself; float64 optima (tolerance {SCAN_LONG_POLISH_TOL}) "
          f"{float(ok.float().mean()):.4f} of its converged answers",
          flush=True)
    if not ok.all():
        raise AssertionError(f"scan_long: {int((~ok).sum())} converged "
                             f"answers are no float64 optimum")
    if not (agree >= 0.99 and p50 <= 1e-4):
        raise AssertionError(f"scan_long: agree {agree}, p50 {p50}")
    by_path["scan_long"] = out["scan"][1]
    print(f"[scan] phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return by_path, table


def _pendulum_condensed_starts(B, seed=43):
    """Rate-form pendulum starts z0 = [x, xdot, theta, thetadot, u_prev]."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-1.0, 1.0, (B, 2)),
                           rng.uniform(-0.1, 0.1, (B, 2)),
                           rng.uniform(-20.0, 20.0, (B, 1))], axis=1)


def _condensed_pendulum(z0s, device, dtype):
    """The pendulum's SPEC step as the condensed QP: the rate-form OCP's
    cost on x_1..x_{N-1} (QN = 0: the rate form has no terminal cost), the
    Du weight r_du^2 on the Ntu free moves, the force box on every move.
    Returns the absolute controls (B, N, nu)."""
    from mpc_verde_tpu_torch.models import cart_pendulum_linear
    from mpc_verde_tpu_torch.ops import c2d
    from mpc_verde_tpu_torch.scenarios.pendulum import SPEC as s
    from mpc_verde_tpu_torch.solver import condense, solve_condensed

    m = cart_pendulum_linear(device="cpu", dtype=torch.float64)
    Ad, Bd = c2d(m.Ac, m.Bc, s["T"])
    data = condense(Ad.to(device, dtype), Bd.to(device, dtype),
                    np.diag([s["q_x"] ** 2, 0.0, s["q_theta"] ** 2, 0.0]),
                    np.zeros((1, 1)), s["N"], QN=np.zeros((4, 4)),
                    Ntu=s["Ntu"], du_weight=s["r_du"] ** 2)
    z0 = torch.as_tensor(z0s, dtype=dtype, device=device)
    xref = torch.tensor([s["x_target"], 0.0, 0.0, 0.0], dtype=dtype,
                        device=device).expand(s["N"], 4)
    us, _ = solve_condensed(data, z0[:, :4], xref, u_prev=z0[:, 4:],
                            u_lb=[-s["u_max"]], u_ub=[s["u_max"]])
    return us


def _warm_start_us(M, device, dtype, backend=None):
    """The LQR warm start over phase 5's queue's first M problems."""
    from mpc_verde_tpu_torch.solver import make_lqr_warm_start
    from mpc_verde_tpu_torch.interop import bench_ocp

    x0q, psq, _ = _queue(QUEUE, BENCH_N)
    warm = make_lqr_warm_start(bench_ocp(BENCH_N, device, dtype),
                               xref_fn=lambda p: p[:3], backend=backend)
    return warm(x0q[:M], psq[:M])


def _rosenbrock_batch(B, seed=47):
    """Bounded Rosenbrock problems (tests/test_nlp.py:79) with a shifted
    minimum a problem: sum 100 (x_{i+1} - x_i^2)^2 + (1 + p - x_i)^2 on the
    box [-0.5, 0.8]^4, from random starts in the box."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.8, (B, 4)), rng.uniform(-0.2, 0.2, (B, 1))


def _numpy_fields(res, names):
    return {n: getattr(res, n).cpu().numpy() for n in names}


def _rosenbrock(B, device):
    from mpc_verde_tpu_torch.solver import make_nlpsol

    def f(x, p):
        return (100.0 * (x[1:] - x[:-1] ** 2) ** 2
                + (1.0 + p[0] - x[:-1]) ** 2).sum()

    x0, p = _rosenbrock_batch(B)
    solve = make_nlpsol(f, None, 4, 0, device=device)
    return solve(x0, p, lbx=np.full(4, -0.5), ubx=np.full(4, 0.8))


def phase_solvers(dev, gpu, queue, ref_fused, refs):
    """Phase 19: FDDP, the condensed QP, the LQR warm start (K1 and K2) and
    the NLP solver, each against its reference."""
    from mpc_verde_tpu_torch import (ILQROptions, make_batched_ilqr_solver,
                                     make_streaming_solver)
    from mpc_verde_tpu_torch.interop import bench_ocp
    from mpc_verde_tpu_torch.ops.cuda.riccati import riccati_launch_plan
    from mpc_verde_tpu_torch.ops.cuda.rollout import linesearch_launch_plan
    from mpc_verde_tpu_torch.scenarios.pendulum import SPEC, pendulum_ocp
    from mpc_verde_tpu_torch.solver import make_batched_ms_solver

    t_phase = time.perf_counter()
    by_path = {}
    x0q, psq, us0q = (a[:SCAN_B] for a in queue)
    ocp = bench_ocp(BENCH_N, dev)
    res, wall, launches, twin_calls = _drive(
        lambda: make_batched_ms_solver(ocp, _opts())(x0q, psq, us0q))
    _check_result(res, SCAN_B, BENCH_N)
    _check_variants("fddp", launches, twin_calls, {})
    by_path["fddp"] = launches
    gap = float(res.max_violation.max())
    ref = type(ref_fused)(**{k: v[:SCAN_B] for k, v in ref_fused.__dict__.items()})
    p50, p99, worst, share = _cost_gap(res, ref)
    print(f"[fddp] B={SCAN_B} N={BENCH_N} from the constant-x0 lifted guess: "
          f"{wall:.3f} s, converged_frac {float(res.converged.float().mean()):.4f}, "
          f"mean_iterations {float(res.iterations.double().mean()):.3f}, max "
          f"final gap {gap:.3e} (gate 1e-5); cost vs phase 8's DDP answers: "
          f"|relative gap| p50 {p50:.2e} p99 {p99:.2e} max {worst:.2e}, share "
          f"within 1e-4 {share:.4f}; launches {launches} | GPU {gpu}",
          flush=True)
    if not (gap < 1e-5 and p50 <= 1e-4 and share >= 0.99):
        raise AssertionError(f"fddp: gap {gap}, cost gap p50 {p50}, share "
                             f"within 1e-4 {share}")

    z0s = _pendulum_condensed_starts(COND_B)
    t0 = time.perf_counter()
    us_qp = _condensed_pendulum(z0s, dev, torch.float64)
    torch.cuda.synchronize()
    qp_s = time.perf_counter() - t0
    u0_qp = us_qp[:, 0, 0]
    print(f"[condensed] pendulum SPEC N={SPEC['N']} Ntu={SPEC['Ntu']} over "
          f"{COND_B} starts: solve_condensed float64 {qp_s:.3f} s (wall, first "
          f"call), share of starts at the force box "
          f"{float((us_qp.abs() >= SPEC['u_max'] - 1e-6).any(1).float().mean()):.4f}",
          flush=True)
    for backend, dtype, opts, tol, expect in (
            ("cuda_fused", torch.float32, _opts(), COND_U0_TOL,
             {"fused_backward": {"staged", "thread"},
              "linesearch_forward": {"lanes", "lanes_ring"}}),
            ("torch", torch.float64, ILQROptions(max_iters=60), COND_U0_TOL64,
             {})):
        pocp, _ = pendulum_ocp(SPEC["N"], SPEC["Ntu"], dev, dtype)
        solve = make_batched_ilqr_solver(pocp, opts, backend=backend)
        rp, wall, launches, twin_calls = _drive(lambda: solve(z0s, None, None))
        _check_variants(f"condensed {backend}", launches, twin_calls, expect,
                        twins=backend == "torch")
        u0_ddp = rp.xs[:, 0, 4].double() + rp.us[:, 0, 0].double()
        err = float(((u0_ddp - u0_qp).abs() / u0_qp.abs().clamp(min=1.0)).max())
        plan = rp.xs[:, :1, 4:5].double() + rp.us.double().cumsum(1)
        print(f"[condensed] against \"{backend}\" {str(dtype)[6:]}: {wall:.3f} "
              f"s, converged_frac {float(rp.converged.float().mean()):.4f}, "
              f"mean_iterations {float(rp.iterations.double().mean()):.3f}; "
              f"first control |diff| / max(1, |u0|) {err:.3e} (tolerance "
              f"{tol}), whole plan max |u diff| "
              f"{float((plan - us_qp).abs().max()):.3e} | GPU {gpu}",
              flush=True)
        if not err <= tol:
            raise AssertionError(f"condensed vs {backend}: {err}")

    (us_w, wall, launches, twin_calls) = _drive(
        lambda: _warm_start_us(QUEUE, dev, torch.float32))
    expect = {"riccati_backward": {riccati_launch_plan(BENCH_N, 3, 2, False,
                                                       QUEUE).variant},
              "linesearch_forward": {linesearch_launch_plan(
                  BENCH_N, 1, 3, B=QUEUE).variant}}
    _check_variants("warm", launches, twin_calls, expect,
                    counts={"riccati_backward": 1, "linesearch_forward": 1})
    box = torch.tensor([1.0, np.pi / 4], device=dev)
    inside = bool((us_w.abs() <= box * (1 + 1e-6)).all())
    w64 = refs.raw("warm", "warm")
    du = float((us_w[:WARM_HOLD].double().cpu() - torch.as_tensor(w64["us"])
                ).abs().max())
    by_path["warm"] = launches
    print(f"[warm] make_lqr_warm_start over {QUEUE} problems: {wall:.3f} s, "
          f"K1 {expect['riccati_backward']} and K2 {expect['linesearch_forward']}"
          f" at A=1, launches {launches}; controls inside the box {inside}; "
          f"first {WARM_HOLD} against CPU float64: max |u diff| {du:.3e} "
          f"(tolerance {WARM_U_TOL}) | GPU {gpu}", flush=True)
    if not (inside and du <= WARM_U_TOL):
        raise AssertionError(f"warm start: inside {inside}, |u diff| {du}")
    solve = make_streaming_solver(ocp, _opts(), backend="cuda_fused",
                                  batch_width=WIDTH, restarts=2)
    x0f, psf, _ = queue
    res, wall, by_path["warm_streaming"], _ = _drive(lambda: solve(
        x0f, psf, us_w, max_iters=60, restarts_n=2))
    print(f"[warm] streaming \"cuda_fused\" from the warm start over {QUEUE}: "
          f"{wall:.3f} s, converged_frac {float(res.converged.float().mean()):.4f}"
          f", mean_iterations {float(res.iterations.double().mean()):.3f} (not "
          f"gated; from us = 0, phase 8: {float(ref_fused.converged.float().mean()):.4f}"
          f", {float(ref_fused.iterations.double().mean()):.3f}) | GPU {gpu}",
          flush=True)

    r, wall, launches, twin_calls = _drive(
        lambda: _rosenbrock(NLP_B, dev))
    _check_variants("nlp", launches, twin_calls, {})
    by_path["nlp"] = launches
    r64 = refs.raw("nlp", "nlp")
    dx = float((r.x.cpu() - torch.as_tensor(r64["x"])).abs().max())
    agree = float((r.converged.cpu().numpy() == r64["converged"]).mean())
    conv, conv64 = float(r.converged.float().mean()), float(r64["converged"].mean())
    print(f"[nlp] make_nlpsol over {NLP_B} bounded Rosenbrock problems, "
          f"float64 on the card: {wall:.3f} s, converged_frac {conv:.4f} (CPU "
          f"{conv64:.4f}, tolerance {NLP_CONV_GAP}; flags alike in "
          f"{agree:.4f}), mean inner iterations "
          f"{float(r.iterations.double().mean()):.2f}; against CPU float64: "
          f"max |x diff| {dx:.3e} (tolerance {NLP_X_TOL}) | GPU {gpu}",
          flush=True)
    if not (abs(conv - conv64) <= NLP_CONV_GAP and dx <= NLP_X_TOL):
        raise AssertionError(f"nlp: converged {conv} / {conv64}, |x diff| {dx}")
    print(f"[solvers] phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return by_path


def _compat_pendulum(device, nsim):
    """tests/test_compat.py:36-95 verbatim: the mpctools pendulum script
    through the compat layer; returns (xcl (4, nsim+1), ucl (1, nsim),
    statuses, wall s)."""
    import mpc_verde_tpu_torch.compat as mpc

    Nx, Nu = 4, 1
    T, Nt = 0.01, 50
    Ac = np.array([[0, 0, 0, 0], [1, -10, 0, -20],
                   [0, 9.81, 0, 39.24], [0, 0, 1, 0]]).T
    Bc = np.array([[0.0], [1.0], [0.0], [2.0]])
    A, B = mpc.util.c2d(Ac, Bc, T)
    A, B = np.asarray(A), np.asarray(B)

    def ffunc(x, u):
        return mpc.mtimes(A, x) + mpc.mtimes(B, u)

    f = mpc.getCasadiFunc(ffunc, [Nx, Nu], ["x", "u"], "f")
    umax = 200
    Dulb = np.tile(-np.inf, (5, 1))
    Duub = np.tile(np.inf, (5, 1))
    Dub = np.tile(0, (45, 1))
    lb = {"u": np.array([-umax]), "Du": np.vstack((Dulb, Dub))}
    ub = {"u": np.array([umax]), "Du": np.vstack((Duub, Dub))}
    xt = np.array([10, 0, 0, 0])
    Q = np.diag([1.2, 0, 1, 0])
    R1 = 0.01

    def lfunc(x, u, du):
        return ((Q[0, 0] * (x[0] - xt[0])) ** 2 + (Q[2, 2] * x[2]) ** 2
                + (R1 * du[0]) ** 2)

    l = mpc.getCasadiFunc(lfunc, [Nx, Nu, Nu], ["x", "u", "Du"])
    x0 = np.array([0.0, 0, 0, 0])
    N = {"x": Nx, "u": Nu, "t": Nt}
    solver = mpc.nmpc(f, l, N, x0, lb, ub, isQP=True, verbosity=0,
                      uprev=np.array([0.0]), funcargs={"l": ["x", "u", "Du"]},
                      device=device)
    xcl = np.zeros((Nx, nsim + 1))
    xcl[:, 0] = x0
    ucl = np.zeros((Nu, nsim))
    statuses = []
    t0 = time.perf_counter()
    for k in range(nsim):
        solver.fixvar("x", 0, x0)
        sol = mpc.callSolver(solver)
        statuses.append(sol["status"])
        xcl[:, k] = sol["x"][0, :]
        ucl[:, k] = sol["u"][0, :]
        x0 = ffunc(x0, ucl[:, k])
    xcl[:, nsim] = x0
    return xcl, ucl, statuses, time.perf_counter() - t0


def _casadi_v1(device, N, max_steps):
    """tests/test_casadi_compat.py:88-158 at horizon N: the single-shooting
    v1 program through the CasADi layer and its closed loop toward (1.5,
    1.5, 0); returns the states (steps+1, 3), the applied controls, the
    distances to the target, each step's success, the max |plant - Xpred|
    and the nlpsol calls' wall seconds."""
    import mpc_verde_tpu_torch.compat.casadi as ca
    from mpc_verde_tpu_torch.compat.casadi import DM, SX, cos, sin

    T_STEP, n_states, n_controls = 0.2, 3, 2
    x, y, theta = SX.sym("x"), SX.sym("y"), SX.sym("theta")
    states = ca.vertcat(x, y, theta)
    v, omega = SX.sym("v"), SX.sym("omega")
    controls = ca.vertcat(v, omega)
    rhs = ca.vertcat(v * cos(theta), v * sin(theta), omega)
    f = ca.Function("f", [states, controls], [rhs], ["x", "u"], ["rhs"])
    P = ca.SX.sym("P", 2 * n_states)
    U = ca.SX.sym("U", n_controls, N)
    X = ca.SX.sym("X", n_states, N + 1)
    X[:, 0] = P[:n_states]
    for k in range(N):
        st, con = X[:, k], U[:, k]
        X[:, k + 1] = st + f(st, con) * T_STEP
    ff = ca.Function("ff", [U, P], [X])
    Q = ca.diagcat(1.0, 5.0, 0.1)
    R = ca.diagcat(0.5, 0.05)
    obj = 0
    for k in range(N):
        st, con = X[:, k], U[:, k]
        e = st - P[n_states:]
        obj = obj + (e.T @ Q @ e + con.T @ R @ con)
    g = ca.reshape(X, (N + 1) * n_states, 1)
    nlp_prob = {"f": obj[0, 0], "x": ca.vertcat(U.reshape((-1, 1))), "g": g,
                "p": P}
    solver = ca.nlpsol("solver", "ipopt", nlp_prob,
                       {"ipopt": {"acceptable_tol": 1e-8}}, device=device)
    lbx = DM.zeros((n_controls * N, 1))
    ubx = DM.zeros((n_controls * N, 1))
    lbx[0: n_controls * N: n_controls] = -0.6
    ubx[0: n_controls * N: n_controls] = 0.6
    lbx[1: n_controls * N: n_controls] = -np.pi / 4
    ubx[1: n_controls * N: n_controls] = np.pi / 4
    state_init = ca.DM([0.0, 0.0, 0.0])
    state_target = ca.DM([1.5, 1.5, 0.0])
    u0 = ca.DM.zeros((2, N))
    states_cl, us_cl, ok, secs = [state_init.full().ravel()], [], [], []
    errs = [ca.norm_2(state_init - state_target)]
    pred_err = 0.0
    for _ in range(max_steps):
        if ca.norm_2(state_init - state_target) <= 1e-1:
            break
        p = ca.vertcat(state_init, state_target)
        t0 = time.perf_counter()
        sol = solver(x0=ca.reshape(u0, 2 * N, 1), lbx=lbx, ubx=ubx,
                     lbg=-ca.inf, ubg=ca.inf, p=p)
        secs.append(time.perf_counter() - t0)
        ok.append(solver.stats()["success"])
        u = ca.reshape(sol["x"], 2, N)
        uf = u.full()
        if not ((np.abs(uf[0]) <= 0.6 + 1e-9).all()
                and (np.abs(uf[1]) <= np.pi / 4 + 1e-9).all()):
            raise AssertionError(f"casadi v1: controls outside the box: {uf}")
        Xpred = ff(u, p)
        state_init = ca.DM.full(state_init + (T_STEP * f(state_init, u[:, 0])))
        pred_err = max(pred_err, float(np.abs(
            Xpred.full()[:, 1] - np.ravel(state_init)).max()))
        u0 = ca.horzcat(u[:, 1:], ca.reshape(u[:, -1], -1, 1))
        states_cl.append(np.ravel(state_init))
        us_cl.append(uf[:, 0])
        errs.append(ca.norm_2(state_init - state_target))
    return (np.array(states_cl), np.array(us_cl), errs, ok, pred_err,
            np.array(secs))


def phase_compat(dev, gpu):
    """Phase 20: the mpctools pendulum script and the CasADi single-shooting
    v1 loop on the card (float64, their Python functions through the plain
    PyTorch solvers: no kernel), with the JAX tests' gates.  It launches no
    kernel, so ``main`` runs it beside the kernels' build; returns the
    paths' counts, the ms per nlpsol call and the first steps that
    ``hold_compat`` holds against the CPU float64 runs after phase 19."""
    t_phase = time.perf_counter()
    by_path = {}
    (xcl, ucl, statuses, _), wall, launches, twin_calls = _drive(
        lambda: _compat_pendulum(dev, COMPAT_PEND_STEPS))
    _check_variants("compat_pendulum", launches, twin_calls, {}, twins=True)
    n_ok = sum(s == "Solve_Succeeded" for s in statuses)
    print(f"[compat_pendulum] mpctools script, {COMPAT_PEND_STEPS} steps at "
          f"N=50 on the card (float64, beside the build): "
          f"{1e3 * wall / COMPAT_PEND_STEPS:.2f} ms a step ({wall:.3f} s), "
          f"Solve_Succeeded {n_ok}/{len(statuses)}, max |u| "
          f"{np.abs(ucl).max():.4f}, x final {xcl[0, -1]:.4f}, max |theta| "
          f"{np.abs(xcl[2]).max():.4f} | GPU {gpu}", flush=True)
    gates = (n_ok == len(statuses) and np.abs(ucl).max() <= 200 + 1e-6
             and xcl[0, -1] > 3.0 and np.abs(xcl[2]).max() < 1.2
             and abs(xcl[0, -1] - 10) < abs(xcl[0, COMPAT_PEND_STEPS // 4] - 10))
    if not gates:
        raise AssertionError("compat pendulum gates failed")
    by_path["compat_pendulum"] = launches

    out, wall, launches, twin_calls = _drive(
        lambda: _casadi_v1(dev, CASADI_N, CASADI_STEPS))
    states, us, errs, ok, pred_err, secs = out
    _check_variants("casadi_v1", launches, twin_calls, {})
    print(f"[casadi_v1] single shooting v1 at N={CASADI_N} on the card "
          f"(float64, beside the build): {len(ok)} steps, {wall:.3f} s, "
          f"nlpsol {1e3 * secs.mean():.1f} ms a call (first "
          f"{1e3 * secs[0]:.1f}, median {1e3 * np.median(secs):.1f}), "
          f"success {sum(ok)}/{len(ok)}, distance to target {errs[0]:.4f} -> "
          f"{errs[-1]:.4f}, max |plant - Xpred| {pred_err:.2e} | GPU {gpu}",
          flush=True)
    if not (all(ok) and errs[-1] <= 1e-1 and errs[-1] < errs[0] / 10
            and pred_err <= 1e-8):
        raise AssertionError("casadi v1 gates failed")
    by_path["casadi_v1"] = launches
    print(f"[compat] phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    first = {"compat_pendulum": xcl[:, :COMPAT_PEND_HOLD + 1],
             "casadi_v1": states[:CASADI_HOLD + 1]}
    return by_path, 1e3 * float(secs.mean()), first


def hold_compat(first, refs):
    """Phase 20's first steps on the card against the same scripts in
    float64 on the CPU (``CpuReferences``)."""
    ref = refs.raw("compat_pendulum", "compat_pendulum")
    dx = float(np.abs(first["compat_pendulum"] - ref["xcl"]).max())
    print(f"[compat_pendulum] first {COMPAT_PEND_HOLD} steps against CPU "
          f"float64: max |x diff| {dx:.3e} (tolerance {COMPAT_X_TOL})",
          flush=True)
    ref = refs.raw("casadi_v1", "casadi_v1")
    dx_c = float(np.abs(first["casadi_v1"]
                        - ref["states"][:CASADI_HOLD + 1]).max())
    print(f"[casadi_v1] first {CASADI_HOLD} steps against CPU float64 "
          f"(nlpsol {1e3 * ref['secs'].mean():.1f} ms a call there): max |x "
          f"diff| {dx_c:.3e} (tolerance {COMPAT_X_TOL})", flush=True)
    if not (dx <= COMPAT_X_TOL and dx_c <= COMPAT_X_TOL):
        raise AssertionError(f"compat holds: pendulum {dx}, casadi {dx_c}")


# Phase 21: the host tools and the scale-out layer.  The sweep at the JAX
# package's defaults: five Q_y weights at B = 5 per horizon, 300 steps,
# max_iters 30; each row's mean_y and mean_path_dist held within
# SWEEP_REL_TOL of the port's float64 CPU sweep at SWEEP_HOLD_HORIZONS.
SWEEP_Q_Y = (0.01, 0.1, 1.0, 10.0, 100.0)
SWEEP_HORIZONS = (3, 5, 8, 10, 15, 20)
SWEEP_STEPS, SWEEP_ITERS, SWEEP_HOLD_HORIZONS = 300, 30, (3, 20)
SWEEP_REL_TOL = 0.02
# the share of converged solves each row must reach, set from float32 runs:
# the stiffest rows (q_y = 100 at N = 5-10) stop at max_iters on some steps.
# The card's least was 0.8967 (N = 8 and 10, q_y = 100), JAX's float32 sweep
# on the CPU 0.89 (N = 5 and 10, q_y = 100); float64 converges every step
SWEEP_CONV_GATE = 0.85
# (b) traces one horizon at fewer steps: torch.profiler records every
# host-side op, and the whole 300 steps would make a trace of hundreds of MiB
SWEEP_TRACE_HORIZON, SWEEP_TRACE_STEPS = 5, 40
# the segmented run: the diff-drive family at B = 1, cut off on its third
# segment and resumed, against the monolithic run
SEG_STEPS, SEG_LEN, SEG_TOL = 84, 28, 1e-6
SHARD_B, SHARD_BACKEND = 1024, "nccl"


def _sweep_model(dev, dtype=torch.float32):
    """(Ad, Bd, refs) of the sweep's lane change: the SPEC model at the
    synthetic course's mean speed, discretized in float64."""
    from mpc_verde_tpu_torch.models.bicycle import lateral_error_lti
    from mpc_verde_tpu_torch.ops import c2d
    from mpc_verde_tpu_torch.refgen import (lateral_error_references,
                                            synthetic_lane_change)
    from mpc_verde_tpu_torch.scenarios.lane_change import SPEC

    path = synthetic_lane_change(n=500, dt=SPEC["T"])
    model = lateral_error_lti(float(np.mean(path["uref"])), SPEC["ar"],
                              SPEC["br"], device="cpu", dtype=torch.float64)
    Ad, Bd = (m.numpy() for m in c2d(model.Ac, model.Bc, SPEC["T"]))
    return Ad, Bd, lateral_error_references(path, SPEC["T"], SPEC["ar"],
                                            SPEC["br"])


def _sweep_case(dev, B, N, seed=41):
    """(OCP, its float64 twin, (x0, xs, us, kff, K), ps) of the sweep's
    OCP at horizon N: params drawn from its own table (the stage
    references of the 300 steps, each row with one of the five Q_y)."""
    from mpc_verde_tpu_torch.refgen import stage_param_tensor
    from mpc_verde_tpu_torch.sweep import sweep_ocp

    Ad, Bd, refs = _sweep_model(dev)
    ocp = sweep_ocp(N, Ad, Bd, dev, torch.float32)
    ocp64 = sweep_ocp(N, Ad, Bd, dev, torch.float64)
    par = stage_param_tensor(refs, N + 1, SWEEP_STEPS)
    q = np.resize(np.asarray(SWEEP_Q_Y), SWEEP_STEPS)
    table = np.concatenate([par, np.broadcast_to(
        q[:, None, None], (SWEEP_STEPS, N + 1, 1))], axis=2)
    data, ps = _linear_inputs(ocp, table, B, 0.5, 0.35, dev, seed=seed)
    return ocp, ocp64, data, ps


def _sweep_variants(B, N, opt):
    """The variants the plans give the sweep's K3 and K2 at horizon N."""
    from mpc_verde_tpu_torch.ops.cuda.fused import fused_launch_plan
    from mpc_verde_tpu_torch.ops.cuda.rollout import linesearch_launch_plan

    return {"fused_backward": {fused_launch_plan(
                N, opt.use_ddp, None, B, nx=4, nu=1).variant},
            "linesearch_forward": {linesearch_launch_plan(
                N, a, 5, nx=4, nu=1, B=B).variant for a in (opt.n_alphas, 1)}}


def _hold_sweep_rows(rows, ref):
    """The card's rows at the reference's horizons against CPU float64:
    mean_y and mean_path_dist within SWEEP_REL_TOL relative."""
    worst = 0.0
    for r64 in ref:
        r = next(r for r in rows if (r["horizon"], r["q_y"]) ==
                 (r64["horizon"], r64["q_y"]))
        for k in ("mean_y", "mean_path_dist"):
            rel = abs(r[k] - r64[k]) / max(abs(r64[k]), 1e-30)
            worst = max(worst, rel)
            if not rel <= SWEEP_REL_TOL:
                raise AssertionError(f"sweep N={r['horizon']} q_y={r['q_y']} "
                                     f"{k}: {r[k]} vs float64 {r64[k]}")
    return worst


def _hold_trace(trace, launches):
    """K2's and K3's launches in a Chrome trace, by kernel symbol, equal to
    their wrappers' counts (and at least one each); returns them."""
    count = lambda part: sum(n for name, n in trace.kernels.items()
                             if part in name)
    counted = {"linesearch_forward": count("linesearch_"),
               "fused_backward": count("fused_")}
    if any(counted[k] != launches[k] or counted[k] < 1 for k in counted):
        raise AssertionError(f"trace counts {counted} against {launches}")
    return counted


def phase_host(dev, gpu, refs, meas):
    """Phase 21: the weight term alone, the sweep, its trace, the sharded
    solve over NCCL, the segmented run and its export; returns the paths'
    launch counts."""
    import os
    import tempfile

    import torch.distributed as dist

    from mpc_verde_tpu_torch import (ILQROptions, make_batched_ilqr_solver)
    from mpc_verde_tpu_torch.interop import bench_ocp
    from mpc_verde_tpu_torch.parallel import (distributed_init,
                                              gather_result,
                                              make_sharded_solver)
    from mpc_verde_tpu_torch.runtime import make_receding_horizon
    from mpc_verde_tpu_torch.runtime.checkpoint import SegmentedRun
    from mpc_verde_tpu_torch.runtime.export import (export_diffdrive_run,
                                                    load_run)
    from mpc_verde_tpu_torch.scenarios import build_diffdrive
    from mpc_verde_tpu_torch.sweep import sweep_lane_change
    from mpc_verde_tpu_torch.utils import device_trace

    t_phase = time.perf_counter()
    by_path = {}
    # (a) the weight term alone, then the sweep
    err = {"linesearch_forward": 0.0, "fused_backward": 0.0}
    ocp, ocp64, data, ps = _sweep_case(dev, WIDTH, 20)
    row2, row3 = _hold_linear_case(
        "sweep q_param", ocp, ocp64, data, ps, tuple(0.4 ** i for i in range(8)),
        err)
    for name, row in (("linesearch_forward", row2), ("fused_backward", row3)):
        t = meas[name]["terms"]
        t["by_case"]["sweep q_param"] = row
        t["max_abs_err"] = max(t["max_abs_err"], err[name])
    print(f"[host] weight term (3,1) N=20 npar=5 B={WIDTH}: K2 "
          f"{row2['ms']:.4f} ms (bound {row2['bound_ms']:.4f}), K3 "
          f"{row3['ms']:.4f} ms (bound {row3['bound_ms']:.4f}); max abs err "
          f"vs float64 K2 {err['linesearch_forward']:.3e} K3 "
          f"{err['fused_backward']:.3e}", flush=True)

    opt = ILQROptions(max_iters=SWEEP_ITERS)
    B = len(SWEEP_Q_Y)
    sweep = lambda horizons, n=SWEEP_STEPS: sweep_lane_change(
        SWEEP_Q_Y, horizons, n_steps=n, max_iters=SWEEP_ITERS, device=dev)
    rows, wall, launches, twin_calls = _drive(lambda: sweep(SWEEP_HORIZONS))
    expect = {}
    for N in SWEEP_HORIZONS:
        for k, v in _sweep_variants(B, N, opt).items():
            expect.setdefault(k, set()).update(v)
    _check_variants("sweep", launches, twin_calls, expect)
    by_path["sweep"] = launches
    print(f"[sweep] B={B} (q_y {SWEEP_Q_Y}) x horizons {SWEEP_HORIZONS}, "
          f"{SWEEP_STEPS} steps, max_iters {SWEEP_ITERS} on \"cuda_fused\": "
          f"{wall:.3f} s ({1e3 * wall / (SWEEP_STEPS * len(SWEEP_HORIZONS)):.2f}"
          f" ms a batched step), launches {launches} | GPU {gpu}", flush=True)
    for r in rows:
        print(f"[sweep] N={r['horizon']:2d} q_y={r['q_y']:g}: mean_y "
              f"{r['mean_y']:.6e} mean_phi {r['mean_phi']:.6e} mean_path_dist "
              f"{r['mean_path_dist']:.6e} converged_frac "
              f"{r['converged_frac']:.4f}", flush=True)
    if len(rows) != B * len(SWEEP_HORIZONS) or not all(
            np.isfinite([r[k] for k in ("mean_y", "mean_phi",
                                        "mean_path_dist")]).all() for r in rows):
        raise AssertionError("sweep: rows missing or not finite")
    conv = min(r["converged_frac"] for r in rows)
    if conv < SWEEP_CONV_GATE:
        raise AssertionError(f"sweep: converged_frac {conv} < "
                             f"{SWEEP_CONV_GATE}")
    worst = _hold_sweep_rows(rows, refs.raw("sweep", "sweep")["rows"])
    print(f"[sweep] min converged_frac {conv:.4f} (gate {SWEEP_CONV_GATE}); "
          f"rows at horizons {SWEEP_HOLD_HORIZONS} against CPU float64: worst "
          f"rel err {worst:.3e} (tolerance {SWEEP_REL_TOL})", flush=True)

    # (b) one horizon of the sweep under the profiler: the trace names K2's
    # and K3's kernels as often as their wrappers counted launches
    with tempfile.TemporaryDirectory() as logdir:
        def traced():
            with device_trace(logdir) as tr:
                sweep((SWEEP_TRACE_HORIZON,), SWEEP_TRACE_STEPS)
            return tr

        tr, wall, launches, twin_calls = _drive(traced)
        _check_variants("sweep_trace", launches, twin_calls,
                        _sweep_variants(B, SWEEP_TRACE_HORIZON, opt))
        size = os.path.getsize(tr.path)
        counted = _hold_trace(tr, launches)
    by_path["sweep_trace"] = launches
    print(f"[trace] N={SWEEP_TRACE_HORIZON}, {SWEEP_TRACE_STEPS} steps under "
          f"device_trace: {wall:.3f} s, trace {size / 2**20:.1f} MiB, kernel "
          f"launches in the trace {counted}, wrapper counts "
          f"{ {k: launches[k] for k in counted} }, kernel symbols "
          f"{sorted(tr.kernels)}", flush=True)

    # (c) the sharded solve at world size 1 over NCCL
    x0q, psq, us0q = (torch.as_tensor(a, device=dev)
                      for a in _queue(SHARD_B, BENCH_N))
    with tempfile.TemporaryDirectory() as d:
        distributed_init(store=dist.FileStore(os.path.join(d, "store"), 1),
                         world_size=1, rank=0, backend=SHARD_BACKEND)
        try:
            if dist.get_backend() != SHARD_BACKEND:
                raise AssertionError(f"backend {dist.get_backend()}")
            for backend in ("cuda_fused", "cuda"):
                solve = make_batched_ilqr_solver(
                    bench_ocp(BENCH_N, dev, torch.float32), _opts(),
                    backend=backend)
                ref = solve(x0q, psq, us0q)
                (res, stats), wall, launches, twin_calls = _drive(
                    lambda: make_sharded_solver(solve, batched=True)(
                        x0q, psq, us0q))
                full = gather_result(res)
                kern = (("fused_backward", "linesearch_forward")
                        if backend == "cuda_fused"
                        else ("riccati_backward", "linesearch_forward"))
                _check_variants(f"sharded {backend}", launches, twin_calls,
                                {k: set(PLANNED[k]) for k in kern})
                same = all(torch.equal(getattr(res, f), getattr(ref, f))
                           and torch.equal(getattr(full, f), getattr(ref, f))
                           for f in ("xs", "us", "cost", "iterations",
                                     "converged", "grad_norm"))
                local = {"n_total": SHARD_B,
                         "n_converged": int(ref.converged.sum()),
                         "mean_cost": float(ref.cost.sum() / SHARD_B),
                         "max_grad_norm": float(ref.grad_norm.max()),
                         "max_iterations": int(ref.iterations.max())}
                got = {k: type(v)(getattr(stats, k).item())
                       for k, v in local.items()}
                by_path[f"sharded_{backend}"] = launches
                print(f"[sharded] {backend} world 1 over "
                      f"{dist.get_backend()}: B={SHARD_B} N={BENCH_N} "
                      f"{wall:.3f} s, equal to the unsharded solve {same}, "
                      f"stats {got} (local {local}), launches {launches}",
                      flush=True)
                if not same or got != local:
                    raise AssertionError(f"sharded {backend}: equal {same}, "
                                         f"stats {got} vs {local}")
        finally:
            dist.destroy_process_group()

    # (d) the segmented run, cut off on its third segment and resumed;
    # (e) its export read back
    b = build_diffdrive(n_steps=SEG_STEPS, device=dev)
    s = b["spec"]
    params = np.broadcast_to(np.array(s["target"]), (SEG_STEPS, s["N"] + 1, 3))
    make = lambda n, record=False: make_receding_horizon(
        b["ocp"], b["solve"], b["plant"], n, record_predictions=record)
    mono, _, launches, twin_calls = _drive(
        lambda: make(SEG_STEPS, True)(np.array(s["x0"]), params))
    _check_path(launches, twin_calls, FUSED_PATH)
    by_path["segmented_monolithic"] = launches
    # the monolithic run records each step's predicted horizon, which
    # starts at that step's state
    pred = mono.predicted
    d0 = float((pred[:, 0] - mono.xs[:-1]).abs().max())
    print(f"[segmented] monolithic run's predictions {tuple(pred.shape)}, "
          f"max |predicted[t, 0] - x_t| {d0:.3e}", flush=True)
    if (tuple(pred.shape) != (SEG_STEPS, s["N"] + 1, 3)
            or not bool(torch.isfinite(pred).all()) or not d0 <= SEG_TOL):
        raise AssertionError(f"predictions {tuple(pred.shape)}, {d0}")
    calls = []

    def cut_on_third(n):
        run = make(n)

        def cut(*a):
            calls.append(n)
            if len(calls) == 3:
                raise RuntimeError("cut off")
            return run(*a)
        return cut

    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "run.npz")
        try:
            SegmentedRun(cut_on_third, SEG_LEN, ck).run(np.array(s["x0"]),
                                                        params)
            raise AssertionError("the cut-off run was not cut off")
        except RuntimeError as exc:
            if str(exc) != "cut off":
                raise
        out, wall, launches, twin_calls = _drive(
            lambda: SegmentedRun(make, SEG_LEN, ck).run(
                np.array(s["x0"]), params, resume=True))
        _check_path(launches, twin_calls, FUSED_PATH)
        by_path["segmented_resumed"] = launches
        dx = float(np.abs(out["xs"] - mono.xs.cpu().numpy()).max())
        du = float(np.abs(out["us"] - mono.us.cpu().numpy()).max())
        bits = (np.array_equal(out["xs"], mono.xs.cpu().numpy())
                and np.array_equal(out["us"], mono.us.cpu().numpy()))
        print(f"[segmented] diff-drive {SEG_STEPS} steps in segments of "
              f"{SEG_LEN}, cut off on the third, resumed ({wall:.3f} s, "
              f"launches {launches}): max |x diff| {dx:.3e}, max |u diff| "
              f"{du:.3e} against the monolithic run (tolerance {SEG_TOL}), "
              f"bit-equal {bits}", flush=True)
        if not (dx <= SEG_TOL and du <= SEG_TOL
                and out["xs"].shape == (SEG_STEPS + 1, 3)):
            raise AssertionError(f"segmented run: {dx}, {du}")
        exact = {}
        for ext in (".csv", ".xlsx"):
            table = load_run(export_diffdrive_run(
                os.path.join(d, "run" + ext), out["xs"], out["us"], s["T"]))
            us = np.append(out["us"], out["us"][-1:], axis=0)
            exact[ext] = all(np.array_equal(table[c], col) for c, col in (
                ("x", out["xs"][:, 0]), ("y", out["xs"][:, 1]),
                ("theta", out["xs"][:, 2]), ("v", us[:, 0]), ("w", us[:, 1]),
                ("t", np.arange(SEG_STEPS + 1) * s["T"])))
        print(f"[export] the resumed run to .csv and .xlsx and back: exact "
              f"{exact}", flush=True)
        if not all(exact.values()):
            raise AssertionError(f"export round trip: {exact}")
    print(f"[host] phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return by_path


# Phase 22: "cuda_bw", named, the counterpart of JAX's default "pallas_bw":
# K1 on an OCP's own callables, with torch.func derivatives and the line
# search's plain PyTorch version (backend=None takes it on a card only in
# float64 or for callables that do not lower).  (a) the bench OCP without its device model, (b)
# three user OCPs at sizes K1 had no library for before it was built per
# size, (c) the bench OCP in float64.
BW_QUEUE = 2048   # 4096 took phase 22 past its 60 s
BW_PATH = ("riccati_backward",)
# (b): written here from plain callables; they are no model of the package,
# nor of the JAX package.  The tests build the same problems in JAX from
# these numbers.  The 1-D double integrator (2, 1); the planar quadrotor of
# Drake's PlanarQuadrotor (Tedrake, Underactuated Robotics, ch. 3) at (6, 2):
# state (x, y, theta, and their rates), the two rotors' thrusts, each boxed in
# [0, m g], hover at the origin; the 3-D point mass (6, 3).  Each stage costs
# x'Qx + (u - u_ref)'R(u - u_ref), the terminal state 10 x'Qx; each is
# discretized with RK4 (the quadrotor) or exactly (linear_model and c2d).
USER_N, USER_B, USER_HOLD = 40, 1024, 64
QUADROTOR = dict(m=0.486, arm=0.25, I=0.00383, g=9.81)
_HOVER = QUADROTOR["m"] * QUADROTOR["g"]
USER_OCPS = {
    "double_integrator": dict(nx=2, nu=1, dt=0.1, Q=(1.0, 0.1), R=(0.01,),
                              lb=(-1.0,), ub=(1.0,), start=(2.0, 1.0)),
    "quadrotor": dict(nx=6, nu=2, dt=0.05, Q=(10.0, 10.0, 10.0, 1.0, 1.0, 1.0),
                      R=(0.1, 0.1), lb=(0.0, 0.0), ub=(_HOVER, _HOVER),
                      start=(1.0, 1.0, 0.3, 0.0, 0.0, 0.0)),
    "point_mass": dict(nx=6, nu=3, dt=0.1, Q=(1.0, 1.0, 1.0, 0.1, 0.1, 0.1),
                       R=(0.1, 0.1, 0.1), lb=(-1.0,) * 3, ub=(1.0,) * 3,
                       start=(2.0, 2.0, 2.0, 0.5, 0.5, 0.5)),
}
USER_QF = 10.0
# converged_frac of JAX float32 "xla" on the CPU over the first USER_B starts
# of user_queue (PYTHONPATH=. python tests/test_torch_bw.py --band: 1.0 each,
# at 10.04 / 11.78 / 7.69 mean iterations); the card must reach each less
# 0.01
USER_JAX_BAND = {"double_integrator": 1.0, "quadrotor": 1.0,
                 "point_mass": 1.0}
BW_COST_TOL, BW_F64_COST_TOL = 1e-3, 1e-4


def quadrotor_rhs(x, u, xp):
    """Drake's PlanarQuadrotor: d/dt (x, y, theta, x', y', theta') for the
    rotors' thrusts u, in the array module ``xp`` (torch or jax.numpy)."""
    m, arm, inertia, g = (QUADROTOR[k] for k in ("m", "arm", "I", "g"))
    thrust = u[0] + u[1]
    return xp.stack([x[3], x[4], x[5], -xp.sin(x[2]) * thrust / m,
                     xp.cos(x[2]) * thrust / m - g,
                     arm * (u[0] - u[1]) / inertia])


def user_linear(name):
    """(Ac, Bc) of the double integrator and of the 3-D point mass."""
    n = USER_OCPS[name]["nu"]
    Ac = np.zeros((2 * n, 2 * n))
    Ac[:n, n:] = np.eye(n)
    return Ac, np.vstack([np.zeros((n, n)), np.eye(n)])


def user_u_ref(name):
    return np.full(2, _HOVER / 2) if name == "quadrotor" else np.zeros(
        USER_OCPS[name]["nu"])


def user_ocp(name, device, dtype=torch.float32):
    """The user OCP ``name`` of ``USER_OCPS`` in the port, from callables
    (no device model)."""
    from mpc_verde_tpu_torch import OCP, box_bounds
    from mpc_verde_tpu_torch.models import linear_model
    from mpc_verde_tpu_torch.ops import rk4_step
    from mpc_verde_tpu_torch.ops.integrators import c2d

    s = USER_OCPS[name]
    z = dict(dtype=dtype, device=device)
    if name == "quadrotor":
        F = rk4_step(lambda x, u, p: quadrotor_rhs(x, u, torch), s["dt"])
    else:
        lm = linear_model(*user_linear(name), device=device,
                          dtype=torch.float64)
        Ad, Bd = (a.to(dtype) for a in c2d(lm.Ac, lm.Bc, s["dt"]))

        def F(x, u, p):
            return Ad @ x + Bd @ u
    Q, R = (torch.diag(torch.tensor(s[k], **z)) for k in ("Q", "R"))
    ur = torch.as_tensor(user_u_ref(name), **z)

    def l(x, u, p):
        du = u - ur
        return x @ Q @ x + du @ R @ du

    def lf(x, p):
        return USER_QF * (x @ Q @ x)

    return OCP(dynamics=F, stage_cost=l, terminal_cost=lf, N=USER_N,
               nx=s["nx"], nu=s["nu"], npar=0,
               control_bounds=box_bounds(s["lb"], s["ub"], device=device,
                                         dtype=dtype),
               device=torch.device(device), dtype=dtype)


def user_queue(name, B, seed=52):
    """B random starts in +-start of ``USER_OCPS[name]``, zero params and
    the reference controls as the first guess (float64 numpy)."""
    s = USER_OCPS[name]
    x0 = np.random.default_rng(seed).uniform(-1, 1, (B, s["nx"])) * s["start"]
    return (x0, np.zeros((B, USER_N + 1, 1)),
            np.broadcast_to(user_u_ref(name), (B, USER_N, s["nu"])).copy())


def _bw_path(tag, gpu, run):
    """Drive one "cuda_bw" path with every count set to 0 just before and
    read just after: K1 launched and no other kernel, no K1 or K3 twin on
    CUDA tensors (the line search's twin is this backend's own); returns
    (result, wall, launches)."""
    res, wall, launches, twin_calls = _drive(run)
    print(f"[{tag}] backend=\"cuda_bw\": {wall:.3f} s, launches "
          f"{launches}, twin calls on CUDA {twin_calls} | GPU {gpu}",
          flush=True)
    if (launches["riccati_backward"] < 1 or launches["linesearch_forward"]
            or launches["fused_backward"]):
        raise AssertionError(f"{tag}: K1 alone must launch: {launches}")
    if (twin_calls["riccati_backward_torch"]
            or twin_calls["fused_backward_torch"]
            or twin_calls["linesearch_forward_torch"] < 1):
        raise AssertionError(f"{tag}: twins on CUDA {twin_calls}")
    if launches["riccati_backward.warps"] + launches["riccati_backward.thread"] \
            != launches["riccati_backward"]:
        raise AssertionError(f"{tag}: K1 variants {launches}")
    return res, wall, launches


# (a) and (c) hold two answers to one queue whose paths differ in the line
# search (K2 against its twin) or in K1's precision: a start may end in
# another local optimum of the bench OCP (as FDDP's does in phase 19, a gap
# of about 1e-1).  So the share of starts whose costs agree within the
# tolerance must be >= 0.99, and each start outside it must have both
# answers float64 optima: a float64 "torch" solve from each converges and
# lowers its cost by at most BW_POLISH_TOL of it.
BW_POLISH_TOL = 1e-4


def _polish(ocp64, us, cost, x0, ps):
    """A float64 "torch" solve of ``ocp64`` from the controls ``us`` (with
    phase 12's AL rounds where it has a state box): (the cost it drops,
    relative to its own cost; converged)."""
    from mpc_verde_tpu_torch import make_batched_ilqr_solver

    f64 = torch.float64
    pol = make_batched_ilqr_solver(ocp64, _opts(al_iters=AL_ITERS),
                                   backend="torch")(
        x0.to(f64), ps.to(f64), us.to(f64))
    return (cost.to(f64) - pol.cost) / pol.cost.abs(), pol.converged


def _hold_optima(tag, res, ref, ocp64, x0, ps, tol, share_gate=0.99):
    """``res`` against ``ref`` on the queue (x0, ps) by the rule above:
    converged agree >= 0.99; where both converged, costs within ``tol``
    relative on >= ``share_gate`` of the starts (0 where two optima of one
    start may differ by more, as on either side of an obstacle); both
    answers of every other start float64 optima of ``ocp64``."""
    agree = float((res.converged == ref.converged).float().mean())
    both = res.converged & ref.converged
    gap = ((res.cost.double() - ref.cost.double()).abs()
           / ref.cost.double().abs())
    share = float((gap[both] <= tol).float().mean())
    off = torch.nonzero(both & (gap > tol)).flatten()
    drops, polished = [], True
    for r in (res, ref):
        if len(off):
            drop, conv = _polish(ocp64, r.us[off], r.cost[off], x0[off],
                                 ps[off])
            drops.append(float(drop.max()))
            polished &= bool(conv.all()) and float(drop.max()) <= BW_POLISH_TOL
    print(f"[{tag}] converged agree {agree:.4f}; where both converged "
          f"({int(both.sum())}): median cost gap {float(gap[both].median()):.2e}, "
          f"max {float(gap[both].max()):.2e}, within {tol:g} {share:.4f}; "
          f"{len(off)} start(s) outside, "
          + (f"costs {res.cost[off][:4].tolist()} against "
             f"{ref.cost[off][:4].tolist()}, each answer polished in float64 "
             f"(max drop {drops}, tolerance {BW_POLISH_TOL}): float64 optima "
             f"{polished}" if len(off) else "none"), flush=True)
    if agree < 0.99 or share < share_gate or not polished:
        raise AssertionError(f"{tag}: agree {agree}, share {share}, "
                             f"polished {polished}")


def _rel_cost_gap(res, ref):
    """max relative cost gap where both converged, and that share."""
    both = res.converged.cpu() & ref.converged.cpu()
    gap = ((res.cost.double().cpu() - ref.cost.double().cpu()).abs()
           / ref.cost.double().cpu().abs().clamp(min=1e-30))[both]
    return (float(gap.max()) if both.any() else float("nan"),
            float(both.float().mean()))


def phase_bw(dev, gpu, ref_main, refs, M=BW_QUEUE, W=WIDTH, N=BENCH_N,
             B=USER_B):
    """Phase 22 (see the module docstring); returns the paths' launches and
    K1's rows on the user OCPs' own derivatives."""
    from mpc_verde_tpu_torch import (make_batched_ilqr_solver,
                                     make_streaming_solver)
    from mpc_verde_tpu_torch.interop import bench_ocp
    from mpc_verde_tpu_torch.solver.batched import resolve_backend

    t_phase = time.perf_counter()
    by_path, k1_rows = {}, []
    # (a) the bench OCP from its callables: phase 5's queue and options
    ocp = dataclasses.replace(bench_ocp(N, dev, torch.float32),
                              device_model=None)
    solve = make_streaming_solver(ocp, _opts(), backend="cuda_bw",
                                  batch_width=W, restarts=2)
    x0q, psq, us0q = (a[:M] for a in _queue(QUEUE, N))
    solve(x0q[:W], psq[:W], us0q[:W], max_iters=60, restarts_n=2)
    torch.cuda.synchronize()
    res, wall, by_path["bw_bench"] = _bw_path(
        "bw-bench", gpu, lambda: solve(x0q, psq, us0q, max_iters=60,
                                       restarts_n=2))
    _check_result(res, M, N)
    conv = float(res.converged.float().mean())
    print(f"[bw-bench] streaming W={W} M={M} N={N}: {M / wall:.1f} solves/s, "
          f"converged_frac {conv:.4f}, mean_iterations "
          f"{float(res.iterations.double().mean()):.3f}", flush=True)
    if conv < 0.99:
        raise AssertionError(f"bw-bench: converged_frac {conv} < 0.99")
    t = lambda a: torch.as_tensor(a, device=dev)
    _hold_optima("bw-bench vs phase 5", res, SimpleNamespace(
        converged=ref_main.converged[:M], cost=ref_main.cost[:M],
        us=ref_main.us[:M]), bench_ocp(N, dev, torch.float64), t(x0q),
        t(psq), BW_COST_TOL)

    # (b) the user OCPs at (2, 1), (6, 2), (6, 3), each against JAX float32's
    # band and the port's float64 "torch" solve of its first USER_HOLD
    for name in USER_OCPS:
        uocp = user_ocp(name, dev)
        solve = make_batched_ilqr_solver(uocp, _opts(), backend="cuda_bw")
        x0, ps, us0 = user_queue(name, B)
        res, wall, by_path[f"bw_{name}"] = _bw_path(
            f"bw-{name}", gpu, lambda: solve(x0, ps, us0))
        if not all(bool(torch.isfinite(getattr(res, k)).all())
                   for k in ("xs", "us", "cost")):
            raise AssertionError(f"bw-{name}: non-finite results")
        conv = float(res.converged.float().mean())
        band = USER_JAX_BAND[name]
        ref = refs.raw(f"bw-{name}", f"user_{name}")
        gap, both = _rel_cost_gap(
            SimpleNamespace(converged=res.converged[:USER_HOLD],
                            cost=res.cost[:USER_HOLD]),
            SimpleNamespace(converged=torch.as_tensor(ref["converged"]),
                            cost=torch.as_tensor(ref["cost"])))
        print(f"[bw-{name}] (nx, nu) = ({uocp.nx}, {uocp.nu}), B={B} N="
              f"{USER_N}: {wall:.3f} s, converged_frac {conv:.4f} (JAX float32 "
              f"on the CPU {band}, gate {band - 0.01:.4f}), mean_iterations "
              f"{float(res.iterations.double().mean()):.3f}; against CPU "
              f"float64 over {USER_HOLD}: both converged {both:.4f}, max "
              f"rel cost gap {gap:.3e} (tol {BW_COST_TOL})", flush=True)
        if not conv >= band - 0.01 or not gap <= BW_COST_TOL:
            raise AssertionError(f"bw-{name}: converged_frac {conv}, gap {gap}")
        # K1 at this path's shape, on the derivatives along its answers
        k1_rows.append(_k1_on_case(
            f"bw-{name}", uocp, user_ocp(name, dev, torch.float64),
            (None, res.xs, res.us, None, None),
            torch.as_tensor(ps, dtype=torch.float32, device=dev)))

    # (c) the bench OCP in float64 on the card: K1 on float32 copies, the
    # backend that backend=None takes in float64
    ocp64 = bench_ocp(N, dev, torch.float64)
    if resolve_backend(ocp64, None) != "cuda_bw":
        raise AssertionError("bw-float64: backend=None does not resolve to "
                             "\"cuda_bw\"")
    x0, ps, us0 = (torch.as_tensor(a[:B], dtype=torch.float64, device=dev)
                   for a in _queue(QUEUE, N))
    solve = make_batched_ilqr_solver(ocp64, _opts(), backend="cuda_bw")
    res, wall, by_path["bw_float64"] = _bw_path(
        "bw-float64", gpu, lambda: solve(x0, ps, us0))
    ref = make_batched_ilqr_solver(ocp64, _opts(), backend="torch")(x0, ps,
                                                                     us0)
    conv = float(res.converged.float().mean())
    print(f"[bw-float64] B={B} N={N}: {wall:.3f} s, converged_frac {conv:.4f} "
          f"(\"torch\" float64 {float(ref.converged.float().mean()):.4f}), "
          f"mean_iterations {float(res.iterations.double().mean()):.3f}, "
          f"cost {res.cost.dtype}", flush=True)
    if res.cost.dtype != torch.float64 or conv < 0.99:
        raise AssertionError(f"bw-float64: {res.cost.dtype}, converged_frac "
                             f"{conv}")
    _hold_optima("bw-float64 vs \"torch\"", res, ref, ocp64, x0, ps,
                 BW_F64_COST_TOL)
    print(f"[bw] phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return by_path, k1_rows

# Phase 23: K2 and K3 on the device model generated from the trace of an
# OCP's own callables (ops/cuda/trace.py, ops/cuda/codegen.py), the
# counterpart of JAX's "pallas" / "pallas_fused" on such an OCP.  The
# programs' libraries are built in phase 2 from a trace on the CPU (a
# program's text, and so its library, does not depend on the device).
TRACED_QUEUE = BW_QUEUE
CUDA_PATH = ("riccati_backward", "linesearch_forward")
# operations a float operation of a traced program takes on K3's dual
# numbers over nz seeds (nh = nz (nz + 1) / 2 Hessian entries): a linear
# one touches every component, a product of two duals 3 nz + 4 nh, a
# function f 16 + 2 nz + 3 nh (chain); a transcendental on floats is 16;
# pow takes two of them
TRACED_UNARY = ("sin", "cos", "tan", "exp", "log", "sqrt", "tanh", "sigmoid",
                "log1p", "exp2", "erfinv")
# (e), backend=None on rate-form OCPs, whose derived OCPs have no device
# model and are traced.  (e2) the LTI lane change's OCP (scenarios/
# lane_change.py at its SPEC's plant and weights, N = 40 without move
# blocking) with a box on its lateral error y, 0.1 m below the start lane's
# centre (y = 0) and 0.1 m short of the target lane's (y = 3), so that the
# box binds in every window that reaches the target lane (0.42 of 64 CPU
# float64 solves), over random windows of the course from starts perturbed
# off the reference; (e3) the rate form of the double integrator
# (tests/test_torch_bw.py's _rate_ocp: T = 0.1, Q = diag(1, 0.1), R = 0.01,
# rates in [-0.5, 0.5], no magnitude box, so the control box is constant and
# a barrier can be derived) through the streaming barrier solver.
LANE_Y_BOX = (-0.1, 2.9)
RATE_DI = dict(Ad=((1.0, 0.1), (0.0, 1.0)), Bd=((0.005,), (0.1,)),
               Q=(1.0, 0.1), R=0.01, du=0.5, x_box=((-3.0, -0.5, -np.inf),
                                                   (3.0, 0.5, np.inf)))
# JAX float32 "xla" on the CPU converges on every start of (e2)'s and (e3)'s
# queues (PYTHONPATH=. python tests/test_torch_bw.py --band: converged_frac
# 1.0 each, at 19.21 / 49.33 mean iterations, (e2)'s max_violation 3.9e-5),
# so both are held to phase 5's converged_frac >= 0.99


def _lane_course():
    """The lane change's course (scenarios/lane_change.py): its per-sample
    references (y, phi, r, delta) (500, 4) and its mean speed."""
    from mpc_verde_tpu_torch.refgen import (lateral_error_references,
                                            synthetic_lane_change)
    from mpc_verde_tpu_torch.scenarios.lane_change import SPEC

    path = synthetic_lane_change(n=500, dt=SPEC["T"])
    return (lateral_error_references(path, SPEC["T"], SPEC["ar"], SPEC["br"]),
            float(np.mean(path["uref"])))


def lane_box_ocp(device, dtype=torch.float32, N=BENCH_N):
    """(e2)'s OCP: the lane change's rate-form OCP, the box LANE_Y_BOX on y."""
    from mpc_verde_tpu_torch.models.bicycle import lateral_error_lti
    from mpc_verde_tpu_torch.ops import c2d
    from mpc_verde_tpu_torch.scenarios.lane_change import (SPEC,
                                                           lateral_error_ocp)

    _, uref = _lane_course()
    model = lateral_error_lti(uref, SPEC["ar"], SPEC["br"], device="cpu",
                              dtype=torch.float64)
    Ad, Bd = (m.numpy() for m in c2d(model.Ac, model.Bc, SPEC["T"]))
    ocp = lateral_error_ocp(N, N, device, dtype, Ad=Ad, Bd=Bd)
    box = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return dataclasses.replace(
        ocp, x_lb=box([LANE_Y_BOX[0], -np.inf, -np.inf, -np.inf]),
        x_ub=box([LANE_Y_BOX[1], np.inf, np.inf, np.inf]))


def lane_box_queue(B, N=BENCH_N, seed=53):
    """(e2)'s queue: windows of the course at random samples, each start
    the window's first reference with y moved by up to 0.3 m (kept 0.05 m
    inside the box) and the other three by up to 0.05."""
    from mpc_verde_tpu_torch.scenarios.lane_change import SPEC

    rng = np.random.default_rng(seed)
    refs, _ = _lane_course()
    off = rng.integers(0, len(refs) - N, B)
    ps = refs[off[:, None] + np.arange(N + 1)].astype(np.float32)
    z0 = ps[:, 0].copy()
    z0[:, 0] = np.clip(z0[:, 0] + rng.uniform(-0.3, 0.0, B),
                       LANE_Y_BOX[0] + 0.05, LANE_Y_BOX[1] - 0.05)
    z0[:, 1:] += rng.uniform(-0.05, 0.05, (B, 3)).astype(np.float32)
    z0[:, 3] = np.clip(z0[:, 3], -SPEC["delta_max"], SPEC["delta_max"])
    return z0, ps, np.zeros((B, N, 1), np.float32)


def rate_di_ocp(N, device, dtype=torch.float32, state_box=False):
    """(e3)'s OCP, RATE_DI (``interop.linear_rate_ocp``, with its device
    model); ``state_box`` adds |position| <= 3, |velocity| <= 0.5."""
    from mpc_verde_tpu_torch.interop import linear_rate_ocp

    s = RATE_DI
    ocp = linear_rate_ocp(N, device, dtype, Q=np.diag(s["Q"]),
                          R=np.array([[s["R"]]]), du_lb=[-s["du"]],
                          du_ub=[s["du"]], Ad=np.array(s["Ad"]),
                          Bd=np.array(s["Bd"]))
    if state_box:
        box = lambda v: torch.tensor(v, dtype=dtype, device=device)
        ocp = dataclasses.replace(ocp, x_lb=box(s["x_box"][0]),
                                  x_ub=box(s["x_box"][1]))
    return ocp


def rate_di_queue(B, N=BENCH_N, seed=54):
    """(e3)'s queue: z0 = (position, velocity, previous control) uniform in
    [-2, 2] x [-0.5, 0.5] x [-0.5, 0.5]."""
    rng = np.random.default_rng(seed)
    z0 = (rng.uniform(-1.0, 1.0, (B, 3)) * [2.0, 0.5, 0.5]).astype(np.float32)
    return z0, np.zeros((B, N + 1, 1), np.float32), np.zeros((B, N, 1),
                                                             np.float32)


# (e4) and (f): the ops the traced model lowers beside the arithmetic, sin,
# cos, tan, exp, log, sqrt and abs (ops/cuda/trace.py: every primitive that
# Mosaic lowers into the Pallas kernels, and the composites JAX builds from
# them).  Each term of TRACED_OP_TERMS calls one of them, in the array
# module ``m``: TORCH_OPS here, its jax.numpy spelling in
# tests/test_torch_trace_ops.py, which builds one OCP an op in both.  Where
# floor, ceil, round, sign, fmod or remainder take a value, it is a params
# column moved by at most 0.05, and op_params keeps each column at least 0.1
# from a jump of its op, so that float32 and float64 round to the same side.
TORCH_OPS = SimpleNamespace(
    sin=torch.sin, cos=torch.cos, stack=torch.stack, tanh=torch.tanh,
    sigmoid=torch.sigmoid, log1p=torch.log1p, exp2=torch.exp2,
    erfinv=torch.erfinv, floor=torch.floor, ceil=torch.ceil,
    round=torch.round, sign=torch.sign, pow=torch.pow, fmod=torch.fmod,
    remainder=torch.remainder, amax=lambda a: torch.amax(a, 0),
    amin=lambda a: torch.amin(a, 0), max=lambda a: a.max(),
    min=lambda a: a.min(), max_dim=lambda a: a.max(0).values,
    min_dim=lambda a: a.min(0).values,
    softplus=lambda z, beta: torch.nn.functional.softplus(z, beta=beta),
    hypot=torch.hypot, logaddexp=torch.logaddexp,
    huber=lambda d, delta: torch.nn.functional.huber_loss(
        d, torch.zeros_like(d), delta=delta, reduction="sum"),
    smooth_l1=lambda d, beta: torch.nn.functional.smooth_l1_loss(
        d, torch.zeros_like(d), beta=beta, reduction="sum"),
    silu=torch.nn.functional.silu)
# each a function of x (>= 2), u (>= 1) and p (4: op_params), bounded in x
# and u where its op grows fast
TRACED_OP_TERMS = {
    "tanh": lambda x, u, p, m: m.tanh(x[0] + u[0]),
    "sigmoid": lambda x, u, p, m: m.sigmoid(2.0 * x[0] - u[0]),
    "log1p": lambda x, u, p, m: m.log1p(x[0] * x[0] + u[0] * u[0]),
    "exp2": lambda x, u, p, m: m.exp2(m.sin(x[0]) * u[0]),
    "erfinv": lambda x, u, p, m: m.erfinv(0.9 * m.sin(x[0] + u[0])),
    "floor": lambda x, u, p, m: m.floor(p[2] + 0.05 * m.sin(x[0])) * x[1],
    "ceil": lambda x, u, p, m: m.ceil(p[2] + 0.05 * m.sin(x[1])) * u[0],
    "round": lambda x, u, p, m: m.round(p[2] + 0.05 * m.sin(u[0])) * x[0],
    "sign": lambda x, u, p, m: m.sign(p[2] + 0.05 * m.sin(x[0])) * x[0] * u[0],
    "fmod": lambda x, u, p, m: m.fmod(p[0] + 0.05 * m.sin(x[0]), p[1]),
    "fmod_scalar": lambda x, u, p, m: m.fmod(p[3] + 0.05 * m.sin(x[1]), 0.7),
    "remainder": lambda x, u, p, m: m.remainder(p[0] + 0.05 * m.sin(x[1]),
                                                p[1]),
    "remainder_scalar": lambda x, u, p, m: m.remainder(
        p[3] + 0.05 * m.sin(u[0]), 0.7),
    "pow": lambda x, u, p, m: m.pow(1.5 + m.sin(x[0]), 1.0 + m.sin(u[0])),
    "pow_scalar_base": lambda x, u, p, m: 1.5 ** (m.sin(x[1]) * u[0]),
    "pow_negative_base": lambda x, u, p, m: m.pow(m.sin(x[0]) - 3.0,
                                                  m.floor(p[2])),
    "amax": lambda x, u, p, m: m.amax(m.stack([x[0], x[1], u[0]])),
    "amin": lambda x, u, p, m: m.amin(m.stack([x[0], x[1], u[0]])),
    "max": lambda x, u, p, m: m.max(m.stack([x[1], u[0], 0.5 * x[0]])),
    "min": lambda x, u, p, m: m.min(m.stack([x[1], u[0], 0.5 * x[0]])),
    "max_dim": lambda x, u, p, m: m.max_dim(m.stack([x[0], -u[0]])),
    "min_dim": lambda x, u, p, m: m.min_dim(m.stack([x[1], -u[0]])),
    "softplus": lambda x, u, p, m: m.softplus(
        1.0 - x[0] * x[0] - x[1] * x[1], 4.0),
    "hypot": lambda x, u, p, m: m.hypot(x[0], x[1] + u[0]),
    "logaddexp": lambda x, u, p, m: m.logaddexp(x[0], u[0]),
    "huber": lambda x, u, p, m: m.huber(m.stack([x[0], x[1] - u[0]]), 0.5),
    "smooth_l1": lambda x, u, p, m: m.smooth_l1(m.stack([x[0], x[1] - u[0]]),
                                                0.5),
    "silu": lambda x, u, p, m: m.silu(x[0] + u[0]),
}
# (f) the "ops" OCP runs every term but (e4)'s two, tanh and softplus
OPS_TERMS = tuple(n for n in TRACED_OP_TERMS if n not in ("tanh", "softplus"))
OPS_DT = 0.1
# (e4): the bench OCP (unicycle, RK4 at T = 0.2, its Q, R and box, target in
# p[:3]) with smooth speed saturation in the dynamics, v_eff = v_max
# tanh(v / v_max), and a soft obstacle in the stage cost, w softplus(kappa
# (r^2 - |p - c|^2)) / kappa, a disc of radius r at c on the straight line
# from most of phase 22's starts to (10, 10).  A start can pass it on either
# side, so its answers are held by their optimality, not by their costs.
OBSTACLE = dict(v_max=2.0, centre=(5.0, 5.0), radius=1.5, weight=20.0,
                kappa=4.0)


def evaluator_ocp(ocp):
    """``ocp`` with the callables of its traced program's evaluator
    (``Program.evaluate``, the plain PyTorch twin of the generated model),
    for the twins where torch.func cannot differentiate the OCP's own
    callables twice: torch's huber_loss and smooth_l1_loss have no
    forward-mode rule for their backward (the trace decomposes them)."""
    from mpc_verde_tpu_torch.ops.cuda.rollout import traced_device_model

    m = traced_device_model(ocp)
    return dataclasses.replace(
        ocp, dynamics=m.step, stage_cost=m.stage_cost,
        terminal_cost=None if ocp.terminal_cost is None else m.terminal_cost,
        control_bounds=None if ocp.control_bounds is None else m.bounds)


def op_params(B, seed=57):
    """(B, 4) float32 params of TRACED_OP_TERMS: p1 = +-U(0.5, 1.5), p0 =
    p1 (k + f) and p3 = 0.7 (k + f) for integers k and f in [0.2, 0.8]
    (at least 0.1 from a multiple of their divisors), p2 = k + f with f in
    [0.1, 0.4] or [0.6, 0.9] (at least 0.1 from an integer, a half-integer
    and 0)."""
    rng = np.random.default_rng(seed)
    k = lambda: rng.integers(-3, 3, B)
    f = lambda: rng.uniform(0.2, 0.8, B)
    p1 = rng.choice([-1.0, 1.0], B) * rng.uniform(0.5, 1.5, B)
    p2 = k() + rng.choice([0.1, 0.6], B) + rng.uniform(0.0, 0.3, B)
    return np.stack([p1 * (k() + f()), p1, p2, 0.7 * (k() + f())],
                    -1).astype(np.float32)


def ops_sum(x, u, p, m, names=OPS_TERMS):
    """The sum of the terms ``names`` of TRACED_OP_TERMS."""
    total = 0.0
    for name in names:
        total = total + TRACED_OP_TERMS[name](x, u, p, m)
    return total


def ops_ocp(device, dtype=torch.float32, N=BENCH_N):
    """(f)'s OCP (3, 2), npar 4: a double integrator and a third integrator
    stepped by Euler at OPS_DT, whose acceleration and stage cost add 0.1
    times the sum of OPS_TERMS, and the box [-1, 1]^2."""
    from mpc_verde_tpu_torch import OCP, box_bounds

    z = dict(dtype=dtype, device=device)
    Q = torch.diag(torch.tensor([1.0, 0.5, 0.1], **z))
    R = torch.diag(torch.tensor([0.1, 0.1], **z))

    def F(x, u, p):
        s = 0.1 * ops_sum(x, u, p, TORCH_OPS)
        return torch.stack([x[0] + OPS_DT * x[1], x[1] + OPS_DT * (u[0] + s),
                            x[2] + OPS_DT * u[1]])

    def l(x, u, p):
        return x @ Q @ x + u @ R @ u + 0.1 * ops_sum(x, u, p, TORCH_OPS)

    return OCP(dynamics=F, stage_cost=l, N=N, nx=3, nu=2, npar=4,
               control_bounds=box_bounds([-1.0, -1.0], [1.0, 1.0],
                                         device=device, dtype=dtype),
               device=torch.device(device), dtype=dtype)


def obstacle_rhs(x, u, m):
    """(e4)'s unicycle with smooth speed saturation, in the array module
    ``m`` (TORCH_OPS or its jax.numpy spelling)."""
    v = OBSTACLE["v_max"] * m.tanh(u[0] / OBSTACLE["v_max"])
    return m.stack([v * m.cos(x[2]), v * m.sin(x[2]), u[1]])


def obstacle_cost(x, u, p, m, Q, R):
    """(e4)'s stage cost: the bench's and the soft obstacle."""
    e = x - p[:3]
    (cx, cy), r = OBSTACLE["centre"], OBSTACLE["radius"]
    d2 = (x[0] - cx) ** 2 + (x[1] - cy) ** 2
    return e @ Q @ e + u @ R @ u + OBSTACLE["weight"] * m.softplus(
        r * r - d2, OBSTACLE["kappa"])


BENCH_Q, BENCH_R = (np.diag(np.array(d, np.float32))
                    for d in ((1.0, 5.0, 0.1), (0.5, 0.05)))
BENCH_BOX = (np.array([-1.0, -np.pi / 4], np.float32),
             np.array([1.0, np.pi / 4], np.float32))


def obstacle_ocp(device, dtype=torch.float32, N=BENCH_N):
    """(e4)'s OCP, from callables (no device model)."""
    from mpc_verde_tpu_torch import OCP, box_bounds
    from mpc_verde_tpu_torch.interop import BENCH_DT
    from mpc_verde_tpu_torch.ops import rk4_step

    Q, R = (torch.as_tensor(a, dtype=dtype, device=device)
            for a in (BENCH_Q, BENCH_R))
    F = rk4_step(lambda x, u, p: obstacle_rhs(x, u, TORCH_OPS), BENCH_DT)

    def l(x, u, p):
        return obstacle_cost(x, u, p, TORCH_OPS, Q, R)

    return OCP(dynamics=F, stage_cost=l, N=N, nx=3, nu=2, npar=3,
               control_bounds=box_bounds(*BENCH_BOX, device=device,
                                         dtype=dtype),
               device=torch.device(device), dtype=dtype)


def traced_ocps(device, N=BENCH_N):
    """The float32 OCPs that phase 23 runs without a device model, as its
    solvers trace them: the bench OCP from its callables, its AL-derived OCP
    under the box y <= AL_Y_MAX (make_streaming_solver derives the same
    one), the three user OCPs, (e)'s derived OCPs of the rate-form models
    (the lane change's AL-derived OCP and the double integrator's streaming
    barrier-derived OCP), (e4)'s obstacle OCP and (f)'s ops OCP."""
    from mpc_verde_tpu_torch.interop import bench_ocp
    from mpc_verde_tpu_torch.solver.batched import _augment_ocp_al
    from mpc_verde_tpu_torch.solver.ipm import _barrier_ocp

    bare = lambda **kw: dataclasses.replace(
        bench_ocp(N, device, torch.float32, **kw), device_model=None)
    return {"bench": bare(),
            "bench_al": _augment_ocp_al(bare(x_ub=[np.inf, AL_Y_MAX, np.inf])),
            **{name: user_ocp(name, device) for name in USER_OCPS},
            "lane_al": _augment_ocp_al(lane_box_ocp(device, N=N)),
            "rate_barrier": _barrier_ocp(rate_di_ocp(N, device), "streaming"),
            "obstacle": obstacle_ocp(device, N=N), "ops": ops_ocp(device, N=N)}


def rate_form_ocps(device):
    """The float32 OCPs of the rate-form families as phases 10, 15-17 and
    21 build them, each run on the model traced from its callables: the
    lane change (LTI at N 5 and the v1 shape, LTV), the dynamic bicycle,
    the pendulum, Frenet, curvature and the sweep at each of its
    horizons."""
    from mpc_verde_tpu_torch import scenarios as sc
    from mpc_verde_tpu_torch.sweep import sweep_ocp

    kw = dict(n_steps=2, device=device)
    built = {"lti": sc.build_lane_change_lti(**kw),
             "lti_v1": sc.build_lane_change_lti(N=20, Ntu=3, **kw),
             "ltv": sc.build_lane_change_ltv(**kw),
             "dynamic": sc.build_dynamic_bicycle(**kw),
             "pendulum": sc.build_pendulum(**kw),
             "frenet": sc.build_frenet(**kw),
             "curvature": sc.build_curvature_ltv(**kw)}
    ocps = {name: b["ocp"] for name, b in built.items()}
    Ad, Bd, _ = _sweep_model(device)
    ocps.update({f"sweep_N{N}": sweep_ocp(N, Ad, Bd, device, torch.float32)
                 for N in SWEEP_HORIZONS})
    return ocps


def quadrotor_cell_ocp(N, device):
    """The benchmark's planar quadrotor at horizon ``N``: its program
    (``portbench/programs/quadrotor2d.py``) on its cell's configuration,
    so that at N = 40 its trace is the cell's own program."""
    import importlib.util

    bench = Path(__file__).resolve().parent / "portbench"
    spec = importlib.util.spec_from_file_location(
        "quadrotor2d_program", bench / "programs" / "quadrotor2d.py")
    program = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(program)
    with open(bench / "configs" / "quadrotor2d_n40.json") as fh:
        cfg = json.load(fh)
    return program.build_ocp(dict(cfg, N=N), torch.device(device))


def traced_programs():
    """Phase 23's programs, the rate-form families' and the quadrotor
    cell's, traced on the CPU, for phase 2's build."""
    from mpc_verde_tpu_torch.ops.cuda.trace import trace_ocp

    return [trace_ocp(o) for o in (*traced_ocps("cpu").values(),
                                   *rate_form_ocps("cpu").values(),
                                   quadrotor_cell_ocp(BENCH_N, "cpu"))]


def _traced_flops(program, use_duals):
    """Operations of one step and stage cost of ``program`` (K2 a step) or
    of their evaluation on second-order duals over z (K3 a stage, without
    K1's recursion), counted from its instructions as TRACED_UNARY says."""
    nz = program.nx + program.nu
    nh = nz * (nz + 1) // 2
    roots = program.outputs["step"] + program.outputs["stage_cost"]
    n = 0
    for v in program.reachable(roots):
        name = program.ops[v][0]
        if name in TRACED_UNARY or name == "pow":
            n += (1 + (name == "pow")) * (16 + 2 * nz + 3 * nh if use_duals
                                          else 16)
        elif name == "mul" and use_duals:
            n += 3 * nz + 4 * nh
        elif name not in ("in", "k", "cf", "ci", "cb", "tab", "tabi"):
            n += 1 + nz + nh if use_duals else 1
    return n


def _traced_path(tag, gpu, run, path_kernels, ocp):
    """Drive one path on the traced model with every count set to 0 just
    before and read just after: the path's kernels launched, the other
    backward kernel not, no twin on CUDA tensors; returns (result, wall,
    launches)."""
    from mpc_verde_tpu_torch.ops.cuda.rollout import (TracedDeviceModel,
                                                      kernel_model)

    if not isinstance(kernel_model(ocp), TracedDeviceModel):
        raise AssertionError(f"{tag}: the OCP has a hand-written model")
    res, wall, launches, twin_calls = _drive(run)
    other = ({"riccati_backward", "fused_backward"} - set(path_kernels))
    print(f"[{tag}] {wall:.3f} s, launches {launches}, twin calls on CUDA "
          f"{twin_calls} | GPU {gpu}", flush=True)
    if (min(launches[k] for k in path_kernels) < 1
            or any(launches[k] for k in other) or max(twin_calls.values())):
        raise AssertionError(f"{tag}: launches {launches}, twins {twin_calls}")
    return res, wall, launches


def _traced_vs_hand(dev, B, N, A=8):
    """(a): K2 and K3 on the bench OCP's traced model against the
    hand-written UnicycleDeviceModel and against the twin, on the same
    inputs, at phase 4's and 7's tolerances; each timed beside the other."""
    from mpc_verde_tpu_torch.interop import bench_ocp
    from mpc_verde_tpu_torch.ops.cuda.fused import (fused_backward,
                                                    fused_backward_torch)
    from mpc_verde_tpu_torch.ops.cuda.rollout import (
        linesearch_forward, linesearch_forward_torch, traced_device_model)

    hand = bench_ocp(N, dev, torch.float32)
    bare = dataclasses.replace(hand, device_model=None)
    program = traced_device_model(bare).program
    alphas = tuple(0.4 ** i for i in range(A))
    data = _k2_inputs(dev, B, N)
    zero = (*data[:4], torch.zeros_like(data[4]), torch.zeros_like(data[5]))
    err = {"linesearch_forward": 0.0, "fused_backward": 0.0}
    for label, d, al in (("random gains", data, alphas),
                         ("pre-roll", zero, (1.0,))):
        out = linesearch_forward(*d, al, ocp=bare)
        for ref_label, ref in (
                ("the unicycle model", linesearch_forward(*d, al, ocp=hand)),
                ("the twin", linesearch_forward_torch(*d, al, ocp=hand))):
            cost_rel = float(((out[2].double() - ref[2].double()).abs()
                              / ref[2].double().abs()).max())
            same = out[3] == ref[3]
            traj = max(_rel_err(out[0][same], ref[0][same]),
                       _rel_err(out[1][same], ref[1][same]))
            print(f"[traced] K2 bench {label} B={B} N={N} A={len(al)} against "
                  f"{ref_label}: cost rel err {cost_rel:.2e}, same alpha "
                  f"{float(same.float().mean()):.4f}, traj err {traj:.2e}",
                  flush=True)
            if cost_rel > 1e-5 or float(same.float().mean()) < 0.999 \
                    or traj > 1e-4:
                raise AssertionError(f"traced K2 {label} against {ref_label}")
            err["linesearch_forward"] = max(
                err["linesearch_forward"], _abs_err(out[2], ref[2]),
                _abs_err(out[0][same], ref[0][same]))
    f = dict(dtype=torch.float32, device=dev)
    args = (*_bench_trajectories(hand, B, dev), torch.full((B,), 1e-6, **f),
            torch.ones((B,), **f))
    for use_ddp in (True, False):
        out = fused_backward(*args, ocp=bare, use_ddp=use_ddp)
        for ref_label, ref in (
                ("the unicycle model", fused_backward(*args, ocp=hand,
                                                      use_ddp=use_ddp)),
                ("the twin", fused_backward_torch(*args, ocp=hand,
                                                  use_ddp=use_ddp))):
            err["fused_backward"] = max(err["fused_backward"], _hold(
                out, ref, "traced", f"K3 bench DDP={use_ddp} against "
                f"{ref_label}"))
    k2 = {m: _time_ms(lambda: linesearch_forward(*data, alphas, ocp=o), 50)
          for m, o in (("traced", bare), ("hand", hand))}
    k3 = {m: _time_ms(lambda: fused_backward(*args, ocp=o), 50)
          for m, o in (("traced", bare), ("hand", hand))}
    k2_plain = _time_ms(lambda: linesearch_forward_torch(*data, alphas,
                                                         ocp=bare),
                        reps=3, warmup=1, queued=False)
    k3_plain = _time_ms(lambda: fused_backward_torch(*args, ocp=bare), reps=3,
                        warmup=1, queued=False)
    # bytes as phase 4's and 7's bounds count them: each input read once,
    # each output of a launch written once
    n2 = sum(a.numel() for a in data) + sum(
        o.numel() for o in linesearch_forward(*data, alphas, ocp=bare))
    n3 = sum(a.numel() for a in args) + sum(
        o.numel() for o in fused_backward(*args, ocp=bare))
    rows = (
        {"case": "bench", "ms": k2["traced"], "hand_written_ms": k2["hand"],
         "plain_ms": k2_plain,
         **_bound(4 * n2, B * A * N * (_traced_flops(program, False)
                                       + 2 * 2 * 3 + 6))},
        {"case": "bench", "ms": k3["traced"], "hand_written_ms": k3["hand"],
         "plain_ms": k3_plain,
         **_bound(4 * n3, B * N * (_traced_flops(program, True)
                                   + K1_STAGE_FLOPS))})
    print(f"[traced] bench B={B} N={N}: K2 traced {k2['traced']:.4f} ms, "
          f"hand-written {k2['hand']:.4f} ms, twin {k2_plain:.2f} ms, bound "
          f"{rows[0]['bound_ms']:.4f} by {rows[0]['bound_by']}; K3 traced "
          f"{k3['traced']:.4f} ms, hand-written {k3['hand']:.4f} ms, twin "
          f"{k3_plain:.2f} ms, bound {rows[1]['bound_ms']:.4f} by "
          f"{rows[1]['bound_by']}", flush=True)
    return rows, err


def _traced_user_kernels(label, ocp, ocp64, res, x0, ps, alphas, err,
                         twins=None):
    """(c): K2 (every variant, against the float64 twin's candidates) and
    K3 (DDP on and off, both variants, against the float64 twin) along the
    user OCP's answers ``res`` with random gains; the twins run on
    ``twins`` (float32, float64) where given, else on ``ocp`` and ``ocp64``;
    returns (K2 row, K3 row) of times and bounds."""
    from mpc_verde_tpu_torch.ops.cuda.fused import (
        fused_backward, fused_backward_torch, fused_launch_plan)
    from mpc_verde_tpu_torch.ops.cuda.rollout import (
        LINESEARCH_VARIANTS, linesearch_forward)

    xs, us = res.xs.contiguous(), res.us.contiguous()
    B, N, nu = us.shape
    nx = xs.shape[-1]
    rng = np.random.default_rng(61)
    f = dict(dtype=torch.float32, device=xs.device)
    t = lambda a: torch.as_tensor(a, **f).contiguous()
    full = (x0, xs, us, ps, t(0.1 * rng.standard_normal((B, N, nu))),
            t(0.05 * rng.standard_normal((B, N, nu, nx))))
    twin, twin64 = twins or (ocp, ocp64)
    cand32 = _k2_candidates(full, alphas, twin)
    cand64 = _k2_candidates(_to64(*full), alphas, twin64)
    planned = _k2_plan(full, alphas).variant
    for variant in (None, *(v for v in LINESEARCH_VARIANTS if v != planned)):
        used, out = _variants_used(
            linesearch_forward,
            lambda: linesearch_forward(*full, alphas, ocp=ocp, variant=variant))
        if used != {variant or planned}:
            raise AssertionError(f"K2 {label} ran variants {used}")
        err["linesearch_forward"] = max(err["linesearch_forward"], _hold_k2_f64(
            f"{label} variant {sorted(used)}", out, cand32, cand64, None))
    args = (xs, us, ps, torch.full((B,), 1e-6, **f), torch.ones((B,), **f))
    for use_ddp in (True, False):
        ref = fused_backward_torch(*args, ocp=twin, use_ddp=use_ddp)
        ref64 = fused_backward_torch(*_to64(*args), ocp=twin64,
                                     use_ddp=use_ddp)
        plan = fused_launch_plan(N, use_ddp, None, B, nx=nx, nu=nu).variant
        for variant in (None, "thread" if plan == "staged" else "staged"):
            used, out = _variants_used(
                fused_backward,
                lambda: fused_backward(*args, ocp=ocp, use_ddp=use_ddp,
                                       variant=variant))
            if used != {variant or plan}:
                raise AssertionError(f"K3 {label} ran variants {used}")
            err["fused_backward"] = max(err["fused_backward"], _hold_f64(
                out, ref, ref64, "traced", f"K3 {label} DDP={use_ddp} "
                f"variant {sorted(used)}"))
    row2, row3 = _time_case(label, ocp, full, alphas, twin=twin,
                            flops=_program_flops(ocp))
    return {"nx": nx, "nu": nu, **row2}, {"nx": nx, "nu": nu, **row3}


def _resolves_fused(tag, ocp):
    """backend=None on ``ocp`` (float32, on the card) must be the traced
    "cuda_fused": K3 and K2 on the model traced from its callables."""
    from mpc_verde_tpu_torch.ops.cuda.rollout import (TracedDeviceModel,
                                                      kernel_model)
    from mpc_verde_tpu_torch.solver.batched import resolve_backend

    backend = resolve_backend(ocp, None)
    traced = isinstance(kernel_model(ocp), TracedDeviceModel)
    print(f"[{tag}] backend=None -> {backend!r} on the traced model: "
          f"{traced}", flush=True)
    if backend != "cuda_fused" or not traced:
        raise AssertionError(f"{tag}: backend=None resolved to {backend!r}, "
                             f"traced {traced}")


def _derived_kernels(label, kind, ocp, ocp64, res, ps, alphas, err, k2_rows,
                     k3_rows, B=WIDTH, seed=63):
    """K2 and K3 on the derived program ``ocp`` of ``kind`` "al" (params [p,
    lam, mu_al]) or "barrier" ([p, mu]) along the first B answers ``res``
    to the base problems of params ``ps``, held to the float64 twins and
    timed as (c) does: lam 0.1 |N(0, 1)|, mu_al 10, the barrier's mu 1e-2."""
    from mpc_verde_tpu_torch.interop import derived_params

    xs, us, ps = res.xs[:B].contiguous(), res.us[:B].contiguous(), ps[:B]
    B = xs.shape[0]
    lam = None
    if kind == "al":
        lam = 0.1 * torch.as_tensor(np.abs(np.random.default_rng(
            seed).standard_normal((B, ps.shape[1], 2 * ocp.nx))),
            dtype=ps.dtype, device=ps.device)
    dps = derived_params(kind, ps, lam=lam)
    row2, row3 = _traced_user_kernels(label, ocp, ocp64, SimpleNamespace(
        xs=xs, us=us), xs[:, 0].contiguous(), dps, alphas, err)
    k2_rows.append(row2)
    k3_rows.append(row3)


def _violation_gate(res):
    """The JAX tests' gate on a state-bounded solve: max_violation < 1e-2."""
    viol = float(res.max_violation.max())
    if not viol < 1e-2:
        raise AssertionError(f"max_violation {viol} >= 1e-2")


def _hold_rate_f64(tag, res, ref, ocp64, queue, share_gate=0.99):
    """The first USER_HOLD answers against CPU float64 by phase 22's rule."""
    dev = res.us.device
    t = lambda a: torch.as_tensor(a, device=dev)
    H = USER_HOLD
    _hold_optima(f"{tag} vs CPU float64", SimpleNamespace(
        converged=res.converged[:H], cost=res.cost[:H], us=res.us[:H]),
        SimpleNamespace(**{k: t(ref[k]) for k in ("converged", "cost",
                                                  "us")}),
        ocp64, t(queue[0][:H]), t(queue[1][:H]), BW_COST_TOL, share_gate)


def _default_rate_paths(dev, gpu, refs, ocps, alphas, err, k2_rows, k3_rows,
                        W, N):
    """(e2) and (e3); returns their launches."""
    from mpc_verde_tpu_torch import (make_streaming_barrier_solver,
                                     make_streaming_solver)
    from mpc_verde_tpu_torch.solver.batched import _augment_ocp_al
    from mpc_verde_tpu_torch.solver.ipm import _barrier_ocp

    by_path = {}
    f64 = torch.float64
    # (e2) the lane change with a box on y: its AL-derived OCP, traced
    lane = lane_box_ocp(dev, N=N)
    _resolves_fused("e2-lane-al", _augment_ocp_al(lane))
    queue = lane_box_queue(W, N)
    solve = make_streaming_solver(lane, _opts(al_iters=AL_ITERS),
                                  batch_width=W, restarts=2)
    by_path["default_lane_al"], res = _streaming_path(
        "e2-lane-al", gpu, solve, queue, FUSED_PATH, warm=W,
        check=_violation_gate, note="backend=None, the lane change with a "
        "box on y: ")
    y = res.xs[..., 0]
    edge = (y.amin(-1) <= LANE_Y_BOX[0] + 1e-2) | (
        y.amax(-1) >= LANE_Y_BOX[1] - 1e-2)
    print(f"[e2-lane-al] y in [{float(y.min()):.4f}, {float(y.max()):.4f}] "
          f"against the box {LANE_Y_BOX}, at an edge in "
          f"{float(edge.float().mean()):.4f} of the problems", flush=True)
    lane64 = lane_box_ocp(dev, f64, N=N)
    _hold_rate_f64("e2-lane-al", res, refs.raw("e2-lane-al", "lane_al"),
                   lane64, queue)
    _derived_kernels("lane_al", "al", ocps["lane_al"], _augment_ocp_al(lane64),
                     res, torch.as_tensor(queue[1], device=dev), alphas, err,
                     k2_rows, k3_rows)

    # (e3) the double integrator's rate form through the streaming barrier
    # solver: its barrier-derived OCP, traced
    rate = rate_di_ocp(N, dev)
    _resolves_fused("e3-rate-barrier", _barrier_ocp(rate, "streaming"))
    queue = rate_di_queue(W, N)
    solve = make_streaming_barrier_solver(rate, _opts(), batch_width=W,
                                          restarts=2)
    by_path["default_rate_barrier"], res = _streaming_path(
        "e3-rate-barrier", gpu, solve, queue, FUSED_PATH, warm=W,
        check=_violation_gate, note="backend=None, the rate-form double "
        "integrator through the barrier solver: ")
    rate64 = rate_di_ocp(N, dev, f64)
    _hold_rate_f64("e3-rate-barrier", res,
                   refs.raw("e3-rate-barrier", "rate_barrier"), rate64, queue)
    _derived_kernels("rate_barrier", "barrier", ocps["rate_barrier"],
                     _barrier_ocp(rate64, "streaming"), res,
                     torch.as_tensor(queue[1], device=dev), alphas, err,
                     k2_rows, k3_rows)
    for key, launches in by_path.items():
        if launches["riccati_backward"]:
            raise AssertionError(f"{key} launched K1")
    return by_path


def _new_ops_paths(dev, gpu, refs, ocps, alphas, err, k2_rows, k3_rows, W,
                   N, M):
    """(e4) and (f); returns (e4)'s launches."""
    from mpc_verde_tpu_torch import make_streaming_solver

    f64 = torch.float64
    f32 = dict(dtype=torch.float32, device=dev)
    t = lambda a: torch.as_tensor(a, **f32).contiguous()
    # (e4) the obstacle OCP over phase 22's starts on backend=None
    ocp = ocps["obstacle"]
    _resolves_fused("e4-obstacle", ocp)
    queue = tuple(a[:M] for a in _queue(QUEUE, N))
    solve = make_streaming_solver(ocp, _opts(), batch_width=W, restarts=2)
    launches, res = _streaming_path(
        "e4-obstacle", gpu, solve, queue, FUSED_PATH, warm=W,
        note="backend=None, the bench OCP with speed saturation (tanh) and a "
        "soft obstacle (softplus): ")
    if launches["riccati_backward"]:
        raise AssertionError("e4-obstacle launched K1")
    (cx, cy), r = OBSTACLE["centre"], OBSTACLE["radius"]
    xy = res.xs[..., :2].double()
    dist = torch.hypot(xy[..., 0] - cx, xy[..., 1] - cy)
    closest = dist.argmin(-1)
    rows = torch.arange(M, device=dev)
    side = (xy[rows, closest, 0] - cx) > (xy[rows, closest, 1] - cy)
    d = dist.min(-1).values
    print(f"[e4-obstacle] closest approach to the disc's centre: min "
          f"{float(d.min()):.4f}, median {float(d.median()):.4f}, max "
          f"{float(d.max()):.4f} (radius {r}); inside the disc in "
          f"{float((d < r).float().mean()):.4f} of the answers; passed below "
          f"the centre (x - cx > y - cy) in {float(side.float().mean()):.4f}",
          flush=True)
    _hold_rate_f64("e4-obstacle", res, refs.raw("e4-obstacle", "obstacle"),
                   obstacle_ocp(dev, f64, N), queue, share_gate=0.0)
    row2, row3 = _traced_user_kernels(
        "obstacle", ocp, obstacle_ocp(dev, f64, N), SimpleNamespace(
            xs=res.xs[:W], us=res.us[:W]), t(queue[0][:W]), t(queue[1][:W]),
        alphas, err)
    k2_rows.append(row2)
    k3_rows.append(row3)

    # (f) the ops OCP, K2 and K3 against their twins (on the evaluator of
    # its program: torch.func cannot differentiate torch's huber_loss twice)
    # on random trajectories and gains, as phase 10 holds its cases
    rng = np.random.default_rng(65)
    ps = t(np.broadcast_to(op_params(W)[:, None], (W, N + 1, 4)))
    xs = t(rng.uniform(-1.5, 1.5, (W, N + 1, 3)))
    us = t(rng.uniform(-0.9, 0.9, (W, N, 2)))
    ops64 = ops_ocp(dev, f64, N)
    row2, row3 = _traced_user_kernels(
        "ops", ocps["ops"], ops64, SimpleNamespace(xs=xs, us=us),
        xs[:, 0].contiguous(), ps, alphas, err,
        twins=(evaluator_ocp(ocps["ops"]), evaluator_ocp(ops64)))
    k2_rows.append(row2)
    k3_rows.append(row3)
    return {"default_obstacle": launches}


def phase_traced(dev, gpu, ref_main, refs, M=TRACED_QUEUE, W=WIDTH,
                 N=BENCH_N, B=USER_B):
    """Phase 23 (see the module docstring); returns the paths' launches and
    the traced rows of K2 and K3."""
    from mpc_verde_tpu_torch import (make_batched_ilqr_solver,
                                     make_streaming_solver)
    from mpc_verde_tpu_torch.interop import bench_ocp
    from mpc_verde_tpu_torch.ops.cuda.build import traced_library_path
    from mpc_verde_tpu_torch.ops.cuda.rollout import (TracedDeviceModel,
                                                      kernel_model,
                                                      traced_device_model)
    from mpc_verde_tpu_torch.solver.batched import _augment_ocp_al

    t_phase = time.perf_counter()
    ocps = traced_ocps(dev, N)
    for name, ocp in ocps.items():
        t0 = time.perf_counter()
        program = traced_device_model(ocp).program
        built = traced_library_path(program).is_file()
        print(f"[traced] {name}: traced on the card in "
              f"{time.perf_counter() - t0:.2f} s, {len(program.ops)} "
              f"instructions, {program.n_table} table entries; its library "
              f"built in phase 2: {built}", flush=True)
        if not built:   # phase 2 traced it on the CPU: one text, one library
            raise AssertionError(f"traced-{name}: the trace on the card is "
                                 "not the trace on the CPU")

    # (a) K2 and K3 against the hand-written unicycle model
    rows, err = _traced_vs_hand(dev, W, N)
    k2_rows, k3_rows = [rows[0]], [rows[1]]

    # (g) K2's variants at the quadrotor cell's width on its traced model:
    # the line search and the pre-roll
    from mpc_verde_tpu_torch.utils.tune_launch_plans import _width_args
    quad = quadrotor_cell_ocp(N, dev)
    for A in (8, 1):
        *wide, alphas_w = _width_args(dev, "quadrotor", CELL_WIDTH, N, A)
        k2_rows.append(_k2_at_width(
            "quadrotor cell" + (" pre-roll" if A == 1 else ""), quad, wide,
            alphas_w, _program_flops(quad)[0], QUADROTOR_AT_WIDTH[A]))
        del wide

    # (b) the bench OCP from its callables over phase 22's queue
    by_path = {}
    bare = ocps["bench"]
    queue = tuple(a[:M] for a in _queue(QUEUE, N))
    t = lambda a: torch.as_tensor(a, device=dev)
    ref = SimpleNamespace(converged=ref_main.converged[:M],
                          cost=ref_main.cost[:M], us=ref_main.us[:M])
    # (e1): backend=None on it is the traced "cuda_fused"
    _resolves_fused("e1-bench", bare)
    for key, backend, path in (("default_bench", None, FUSED_PATH),
                               ("traced_cuda", "cuda", CUDA_PATH)):
        solve = make_streaming_solver(bare, _opts(), backend=backend,
                                      batch_width=W, restarts=2)
        if not isinstance(kernel_model(bare), TracedDeviceModel):
            raise AssertionError("traced-bench: not on the traced model")
        by_path[key], res = _streaming_path(
            key, gpu, solve, queue, path, warm=W,
            note=f"streaming on the traced bench OCP, backend={backend} "
            f"W={W}: ")
        other = "riccati_backward" if path == FUSED_PATH else "fused_backward"
        if by_path[key][other]:
            raise AssertionError(f"{key} launched {other}")
        _hold_optima(f"{key} vs phase 5", res, ref,
                     bench_ocp(N, dev, torch.float64), t(queue[0]),
                     t(queue[1]), BW_COST_TOL)

    # (c) the user OCPs on "cuda_fused", K2 and K3 held along their answers
    alphas = tuple(0.4 ** i for i in range(_opts().n_alphas))
    for name in USER_OCPS:
        uocp = ocps[name]
        solve = make_batched_ilqr_solver(uocp, _opts(), backend="cuda_fused")
        x0, ps, us0 = user_queue(name, B)
        res, wall, by_path[f"traced_{name}"] = _traced_path(
            f"traced-{name}", gpu, lambda: solve(x0, ps, us0), FUSED_PATH,
            uocp)
        if not all(bool(torch.isfinite(getattr(res, k)).all())
                   for k in ("xs", "us", "cost")):
            raise AssertionError(f"traced-{name}: non-finite results")
        conv = float(res.converged.float().mean())
        band = USER_JAX_BAND[name]
        cpu = refs.raw(f"traced-{name}", f"user_{name}")
        gap, both = _rel_cost_gap(
            SimpleNamespace(converged=res.converged[:USER_HOLD],
                            cost=res.cost[:USER_HOLD]),
            SimpleNamespace(converged=torch.as_tensor(cpu["converged"]),
                            cost=torch.as_tensor(cpu["cost"])))
        print(f"[traced-{name}] (nx, nu) = ({uocp.nx}, {uocp.nu}), B={B} "
              f"N={N} on \"cuda_fused\": {wall:.3f} s, converged_frac "
              f"{conv:.4f} (JAX float32 on the CPU {band}, gate "
              f"{band - 0.01:.4f}), mean_iterations "
              f"{float(res.iterations.double().mean()):.3f}; against CPU "
              f"float64 over {USER_HOLD}: both converged {both:.4f}, max rel "
              f"cost gap {gap:.3e} (tol {BW_COST_TOL})", flush=True)
        if not conv >= band - 0.01 or not gap <= BW_COST_TOL:
            raise AssertionError(f"traced-{name}: converged_frac {conv}, "
                                 f"gap {gap}")
        f32 = dict(dtype=torch.float32, device=dev)
        row2, row3 = _traced_user_kernels(
            name, uocp, user_ocp(name, dev, torch.float64), res,
            torch.as_tensor(x0, **f32).contiguous(),
            torch.as_tensor(ps, **f32).contiguous(), alphas, err)
        k2_rows.append(row2)
        k3_rows.append(row3)

    # (d) the state box y <= AL_Y_MAX on the bench OCP from its callables:
    # the AL-derived OCP, traced; phase 12's setup on the first M starts
    al = dataclasses.replace(
        bench_ocp(N, dev, torch.float32, x_ub=[np.inf, AL_Y_MAX, np.inf]),
        device_model=None)
    solve = make_streaming_solver(al, _opts(al_iters=AL_ITERS),
                                  backend="cuda_fused", batch_width=W,
                                  restarts=2)
    by_path["traced_al"], res = _streaming_path(
        "traced-al", gpu, solve, queue, FUSED_PATH,
        check=lambda r: _al_gate(r, "traced-al"),
        note="the AL-derived OCP of the bench OCP's callables: ")
    if by_path["traced_al"]["riccati_backward"]:
        raise AssertionError("traced-al launched K1")
    al64 = dataclasses.replace(bench_ocp(N, dev, torch.float64, x_ub=[
        np.inf, AL_Y_MAX, np.inf]), device_model=None)
    _derived_kernels("bench_al", "al", ocps["bench_al"], _augment_ocp_al(al64),
                     res, t(queue[1]), alphas, err, k2_rows, k3_rows)

    # (e2), (e3): the default path on the rate-form models' derived OCPs
    by_path.update(_default_rate_paths(dev, gpu, refs, ocps, alphas, err,
                                       k2_rows, k3_rows, W, N))
    # (e4), (f): the ops beside the arithmetic and sin, cos, tan, exp, log
    by_path.update(_new_ops_paths(dev, gpu, refs, ocps, alphas, err, k2_rows,
                                  k3_rows, W, N, M))
    print(f"[traced] phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return by_path, k2_rows, k3_rows, err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    from mpc_verde_tpu_torch.ops.cuda.build import build, load_library
    from mpc_verde_tpu_torch.ops.cuda.riccati import HELD_SIZES
    from mpc_verde_tpu_torch.utils import gpu_info

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    info = gpu_info()
    gpu = info["nvidia_smi"]
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: "
          f"{gpu} | torch {torch.__version__} CUDA "
          f"{info['torch_cuda']} | {info['nvcc']}", flush=True)

    # phase 20 launches no kernel: it runs while the kernels build, the
    # kernels library and K1 at every size phase 3 holds, every nvcc process
    # started together
    t0 = time.perf_counter()
    outcome = {}

    def run_build():
        try:
            outcome["built"] = build(HELD_SIZES, traced_programs())
        except BaseException as exc:   # raised below, in the main thread
            outcome["error"] = exc

    build_thread = threading.Thread(target=run_build)
    build_thread.start()
    try:
        compat = phase_compat(dev, gpu)
    finally:
        build_thread.join()
    if "error" in outcome:
        raise outcome["error"]
    load_library()
    for name, built in outcome["built"].items():
        per_source = " ".join(line[3:] for line in built.log.splitlines()
                              if line.startswith("== ") and "(" in line)
        print(f"[build] {name} {built.path.name}: nvcc and link "
              f"{built.seconds:.1f} s ({per_source})", flush=True)
    print(f"[build] every library built and the kernels library loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for built in outcome["built"].values():
        for line in _ptxas_summary(built.log):
            print(f"[build] ptxas {line}", flush=True)

    from mpc_verde_tpu_torch.utils.profiling import counters

    built_before = counters()["traced_builds"]
    refs = CpuReferences(CIRC_HOLD_STEPS, LC_HOLD, LC_START)
    try:
        kernels = _phases(dev, gpu, refs, compat)
    finally:
        refs.stop()
    print(f"[build] traced libraries built after phase 2: "
          f"{counters()['traced_builds'] - built_before} (each a program "
          "phase 2 did not build)", flush=True)
    print(f"[total] chip_smoke wall {time.perf_counter() - t_start:.1f} s "
          f"of its {WALL_LIMIT_S} s limit", flush=True)
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _phases(dev, gpu, refs, compat):
    """Phases 3-19, the hold of phase 20 (``compat``: what
    ``phase_compat`` returned), phases 21 to 23; returns the kernels' JSON
    entries."""
    meas = {"riccati_backward": phase_k1(dev),
            "linesearch_forward": phase_k2(dev)}
    phase_rebase(dev)
    phase_refill(dev)
    by_path = {}
    by_path["main"], res_main = phase_main(dev, gpu)
    phase_cross(dev)
    meas["fused_backward"] = phase_k3(dev)
    by_path["main_fused"], res_fused = phase_main_fused(dev, gpu, res_main)
    by_path["fleet"] = phase_fleet(dev, gpu)
    terms = phase_terms(dev)
    for name, t in terms.items():
        meas[name]["terms"] = t
    by_path.update(phase_ipm(dev, gpu, res_main))
    by_path.update(phase_al(dev, gpu))
    by_path.update(phase_circular(dev, gpu, refs))
    by_path.update(phase_diffdrive(dev, gpu))
    for phase in (phase_lanechange, phase_pendulum_dynamic):
        paths, _ = phase(dev, gpu)
        by_path.update(paths)
    by_path.update(phase_frenet_curvature(dev, gpu, refs)[0])
    t0 = time.perf_counter()
    queue = _queue(QUEUE, BENCH_N)
    paths, meas["riccati_backward"]["scan_crossover"] = phase_scan(dev, gpu,
                                                                   queue)
    by_path.update(paths)
    by_path.update(phase_solvers(dev, gpu, queue, res_fused, refs))
    paths, nlpsol_ms, first = compat
    hold_compat(first, refs)
    by_path.update(paths)
    print(f"[18-19] phases 18-19 and the hold of 20 wall "
          f"{time.perf_counter() - t0:.1f} s; nlpsol {nlpsol_ms:.1f} ms a "
          "call", flush=True)
    by_path.update(phase_host(dev, gpu, refs, meas))
    paths, meas["riccati_backward"]["bw_cases"] = phase_bw(dev, gpu, res_main,
                                                           refs)
    by_path.update(paths)
    paths, k2_rows, k3_rows, err = phase_traced(dev, gpu, res_main, refs)
    by_path.update(paths)
    for name, rows in (("linesearch_forward", k2_rows),
                       ("fused_backward", k3_rows)):
        meas[name]["traced_cases"] = rows
        meas[name]["max_abs_err"] = max(meas[name]["max_abs_err"], err[name])

    # launches: K1 and K2 on the main path (phase 5), K3 on this slice's
    # entry point, the fleet; every path's counts are in launches_by_path
    count_in = {"riccati_backward": "main", "linesearch_forward": "main",
                "fused_backward": "fleet"}
    kernels = []
    for name, m in meas.items():
        source, replaces = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": by_path[count_in[name]][name], **m,
                        "launches_by_path": {p: c[name]
                                             for p, c in by_path.items()},
                        "launches_by_variant": {
                            p: {k.split(".")[1]: n for k, n in c.items()
                                if k.startswith(name + ".")}
                            for p, c in by_path.items()}})
    return kernels


FIRST_BUILD = ("lane_al", "rate_barrier", "obstacle")


def _first_build_child(name):
    """In a process of its own, after CUDA's start: (e2)'s, (e3)'s or
    (e4)'s default path as a user's first use of it, make the solver (the
    factory's trace, the process's first), then solve the queue twice;
    prints {"factory_s", "first_solve_s", "solve_s"} as JSON."""
    from mpc_verde_tpu_torch import (make_streaming_barrier_solver,
                                     make_streaming_solver)

    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if name == "lane_al":
        solve = make_streaming_solver(lane_box_ocp(dev),
                                      _opts(al_iters=AL_ITERS),
                                      batch_width=WIDTH, restarts=2)
        queue = lane_box_queue(WIDTH)
    elif name == "obstacle":
        solve = make_streaming_solver(obstacle_ocp(dev), _opts(),
                                      batch_width=WIDTH, restarts=2)
        queue = _queue(WIDTH, BENCH_N)
    else:
        solve = make_streaming_barrier_solver(rate_di_ocp(BENCH_N, dev),
                                              _opts(), batch_width=WIDTH,
                                              restarts=2)
        queue = rate_di_queue(WIDTH)
    out = {"factory_s": time.perf_counter() - t0}
    for key in ("first_solve_s", "solve_s"):
        t0 = time.perf_counter()
        solve(*queue, max_iters=60, restarts_n=2)
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


def first_build_times() -> int:
    """``python3 chip_smoke.py --first-build``: the one-time cost of a new
    program text on the default path.  For (e2)'s and (e3)'s derived
    programs and (e4)'s, remove the program's library and run the first use
    in a fresh process (cold: nvcc builds the library), then again (warm:
    the library is loaded from mpc_verde_tpu_torch/_build/); the kernels
    library must be built already (a run of the script)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    from mpc_verde_tpu_torch.ops.cuda.build import traced_library_path

    programs = traced_programs()
    names = list(traced_ocps("cpu"))
    for name in FIRST_BUILD:
        path = traced_library_path(programs[names.index(name)])
        path.unlink(missing_ok=True)
        for run in ("cold", "warm"):
            child = subprocess.run(
                [sys.executable, __file__, "--first-build-child", name],
                capture_output=True, text=True, check=True)
            t = json.loads(child.stdout.strip().splitlines()[-1])
            print(f"[first-build] {name} {run}: the factory (its trace, the "
                  f"process's first) {t['factory_s']:.2f} s, first solve "
                  f"{t['first_solve_s']:.2f} s, next solve {t['solve_s']:.2f} "
                  f"s; library {path.name} present after: {path.is_file()}",
                  flush=True)
            if not path.is_file():
                raise AssertionError(f"{name}: the first use built another "
                                     "library than phase 2's")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--first-build-child"]:
        _first_build_child(sys.argv[2])
        sys.exit(0)
    sys.exit(first_build_times() if sys.argv[1:] == ["--first-build"]
             else main())
