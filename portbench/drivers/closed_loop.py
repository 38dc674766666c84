"""A fleet of robots under batched receding-horizon MPC, in lockstep.

The traffic file gives ``robots`` (B, one problem each per step),
``start_box`` (positions in [-b, b]^2, headings in [-pi/2, pi/2]),
``warm_steps`` (closed-loop steps of set-up), ``check_robots_per_step``
(robots of each step kept for the reference) and ``trace`` (``skip``
steps, then ``take`` steps profiled, in a ``--trace 1`` run).  The
configuration gives the episode's length ``Nsim``.

Each step is one call of the port's closed-loop driver
(``make_batched_receding_horizon`` over ``make_batched_ilqr_solver``, one
step a call): one batched solve from the robots' states, the first
controls applied by the plant, the plans shifted into the next warm start.
Episodes run back to back, each from new starts drawn from the seed with a
cold warm start; the window closes at the first step that ends
``--seconds`` after the first began.

Readings: ``mpc_steps_per_s`` is robots x steps of the window over its wall
time (host clock, first step's start to a synchronize after the last);
``step_ms_p95`` is the 95th percentile over the window's steps of the time
between consecutive step boundaries, read from CUDA events recorded on the
stream at each boundary; ``setup_s`` runs from the process's start to the
first step's start.  The gates of the closed loop (every robot within the
reference's ball at the end of each episode that the window completed)
are compared with their limits beside the reference's numbers.
"""
from __future__ import annotations

import sys
import time

import torch

from harness import inputs
from harness.device import Clock, synchronize
from harness.trace import Traced
from harness.window import (Box, DriverOutput, kernel_launches, percentile,
                            report_raise)


def run(ctx) -> DriverOutput:
    from mpc_verde_tpu_torch import ILQROptions, make_batched_ilqr_solver
    from mpc_verde_tpu_torch.runtime import make_batched_receding_horizon

    cfg, tr, dev, seed = ctx.cell.config, ctx.cell.traffic, ctx.device, ctx.seed
    ocp = ctx.program.build_ocp(cfg, dev)
    opts = ILQROptions(**cfg["solver"])
    step = make_batched_receding_horizon(
        ocp, make_batched_ilqr_solver(ocp, opts), ctx.program.plant(cfg), 1)
    B, take, n_sim = tr["robots"], tr["check_robots_per_step"], cfg["Nsim"]
    N, nu = ocp.N, ocp.nu
    target = torch.tensor(cfg["target"], dtype=torch.float32, device=dev)
    params = target.expand(1, N + 1, target.shape[0])
    box = Box(cfg, dev)
    starts = lambda g: inputs.fleet_starts(B, tr["start_box"], g, dev)
    cold = lambda: torch.zeros((B, N, nu), dtype=torch.float32, device=dev)
    ctx.stamp("factory")

    # set-up: closed-loop steps at the window's sizes build and load the
    # kernels and fill the allocator's cache
    x, warm = starts(inputs.generator(dev, seed, "warm")), cold()
    for _ in range(tr["warm_steps"]):
        r = step(x, params, None, warm)
        x, warm = r.xs[1], r.final_warm
    synchronize(dev)
    ctx.stamp("warm_up")

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    converged, iterations, bad = zero.clone(), zero.clone(), zero.clone()
    start_gap = torch.zeros((), dtype=torch.float32, device=dev)
    finals, samples = [], []
    skip, n_traced = tr["trace"]["skip"], tr["trace"]["take"]
    traced = Traced(dev, kernel_launches) if ctx.trace else None
    clock = Clock(dev)
    steps = raised = 0
    episode, t = 0, 0
    x0 = starts(inputs.generator(dev, seed, "episode", episode))
    x, warm = x0, cold()
    t_first = time.perf_counter()
    clock.mark()
    while True:
        if traced is not None and steps == skip:
            traced.start()
        try:
            r = step(x, params, None, warm)
        except Exception:
            report_raise(f"step {steps}")
            raised += B
            break
        clock.mark()
        u0, x_next, cost = r.us[0], r.xs[1], r.costs[0]
        plan = torch.cat([u0[:, None], r.final_warm[:, :-1]], dim=1)
        if t == 0:
            start_gap = torch.maximum(start_gap, (r.xs[0] - x0).abs().max())
        converged += r.converged.sum()
        iterations += r.iterations.max()
        bad += box.faults(plan, x_next, cost).sum()
        idx = inputs.sample_rows(
            B, take, inputs.generator(dev, seed, "check", steps), dev)
        samples.append({"x": x[idx], "plan": plan[idx], "cost": cost[idx],
                        "x_next": x_next[idx]})
        steps, t = steps + 1, t + 1
        if traced is not None and traced.running():
            traced.calls += 1
            if traced.calls == n_traced:
                traced.stop()
        x, warm = x_next, r.final_warm
        del r
        if t == n_sim:
            finals.append(x)
            episode, t = episode + 1, 0
            x0 = starts(inputs.generator(dev, seed, "episode", episode))
            x, warm = x0, cold()
        if time.perf_counter() - t_first >= ctx.seconds:
            break
    synchronize(dev)
    t_end = time.perf_counter()
    if traced is not None:
        traced.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    del step
    step_ms = clock.intervals_ms()

    gates = {"episodes": len(finals), "start_gap": float(start_gap),
             "converged_share": int(converged) / max(B * steps, 1)}
    if finals:
        err = torch.stack([torch.linalg.vector_norm(
            f[:, :2].double() - target[:2].double(), dim=-1) for f in finals])
        gates.update(final_err_max=float(err.max()),
                     final_err_p99=float(torch.quantile(err, 0.99, dim=1).max()),
                     final_err_mean=float(err.mean(dim=1).max()))
    metrics = {"mpc_steps_per_s": B * steps / (t_end - t_first),
               "setup_s": t_first - ctx.t_start}
    if step_ms:
        metrics["step_ms_p95"] = percentile(step_ms, 95)
    print(f"portbench: {steps} steps in {t_end - t_first:.3f} s, "
          f"{sum(step_ms) / 1e3:.3f} s between their boundaries by the "
          f"device's clock", file=sys.stderr)
    trace = None
    if traced is not None and traced.launches is not None:
        trace = dict(traced.read(), calls=traced.calls, rows_per_call=B,
                     width=B,
                     N=N, A=opts.n_alphas, nx=ocp.nx, nu=nu, npar=ocp.npar,
                     terms=[])
    return DriverOutput(
        kind="fleet", metrics=metrics, attempted=B * steps + raised,
        failed=int(bad) + raised,
        counts={"steps": steps, "robot_steps": B * steps,
                "converged": int(converged),
                "loop_iterations": int(iterations)},
        sample={k: torch.cat([s[k] for s in samples]) for k in samples[0]}
        if samples else {},
        gates=gates, tail_ms=step_ms, trace=trace, memory_peak_bytes=peak,
        setup_parts=ctx.setup_parts(t_first))
