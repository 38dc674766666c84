"""Queues of independent solves, one call after another.

The traffic file gives ``solver`` (``streaming``: ``make_streaming_solver``;
``streaming_barrier``: ``make_streaming_barrier_solver``; ``batched``:
``make_batched_ilqr_solver``), its ``width`` (resident slots of a
streaming solver), ``restarts`` and ``inexact_kappa`` where they apply,
``rows_per_call`` (the queue or batch one call solves), ``start_box``
(starts uniform in [-b, b]^nx), ``check_rows_per_call`` (answers of each
call kept for the reference) and ``trace`` (``skip`` calls, then ``take``
calls profiled, in a ``--trace 1`` run).  Every call solves new starts
drawn from the seed and waits for its answers; the window closes at the
end of the first call that ends ``--seconds`` after the first began.

Readings: ``solves_per_s`` counts the converged solves of the window over
the wall time from the first call's start to the last call's end;
``batch_ms_p90`` is the 90th percentile of the calls' times, each read from
CUDA events recorded on the stream at the call's start and end (a call, of
about 135 ms, is shorter than the 250 ms that a time on the host's clock
needs); ``setup_s`` runs from the process's start to the first call's
start.
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


def _solver(ocp, opts, traffic: dict):
    """(solve, npar of the OCP the kernels run, the model's extra terms)."""
    from mpc_verde_tpu_torch import (make_batched_ilqr_solver,
                                     make_streaming_barrier_solver,
                                     make_streaming_solver)

    kind = traffic["solver"]
    if kind == "streaming":
        return make_streaming_solver(
            ocp, opts, batch_width=traffic["width"],
            restarts=traffic["restarts"]), ocp.npar, ()
    if kind == "streaming_barrier":
        return make_streaming_barrier_solver(
            ocp, opts, batch_width=traffic["width"],
            restarts=traffic["restarts"],
            inexact_kappa=traffic["inexact_kappa"]), ocp.npar + 1, ("barrier",)
    if kind == "batched":
        return make_batched_ilqr_solver(ocp, opts), ocp.npar, ()
    raise ValueError(f"unknown solver {kind!r}")


def run(ctx) -> DriverOutput:
    from mpc_verde_tpu_torch import ILQROptions

    cfg, tr, dev, seed = ctx.cell.config, ctx.cell.traffic, ctx.device, ctx.seed
    ocp = ctx.program.build_ocp(cfg, dev)
    opts = ILQROptions(**cfg["solver"])
    solve, npar, terms = _solver(ocp, opts, tr)
    M, take = tr["rows_per_call"], tr["check_rows_per_call"]
    N, nx = ocp.N, ocp.nx
    target = torch.tensor(cfg["target"], dtype=torch.float32,
                          device=dev).expand(N + 1, len(cfg["target"]))
    box = Box(cfg, dev)
    starts = lambda g: inputs.queue_starts(M, nx, tr["start_box"], g, dev)
    ctx.stamp("factory")

    # set-up: one call at the window's sizes builds and loads the kernels
    # and fills the allocator's cache
    solve(starts(inputs.generator(dev, seed, "warm")), target)
    synchronize(dev)
    ctx.stamp("warm_up")

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    converged, iterations, bad = zero.clone(), zero.clone(), zero.clone()
    attempted = raised = 0
    durations, samples = [], []
    skip, n_traced = tr["trace"]["skip"], tr["trace"]["take"]
    traced = Traced(dev, kernel_launches) if ctx.trace else None
    clock = Clock(dev)   # marks at each call's start and end
    t_first = None
    while True:
        i = len(durations)
        x0 = starts(inputs.generator(dev, seed, "call", i))
        if traced is not None and i == skip:
            traced.start()
        t0 = time.perf_counter()
        t_first = t0 if t_first is None else t_first
        clock.mark()
        try:
            r = solve(x0, target)
            clock.mark()
            synchronize(dev)
        except Exception:
            report_raise(f"call {i}")
            attempted, raised = attempted + M, raised + M
            t_end = time.perf_counter()
            break
        t_end = time.perf_counter()
        durations.append(t_end - t0)
        if traced is not None and traced.running():
            traced.calls += 1
            if traced.calls == n_traced:
                traced.stop()
        attempted += M
        converged += r.converged.sum()
        iterations += r.iterations.sum(dtype=torch.int64)
        bad += box.faults(r.us, r.xs, r.cost).sum()
        idx = inputs.sample_rows(M, take,
                                 inputs.generator(dev, seed, "check", i), dev)
        samples.append({"x0": x0[idx], "xs": r.xs[idx], "us": r.us[idx],
                        "cost": r.cost[idx]})
        del r
        if t_end - t_first >= ctx.seconds:
            break
    synchronize(dev)
    if traced is not None:
        traced.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    del solve
    n_conv = int(converged)
    tail_ms = clock.intervals_ms()[::2][:len(durations)]
    metrics = {"solves_per_s": n_conv / (t_end - t_first),
               "setup_s": t_first - ctx.t_start}
    if tail_ms:
        metrics["batch_ms_p90"] = percentile(tail_ms, 90)
    print(f"portbench: {len(durations)} calls in {t_end - t_first:.3f} s, "
          f"{sum(durations):.3f} s inside them by the host's clock, "
          f"{sum(tail_ms) / 1e3:.3f} s by the device's", file=sys.stderr)
    trace = None
    if traced is not None and traced.launches is not None:
        trace = dict(traced.read(), calls=traced.calls, rows_per_call=M,
                     width=tr.get("width", M), N=N, A=opts.n_alphas, nx=nx,
                     nu=ocp.nu, npar=npar, terms=list(terms))
    return DriverOutput(
        kind="queue", metrics=metrics, attempted=attempted,
        failed=int(bad) + raised,
        counts={"solves": attempted, "converged": n_conv,
                "iterations": int(iterations), "calls": len(durations)},
        sample={k: torch.cat([s[k] for s in samples]) for k in samples[0]}
        if samples else {},
        tail_ms=tail_ms, trace=trace, memory_peak_bytes=peak,
        setup_parts=ctx.setup_parts(t_first))
