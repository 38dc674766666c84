"""Log-barrier interior-point solvers (port of ``mpc_verde_tpu.solver.ipm``).

The interior-point treatment of a box-constrained OCP: the control box
becomes the stage term ``-mu * sum(log(u - lb) + log(ub - u))``, and each
barrier subproblem is solved by the unmodified DDP iteration.  ``mu`` is
data, a per-stage parameter column after the OCP's own, so the whole
continuation mu_0 > mu_1 > ... reuses one set of parts and kernels, each
subproblem warm-started from the previous one.

* ``make_barrier_solver``: the continuation as successive batched solves on
  an OCP without the clip box, then a crossover of exact box-QP DDP
  iterations from the barrier point.
* ``make_streaming_barrier_solver``: the continuation as in-place rounds of
  the streaming solver (``rounds=``), with a final mu = 0 round that is the
  crossover, early rounds solved inexactly (``inexact_kappa``), an optional
  DDP warm start, and state bounds composed with the augmented-Lagrangian
  rounds as one product schedule.

Every derived OCP carries the derived device model
(``UnicycleDeviceModel.with_barrier`` / ``with_al``) or None, so the
``"cuda"`` backends evaluate the barrier and AL terms in the kernels.  A
derived OCP without one (any OCP's but the unicycle's) runs
``"cuda_fused"`` under the default backend on the model traced from its
own callables (``ops/cuda/trace.py``), whose terms the trace carries.

Limitations (by construction of the barrier): bounds must be constant boxes
with lb < ub strictly; move blocking and state-dependent boxes belong to the
DDP path.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence

import torch
from torch.func import vmap

from ..ocp.spec import OCP
from ..ops.cuda.rollout import trajectory_cost_torch
from ..utils.profiling import span, spanned
from .batched import (_al_cvals, _as_tensor, _augment_ocp_al,
                      _broadcast_params, _lam_update, _violation,
                      make_batched_ilqr_solver, resolve_backend)
from .ilqr import ILQROptions, ILQRResult
from .streaming import make_streaming_solver


def _constant_box(ocp: OCP):
    """The (lb, ub) tensors of a constant control box."""
    if ocp.control_bounds is None:
        raise ValueError("barrier solver needs finite control bounds; "
                         "use the DDP solvers for unconstrained problems")
    z = dict(dtype=ocp.dtype, device=ocp.device)
    zx = torch.zeros((ocp.nx,), **z)
    zp = torch.zeros((max(ocp.npar, 1),), **z)
    lb0, ub0 = ocp.control_bounds(zx, zp, 0)
    # probe every stage index plus a shifted (x, p) point: a box that varies
    # only mid-horizon must be rejected, not silently mis-solved
    probes = [(zx + 1.0, zp + 1.0, 0)] + [(zx, zp, k) for k in range(1, ocp.N)]
    for px, pp, pk in probes:
        lbk, ubk = ocp.control_bounds(px, pp, pk)
        if not (bool((lb0 == lbk).all()) and bool((ub0 == ubk).all())):
            raise ValueError(
                "barrier solver requires constant control bounds "
                "(state/stage-dependent boxes belong to the DDP path)")
    if not (bool(torch.isfinite(lb0).all()) and bool(torch.isfinite(ub0).all())
            and bool((ub0 > lb0).all())):
        raise ValueError("barrier solver requires finite boxes with lb < ub "
                         "strictly (move blocking belongs to the DDP path)")
    return lb0, ub0


def _barrier_ocp(ocp: OCP, rule: str) -> OCP:
    """The barrier OCP the solvers run on ``ocp``: params ``[p, mu]``, the
    dynamics and costs reading ``p``, the stage cost plus the barrier of
    ``ocp``'s constant control box.  Rule ``"batched"``
    (``make_barrier_solver``): ``- mu (sum(log(u - lb)) + sum(log(ub -
    u)))`` and no clip box.  Rule ``"streaming"``
    (``make_streaming_barrier_solver``): ``_barrier_term`` and the clip box
    kept.  The device model is the base one with the same barrier
    (``with_barrier``), or None."""
    lb, ub = _constant_box(ocp)
    npar = max(ocp.npar, 1)
    l, lf, F, cb = (ocp.stage_cost, ocp.terminal_cost, ocp.dynamics,
                    ocp.control_bounds)
    if rule == "batched":
        def stage_b(x, u, p):
            barrier = torch.log(u - lb).sum() + torch.log(ub - u).sum()
            return l(x, u, p[:npar]) - p[npar] * barrier

        cb_b = None
    elif rule == "streaming":
        def stage_b(x, u, p):
            return l(x, u, p[:npar]) + _barrier_term(u, lb, ub, p[npar])

        def cb_b(x, p, k):
            return cb(x, p[:npar], k)
    else:
        raise ValueError(f"unknown barrier rule {rule!r}")
    model = ocp.device_model
    if model is not None:
        model = model.with_barrier(lb.cpu().numpy(), ub.cpu().numpy(),
                                   mu_col=npar, rule=rule,
                                   clip=cb_b is not None)
    return dataclasses.replace(
        ocp, stage_cost=stage_b,
        terminal_cost=None if lf is None else (lambda x, p: lf(x, p[:npar])),
        dynamics=lambda x, u, p: F(x, u, p[:npar]), control_bounds=cb_b,
        npar=npar + 1, device_model=model)


def _rollout_cost(ocp: OCP, x0s, us, ps):
    """True cost of rolling ``us`` out from ``x0s`` (no clip), (B,)."""
    F, l = vmap(ocp.dynamics), vmap(ocp.stage_cost)
    x, cs = x0s, []
    for k in range(ocp.N):
        cs.append(l(x, us[:, k], ps[:, k]))
        x = F(x, us[:, k], ps[:, k])
    c = torch.stack(cs, dim=-1).sum(-1)
    if ocp.terminal_cost is not None:
        c = c + vmap(ocp.terminal_cost)(x, ps[:, ocp.N])
    return c


def make_barrier_solver(ocp: OCP, options: ILQROptions = ILQROptions(),
                        backend: str = "torch",
                        mu_schedule: Sequence[float] = (1.0, 1e-1, 1e-2, 1e-3,
                                                        1e-4, 1e-5, 1e-6),
                        interior_margin: float = 1e-3,
                        crossover: bool = True):
    """Build a batch-major interior-point solve for ``ocp``.

    Returns ``solve(x0s, params, us_init) -> ILQRResult`` with the calling
    convention of ``make_batched_ilqr_solver``.  ``us_init`` is projected
    ``interior_margin * (ub - lb)`` inside the box before the first barrier
    subproblem.  Each mu of ``mu_schedule`` is one batched solve of the
    barrier OCP, which has no clip box: a line-search candidate outside the
    box costs NaN (log of a negative number).  The returned ``cost`` is the
    true (barrier-free) cost of the final controls, ``iterations`` the total
    over the continuation, ``converged`` the last solve's flag.

    ``crossover=True`` finishes with exact box-QP DDP iterations from the
    barrier point, which pins active bounds exactly (nu <= 4 only; beyond
    that the pure barrier answer is returned, with a warning).

    ``backend`` is ``"torch"`` unless a kernel backend is named, as the
    JAX solver's default is ``"xla"``.
    """
    lb, ub = _constant_box(ocp)
    N, nu = ocp.N, ocp.nu
    solve_b = make_batched_ilqr_solver(_barrier_ocp(ocp, "batched"), options,
                                       backend=backend)
    mus = tuple(float(m) for m in mu_schedule)
    if crossover and nu > 4:
        warnings.warn(
            f"barrier crossover skipped: nu={nu} exceeds the exact-boxQP "
            "enumeration limit (4); returning the pure barrier optimum "
            "(~O(final mu) inside active bounds)", stacklevel=2)
    solve_x = (make_batched_ilqr_solver(ocp, options, backend=backend)
               if crossover and nu <= 4 else None)
    z = dict(dtype=ocp.dtype, device=ocp.device)

    @spanned("mpc.solve")
    def solve(x0s, params=None, us_init=None):
        with span("mpc.preroll"):
            x0s = _as_tensor(x0s, z).contiguous()
            B = x0s.shape[0]
            ps = _broadcast_params(ocp, params, B)
            if us_init is None:
                us_init = torch.zeros((B, N, nu), **z)
            margin = interior_margin * (ub - lb)
            us = torch.clamp(_as_tensor(us_init, z), lb + margin, ub - margin)
            total_it = torch.zeros((B,), dtype=torch.int32, device=ocp.device)

        res = None
        for mu in mus:
            with span("mpc.rebase"):
                mu_col = torch.full((B, N + 1, 1), mu, **z)
                ps_mu = torch.cat([ps, mu_col], dim=-1)
            res = solve_b(x0s, ps_mu, us)
            us = res.us
            total_it = total_it + res.iterations
        if solve_x is not None:
            res = solve_x(x0s, ps, us)
            us = res.us
            total_it = total_it + res.iterations
        with span("mpc.unpack"):
            return ILQRResult(
                xs=res.xs, us=us, cost=_rollout_cost(ocp, x0s, us, ps),
                grad_norm=res.grad_norm, iterations=total_it,
                converged=res.converged, max_violation=res.max_violation)

    return solve


def _barrier_term(u, lb, ub, mu):
    """Log-barrier term ``-mu * sum(log(d))``, d = [u - lb, ub - u], over the
    last axis, with the boundary rules of the streaming continuation:

      * mu > 0, u strictly inside: the ordinary barrier value;
      * mu > 0, u on or outside the box (some d <= 0): +inf, so the line
        search rejects the candidate (the sign matters: -inf would make
        saturated candidates infinitely attractive);
      * mu == 0 (the crossover round): exactly 0 with exactly zero
        derivatives, boundary included, so that round is plain box DDP.
    """
    lb = torch.as_tensor(lb, dtype=u.dtype, device=u.device)
    ub = torch.as_tensor(ub, dtype=u.dtype, device=u.device)
    if not torch.is_tensor(mu):
        mu = torch.tensor(float(mu), dtype=u.dtype, device=u.device)
    d = torch.cat([u - lb, ub - u], dim=-1)
    # d <= 0 -> log term -inf -> -mu * (-inf) = +inf (rejection); the
    # maximum keeps the untaken log finite, so its derivatives are too
    logs = torch.where(d > 0, torch.log(torch.maximum(
        d, torch.full_like(d, 1e-30))), -torch.inf)
    return torch.where(mu > 0, -mu * logs.sum(-1), 0.0)


def make_streaming_barrier_solver(
        ocp: OCP, options: ILQROptions = ILQROptions(),
        backend: Optional[str] = None,
        mu_schedule: Sequence[float] = (1e-2, 1e-4),
        interior_margin: float = 1e-3,
        batch_width: int = 2048,
        restarts: int = 0,
        refill_every: int = 1,
        inexact_kappa: float = 10.0,
        warmstart: Optional[str] = None):
    """Streaming interior-point solve: the mu continuation as in-place
    rounds of ``make_streaming_solver``.

    When a slot's barrier subproblem ends, its mu column steps down the
    schedule in place and the slot restarts fresh with its own restart
    budget, so every problem pays its own iterations per stage.  The
    schedule ends with a mu = 0 round, and the control box stays on the OCP:
    the backward pass solves exact stage box QPs throughout, and the last
    round is warm-started exact box-QP DDP (the crossover).  The barrier
    term follows ``_barrier_term``'s rules, so the last round's cost is the
    true one and an out-of-box candidate prices +inf while mu > 0.  nu <= 4
    (the box-QP enumeration limit).

    ``inexact_kappa``: the tolerances of the round at barrier parameter mu
    are scaled to ``max(kappa * mu, tol_grad)`` (tol_grad and tol_cost
    together, ``tol_scale_fn``); the mu = 0 round is strict.  0 disables.

    State bounds compose with the barrier: the AL (lam, mu_al) and barrier
    (mu) continuations advance together at every round boundary over
    ``max(len(mu_schedule) + 1, options.al_iters) + 1`` rounds, mu_al capped
    at what ``options.al_iters`` rounds of the plain AL path reach.

    ``warmstart="ddp"``: run the streaming box-DDP solver on ``ocp`` first
    and start the continuation from its controls, pulled ``interior_margin``
    inside the box; the reported iterations include that phase's.

    ``backend``: as in ``make_streaming_solver``; None (the default)
    resolves by ``resolve_backend`` on each OCP that a streaming solver
    here runs: the barrier-derived OCP (and its AL-derived one under state
    bounds), and for ``warmstart="ddp"`` the OCP itself.  On a CUDA device
    that is ``"cuda_fused"`` for a float32 OCP: on the derived device model
    where the derived OCP keeps one, else on the model traced from its
    callables (any OCP's but the unicycle's; its library built once per
    program text, at the first solve); ``"cuda_bw"`` in float64 or where
    the callables do not lower; nu > 4 raises.

    Returns ``solve(x0s, params, us_init, max_iters=None, restarts_n=None)``
    with the streaming solver's calling convention.
    """
    # raises (nu > 4 on a card) before anything is allocated on the OCP's
    # device; a None backend resolves below, on the OCPs the solvers run
    resolve_backend(ocp, backend)
    lb, ub = _constant_box(ocp)
    npar = max(ocp.npar, 1)
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    opt = options
    has_xb = ocp.has_state_bounds
    if has_xb and opt.al_iters < 1:
        raise ValueError("streaming barrier solver with state bounds needs "
                         "options.al_iters >= 1")
    if warmstart not in (None, "ddp"):
        raise ValueError(f"unknown warmstart mode {warmstart!r}; "
                         "supported: None (cold continuation), 'ddp'")
    z = dict(dtype=ocp.dtype, device=ocp.device)
    ocp_b = _barrier_ocp(ocp, "streaming")
    # the schedule's stages, then the mu = 0 crossover round
    mus = tuple(float(m) for m in mu_schedule) + (0.0,)
    n_mu = len(mus)
    mus_t = torch.tensor(mus, **z)

    def mu_column(ps, rnd):
        mu_next = mus_t[(rnd + 1).clamp(0, n_mu - 1).long()]
        return mu_next[:, None, None].expand(ps.shape[0], ps.shape[1], 1)

    if has_xb:
        # product composition with the AL continuation: params [p, mu_b,
        # lam (2 nx), mu_al], both advanced at every round boundary
        cvals = _al_cvals(ocp_b)
        ocp_run = _augment_ocp_al(ocp_b)
        nlam, npar_b = 2 * nx, npar + 1
        # one more strict round than either schedule: the interleaved lam
        # updates ride looser mid-continuation iterates
        n_rounds = max(n_mu, opt.al_iters) + 1
        # the penalty stops where options.al_iters rounds of plain AL stop
        mu_al_cap = float(opt.al_mu0 * opt.al_mu_factor ** (opt.al_iters - 1))

        def advance(ps, xs, rnd):
            lam = ps[..., npar_b:npar_b + nlam]
            mu_al = ps[..., npar_b + nlam:]
            mu_al_n = (mu_al * opt.al_mu_factor).clamp(max=mu_al_cap)
            return torch.cat([ps[..., :npar], mu_column(ps, rnd),
                              _lam_update(lam, mu_al, cvals(xs)), mu_al_n],
                             dim=-1)
    else:
        ocp_run = ocp_b
        n_rounds = n_mu

        def advance(ps, xs, rnd):
            return torch.cat([ps[..., :npar], mu_column(ps, rnd)], dim=-1)

    tol_scale_fn = None
    if inexact_kappa > 0:
        kap, tg = float(inexact_kappa), float(opt.tol_grad)

        def tol_scale_fn(ps):
            # mu is constant across a slot's stages; read stage 0
            return (kap * ps[:, 0, npar] / tg).clamp(min=1.0)

    ssolve = make_streaming_solver(
        ocp_run, options, backend=backend, batch_width=batch_width,
        restarts=restarts, refill_every=refill_every,
        rounds=(n_rounds, advance), tol_scale_fn=tol_scale_fn)
    dsolve = None
    if warmstart == "ddp":
        # the DDP phase solves the original OCP (exact box QPs; AL for any
        # state bounds)
        dsolve = make_streaming_solver(
            ocp, options, backend=backend, batch_width=batch_width,
            restarts=restarts, refill_every=refill_every)

    @spanned("mpc.solve")
    def solve(x0s, params=None, us_init=None, max_iters=None,
              restarts_n=None):
        with span("mpc.preroll"):
            x0s = _as_tensor(x0s, z).contiguous()
            M = x0s.shape[0]
            ps = _broadcast_params(ocp, params, M)
            if us_init is None:
                us_init = torch.zeros((M, N, nu), **z)
        it_warm = None
        if dsolve is not None:
            r0 = dsolve(x0s, ps, us_init, max_iters, restarts_n)
            us_init, it_warm = r0.us, r0.iterations
        with span("mpc.preroll"):
            margin = interior_margin * (ub - lb)
            us = torch.clamp(_as_tensor(us_init, z), lb + margin, ub - margin)
            cols = [ps, torch.full((M, N + 1, 1), mus[0], **z)]
            if has_xb:
                cols += [torch.zeros((M, N + 1, 2 * nx), **z),
                         torch.full((M, N + 1, 1), opt.al_mu0, **z)]
            ps_b, us = torch.cat(cols, dim=-1), us.contiguous()
        res = ssolve(x0s, ps_b, us, max_iters, restarts_n)
        with span("mpc.unpack"):
            if it_warm is not None:   # both phases' iterations
                res = dataclasses.replace(
                    res, iterations=res.iterations + it_warm)
            if not has_xb:
                return res
            # the loop's cost is the AL-augmented one at the last multipliers
            return dataclasses.replace(
                res, cost=trajectory_cost_torch(res.xs, res.us, ps, ocp=ocp),
                max_violation=_violation(cvals(res.xs)))

    return solve
