"""Multiple-shooting (lifted, infeasible-start) solver: feasibility-gap DDP.

Port of ``mpc_verde_tpu.solver.multiple_shooting``.  The state trajectory
is an iterate that need not satisfy the dynamics; each backward pass
processes the defect ``d_k = F(x_k, u_k) - x_{k+1}`` through the
value-function recursion (``Vx_eff = Vx + Vxx d_k``), and the forward pass
contracts the gaps with the step length (a step alpha leaves ``(1 - alpha)
d``).  The stage QPs are the exact box QPs of the single-shooting solver
(``_stage_boxqp_with_gain``); a step is accepted on the merit ``cost +
ms_merit_weight * max |gap|``.

The core is batch-major (``make_batched_ms_solver``, the counterpart of
``jax.vmap`` over the JAX solve): every problem of the batch runs the JAX
single-problem iteration, and a problem whose loop has ended keeps its
state.  ``make_ms_solver`` is that core at B = 1.  It runs in plain PyTorch
on the OCP's device: K1 has no gap term and K2 no gap contraction, and the
JAX package runs this solver in XLA.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import vmap

from ..ocp.spec import OCP
from ..ops.linearize import trajectory_derivatives
from .batched import (_as_tensor, _bcast, _broadcast_params,
                      _trajectory_cost)
from .ilqr import ILQROptions, ILQRResult, _stage_boxqp_with_gain

_STAGE_KEYS = ("fx", "fu", "lx", "lu", "lxx", "luu", "lux")


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _backward(opt: ILQROptions, d, gN, HN, dlb, dub, gaps, reg, ddp_scale):
    """Gap-aware Riccati recursion with exact stage box QPs, over (B, N)
    stage derivatives; returns (kffs, Ks, dV1, dV2, gmax)."""
    B, N, nu = dlb.shape
    nx = gN.shape[-1]
    dt, dev = gN.dtype, gN.device
    rg = reg[:, None, None] * torch.eye(nu, dtype=dt, device=dev)
    ds = ddp_scale[:, None, None]
    Vx, Vxx = gN, HN
    dV1 = torch.zeros((B,), dtype=dt, device=dev)
    dV2 = torch.zeros_like(dV1)
    gmax = torch.zeros_like(dV1)
    kffs = torch.empty((B, N, nu), dtype=dt, device=dev)
    Ks = torch.empty((B, N, nu, nx), dtype=dt, device=dev)
    for k in reversed(range(N)):
        fx, fu, lx, lu, lxx, luu, lux = (d[n][:, k] for n in _STAGE_KEYS)
        lo, hi = dlb[:, k], dub[:, k]
        fxT, fuT = fx.transpose(-1, -2), fu.transpose(-1, -2)
        # the next-state value gradient at the gap-shifted point
        Vx_eff = Vx + _mv(Vxx, gaps[:, k])
        Qx = lx + _mv(fxT, Vx_eff)
        Qu = lu + _mv(fuT, Vx_eff)
        Qxx = lxx + fxT @ Vxx @ fx
        Quu = luu + fuT @ Vxx @ fu + rg
        Qux = lux + fuT @ Vxx @ fx
        if opt.use_ddp:
            fxx, fux, fuu = d["fxx"][:, k], d["fux"][:, k], d["fuu"][:, k]
            Qxx = Qxx + ds * torch.einsum("bi,bijk->bjk", Vx_eff, fxx)
            Qux = Qux + ds * torch.einsum("bi,bijk->bjk", Vx_eff, fux)
            Quu = Quu + ds * torch.einsum("bi,bijk->bjk", Vx_eff, fuu)
        kff, K, _ = _stage_boxqp_with_gain(Quu, Qu, Qux, lo, hi, opt.boxqp_tol)
        dV1 = dV1 + (kff * Qu).sum(-1)
        dV2 = dV2 + 0.5 * (_mv(Quu.transpose(-1, -2), kff) * kff).sum(-1)
        KT, QuxT = K.transpose(-1, -2), Qux.transpose(-1, -2)
        Vx_n = Qx + _mv(KT @ Quu, kff) + _mv(KT, Qu) + _mv(QuxT, kff)
        Vxx_n = Qxx + KT @ Quu @ K + KT @ Qux + QuxT @ K
        pg = -torch.clamp(-Qu, lo, hi)
        gmax = torch.maximum(gmax, pg.abs().amax(-1))
        Vx, Vxx = Vx_n, 0.5 * (Vxx_n + Vxx_n.transpose(-1, -2))
        kffs[:, k] = kff
        Ks[:, k] = K
    return kffs, Ks, dV1, dV2, gmax


def _forward(ocp: OCP, x0s, xs, us, ps, gaps, kffs, Ks, alphas):
    """Gap-contracting rollouts of every alpha at once: the candidate
    trajectories (A, B, ...) and costs (A, B)."""
    B, N, nu = us.shape
    A = alphas.shape[0]
    F, l = vmap(ocp.dynamics), vmap(ocp.stage_cost)
    cbv = (None if ocp.control_bounds is None
           else vmap(ocp.control_bounds, in_dims=(0, 0, None)))
    rep = lambda t: t.expand((A,) + t.shape).reshape((A * B,) + t.shape[1:])
    al = alphas.repeat_interleave(B)[:, None]
    x = rep(x0s)
    xs_c, us_c, cs = [x], [], []
    for k in range(N):
        p = rep(ps[:, k])
        u = rep(us[:, k]) + al * rep(kffs[:, k]) + _mv(
            rep(Ks[:, k]), x - rep(xs[:, k]))
        if cbv is not None:
            lb, ub = cbv(x, p, k)
            u = torch.clamp(u, lb, ub)
        us_c.append(u)
        cs.append(l(x, u, p))
        x = F(x, u, p) - (1.0 - al) * rep(gaps[:, k])
        xs_c.append(x)
    cost = torch.stack(cs, dim=-1).sum(-1)
    if ocp.terminal_cost is not None:
        cost = cost + vmap(ocp.terminal_cost)(x, rep(ps[:, N]))
    shape = lambda t: t.reshape((A, B) + t.shape[1:])
    return (shape(torch.stack(xs_c, 1)), shape(torch.stack(us_c, 1)),
            cost.reshape(A, B))


def make_batched_ms_solver(ocp: OCP, options: ILQROptions = ILQROptions()):
    """Build ``solve(x0s, params, us_init, xs_init) -> ILQRResult`` over a
    batch: x0s (B, nx), params (B, N+1, npar) (or the broadcast forms of the
    batched solver), us_init (B, N, nu), xs_init (B, N+1, nx); None
    defaults are zero controls and the constant-x0 lifted states.

    ``max_violation`` carries the final dynamics-defect gap, as in the JAX
    solver (which rejects state-bounded OCPs, so the field is otherwise
    unused).
    """
    if ocp.has_state_bounds:
        raise NotImplementedError("state bounds: use make_ilqr_solver (AL)")
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    opt = options
    z = dict(dtype=ocp.dtype, device=ocp.device)
    Fv = vmap(vmap(ocp.dynamics))
    alphas = opt.alpha_decay ** torch.arange(opt.n_alphas, **z)

    def gaps_of(xs, us, ps):
        return Fv(xs[:, :N], us, ps[:, :N]) - xs[:, 1:]

    def merit(c, g):
        return c + opt.ms_merit_weight * g

    def step(x0s, ps, carry):
        xs, us, cost, gap, reg, it, done, gnorm, stall, fail, ddp_on = carry
        B = x0s.shape[0]
        d_gap = gaps_of(xs, us, ps)
        der, gN, HN, dlb, dub = trajectory_derivatives(
            ocp, xs, us, ps, second_order=opt.use_ddp)
        kffs, Ks, dV1, dV2, gmax = _backward(opt, der, gN, HN, dlb, dub,
                                             d_gap, reg, ddp_on.to(cost.dtype))
        xs_c, us_c, costs_c = _forward(ocp, x0s, xs, us, ps, d_gap, kffs, Ks,
                                       alphas)
        # by construction of the rollout the candidate defect is exactly
        # (1 - alpha) * d: no dynamics re-evaluation
        gaps_c = (1.0 - alphas)[:, None] * d_gap.abs().reshape(B, -1).amax(-1)
        merits = merit(costs_c, gaps_c)                       # (A, B)
        best = torch.argmin(merits, dim=0)                    # first minimum
        bi = torch.arange(B, device=xs.device)
        cur_merit = merit(cost, gap)
        improved = merits[best, bi] < cur_merit - 1e-12
        small_step = ((cur_merit - merits[best, bi]).abs()
                      < opt.tol_cost * (1.0 + cur_merit.abs()))
        stall_n = torch.where(improved, 0, stall + 1)
        stalled = stall_n >= opt.stall_iters
        ddp_off_now = (stalled & ddp_on
                       & (gmax > opt.tol_grad * opt.ddp_fallback_factor))
        ddp_on_n = ddp_on & ~ddp_off_now
        stall_n = torch.where(ddp_off_now, 0, stall_n)
        feasible = gap < opt.ms_gap_tol
        new_fail = (((~improved) & (reg >= opt.reg_max) & ~ddp_off_now)
                    | ~torch.isfinite(cur_merit))
        new_done = ((feasible & (gmax < opt.tol_grad))
                    | (feasible & improved & small_step)
                    | (stalled & ~ddp_off_now)
                    | new_fail)

        take = lambda old, new: torch.where(_bcast(improved, old), new, old)
        reg_n = torch.where(improved,
                            torch.clamp(reg / opt.reg_down, min=opt.reg_min),
                            torch.clamp(reg * opt.reg_up, max=opt.reg_max))
        reg_n = torch.where(ddp_off_now, opt.reg_init, reg_n)
        return (take(xs, xs_c[best, bi]), take(us, us_c[best, bi]),
                take(cost, costs_c[best, bi]), take(gap, gaps_c[best, bi]),
                reg_n, it + 1, done | new_done, gmax, stall_n,
                fail | new_fail, ddp_on_n)

    def solve(x0s, params=None, us_init=None, xs_init=None):
        x0s = _as_tensor(x0s, z).contiguous()
        B = x0s.shape[0]
        dev = x0s.device
        ps = _broadcast_params(ocp, params, B)
        us = (torch.zeros((B, N, nu), **z) if us_init is None
              else _as_tensor(us_init, z))
        xs = (x0s[:, None].expand(B, N + 1, nx) if xs_init is None
              else _as_tensor(xs_init, z))
        xs = torch.cat([x0s[:, None], xs[:, 1:]], dim=1)
        cost0 = _trajectory_cost(ocp, xs, us, ps)
        gap0 = gaps_of(xs, us, ps).abs().reshape(B, -1).amax(-1)
        flag = lambda v: torch.full((B,), v, dtype=torch.bool, device=dev)
        zi = torch.zeros((B,), dtype=torch.int32, device=dev)
        carry = (xs, us, cost0, gap0, torch.full((B,), opt.reg_init, **z),
                 zi, flag(False), torch.full((B,), torch.inf, **z), zi,
                 flag(False), flag(bool(opt.use_ddp)))
        while True:
            # a problem whose loop has ended keeps its state, as under
            # jax.vmap of the single-problem while_loop
            active = (carry[5] < opt.max_iters) & ~carry[6]
            if not bool(active.any()):
                break
            new = step(x0s, ps, carry)
            carry = tuple(torch.where(_bcast(active, old), n, old)
                          for old, n in zip(carry, new))
        xs, us, cost, gap, _, it, done, gnorm, _, fail, _ = carry
        return ILQRResult(
            xs=xs, us=us, cost=cost, grad_norm=gnorm, iterations=it,
            converged=(done & ~fail & (gap < 10 * opt.ms_gap_tol)
                       & torch.isfinite(cost)),
            max_violation=gap)

    return solve


def make_ms_solver(ocp: OCP, options: ILQROptions = ILQROptions()):
    """Build ``solve(x0, params, us_init, xs_init) -> ILQRResult`` for one
    problem: ``make_batched_ms_solver`` at B = 1, results without the batch
    axis.  ``xs_init`` is an optional (N+1, nx) lifted-state guess; it
    defaults to the constant-x0 trajectory (maximally infeasible, as the
    reference's ``repmat(state_init)``)."""
    solve_b = make_batched_ms_solver(ocp, options)
    z = dict(dtype=ocp.dtype, device=ocp.device)
    one = lambda a: None if a is None else _as_tensor(a, z)[None]

    def solve(x0, params=None, us_init=None, xs_init=None):
        res = solve_b(one(x0), params, one(us_init), one(xs_init))
        return ILQRResult(**{f.name: getattr(res, f.name)[0]
                             for f in dataclasses.fields(res)})

    return solve
