"""General NLP solver: augmented Lagrangian + box-projected Newton.

Port of ``mpc_verde_tpu.solver.nlp``, the backend of
``compat.casadi.nlpsol``:

    min_x  f(x, p)   s.t.  lbx <= x <= ubx,  lbg <= g(x, p) <= ubg

* The ``g`` bounds enter a Powell-Hestenes-Rockafellar augmented
  Lagrangian: each one-sided constraint contributes ``(1/2mu) (max(0, lam +
  mu*c)^2 - lam^2)``; an equality row (``lbg == ubg``) gets both sides.
* The box on ``x`` stays exact in the inner solver: projected Newton with an
  active-set mask (clamped coordinates frozen, the Newton system solved on
  the free subspace by masked assembly), Levenberg regularization adapted on
  rejection, and a parallel backtracking line search over ``n_alphas`` step
  lengths.
* Derivatives are ``torch.func``: the gradient and the dense Hessian
  (forward over reverse), as the JAX solver takes them from ``jax.grad`` /
  ``jax.jacfwd``.

``solve`` takes a leading batch axis (the counterpart of ``jax.vmap`` over
the JAX solve): every problem of the batch runs the JAX iteration, and a
problem whose loop has ended keeps its state.  It runs in plain PyTorch on
the solver's device; the JAX package runs it in XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import grad, jacfwd, vmap

from ..utils.platform import scenario_device


@dataclasses.dataclass(frozen=True)
class NLPOptions:
    """Solver configuration; fields and defaults as in the JAX package."""

    max_outer: int = 25           # augmented-Lagrangian rounds
    max_inner: int = 60           # projected-Newton iterations per round
    tol: float = 1e-8             # projected-gradient (KKT) tolerance
    tol_con: float = 1e-8         # constraint-violation tolerance
    mu0: float = 10.0             # initial AL penalty
    mu_factor: float = 10.0       # escalation when violation stalls
    mu_max: float = 1e8
    viol_decrease: float = 0.25   # required per-round violation contraction
    reg_init: float = 1e-8
    reg_up: float = 10.0
    reg_down: float = 5.0
    reg_min: float = 1e-10
    reg_max: float = 1e10
    n_alphas: int = 16
    alpha_decay: float = 0.5
    active_tol: float = 1e-9      # bound-activity detection width


@dataclasses.dataclass
class NLPResult:
    x: torch.Tensor            # (B?, n) primal solution
    f: torch.Tensor            # (B?) objective at x
    g: torch.Tensor            # (B?, m) constraint values at x
    lam_g: torch.Tensor        # (B?, m) multiplier estimate (lamU - lamL)
    kkt: torch.Tensor          # projected-gradient inf-norm of the Lagrangian
    viol: torch.Tensor         # constraint violation inf-norm
    iterations: torch.Tensor   # total inner Newton iterations
    converged: torch.Tensor    # bool


def _inf_norm(v):
    """max |v| over the last axis, 0 for an empty one (as the JAX solver
    appends a zero)."""
    zero = torch.zeros(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    return torch.cat([v.abs(), zero], -1).amax(-1)


def _sel(mask, new, old):
    return torch.where(mask.reshape(mask.shape + (1,) * (old.ndim - 1)),
                       new, old)


def make_nlpsol(f: Callable, g: Optional[Callable], n: int, m: int,
                options: NLPOptions = NLPOptions(), device=None):
    """Build ``solve(x0, p, lbx, ubx, lbg, ubg) -> NLPResult``.

    Args:
      f: objective ``f(x, p) -> scalar`` on one problem's tensors.
      g: constraints ``g(x, p) -> (m,)`` or None (m must then be 0).
      n, m: sizes of x and g.
      device: the port's addition: where the solve runs; None is the CUDA
        device, and raises where there is none (pass ``device="cpu"`` for
        the CPU).  The solve is in float64, the precision the default
        tolerances are made for.

    ``solve`` takes every bound as data, +-inf disabling a side.  ``x0`` is
    (n,) or (B, n); with a batch, ``p`` is (B, np) or (np,) and the bounds
    (n,) / (m,) or with the batch axis, and every result field has it.
    """
    opt = options
    dev = scenario_device(device, "make_nlpsol")
    dtype = torch.float64
    z = dict(dtype=dtype, device=dev)
    if g is None:
        if m != 0:
            raise ValueError("g is None but m != 0")

        def g(x, p):
            return torch.zeros((0,), dtype=x.dtype, device=x.device)

    def al_value(x, p, lamL, lamU, mu, lbg, ubg):
        """PHR augmented Lagrangian (the box on x is kept by projection)."""
        gv = g(x, p)
        cl = torch.where(torch.isfinite(lbg), lbg - gv, -1.0)   # <= 0 feasible
        cu = torch.where(torch.isfinite(ubg), gv - ubg, -1.0)
        tL = torch.clamp(lamL + mu * cl, min=0.0)
        tU = torch.clamp(lamU + mu * cu, min=0.0)
        pen = (tL ** 2 - lamL ** 2).sum() + (tU ** 2 - lamU ** 2).sum()
        return f(x, p) + pen / (2.0 * mu)

    value_b = vmap(al_value)
    grad_b = vmap(grad(al_value))
    hess_b = vmap(jacfwd(grad(al_value)))
    # candidates (B, A, n) against one problem's data
    value_ba = vmap(vmap(al_value, in_dims=(0,) + (None,) * 6))
    alphas = opt.alpha_decay ** torch.arange(opt.n_alphas, **z)
    eye = torch.eye(n, **z)

    def lagrangian(x, p, lam):
        return f(x, p) + (lam * g(x, p)).sum()

    lag_grad_b = vmap(grad(lagrangian))

    def pg_norm(x, gr, lbx, ubx):
        return _inf_norm(x - torch.minimum(torch.maximum(x - gr, lbx), ubx))

    def inner_solve(x, al, lbx, ubx, tol_inner, run):
        """Projected Newton on the AL within [lbx, ubx] for the problems of
        ``run``; the others keep ``x``.  Returns (x, iterations (B,))."""
        B = x.shape[0]
        x = torch.minimum(torch.maximum(x, lbx), ubx)
        reg = torch.full((B,), opt.reg_init, **z)
        it = torch.zeros((B,), dtype=torch.int32, device=dev)
        done = ~run
        while True:
            active = (it < opt.max_inner) & ~done
            if not bool(active.any()):
                break
            L0 = value_b(x, *al)
            gr = grad_b(x, *al)
            H = hess_b(x, *al)
            at_lo = (x <= lbx + opt.active_tol) & (gr > 0)
            at_hi = (x >= ubx - opt.active_tol) & (gr < 0)
            free = (~(at_lo | at_hi)).to(x.dtype)
            # masked Newton system: clamped coordinates get identity rows
            Hm = (free[:, :, None] * H * free[:, None, :]
                  + torch.diag_embed(1.0 - free) + reg[:, None, None] * eye)
            d = -free * torch.linalg.solve_ex(Hm, free * gr)[0]
            xc = torch.minimum(torch.maximum(
                x[:, None] + alphas[:, None] * d[:, None],
                lbx[:, None]), ubx[:, None])
            Lc = value_ba(xc, *al)                              # (B, A)
            best = torch.argmin(Lc, dim=1)
            bi = torch.arange(B, device=dev)
            improved = Lc[bi, best] < L0 - 1e-16
            x_n = _sel(improved, xc[bi, best], x)
            reg_n = torch.where(improved,
                                torch.clamp(reg / opt.reg_down, min=opt.reg_min),
                                torch.clamp(reg * opt.reg_up, max=opt.reg_max))
            g_n = grad_b(x_n, *al)
            done_n = ((pg_norm(x_n, g_n, lbx, ubx) < tol_inner)
                      | (~improved & (reg >= opt.reg_max)))
            x = _sel(active, x_n, x)
            reg = torch.where(active, reg_n, reg)
            it = torch.where(active, it + 1, it)
            done = torch.where(active, done_n, done)
        return x, it

    def solve(x0, p=None, lbx=None, ubx=None, lbg=None, ubg=None):
        x0 = torch.as_tensor(x0, **z)
        single = x0.ndim == 1
        x0 = x0.reshape(-1, n)
        B = x0.shape[0]

        def data(v, size, fill):
            if v is None:
                return torch.full((B, size), fill, **z)
            v = torch.as_tensor(v, **z)
            return v.reshape(-1, size).expand(B, size) if v.numel() != 1 \
                else v.reshape(1, 1).expand(B, size)

        p = torch.zeros((B, 0), **z) if p is None else torch.as_tensor(p, **z)
        p = p.expand(B, -1) if p.ndim < 2 else p
        lbx, ubx = data(lbx, n, -torch.inf), data(ubx, n, torch.inf)
        lbg, ubg = data(lbg, m, -torch.inf), data(ubg, m, torch.inf)
        g_b = vmap(g)

        def viol_of(gv):
            vl = torch.where(torch.isfinite(lbg), lbg - gv, 0.0).clamp(min=0.0)
            vu = torch.where(torch.isfinite(ubg), gv - ubg, 0.0).clamp(min=0.0)
            return _inf_norm(torch.cat([vl, vu], -1))

        def kkt_of(x, lamL, lamU):
            # gradient of the true Lagrangian, projected on the x box
            return pg_norm(x, lag_grad_b(x, p, lamU - lamL), lbx, ubx)

        x = torch.minimum(torch.maximum(x0, lbx), ubx)
        lamL = torch.zeros((B, m), **z)
        lamU = torch.zeros((B, m), **z)
        mu = torch.full((B,), opt.mu0, **z)
        viol = torch.full((B,), torch.inf, **z)
        it = torch.zeros((B,), dtype=torch.int32, device=dev)
        rounds = torch.zeros((B,), dtype=torch.int32, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        while True:
            run = (rounds < opt.max_outer) & ~done
            if not bool(run.any()):
                break
            # the inner tolerance tightens with the penalty and with the
            # round, so unconstrained or frozen-mu problems still reach the
            # final KKT tolerance
            if m == 0:
                tol_inner = torch.full((B,), opt.tol, **z)
            else:
                tol_inner = torch.clamp(
                    (1e-3 / (mu * mu)) * 0.1 ** rounds.to(dtype), min=opt.tol)
            x_n, it_in = inner_solve(x, (p, lamL, lamU, mu, lbg, ubg), lbx,
                                     ubx, tol_inner, run)
            gv = g_b(x_n, p)
            cl = torch.where(torch.isfinite(lbg), lbg - gv, -1.0)
            cu = torch.where(torch.isfinite(ubg), gv - ubg, -1.0)
            lamL_n = torch.clamp(lamL + mu[:, None] * cl, min=0.0)
            lamU_n = torch.clamp(lamU + mu[:, None] * cu, min=0.0)
            viol_n = viol_of(gv)
            mu_n = torch.where(viol_n > opt.viol_decrease * viol,
                               torch.clamp(mu * opt.mu_factor, max=opt.mu_max),
                               mu)
            kkt = kkt_of(x_n, lamL_n, lamU_n)
            # scale-relative stationarity (IPOPT-style)
            fscale = 1.0 + vmap(f)(x_n, p).abs()
            done_n = (viol_n < opt.tol_con) & (kkt < opt.tol * fscale)
            x = _sel(run, x_n, x)
            lamL, lamU = _sel(run, lamL_n, lamL), _sel(run, lamU_n, lamU)
            mu = torch.where(run, mu_n, mu)
            viol = torch.where(run, viol_n, viol)
            it = it + it_in
            rounds = torch.where(run, rounds + 1, rounds)
            done = torch.where(run, done_n, done)

        gv = g_b(x, p)
        res = NLPResult(x=x, f=vmap(f)(x, p), g=gv, lam_g=lamU - lamL,
                        kkt=kkt_of(x, lamL, lamU), viol=viol_of(gv),
                        iterations=it, converged=done)
        if single:
            return NLPResult(**{k.name: getattr(res, k.name)[0]
                                for k in dataclasses.fields(res)})
        return res

    return solve
