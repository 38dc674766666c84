"""Exact stage-wise box-constrained QP (port of ``mpc_verde_tpu.solver.boxqp``).

Solves  min_v  0.5 v'Hv + g'v   s.t.  lb <= v <= ub  by enumerating all 3^nu
active-set patterns (each coordinate free / at lower / at upper), solving
each candidate's masked KKT system in closed form, and taking the first
feasible-and-stationary candidate of lowest objective.  Everything is
batched over leading dimensions.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..ops.smallmat import small_solve

_BIG = 1e30


def _patterns(nu: int) -> np.ndarray:
    """All active-set patterns: 0 = free, 1 = at lower, 2 = at upper."""
    return np.array(list(itertools.product([0, 1, 2], repeat=nu)),
                    dtype=np.int32)


def _matvec(H, v):
    return (H @ v[..., None])[..., 0]


def _eval_pattern(pattern, H, g, lb, ub, tol):
    """Candidate of one pattern; every argument broadcasts over leading dims.

    Returns ``(v, free_mask, obj)`` with ``obj = _BIG`` for an infeasible or
    non-stationary candidate, or one that clamps to an infinite bound.
    """
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    m = (pattern == 0).to(H.dtype)                     # free mask
    at_lo = pattern == 1
    at_up = pattern == 2
    c = torch.where(at_lo, lb, torch.where(at_up, ub, zero))
    valid = torch.isfinite(torch.where(m > 0, zero, c)).all(-1)
    c = torch.where(torch.isfinite(c), c, zero)

    # masked KKT: free rows of H, identity on clamped rows
    A = m[..., :, None] * H * m[..., None, :] + torch.diag_embed(1.0 - m)
    b = -m * (g + _matvec(H, (1.0 - m) * c))
    v_free = small_solve(A, b)
    v = m * v_free + (1.0 - m) * c

    grad = g + _matvec(H, v)
    feas = torch.where(m > 0, (v >= lb - tol) & (v <= ub + tol),
                       True).all(-1)
    stat = (torch.where(at_lo, grad >= -tol, True)
            & torch.where(at_up, grad <= tol, True)).all(-1)
    obj = 0.5 * (_matvec(H.transpose(-1, -2), v) * v).sum(-1) + (g * v).sum(-1)
    obj = torch.where(valid & feas & stat, obj, _BIG)
    return v, m, obj


def _best_pattern(H, g, lb, ub, tol):
    """Evaluate every pattern; return the winner's ``(v, free_mask)``.

    ``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does, so
    ties go to the earlier pattern in ``itertools.product`` order.
    """
    nu = H.shape[-1]
    pats = torch.as_tensor(_patterns(nu), device=H.device)     # (P, nu)
    vs, ms, objs = _eval_pattern(pats, H[..., None, :, :], g[..., None, :],
                                 lb[..., None, :], ub[..., None, :], tol)
    best = torch.argmin(objs, dim=-1, keepdim=True)             # (..., 1)
    idx = best[..., None].expand(*best.shape, nu)
    ms = ms.expand_as(vs)
    return vs.gather(-2, idx)[..., 0, :], ms.gather(-2, idx)[..., 0, :]


def solve_boxqp(H, g, lb, ub, tol: float = 1e-8):
    """Exact solve of the box QP by active-set enumeration.

    Args:
      H: (..., nu, nu) positive-definite Hessian.
      g: (..., nu) gradient.
      lb, ub: (..., nu) bounds; +-inf allowed.
      tol: feasibility/stationarity tolerance.

    Returns ``(v, free_mask)``, each (..., nu).
    """
    if H.shape[-1] > 4:
        raise NotImplementedError(
            "active-set enumeration is intended for nu <= 4; "
            "use a projected-Newton stage QP for larger control dimensions")
    return _best_pattern(H, g, lb, ub, tol)
