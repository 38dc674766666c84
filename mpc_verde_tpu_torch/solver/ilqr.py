"""Box-DDP options, result type and the stage QP with feedback gain.

Port of the shared pieces of ``mpc_verde_tpu.solver.ilqr``.  The
single-problem ``make_ilqr_solver`` is not ported yet; the batched solver
covers B = 1.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.smallmat import small_solve
from .boxqp import _best_pattern


@dataclasses.dataclass(frozen=True)
class ILQROptions:
    """Solver configuration; fields and defaults as in the JAX package
    (whose XLA-only ``ls_unroll`` knob has no counterpart here)."""

    max_iters: int = 60
    tol_grad: float = 1e-7
    tol_cost: float = 1e-9
    reg_init: float = 1e-6
    reg_min: float = 1e-9
    reg_max: float = 1e10
    reg_up: float = 100.0
    reg_down: float = 8.0
    n_alphas: int = 12
    alpha_decay: float = 0.5
    stall_iters: int = 8
    use_ddp: bool = True
    ddp_fallback_factor: float = 1e3
    ms_gap_tol: float = 1e-5
    ms_merit_weight: float = 10.0
    quorum: float = 1.0
    al_iters: int = 0
    al_mu0: float = 10.0
    al_mu_factor: float = 10.0
    boxqp_tol: float = 1e-8


@dataclasses.dataclass
class ILQRResult:
    xs: torch.Tensor          # (B, N+1, nx) optimal state trajectories
    us: torch.Tensor          # (B, N, nu) optimal controls
    cost: torch.Tensor        # (B,) final cost
    grad_norm: torch.Tensor   # projected-gradient norm at the last backward
    iterations: torch.Tensor  # total inner iterations (restarts included)
    converged: torch.Tensor   # bool: tolerance/stationarity with finite cost
    max_violation: torch.Tensor  # state-bound violation (0 without bounds)


def _stage_boxqp_with_gain(Quu, Qu, Qux, lb, ub, tol):
    """Solve the stage box QP and the free-subspace feedback gain.

    Batched over leading dims.  Returns ``(k_ff, K, free_mask)``; K rows of
    clamped coordinates are zero (control-limited DDP).
    """
    k_ff, m = _best_pattern(Quu, Qu, lb, ub, tol)
    A = m[..., :, None] * Quu * m[..., None, :] + torch.diag_embed(1.0 - m)
    K = -small_solve(A, m[..., :, None] * Qux)
    return k_ff, K, m
