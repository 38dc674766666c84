"""Box-DDP options, result type, the stage QP with feedback gain, and the
single-problem solver.

Port of ``mpc_verde_tpu.solver.ilqr``.  The JAX package keeps a second copy
of the iteration for one problem; here ``make_ilqr_solver`` is a B = 1 call
of the batched solver (``solver/batched.py``), which runs the same math.
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


def make_ilqr_solver(ocp, options: ILQROptions = ILQROptions(),
                     backend=None):
    """Build ``solve(x0, params, us_init) -> ILQRResult`` for one problem.

    Args of ``solve``: x0 (nx,); params (N+1, npar) or (npar,) or None;
    us_init (N, nu) or None.  The result has no batch axis: xs (N+1, nx),
    us (N, nu), and 0-d cost, grad_norm, iterations, converged and
    max_violation, as the JAX solver returns them.

    ``backend`` is the port's one addition to the JAX signature (whose
    single-problem solver has no kernel path): it is passed to
    ``make_batched_ilqr_solver``, so None runs ``"torch"`` on the CPU and
    on a CUDA device ``"cuda_fused"`` for a float32 OCP with a device model
    or whose callables lower to a traced one (its library built once per
    program text, at the first solve), else ``"cuda_bw"``
    (``resolve_backend``).
    """
    from .batched import _as_tensor, make_batched_ilqr_solver

    solve_b = make_batched_ilqr_solver(ocp, options, backend=backend)
    z = dict(dtype=ocp.dtype, device=ocp.device)

    def solve(x0, params=None, us_init=None):
        # the batched solver broadcasts (npar,) and (N+1, npar) params itself
        res = solve_b(_as_tensor(x0, z)[None], params,
                      None if us_init is None else _as_tensor(us_init, z)[None])
        return ILQRResult(**{f.name: getattr(res, f.name)[0]
                             for f in dataclasses.fields(res)})

    return solve
