"""Receding-horizon closed-loop driver (port of ``mpc_verde_tpu.runtime.receding``).

Each control step solves the OCP from the current state, applies the first
control to the plant, and warm-starts the next solve with the plan shifted
by one stage (the last control repeated).  The JAX driver is one
``lax.scan`` over steps; here it is a host loop over steps whose tensors all
stay on the OCP's device, and the only host reads are the solver's own
termination checks.  The plant is a separate single-vector step
``(x, u, p_plant) -> x_next`` (the controller's model and the plant may
differ), batched with ``torch.func.vmap`` in the batched driver.  Each
step is an ``mpc.step`` span with its plant call and warm-start shift in
``mpc.plant`` (``utils.profiling``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import vmap

from ..ocp.spec import OCP
from ..solver.batched import _as_tensor
from ..utils.profiling import span


@dataclasses.dataclass
class ClosedLoopResult:
    xs: torch.Tensor           # (Nsim+1, nx) closed-loop states ((Nsim+1, B, nx) batched)
    us: torch.Tensor           # (Nsim, nu) applied controls ((Nsim, B, nu))
    costs: torch.Tensor        # (Nsim,) OCP cost per solve ((Nsim, B))
    iterations: torch.Tensor   # (Nsim,) solver iterations per step ((Nsim, B))
    converged: torch.Tensor    # (Nsim,) solver convergence flags ((Nsim, B))
    predicted: Optional[torch.Tensor] = None   # (Nsim, N+1, nx) horizons
    final_warm: Optional[torch.Tensor] = None  # (N, nu) next warm start


def shift_warm_start(us):
    """Shift the control plan one stage along axis 0, repeating the last control."""
    return torch.cat([us[1:], us[-1:]], dim=0)


def _zeros_or(a, shape, z):
    return torch.zeros(shape, **z) if a is None else _as_tensor(a, z)


def make_receding_horizon(ocp: OCP, solve: Callable, plant_step: Callable,
                          n_steps: int, record_predictions: bool = False):
    """Build the closed-loop runner for one plant.

    Args:
      ocp: the OCP the solver was built for (shapes, device, dtype).
      solve: ``solve(x0, params, us_init) -> ILQRResult`` from
        ``make_ilqr_solver``.
      plant_step: ``(x, u, p_plant) -> x_next``, the plant integrator.
      n_steps: Nsim, the number of closed-loop steps.
      record_predictions: also record each step's predicted horizon.

    Returns ``run(x0, params_seq, plant_params, us_init) -> ClosedLoopResult``:
    params_seq (Nsim, N+1, npar) per-step stage parameters or None;
    plant_params (Nsim, ...) per-step plant parameters or None.
    """
    N, nu = ocp.N, ocp.nu
    z = dict(dtype=ocp.dtype, device=ocp.device)

    def run(x0, params_seq=None, plant_params=None, us_init=None):
        x = _as_tensor(x0, z)
        warm = _zeros_or(us_init, (N, nu), z)
        params_seq = _zeros_or(params_seq, (n_steps, N + 1, max(ocp.npar, 1)), z)
        plant_params = _zeros_or(plant_params, (n_steps, 1), z)
        rows = []
        for t in range(n_steps):
            with span("mpc.step"):
                res = solve(x, params_seq[t], warm)
                with span("mpc.plant"):
                    u0 = res.us[0]
                    rows.append((x, u0, res.cost, res.iterations,
                                 res.converged, res.xs))
                    x = plant_step(x, u0, plant_params[t])
                    warm = shift_warm_start(res.us)
        xs, us, costs, iters, conv, preds = (torch.stack(c) for c in zip(*rows))
        return ClosedLoopResult(
            xs=torch.cat([xs, x[None]]), us=us, costs=costs, iterations=iters,
            converged=conv, predicted=preds if record_predictions else None,
            final_warm=warm)

    return run


def make_batched_receding_horizon(ocp: OCP, solve_batch: Callable,
                                  plant_step: Callable, n_steps: int,
                                  plant_params_per_plant: bool = False):
    """Build the closed-loop runner for B independent plants.

    Args:
      solve_batch: ``(x0s (B, nx), params (B, N+1, npar), us (B, N, nu)) ->
        ILQRResult`` with leading batch axes (``make_batched_ilqr_solver``).
      plant_step: single-plant ``(x, u, p_plant) -> x_next``; vmapped here.
      plant_params_per_plant: plant parameters are (Nsim, B, ...), one per
        plant, instead of (Nsim, ...) shared across the batch.

    Returns ``run(x0s, params_seq, plant_params, us_init) ->
    ClosedLoopResult`` with the batch axis after the time axis: xs is
    (Nsim+1, B, nx), us (Nsim, B, nu), costs / iterations / converged
    (Nsim, B), final_warm (B, N, nu).  ``params_seq`` is (Nsim, B, N+1,
    npar), or (Nsim, N+1, npar) shared across the batch, or None.
    """
    N, nu = ocp.N, ocp.nu
    npar = max(ocp.npar, 1)
    z = dict(dtype=ocp.dtype, device=ocp.device)
    plant_b = vmap(plant_step, in_dims=(0, 0, 0 if plant_params_per_plant
                                        else None))

    def run(x0s, params_seq=None, plant_params=None, us_init=None):
        x = _as_tensor(x0s, z)
        B = x.shape[0]
        warm = _zeros_or(us_init, (B, N, nu), z)
        params_seq = _zeros_or(params_seq, (n_steps, B, N + 1, npar), z)
        if params_seq.ndim == 3:   # (Nsim, N+1, npar) shared across the batch
            params_seq = params_seq[:, None].expand(n_steps, B, N + 1, npar)
        plant_params = _zeros_or(
            plant_params,
            (n_steps, B, 1) if plant_params_per_plant else (n_steps, 1), z)
        rows = []
        for t in range(n_steps):
            with span("mpc.step"):
                res = solve_batch(x, params_seq[t], warm)
                with span("mpc.plant"):
                    u0 = res.us[:, 0]
                    rows.append((x, u0, res.cost, res.iterations,
                                 res.converged))
                    x = plant_b(x, u0, plant_params[t])
                    warm = torch.cat([res.us[:, 1:], res.us[:, -1:]], dim=1)
        xs, us, costs, iters, conv = (torch.stack(c) for c in zip(*rows))
        return ClosedLoopResult(xs=torch.cat([xs, x[None]]), us=us,
                                costs=costs, iterations=iters, converged=conv,
                                final_warm=warm)

    return run
