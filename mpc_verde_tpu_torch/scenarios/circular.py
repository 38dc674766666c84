"""Circular-track kinematic tracking: the Trajectory_tracking.py family (port
of ``mpc_verde_tpu.scenarios.circular``).

Constants from ``Trajectory Tracking/Trajectory_tracking.py:15-97``:
Delta = 0.2, Nt = 10, Q = diag(1, 1, 0.1), R = diag(0.5, 0.05), v / omega
bounds as the diff-drive, state box x in [-20, 20], y in [-2, 2], reference
(cos .1t, sin .1t, pi/2 + .1t, 1, 1) in the stage params (the last two the
control reference), Nsim = 500, the plant ``DiscreteSimulator`` on the
continuous model (10 RK4 substeps).  One problem at a time (B = 1), two AL
rounds over the state box each step; on the card the solve runs
``"cuda_fused"``, whose device model carries the control reference and
the AL penalty.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..interop import unicycle_ocp
from ..models import unicycle
from ..ops import DiscreteSimulator
from ..refgen import circular_reference_params
from ..runtime import make_receding_horizon
from ..solver import ILQROptions, make_ilqr_solver
from ..utils import scenario_device

SPEC = dict(T=0.2, N=10, Q=(1.0, 1.0, 0.1), R=(0.5, 0.05),
            v_max=1.0, omega_max=np.pi / 4,
            x_lb=(-20.0, -2.0, -np.inf), x_ub=(20.0, 2.0, np.inf),
            x0=(0.0, 0.0, 0.0), n_steps=500)


def circular_ocp(N: int, device, dtype=torch.float32,
                 use_state_bounds: bool = True):
    """The circular track's OCP at horizon ``N``: SPEC's weights and boxes,
    the target in p[:3] and the control reference in p[3:5] (npar 5)."""
    s = SPEC
    ocp = unicycle_ocp(N, device, dtype, dt=s["T"], Q=np.diag(s["Q"]),
                       R=np.diag(s["R"]), lb=[-s["v_max"], -s["omega_max"]],
                       ub=[s["v_max"], s["omega_max"]], u_ref=3)
    if not use_state_bounds:
        return ocp
    box = lambda b: torch.as_tensor(np.asarray(b), dtype=dtype,
                                    device=ocp.device)
    return dataclasses.replace(ocp, x_lb=box(s["x_lb"]), x_ub=box(s["x_ub"]))


def build_circular_tracking(n_steps: int = None, use_state_bounds: bool = True,
                            max_iters: int = 40, device=None, backend=None,
                            dtype=torch.float32):
    """The circular track's OCP, solver, closed-loop runner and reference.

    ``n_steps`` must be at least N = 10 (``circular_reference_params``
    indexes the first N entries of the time grid).  ``device`` defaults to
    the CUDA device and raises without one (pass ``device="cpu"`` for the
    CPU); ``backend`` None is ``"cuda_fused"`` on a CUDA device and
    ``"torch"`` elsewhere.  Returns a dict with ``ocp``, ``solve``, ``run``,
    ``spec``, ``params_seq`` (Nsim, N+1, 5) and ``times`` (Nsim+1,).
    """
    s = dict(SPEC)
    if n_steps is not None:
        s["n_steps"] = n_steps
    Nsim, N, T = s["n_steps"], s["N"], s["T"]
    dev = scenario_device(device, "build_circular_tracking")

    ocp = circular_ocp(N, dev, dtype, use_state_bounds)
    opts = ILQROptions(max_iters=max_iters,
                       al_iters=2 if use_state_bounds else 0)
    solve = make_ilqr_solver(ocp, opts, backend=backend)
    plant = DiscreteSimulator(unicycle, T, M=10)
    run = make_receding_horizon(ocp, solve, lambda x, u, pp: plant.sim(x, u),
                                Nsim)

    times = T * Nsim * np.linspace(0, 1, Nsim + 1)
    par = circular_reference_params(times[:Nsim], N, T)       # (Nsim, N, 5)
    par_full = np.concatenate([par, par[:, -1:, :]], axis=1)   # terminal row
    return {"ocp": ocp, "solve": solve, "run": run, "spec": s,
            "params_seq": par_full, "times": times}


def run_circular_tracking(built=None, **kw):
    """Run the closed loop; the JAX package's metrics under its keys."""
    if built is None:
        built = build_circular_tracking(**kw)
    s = built["spec"]
    res = built["run"](np.array(s["x0"]), built["params_seq"])
    xs = res.xs.double().cpu().numpy()
    par = built["params_seq"]
    ref0 = par[:, 0, :3]  # reference at each applied step
    err = xs[:-1] - ref0
    # transient excluded: the robot starts at the circle's interior
    settle = len(err) // 5
    return {
        "result": res,
        "rmse_xy": float(np.sqrt((err[settle:, :2] ** 2).mean())),
        "max_err_xy": float(np.abs(err[settle:, :2]).max()),
        "mean_path_dist": float(np.linalg.norm(err[settle:, :2], axis=1).mean()),
        "converged_frac": float(res.converged.double().mean()),
    }
