"""Nonlinear path-frame (Frenet) MPC: Trajectory Tracking/test2.py (port of
``mpc_verde_tpu.scenarios.frenet``).

Constants (:19-59): L = 3.5, Delta = 0.05, Nt = 20, states (y, phi, v),
controls (delta, a), params (y_t, phi_t, kappa_t, v_des); cost weights
lambda1 = 2.5 (speed), lambda2 = 1.75 (lateral), lambda3 = 2.5 (yaw),
lambda4 = 0.4 (accel), lambda5 = 10 with z = tan(delta) - L kappa, all
divided by (Nt + 1); bounds delta in +-0.384, a in +-2, steering rate Du in
+-0.1225 (a free).  The params keep the ode's order (y_t, phi_t, kappa_t,
v_des), as the JAX package does.

The controller is the rate form (``ocp/rate.py``) of one RK4 step of the
path-frame model: z = [y, phi, v, delta_prev, a_prev] (nx 5, nu 2).  One
problem at a time (B = 1) through ``make_ilqr_solver``; on the card the
solve runs ``"cuda_fused"`` on the model traced from the callables of
``interop.frenet_rate_ocp``.  The plant is a separate 10-substep RK4
of the same model (:115).
"""
from __future__ import annotations

import numpy as np
import torch

from ..interop import frenet_rate_ocp
from ..models import frenet_path_frame
from ..ops import DiscreteSimulator
from ..refgen import path_heading, stage_param_tensor, synthetic_lane_change
from ..runtime import make_receding_horizon
from ..solver import ILQROptions, make_ilqr_solver
from ..utils import scenario_device

SPEC = dict(T=0.05, N=20, L=3.5,
            lambda1=2.5, lambda2=1.75, lambda3=2.5, lambda4=0.4, lambda5=10.0,
            delta_max=0.384, a_max=2.0, delta_dot_max=0.1225)


def path_curvature(xr, yr, T: float):
    """The curvature magnitude of a sampled path from second differences
    (test2.py:101-103).  Two quirks of the reference are kept: the first two
    samples take its literal fallback 1.0 (:105-106), and the last repeats
    the one before."""
    ddx, ddy = np.zeros_like(xr), np.zeros_like(yr)
    ddx[1:-1] = (xr[:-2] - 2 * xr[1:-1] + xr[2:]) / T ** 2
    ddy[1:-1] = (yr[:-2] - 2 * yr[1:-1] + yr[2:]) / T ** 2
    kappa = np.hypot(ddx, ddy)
    kappa[:2] = 1.0
    kappa[-1] = kappa[-2]
    return kappa


def build_frenet(path=None, n_steps=None, max_iters: int = 40, device=None,
                 backend=None, dtype=torch.float32):
    """The Frenet controller on ``path`` (the synthetic lane change by
    default).  The horizon reads a table of the whole course, so that it
    looks past the last closed-loop step (clamped only at the course's end),
    as the lane-change scenarios do.  ``device`` defaults to the CUDA device
    and raises without one (pass ``device="cpu"`` for the CPU); ``backend``
    None is ``"cuda_fused"`` on a CUDA device and ``"torch"`` elsewhere."""
    s = dict(SPEC)
    dev = scenario_device(device, "build_frenet")
    if path is None:
        path = synthetic_lane_change(n=500, dt=s["T"])
    Nsim = len(path["x"]) if n_steps is None else n_steps
    N, T, L = s["N"], s["T"], s["L"]

    xr = np.asarray(path["x"], float)
    yr = np.asarray(path["y"], float)
    vdes = np.asarray(path["uref"], float)
    refs_full = np.stack([yr, path_heading(xr, yr), path_curvature(xr, yr, T),
                          vdes], axis=-1)
    refs = refs_full[:Nsim]

    ocp = frenet_rate_ocp(N, dev, dtype, **{k: s[k] for k in (
        "T", "L", "lambda1", "lambda2", "lambda3", "lambda4", "lambda5",
        "delta_max", "a_max", "delta_dot_max")})
    solve = make_ilqr_solver(ocp, ILQROptions(max_iters=max_iters),
                             backend=backend)

    plant = DiscreteSimulator(frenet_path_frame(L), T, M=10)

    def plant_step(z, w, pp):
        x, u_prev = z[:3], z[3:]
        u = u_prev + w
        return torch.cat([plant.sim(x, u, pp), u])

    run = make_receding_horizon(ocp, solve, plant_step, Nsim)
    par = stage_param_tensor(refs_full, N + 1, Nsim)
    return {"ocp": ocp, "solve": solve, "run": run, "spec": s, "path": path,
            "params_seq": par, "plant_params": np.asarray(par[:, 0, :]),
            "refs": refs, "n_steps": Nsim}


def run_frenet(built=None, **kw):
    """Run the closed loop from z = 0; the JAX package's metrics under its
    keys."""
    if built is None:
        built = build_frenet(**kw)
    Nsim = built["n_steps"]
    res = built["run"](np.zeros(5), built["params_seq"], built["plant_params"])
    zs = res.xs.double().cpu().numpy()
    xs = zs[:, :3]
    refs = built["refs"]
    err_y = xs[:Nsim, 0] - refs[:, 0]
    err_v = xs[:Nsim, 2] - refs[:, 3]
    dus = res.us.double().cpu().numpy()
    deltas = zs[:Nsim, 3] + dus[:, 0]
    return {
        "result": res, "x": xs,
        "mse_y": float((err_y ** 2).mean()),
        "mse_v": float((err_v ** 2).mean()),
        "max_delta": float(np.abs(deltas).max()),
        "max_delta_rate": float(np.abs(dus[:, 0]).max()),
        "converged_frac": float(res.converged.double().mean()),
    }
