"""Curvature-cost LTV tracker: Trajectory Tracking/test.py (port of
``mpc_verde_tpu.scenarios.curvature``).

Constants (:19-30): L = 3.5, Delta = 0.05, Nt = 20, Ntu = 3 (move blocking),
the LTV lateral-error model (y, phi, r) rebuilt from the path speed c[t]
(ar = -23.55, br = 61.99), steering bounds +-20 (inactive), uprev = 0.
Stage cost (:46-54):

    lambda2 (y - y_t)^2 + lambda3 (phi - phi_t)^2
      + lambda1 (r * Rt - v_des)^2 + Rt * z^2,   z = tan(delta) - L kappa_t

with Rt = 1 / kappa_t: the script shadows the weight ``R = 10`` with the
turn radius inside ``lfunc``, which is kept.  The params keep the cost's
order (y_t, phi_t, kappa_t, v_des), then each step's (Ad, Bd) in p[4:16],
as the JAX package does.

The controller is the rate form of the LTV model with the curvature cost:
``interop.curvature_rate_ocp``.  One problem at a time (B = 1) through
``make_ilqr_solver``, on ``"cuda_fused"`` on the card, on the model traced
from the OCP's callables.  The plant is the
same step's exact discretization, ``Ad x + Bd u``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..interop import curvature_rate_ocp
from ..models.bicycle import lateral_error_ltv_coeffs
from ..ops import c2d
from ..refgen import path_heading, stage_param_tensor, synthetic_lane_change
from ..runtime import make_receding_horizon
from ..solver import ILQROptions, make_ilqr_solver
from ..utils import scenario_device
from .frenet import path_curvature

SPEC = dict(T=0.05, N=20, Ntu=3, L=3.5, lambda1=2.5, lambda2=1.75,
            lambda3=2.5, delta_max=20.0, ar=-23.55, br=61.99)


def build_curvature_ltv(path=None, n_steps=None, max_iters: int = 30,
                        device=None, backend=None, dtype=torch.float32):
    """The curvature-cost controller on ``path`` (the synthetic lane change
    by default), its horizon reading the whole course's table as
    ``build_frenet``'s does.  The batched ZOH discretization runs in float64
    on the scenario's device and is rounded to ``dtype``.  ``device``
    defaults to the CUDA device and raises without one (pass
    ``device="cpu"`` for the CPU); ``backend`` None is ``"cuda_fused"`` on a
    CUDA device and ``"torch"`` elsewhere."""
    s = dict(SPEC)
    dev = scenario_device(device, "build_curvature_ltv")
    if path is None:
        path = synthetic_lane_change(n=500, dt=s["T"])
    Nsim = len(path["x"]) if n_steps is None else n_steps
    N, T = s["N"], s["T"]

    xr = np.asarray(path["x"], float)
    yr = np.asarray(path["y"], float)
    c = np.asarray(path["uref"], float)
    # the cost divides by kappa (the turn radius): a guard keeps it away from
    # zero, as the reference's fallback value 1.0 does for its first samples
    kappa = np.maximum(path_curvature(xr, yr, T), 1e-3)
    refs_full = np.stack([yr, path_heading(xr, yr), kappa, c], axis=-1)
    refs = refs_full[:Nsim]

    f64 = dict(dtype=torch.float64, device=dev)
    Acs, Bcs = lateral_error_ltv_coeffs(torch.as_tensor(c[:Nsim], **f64),
                                        s["ar"], s["br"])
    Ads, Bds = c2d(Acs, Bcs, T)                       # (Nsim, 3, 3), (Nsim, 3, 1)

    ocp = curvature_rate_ocp(N, dev, dtype, **{k: s[k] for k in (
        "Ntu", "L", "lambda1", "lambda2", "lambda3", "delta_max")})
    solve = make_ilqr_solver(ocp, ILQROptions(max_iters=max_iters),
                             backend=backend)

    ref_par = stage_param_tensor(refs_full, N + 1, Nsim)   # (Nsim, N+1, 4)
    mats = torch.cat([Ads.reshape(Nsim, 9), Bds.reshape(Nsim, 3)],
                     dim=1).cpu().numpy()                # (Nsim, 12)
    par = np.concatenate([
        ref_par, np.broadcast_to(mats[:, None, :], (Nsim, N + 1, 12))], axis=2)

    def plant(z, w, pp):
        x, u_prev = z[:3], z[3:]
        u = u_prev + w
        A = pp[:9].reshape(3, 3)
        B = pp[9:12]
        return torch.cat([A @ x + B * u[0], u])

    run = make_receding_horizon(ocp, solve, plant, Nsim)
    return {"ocp": ocp, "solve": solve, "run": run, "spec": s, "path": path,
            "params_seq": par, "plant_params": mats, "refs": refs,
            "n_steps": Nsim}


def run_curvature_ltv(built=None, **kw):
    """Run the closed loop from z = 0; the JAX package's metrics under its
    keys."""
    if built is None:
        built = build_curvature_ltv(**kw)
    Nsim = built["n_steps"]
    res = built["run"](np.zeros(4), built["params_seq"], built["plant_params"])
    xs = res.xs.double().cpu().numpy()[:, :3]
    refs = built["refs"]
    err_y = xs[:Nsim, 0] - refs[:, 0]
    err_phi = xs[:Nsim, 1] - refs[:, 1]
    return {
        "result": res, "x": xs,
        "mse_y": float((err_y ** 2).mean()),
        "mse_phi": float((err_phi ** 2).mean()),
        "converged_frac": float(res.converged.double().mean()),
    }
