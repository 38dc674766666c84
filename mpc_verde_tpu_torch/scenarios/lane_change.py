"""LTI lateral-error lane-change tracking: Trajectory_tracking_le_LTI.py
(port of ``mpc_verde_tpu.scenarios.lane_change``).

Constants (:17-35): Delta = 0.05, Nt = 5, Ntu = 1 (move blocking), 3 states
(y, phi, r), 1 control (delta), Q = diag(10, 1, 0), R = 0.01, R_du = 0,
delta_max = 0.3491, ar = -23.55, br = 61.99, uref = mean path speed.  The
stage cost tracks per-stage params (y_ref, phi_ref, r_ref, delta_ref)
synthesized from the path by finite differences (:104-128).  The rate form
(``ocp/rate.py``) makes the state z = [y, phi, r, delta_prev] (nx 4) and
the control the steering rate; the plant is the ZOH-discretized model, as
in the JAX package.  One problem at a time (B = 1) through
``make_ilqr_solver``; on the card the solve runs ``"cuda_fused"`` on the
model traced from the callables of ``interop.linear_rate_ocp``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..interop import linear_rate_ocp
from ..models.bicycle import AR_DEFAULT, BR_DEFAULT, lateral_error_lti
from ..ops import c2d
from ..refgen import (lateral_error_references, stage_param_tensor,
                      synthetic_lane_change)
from ..runtime import make_receding_horizon
from ..solver import ILQROptions, make_ilqr_solver
from ..utils import scenario_device

SPEC = dict(T=0.05, N=5, Ntu=1, Q=(10.0, 1.0, 0.0), R=0.01, R_du=0.0,
            delta_max=0.3491, ar=AR_DEFAULT, br=BR_DEFAULT)


def move_blocking(N: int, Ntu: int):
    """Rate bounds (N, 1): free for the first ``Ntu`` stages, pinned to 0
    after."""
    du_lb, du_ub = np.zeros((N, 1)), np.zeros((N, 1))
    du_lb[:Ntu], du_ub[:Ntu] = -np.inf, np.inf
    return du_lb, du_ub


def lateral_error_ocp(N: int, Ntu: int, device, dtype=torch.float32, *,
                      Ad=None, Bd=None, ab_col=None, spec=SPEC):
    """The lane-change OCP in rate form: Q = diag(spec Q), R, R_du, the
    steering box and move blocking after ``Ntu``; references in p[:4]
    (y, phi, r, delta); (Ad, Bd) constant or, with ``ab_col``, in the
    params."""
    s = spec
    du_lb, du_ub = move_blocking(N, Ntu)
    return linear_rate_ocp(
        N, device, dtype, Q=np.diag(s["Q"]), R=[[s["R"]]], R_du=[[s["R_du"]]],
        u_lb=[-s["delta_max"]], u_ub=[s["delta_max"]], du_lb=du_lb,
        du_ub=du_ub, Ad=Ad, Bd=Bd, ab_col=ab_col, x_ref=0, u_ref=3)


def build_lane_change_lti(path=None, n_steps=None, max_iters: int = 30,
                          N: int = None, Ntu: int = None, device=None,
                          backend=None, dtype=torch.float32):
    """``N`` / ``Ntu`` override the v2 defaults (5 / 1); the v1 variant
    (``Trajectory_tracking_lateral_error.py:17,61-69``) uses Nt = 20,
    Ntu = 3.  ``device`` defaults to the CUDA device and raises without one
    (pass ``device="cpu"`` for the CPU); ``backend`` None is
    ``"cuda_fused"`` on a CUDA device and ``"torch"`` elsewhere.  The ZOH
    discretization runs in float64 and is rounded to ``dtype``."""
    s = dict(SPEC)
    if N is not None:
        s["N"] = int(N)
    if Ntu is not None:
        s["Ntu"] = int(Ntu)
    dev = scenario_device(device, "build_lane_change_lti")
    if path is None:
        path = synthetic_lane_change(n=500, dt=s["T"])
    Nsim = len(path["x"]) if n_steps is None else n_steps
    N, T = s["N"], s["T"]

    uref = float(np.mean(path["uref"]))
    model = lateral_error_lti(uref, s["ar"], s["br"], device="cpu",
                              dtype=torch.float64)
    Ad, Bd = (m.numpy() for m in c2d(model.Ac, model.Bc, T))
    ocp = lateral_error_ocp(N, s["Ntu"], dev, dtype, Ad=Ad, Bd=Bd, spec=s)
    solve = make_ilqr_solver(ocp, ILQROptions(max_iters=max_iters),
                             backend=backend)

    # plant: the ZOH-exact model for piecewise-constant steering
    Ap = torch.as_tensor(Ad, dtype=dtype, device=dev)
    Bp = torch.as_tensor(Bd, dtype=dtype, device=dev)

    def plant(z, w, pp):
        x, u_prev = z[:3], z[3:]
        u = u_prev + w
        return torch.cat([Ap @ x + Bp @ u, u])

    run = make_receding_horizon(ocp, solve, plant, Nsim)
    refs = lateral_error_references(path, T, s["ar"], s["br"])  # (Nsim0, 4)
    par = stage_param_tensor(refs, N + 1, Nsim)                 # (Nsim, N+1, 4)
    return {"ocp": ocp, "solve": solve, "run": run, "spec": s, "path": path,
            "params_seq": par, "uref": uref, "refs": refs, "n_steps": Nsim}


def run_lane_change_lti(built=None, **kw):
    """Run the closed loop from z = 0; the JAX package's metrics under its
    keys."""
    if built is None:
        built = build_lane_change_lti(**kw)
    s = built["spec"]
    Nsim = built["n_steps"]
    res = built["run"](np.zeros(4), built["params_seq"])  # x0 = 0, uprev = 0
    zs = res.xs.double().cpu().numpy()
    xs = zs[:, :3]
    dus = res.us.double().cpu().numpy()
    us = zs[:Nsim, 3] + dus[:, 0]  # applied absolute steering

    refs = built["refs"][:Nsim]
    err = xs[:Nsim] - refs[:, :3]
    # reference metrics (:160-163): per-state MSEs and mean path distance
    mean_y = float((err[:, 0] ** 2).mean())
    mean_phi = float((err[:, 1] ** 2).mean())
    mean_r = float((err[:, 2] ** 2).mean())
    mean_delta = float(((us - refs[:, 3]) ** 2).mean())

    # actual trajectory reconstruction (:201-206)
    uref = built["uref"]
    xz = np.concatenate([[0.0], np.cumsum(uref * np.cos(xs[:-1, 1]) * s["T"])])
    yz = xs[:, 0]
    traj = np.stack([xz[:Nsim], yz[:Nsim]])
    traje = np.stack([built["path"]["x"][:Nsim], built["path"]["y"][:Nsim]])
    mean_t = float(np.linalg.norm(traj - traje, axis=0).mean())
    return {
        "result": res, "u": us, "x": xs,
        "mean_y": mean_y, "mean_phi": mean_phi, "mean_r": mean_r,
        "mean_delta": mean_delta, "mean_path_dist": mean_t,
        "converged_frac": float(res.converged.double().mean()),
    }
