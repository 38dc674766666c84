"""LTV lateral-error tracking: Trjectory_tracking_le_LTV.py, leitura.py
(port of ``mpc_verde_tpu.scenarios.ltv``).

The reference re-linearizes ``Ac`` with the time-varying speed ``c[t]`` and
rebuilds its solver every step (:124-146).  Here the per-step (Ad_t, Bd_t)
are data: all Nsim discretizations come from one batched ``c2d``, the
matrices ride in the per-stage params (p[4:13] Ad row-major, p[13:16] Bd),
and one solver handles every step.  Constants follow the LTI variant (Nt = 5, Ntu = 1,
Q = diag(10, 1, 0), R = 0.01, delta_max = 0.3491).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.bicycle import lateral_error_ltv_coeffs
from ..ops import c2d
from ..refgen import (extend_lane_change_course, lateral_error_references,
                      load_path_csv, stage_param_tensor, synthetic_lane_change)
from ..runtime import make_receding_horizon
from ..solver import ILQROptions, make_ilqr_solver
from ..utils import scenario_device
from .lane_change import SPEC as LTI_SPEC
from .lane_change import lateral_error_ocp


def build_lane_change_ltv(path=None, n_steps=None, max_iters: int = 30,
                          unwrap: bool = False, yaw_scale_mode: bool = False,
                          device=None, backend=None, dtype=torch.float32):
    """The LTV controller on ``path`` (the synthetic lane change by
    default); ``unwrap`` the +2pi heading correction, ``yaw_scale_mode``
    the ``leitura.py:140`` linearization (speed times the yaw reference).
    The batched ZOH discretization (``torch.linalg.matrix_exp``) runs in
    float64 on the scenario's device and is rounded to ``dtype``.
    ``device`` defaults to the CUDA device and raises without one (pass
    ``device="cpu"`` for the CPU); ``backend`` None is ``"cuda_fused"`` on a
    CUDA device and ``"torch"`` elsewhere."""
    s = dict(LTI_SPEC)
    dev = scenario_device(device, "build_lane_change_ltv")
    if path is None:
        path = synthetic_lane_change(n=500, dt=s["T"])
    Nsim = len(path["x"]) if n_steps is None else n_steps
    N, T = s["N"], s["T"]

    speeds = np.asarray(path["uref"][:Nsim], dtype=float)
    refs = lateral_error_references(path, T, s["ar"], s["br"], unwrap=unwrap)

    # per-step linearization, batched over the whole run (leitura.py:140
    # optionally scales by the yaw reference)
    f64 = dict(dtype=torch.float64, device=dev)
    yaw_scale = (torch.as_tensor(refs[:Nsim, 1], **f64) if yaw_scale_mode
                 else 1.0)
    Acs, Bcs = lateral_error_ltv_coeffs(torch.as_tensor(speeds, **f64),
                                        s["ar"], s["br"], yaw_scale=yaw_scale)
    Ads, Bds = c2d(Acs, Bcs, T)                       # (Nsim, 3, 3), (Nsim, 3, 1)

    # params per stage: [y_ref, phi_ref, r_ref, delta_ref, vec(Ad) 9, Bd 3]
    ocp = lateral_error_ocp(N, s["Ntu"], dev, dtype, ab_col=4, spec=s)
    solve = make_ilqr_solver(ocp, ILQROptions(max_iters=max_iters),
                             backend=backend)

    ref_par = stage_param_tensor(refs, N + 1, Nsim)  # (Nsim, N+1, 4)
    mats = torch.cat([Ads.reshape(Nsim, 9), Bds.reshape(Nsim, 3)],
                     dim=1).cpu().numpy()  # (Nsim, 12), one step's matrices
    par = np.concatenate([
        ref_par, np.broadcast_to(mats[:, None, :], (Nsim, N + 1, 12))], axis=2)

    def plant(z, w, pp):
        # the same step's exact discretization, pp = flattened (Ad, Bd)
        x, u_prev = z[:3], z[3:]
        u = u_prev + w
        A = pp[:9].reshape(3, 3)
        B = pp[9:12]
        return torch.cat([A @ x + B * u[0], u])

    run = make_receding_horizon(ocp, solve, plant, Nsim)
    return {"ocp": ocp, "solve": solve, "run": run, "spec": s, "path": path,
            "params_seq": par, "plant_params": mats, "refs": refs,
            "n_steps": Nsim, "speeds": speeds}


def build_leitura(n_steps=None, max_iters: int = 30,
                  csv_name: str = "traj5.csv", device=None, backend=None,
                  dtype=torch.float32):
    """The ``leitura.py`` configuration: the LTV controller on a recorded
    course (``traj5.csv``) with the +2pi heading unwrap (:98-127); the
    synthetic extended course when the reference data directory is
    absent."""
    try:
        path = load_path_csv(csv_name)
    except FileNotFoundError:
        path = extend_lane_change_course()
    return build_lane_change_ltv(path=path, n_steps=n_steps,
                                 max_iters=max_iters, unwrap=True,
                                 device=device, backend=backend, dtype=dtype)


def run_lane_change_ltv(built=None, **kw):
    """Run the closed loop from z = 0; the JAX package's metrics under its
    keys."""
    if built is None:
        built = build_lane_change_ltv(**kw)
    s = built["spec"]
    Nsim = built["n_steps"]
    res = built["run"](np.zeros(4), built["params_seq"], built["plant_params"])
    zs = res.xs.double().cpu().numpy()
    xs = zs[:, :3]
    dus = res.us.double().cpu().numpy()
    us = zs[:Nsim, 3] + dus[:, 0]

    refs = built["refs"][:Nsim]
    err = xs[:Nsim] - refs[:, :3]
    mse = float((np.linalg.norm(err[:, :2], axis=1) ** 2).mean())
    speeds = built["speeds"]
    xz = np.concatenate([[0.0], np.cumsum(speeds[:-1] * np.cos(xs[1:Nsim, 1]) * s["T"])])
    traj = np.stack([xz, xs[:Nsim, 0]])
    traje = np.stack([built["path"]["x"][:Nsim], built["path"]["y"][:Nsim]])
    dists = np.linalg.norm(traj - traje, axis=0)
    return {
        "result": res, "u": us, "x": xs,
        "mse": mse,
        "mean_path_dist": float(dists.mean()),
        "max_path_dist": float(dists.max()),
        "converged_frac": float(res.converged.double().mean()),
    }
