"""Tuning sweeps as a batch axis — the Phiref.py harness, parallelized (port
of ``mpc_verde_tpu.sweep``).

The reference sweeps horizon lists and weight lists by re-running the whole
closed loop serially per config (``Trajectory Tracking/Phiref.py:22-28``,
loop at :27-355).  Here weight configs become a *batch dimension*: the stage
cost reads its lateral weight from the parameter vector
(``interop.linear_rate_ocp``'s ``q_param``), so one batched closed loop
evaluates every weight config at once.  On the card that loop runs the
kernels (``"cuda_fused"``: K3, then K2).  The JAX package maps a
single-plant runner over the batch (``vmap``); here the batched solver and
driver (``make_batched_ilqr_solver``, ``make_batched_receding_horizon``)
are its counterpart.  Horizons change tensor shapes, so they remain an
outer loop.
"""
from __future__ import annotations

import numpy as np
import torch

from .interop import linear_rate_ocp
from .models.bicycle import lateral_error_lti
from .ops import c2d
from .refgen import (lateral_error_references, stage_param_tensor,
                     synthetic_lane_change)
from .runtime import make_batched_receding_horizon
from .scenarios.lane_change import SPEC, move_blocking
from .solver import ILQROptions, make_batched_ilqr_solver
from .utils import scenario_device


def sweep_ocp(N: int, Ad, Bd, device, dtype=torch.float32):
    """The sweep's OCP at horizon ``N``: the lane change's rate form
    (``SPEC``: R, the steering box, move blocking after Ntu) with params
    ``[y_ref, phi_ref, r_ref, delta_ref, q_y]``, ``Q = diag(p[4], Q[1],
    Q[2])`` (the JAX package's ``sweep.py:55-59``) and ``R_du = 0``."""
    s = SPEC
    du_lb, du_ub = move_blocking(N, s["Ntu"])
    return linear_rate_ocp(
        N, device, dtype, Q=np.diag(s["Q"]), R=[[s["R"]]], R_du=[[0.0]],
        u_lb=[-s["delta_max"]], u_ub=[s["delta_max"]], du_lb=du_lb,
        du_ub=du_ub, Ad=Ad, Bd=Bd, x_ref=0, u_ref=3, q_param=(0, 4))


def sweep_lane_change(q_y_values=(0.01, 0.1, 1.0, 10.0, 100.0),
                      horizons=(3, 5, 8, 10, 15, 20),
                      path=None, n_steps: int = 300, max_iters: int = 30,
                      device=None, dtype=torch.float32):
    """Sweep lateral-error lane-change tuning: Q_y batch x horizon loop.

    Returns a list of dicts (one per (horizon, q_y)) with the reference's
    metrics (mean path distance / per-state MSEs — ``Phiref.py:315``,
    ``Trajectory_tracking_le_LTI.py:160-163``) under the JAX package's keys.
    ``device`` defaults to the CUDA device and raises without one (pass
    ``device="cpu"`` for the CPU); the solver runs its default backend,
    ``"cuda_fused"`` on a CUDA device and ``"torch"`` elsewhere.  The ZOH
    discretization runs in float64 and is rounded to ``dtype``.
    """
    dev = scenario_device(device, "sweep_lane_change")
    s = dict(SPEC)
    if path is None:
        path = synthetic_lane_change(n=max(n_steps, 500), dt=s["T"])
    Nsim = n_steps
    T = s["T"]

    uref = float(np.mean(path["uref"]))
    model = lateral_error_lti(uref, s["ar"], s["br"], device="cpu",
                              dtype=torch.float64)
    Ad, Bd = (m.numpy() for m in c2d(model.Ac, model.Bc, T))
    refs = lateral_error_references(path, T, s["ar"], s["br"])
    Ap = torch.as_tensor(Ad, dtype=dtype, device=dev)
    Bp = torch.as_tensor(Bd, dtype=dtype, device=dev)

    def plant(z, w, pp):
        x, u_prev = z[:3], z[3:]
        u = u_prev + w
        return torch.cat([Ap @ x + Bp @ u, u])

    results = []
    qys = np.asarray(q_y_values, dtype=float)
    B = len(qys)

    for N in horizons:
        ocp = sweep_ocp(N, Ad, Bd, dev, dtype)
        solve = make_batched_ilqr_solver(ocp, ILQROptions(max_iters=max_iters))
        run = make_batched_receding_horizon(ocp, solve, plant, Nsim)

        ref_par = stage_param_tensor(refs, N + 1, Nsim)             # (Nsim, N+1, 4)
        base = np.concatenate([ref_par, np.zeros((Nsim, N + 1, 1))], axis=2)
        batch_par = np.broadcast_to(base[:, None], (Nsim, B) + base.shape[1:]).copy()
        batch_par[..., 4] = qys[None, :, None]

        res = run(np.zeros((B, 4)), batch_par)
        zs = res.xs.double().cpu().numpy().transpose(1, 0, 2)      # (B, Nsim+1, 4)
        conv = res.converged.cpu().numpy().T                       # (B, Nsim)
        xs = zs[:, :, :3]
        err = xs[:, :Nsim] - refs[None, :Nsim, :3]
        xz = np.concatenate([
            np.zeros((B, 1)),
            np.cumsum(uref * np.cos(xs[:, :-1, 1]) * T, axis=1)], axis=1)
        traj = np.stack([xz[:, :Nsim], xs[:, :Nsim, 0]], axis=1)     # (B,2,Nsim)
        traje = np.stack([path["x"][:Nsim], path["y"][:Nsim]])       # (2,Nsim)
        dist = np.linalg.norm(traj - traje[None], axis=1)            # (B,Nsim)

        for i, qy in enumerate(qys):
            results.append({
                "horizon": int(N), "q_y": float(qy),
                "mean_y": float((err[i, :, 0] ** 2).mean()),
                "mean_phi": float((err[i, :, 1] ** 2).mean()),
                "mean_path_dist": float(dist[i].mean()),
                "converged_frac": float(conv[i].mean()),
            })
    return results
