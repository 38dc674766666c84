"""Inverted pendulum on a cart: the Inverted_pendulum/ family (port of
``mpc_verde_tpu.scenarios.pendulum``).

Constants from ``inverted_pendulum_single_shooting_mpctools.py:15-64``:
T = 0.01, Nt = 50, 4 states (x, xdot, theta, thetadot), force input bounded
+-200, move blocking (Du free for 5 stages, pinned after), stage cost
(1.2 (x1 - 10))^2 + theta^2 + (0.01 du)^2, exact linear plant.  In rate
form the state is z = [x, xdot, theta, thetadot, u_prev] (nx 5) and the OCP
has no params (npar 0; the closed-loop runner pads them to one column).
One problem at a time (B = 1); on the card the solve runs ``"cuda_fused"``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..interop import linear_rate_ocp
from ..models import cart_pendulum_linear
from ..ops import c2d
from ..runtime import make_receding_horizon
from ..solver import ILQROptions, make_ilqr_solver
from ..utils import scenario_device
from .lane_change import move_blocking

SPEC = dict(T=0.01, N=50, Ntu=5, u_max=200.0, x_target=10.0,
            q_x=1.2, q_theta=1.0, r_du=0.01, n_steps=1000)


def pendulum_ocp(N: int, Ntu: int, device, dtype=torch.float32, spec=SPEC):
    """The pendulum's rate-form OCP: Q = diag(q_x^2, 0, q_theta^2, 0)
    toward the constant target (x_target, 0, 0, 0), R_du = r_du^2, the force
    box and move blocking after ``Ntu``; ZOH (Ad, Bd) in float64."""
    s = spec
    m = cart_pendulum_linear(device="cpu", dtype=torch.float64)
    Ad, Bd = (a.numpy() for a in c2d(m.Ac, m.Bc, s["T"]))
    du_lb, du_ub = move_blocking(N, Ntu)
    return linear_rate_ocp(
        N, device, dtype, Q=np.diag([s["q_x"] ** 2, 0.0, s["q_theta"] ** 2, 0.0]),
        R=[[0.0]], R_du=[[s["r_du"] ** 2]], u_lb=[-s["u_max"]],
        u_ub=[s["u_max"]], du_lb=du_lb, du_ub=du_ub, Ad=Ad, Bd=Bd,
        target=[s["x_target"], 0.0, 0.0, 0.0]), (Ad, Bd)


def build_pendulum(n_steps: int = None, max_iters: int = 25, device=None,
                   backend=None, dtype=torch.float32):
    """The pendulum's OCP, solver and closed-loop runner.  ``device``
    defaults to the CUDA device and raises without one (pass
    ``device="cpu"`` for the CPU); ``backend`` None is ``"cuda_fused"`` on a
    CUDA device and ``"torch"`` elsewhere."""
    s = dict(SPEC)
    if n_steps is not None:
        s["n_steps"] = n_steps
    dev = scenario_device(device, "build_pendulum")
    ocp, (Ad, Bd) = pendulum_ocp(s["N"], s["Ntu"], dev, dtype, s)
    solve = make_ilqr_solver(ocp, ILQROptions(max_iters=max_iters),
                             backend=backend)
    Ap = torch.as_tensor(Ad, dtype=dtype, device=dev)
    Bp = torch.as_tensor(Bd, dtype=dtype, device=dev)

    def plant(z, w, pp):
        # exact linear update, as the reference's ffunc plant (:78)
        x, u_prev = z[:4], z[4:]
        u = u_prev + w
        return torch.cat([Ap @ x + Bp @ u, u])

    run = make_receding_horizon(ocp, solve, plant, s["n_steps"])
    return {"ocp": ocp, "solve": solve, "run": run, "spec": s}


def run_pendulum(built=None, **kw):
    """Run the closed loop from rest at the origin; the JAX package's
    metrics under its keys."""
    if built is None:
        built = build_pendulum(**kw)
    s = built["spec"]
    res = built["run"](np.zeros(5))
    zs = res.xs.double().cpu().numpy()
    xs = zs[:, :4]
    dus = res.us.double().cpu().numpy()
    us = zs[:-1, 4] + dus[:, 0]
    return {
        "result": res, "x": xs, "u": us,
        "final_pos_error": float(abs(xs[-1, 0] - s["x_target"])),
        "max_angle": float(np.abs(xs[:, 2]).max()),
        "max_force": float(np.abs(us).max()),
        "converged_frac": float(res.converged.double().mean()),
    }
