"""Dynamic bicycle LTV tracking: Trajectory_tracking_dynamic_model.py (port
of ``mpc_verde_tpu.scenarios.dynamic_bicycle``).

Constants (:18-45): Delta = 0.05, Nt = 10, Ntu = 10, 4 states (y, phi,
v_lat, r), 1 control (steering), Q = eye(4), R = 1, delta bounds +-20,
m = 1200, a = 1.5, b = 2, Ca = 55000, Jz = 1350.  The A/B coefficients are
rebuilt from the time-varying speed vref[t] each step (:119-128).

The committed reference uses A33 / A34 / B31 before their first assignment
in its reference synthesis (:107,110,115 against :119-123), so it raises
NameError when run fresh (SURVEY.md §2.1).  As in the JAX package, the
coefficients are computed before delta_ref is synthesized, the only order
under which the program is well-defined.  In rate form the state is
z = [y, phi, v_lat, r, delta_prev] (nx 5); each step's (Ad, Bd) ride in
p[5:21] and p[21:25], where the OCP's dynamics read them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..interop import linear_rate_ocp
from ..models.bicycle import dynamic_bicycle_coeffs
from ..ops import c2d
from ..refgen import path_heading, stage_param_tensor, synthetic_lane_change
from ..runtime import make_receding_horizon
from ..solver import ILQROptions, make_ilqr_solver
from ..utils import scenario_device

SPEC = dict(T=0.05, N=10, Ntu=10, Q=(1.0, 1.0, 1.0, 1.0), R=1.0,
            delta_max=20.0, m=1200.0, a=1.5, b=2.0, Ca=55000.0, Jz=1350.0)


def build_dynamic_bicycle(path=None, n_steps=None, max_iters: int = 30,
                          corrected: bool = False, device=None, backend=None,
                          dtype=torch.float32):
    """``corrected=True`` replaces the reference's reference-synthesis quirks
    (phi_ref = atan2(y, x) position angle :97-99; forward speed tracked as
    the lateral-velocity state) with consistent references: path-heading
    phi_ref, v_lat_ref = 0, r_ref = dphi/dt.  The batched ZOH
    discretization runs in float64 on the scenario's device and is rounded
    to ``dtype``.  ``device`` defaults to the CUDA device and raises without
    one (pass ``device="cpu"`` for the CPU); ``backend`` None is
    ``"cuda_fused"`` on a CUDA device and ``"torch"`` elsewhere."""
    s = dict(SPEC)
    dev = scenario_device(device, "build_dynamic_bicycle")
    if path is None:
        path = synthetic_lane_change(n=500, dt=s["T"])
    Nsim = len(path["x"]) if n_steps is None else n_steps
    N, T = s["N"], s["T"]

    xr = np.asarray(path["x"], float)
    yr = np.asarray(path["y"], float)
    vr = np.asarray(path["uref"], float)
    Nfull = len(xr)

    # coefficients first (the reference's order bug fixed), over the run
    A33 = -4 * s["Ca"] / (s["m"] * vr)
    A34 = (2 * s["Ca"] * (s["b"] - s["a"]) / s["m"] * vr) - vr
    B31 = 2 * s["Ca"] / s["m"]

    # reference synthesis: y_ref, phi_ref = atan2(y, x) (the reference's
    # literal position-angle form :97-99), v_ref, then r_ref / delta_ref by
    # finite differences inverted through the model (:100-115)
    if corrected:
        phi_r = path_heading(xr, yr)
    else:
        phi_r = np.arctan2(yr, xr)
        phi_r[0] = 0.0
    r_r = np.zeros(Nfull)
    r_r[1:-1] = (phi_r[2:] - phi_r[:-2]) / (2 * T)
    r_r[0] = (phi_r[1] - phi_r[0]) / T
    r_r[-1] = (phi_r[-1] - phi_r[-2]) / T
    v_dot = np.gradient(vr, T)
    if corrected:
        vlat_r = np.zeros(Nfull)
        delta_r = np.zeros(Nfull)
    else:
        vlat_r = vr  # the reference tracks forward speed in the v_lat slot
        delta_r = (v_dot - A33 * vr - A34 * r_r) / B31

    # full-path table, so that the horizon peeks past Nsim
    refs_full = np.stack([yr, phi_r, vlat_r, r_r, delta_r], axis=-1)  # (Nfull, 5)
    refs = refs_full[:Nsim]

    # per-step (Ad, Bd) from the LTV coefficients, one batched c2d
    f64 = dict(dtype=torch.float64, device=dev)
    Acs, Bcs = dynamic_bicycle_coeffs(torch.as_tensor(vr[:Nsim], **f64),
                                      s["m"], s["a"], s["b"], s["Ca"], s["Jz"])
    Ads, Bds = c2d(Acs, Bcs, T)                 # (Nsim, 4, 4), (Nsim, 4, 1)

    # params: [y_ref, phi_ref, v_ref, r_ref, delta_ref, vec(Ad) 16, Bd 4]
    ocp = linear_rate_ocp(N, dev, dtype, Q=np.diag(s["Q"]), R=[[s["R"]]],
                          u_lb=[-s["delta_max"]], u_ub=[s["delta_max"]],
                          ab_col=5, x_ref=0, u_ref=4)
    solve = make_ilqr_solver(ocp, ILQROptions(max_iters=max_iters),
                             backend=backend)

    ref_par = stage_param_tensor(refs_full, N + 1, Nsim)
    mats = torch.cat([Ads.reshape(Nsim, 16), Bds.reshape(Nsim, 4)],
                     dim=1).cpu().numpy()
    par = np.concatenate([
        ref_par, np.broadcast_to(mats[:, None, :], (Nsim, N + 1, 20))], axis=2)

    def plant(z, w, pp):
        x, u_prev = z[:4], z[4:]
        u = u_prev + w
        A = pp[:16].reshape(4, 4)
        B = pp[16:20]
        return torch.cat([A @ x + B * u[0], u])

    run = make_receding_horizon(ocp, solve, plant, Nsim)
    return {"ocp": ocp, "solve": solve, "run": run, "spec": s, "path": path,
            "params_seq": par, "plant_params": mats, "refs": refs,
            "n_steps": Nsim}


def run_dynamic_bicycle(built=None, **kw):
    """Run the closed loop from z = 0; the JAX package's metrics under its
    keys."""
    if built is None:
        built = build_dynamic_bicycle(**kw)
    Nsim = built["n_steps"]
    res = built["run"](np.zeros(5), built["params_seq"], built["plant_params"])
    xs = res.xs.double().cpu().numpy()[:, :4]
    refs = built["refs"][:Nsim]
    err_y = xs[:Nsim, 0] - refs[:, 0]
    return {
        "result": res, "x": xs,
        "mse_y": float((err_y ** 2).mean()),
        "max_err_y": float(np.abs(err_y).max()),
        "converged_frac": float(res.converged.double().mean()),
    }
