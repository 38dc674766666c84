"""Differential-drive point stabilization: the Casadi/ family (port of
``mpc_verde_tpu.scenarios.diffdrive``).

Constants from ``Casadi/single_shooting_v1.py:29-47``: T = 0.2, N = 10,
Q = diag(1, 5, 0.1), R = diag(0.5, 0.05), v in [-1, 1], omega in
[-pi/4, pi/4], start (0, 0, 0) toward the target (10, 10, 0); the closed loop
reaches ||(x, y) - target|| < 0.1 in 84 steps in the reference (:232-235).
One problem at a time (B = 1), through ``make_ilqr_solver`` and the
receding-horizon driver.  On the card the solve runs ``"cuda_fused"``: the
device model carries both the RK4 / Euler dynamics and the quadrature cost.
"""
from __future__ import annotations

import numpy as np
import torch

from ..interop import unicycle_ocp
from ..models import unicycle
from ..ops import euler_step, rk4_step
from ..runtime import make_receding_horizon
from ..solver import ILQROptions, make_ilqr_solver
from ..utils import scenario_device

SPEC = dict(T=0.2, N=10, Q=(1.0, 5.0, 0.1), R=(0.5, 0.05),
            v_max=1.0, omega_max=np.pi / 4,
            x0=(0.0, 0.0, 0.0), target=(10.0, 10.0, 0.0), sim_time=20.0)
PLANTS = ("euler", "rk4")


def diffdrive_ocp(N: int, device, dtype=torch.float32, integrator="rk4",
                  cost="discrete", M: int = 1):
    """The diff-drive OCP at horizon ``N`` (SPEC's weights and box, target
    in p[:3]): ``integrator`` "rk4" with ``M`` substeps or "euler", stage
    cost "discrete" or "quadrature" over ``M`` RK4 substeps."""
    s = SPEC
    return unicycle_ocp(N, device, dtype, dt=s["T"], Q=np.diag(s["Q"]),
                        R=np.diag(s["R"]), lb=[-s["v_max"], -s["omega_max"]],
                        ub=[s["v_max"], s["omega_max"]], cost=cost,
                        quad_substeps=M, integrator=integrator, substeps=M)


def build_diffdrive(integrator: str = "rk4", max_iters: int = 40,
                    n_steps: int = 100, cost: str = "discrete",
                    plant: str = "euler", M: int = 1, device=None,
                    backend=None, dtype=torch.float32):
    """The diff-drive OCP, solver, plant step and closed-loop runner, across
    the Casadi/ family's variants (``plant``, ``(x, u, p_plant) -> x_next``,
    builds runners of other lengths, as ``runtime.SegmentedRun`` needs).

    ``integrator``: the controller's dynamics, "rk4" with ``M`` substeps or
    "euler".  ``cost="discrete"``: the per-stage sum
    (single_shooting_v1.py:97-105); ``cost="quadrature"``: the running cost
    integrated with RK4 over ``M`` substeps (single_shooting_v2.py:100-113),
    the transcription behind the reference's xlsx goldens.
    ``plant="euler"``: the v1 Euler shift (:17-27); ``plant="rk4"``: the
    controller's RK4 model (``M`` substeps) as the plant.
    ``device`` defaults to the CUDA device and raises without one (pass
    ``device="cpu"`` for the CPU); ``backend`` None is ``"cuda_fused"`` on a
    CUDA device and ``"torch"`` elsewhere.
    """
    if plant not in PLANTS:
        raise ValueError(f"unknown plant {plant!r}; expected {PLANTS}")
    dev = scenario_device(device, "build_diffdrive")
    s = SPEC
    ocp = diffdrive_ocp(s["N"], dev, dtype, integrator, cost, M)
    solve = make_ilqr_solver(ocp, ILQROptions(max_iters=max_iters),
                             backend=backend)
    pstep = (euler_step(unicycle.f, s["T"]) if plant == "euler"
             else rk4_step(unicycle.f, s["T"], M=M))
    plant_step = lambda x, u, pp: pstep(x, u, None)
    run = make_receding_horizon(ocp, solve, plant_step, n_steps)
    return {"ocp": ocp, "solve": solve, "run": run, "spec": s,
            "n_steps": n_steps, "plant": plant_step}


def run_diffdrive(built=None, **kw):
    """Run the closed loop; the JAX package's metrics under its keys, plus
    ``converged_frac`` (the share of steps whose solve converged)."""
    if built is None:
        built = build_diffdrive(**kw)
    s = built["spec"]
    n = built["n_steps"]
    params = np.broadcast_to(np.array(s["target"]), (n, s["N"] + 1, 3))
    res = built["run"](np.array(s["x0"]), params)
    xs = res.xs.double().cpu().numpy()
    errs = np.linalg.norm(xs[:, :2] - np.array(s["target"])[:2], axis=1)
    reached = errs < 0.1
    steps_to_target = int(np.argmax(reached)) if reached.any() else -1
    return {
        "result": res,
        "steps_to_target": steps_to_target,
        "final_error": float(np.linalg.norm(xs[-1] - np.array(s["target"]))),
        "ss_error": float(errs[-1]),
        "converged_all": bool(res.converged.all()),
        "converged_frac": float(res.converged.double().mean()),
    }
