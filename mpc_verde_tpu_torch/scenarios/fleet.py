"""Fleet closed loop: B robots driven to one target by batched receding-horizon MPC.

Port of ``mpc_verde_tpu.scenarios.fleet``, the JAX package's flagship
serving workload: the reference's single diff-drive robot
(``Casadi/single_shooting_v1.py:164-214``) batched over a fleet that starts
from random poses around the origin.  Every MPC step solves all B problems
with one batched solve (RK4 controller model); the plant is an Euler step,
the reference's ``shift_timestep``.  Every robot must reach the reference's
acceptance ball ``||(x, y) - target|| < 0.1`` (``single_shooting_v1.py:166``).

On the card the fleet runs ``backend="cuda_fused"``: each solver iteration
is the fused derivs+backward kernel, the line-search kernel and the
acceptance logic.
"""
from __future__ import annotations

import numpy as np
import torch

from ..interop import unicycle_ocp
from ..models import unicycle
from ..ops import euler_step
from ..runtime import make_batched_receding_horizon
from ..solver import ILQROptions, make_batched_ilqr_solver
from ..utils import scenario_device

SPEC = dict(T=0.2, N=10, Nsim=150, B=1024, target=(10.0, 10.0, 0.0),
            v_max=1.0, omega_max=np.pi / 4,
            Q=(1.0, 5.0, 0.1), R=(0.5, 0.05),
            start_box=2.0, seed=0, tol=0.1)


def build_fleet(B: int = None, n_steps: int = None, backend: str = None,
                max_iters: int = 30, device=None, dtype=torch.float32):
    """The fleet's OCP, closed-loop runner and inputs.

    ``device`` defaults to the CUDA device; without one the call raises, and
    the fleet runs on the CPU only when asked with ``device="cpu"``.
    ``backend`` None is the solvers' rule (``solver.batched.resolve_backend``):
    ``"cuda_fused"`` for the float32 fleet on a CUDA device (its own
    unicycle device model), ``"cuda_bw"`` for a float64 one there (K1 on
    float32 copies), ``"torch"`` on the CPU.  Returns a dict with ``ocp``, ``run``, ``x0s`` (B, 3) and
    ``params`` (Nsim, N+1, 3) as numpy float32, and ``spec``.
    """
    s = dict(SPEC)
    if B is not None:
        s["B"] = B
    if n_steps is not None:
        s["Nsim"] = n_steps
    device = scenario_device(device, "build_fleet")

    T, N = s["T"], s["N"]
    f32 = lambda a: np.array(a, dtype=np.float32)   # as the JAX fleet writes them
    ocp = unicycle_ocp(N, device, dtype, dt=T, Q=np.diag(f32(s["Q"])),
                       R=np.diag(f32(s["R"])),
                       lb=f32([-s["v_max"], -s["omega_max"]]),
                       ub=f32([s["v_max"], s["omega_max"]]))
    solve = make_batched_ilqr_solver(ocp, ILQROptions(max_iters=max_iters),
                                     backend=backend)
    plant = euler_step(unicycle.f, T)
    run = make_batched_receding_horizon(
        ocp, solve, lambda x, u, pp: plant(x, u, None), s["Nsim"])

    rng = np.random.default_rng(s["seed"])
    x0s = np.zeros((s["B"], 3), dtype=np.float32)
    x0s[:, :2] = rng.uniform(-s["start_box"], s["start_box"], (s["B"], 2))
    x0s[:, 2] = rng.uniform(-np.pi / 2, np.pi / 2, s["B"])
    params = np.broadcast_to(
        np.asarray(s["target"], dtype=np.float32),
        (s["Nsim"], N + 1, 3)).copy()
    return {"ocp": ocp, "run": run, "x0s": x0s, "params": params, "spec": s}


def run_fleet(built=None, **kw):
    """Run the fleet; returns the per-robot final-error distribution metrics
    under the JAX package's keys (``result`` is the ``ClosedLoopResult``).
    Without ``built`` the fleet is ``build_fleet(**kw)``, on the CUDA device
    unless ``device="cpu"`` is given."""
    if built is None:
        built = build_fleet(**kw)
    s = built["spec"]
    res = built["run"](built["x0s"], built["params"])
    xs = res.xs.double().cpu().numpy()                    # (Nsim+1, B, 3)
    tgt = np.asarray(s["target"][:2], dtype=np.float64)
    err_t = np.linalg.norm(xs[:, :, :2] - tgt, axis=-1)   # (Nsim+1, B)
    final_err = err_t[-1]
    # first step each robot enters the reference's acceptance ball (tol=0.1)
    inside = err_t < s["tol"]
    reached = inside.any(axis=0)
    t_first = np.where(reached, inside.argmax(axis=0), -1)
    return {
        "result": res,
        "final_err": final_err,
        "B": int(s["B"]),
        "n_steps": int(s["Nsim"]),
        "final_err_max": float(final_err.max()),
        "final_err_p99": float(np.percentile(final_err, 99)),
        "final_err_mean": float(final_err.mean()),
        "frac_reached": float(reached.mean()),
        "steps_to_ball_mean": float(t_first[reached].mean()) if reached.any()
        else float("nan"),
        "steps_to_ball_max": int(t_first.max()),
        "converged_frac": float(res.converged.float().mean()),
    }
