"""The system under test for a planar quadrotor configuration: the OCP as a
user of the port writes one, from plain callables, with no device model.

On the card the solver factories' ``backend=None`` therefore traces the
callables (``ops/cuda/trace.py``), generates a device model from the trace
(``ops/cuda/codegen.py``) and runs K3 and K2 instantiated on it from the
program's own library (``"cuda_fused"``): nothing of the model is written
by hand."""
from __future__ import annotations

import torch


def build_ocp(cfg: dict, device: torch.device):
    """Drake's Quadrotor2D as an OCP of the port: RK4 of T a stage over N
    stages, the stage cost (x - p)' Q (x - p) + (u - u_ref)' R (u - u_ref),
    the terminal cost terminal_weight (x_N - p)' Q (x_N - p) and the box
    u_lb <= u <= u_ub, with the target as the stage parameter p (npar 6).
    Every number comes from the configuration."""
    from mpc_verde_tpu_torch import OCP, box_bounds
    from mpc_verde_tpu_torch.ops import rk4_step

    if cfg["integrator"] != "rk4":
        raise ValueError(f"unknown integrator {cfg['integrator']!r}")
    dtype = getattr(torch, cfg["dtype"])
    z = dict(dtype=dtype, device=device)
    m, arm, inertia, g = (float(cfg[k]) for k in ("m", "arm", "I", "g"))
    Q, R = (torch.diag(torch.tensor(cfg[k], **z)) for k in ("Q", "R"))
    u_ref = torch.tensor(cfg["u_ref"], **z)
    qf = float(cfg["terminal_weight"])

    def rhs(x, u, p):
        thrust = u[0] + u[1]
        return torch.stack([x[3], x[4], x[5], -torch.sin(x[2]) * thrust / m,
                            torch.cos(x[2]) * thrust / m - g,
                            arm * (u[0] - u[1]) / inertia])

    def stage_cost(x, u, p):
        e, du = x - p, u - u_ref
        return e @ Q @ e + du @ R @ du

    def terminal_cost(x, p):
        e = x - p
        return qf * (e @ Q @ e)

    nx = len(cfg["Q"])
    return OCP(dynamics=rk4_step(rhs, float(cfg["T"])), stage_cost=stage_cost,
               terminal_cost=terminal_cost, N=int(cfg["N"]), nx=nx,
               nu=len(cfg["R"]), npar=len(cfg["target"]),
               control_bounds=box_bounds(cfg["u_lb"], cfg["u_ub"],
                                         device=device, dtype=dtype),
               device=torch.device(device), dtype=dtype)
