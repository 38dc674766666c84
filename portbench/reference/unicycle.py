"""Plain reference of the unicycle OCP and its plant, in PyTorch alone.

The reference's diff-drive problem (gabrielhaj/mpc-verde,
``Casadi/single_shooting_v1.py`` and ``Casadi/multiple_shooting_casadi.py``):
states (x, y, theta), controls (v, omega), ``dx/dt = (v cos theta, v sin
theta, omega)``, one RK4 or Euler step of T per stage, stage cost ``(x -
p)' Q (x - p) + u' R u`` over stages 0 .. N-1 and no terminal cost, and the
box ``u_lb <= u <= u_ub``.  Every number comes from the configuration's
file; the functions run in the dtype of their inputs (float64 for the
check, a lower one for the control) on any device, batched over a leading
axis.  Nothing of the program is imported or read.
"""
from __future__ import annotations

import torch


def rhs(x, u):
    th = x[..., 2]
    v, w = u[..., 0], u[..., 1]
    return torch.stack([v * torch.cos(th), v * torch.sin(th), w], dim=-1)


def step(x, u, T: float, integrator: str):
    """One step of T from x under the control u held constant."""
    if integrator == "euler":
        return x + T * rhs(x, u)
    if integrator == "rk4":
        k1 = rhs(x, u)
        k2 = rhs(x + (0.5 * T) * k1, u)
        k3 = rhs(x + (0.5 * T) * k2, u)
        k4 = rhs(x + T * k3, u)
        return x + (T / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    raise ValueError(f"unknown integrator {integrator!r}")


def rollout(x0, us, cfg: dict):
    """(B, N+1, 3) states of the controller's model from x0 (B, 3) under
    us (B, N, 2)."""
    xs = [x0]
    for k in range(us.shape[1]):
        xs.append(step(xs[-1], us[:, k], cfg["T"], cfg["integrator"]))
    return torch.stack(xs, dim=1)


def _weights(cfg: dict, like):
    t = lambda a: torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return t(cfg["Q"]), t(cfg["R"]), t(cfg["target"])


def cost(xs, us, cfg: dict):
    """(B,) cost of the trajectories: the stage costs of stages 0 .. N-1."""
    Q, R, p = _weights(cfg, xs)
    e = xs[:, :-1] - p
    return (e * e * Q).sum(dim=(-1, -2)) + (us * us * R).sum(dim=(-1, -2))


def projected_gradient(x0, us, cfg: dict, at_bound: float = 1e-6):
    """(B,) largest |component| of the gradient of the cost of rolling us
    out from x0 with respect to us, with the components that push a control
    resting on its bound (within ``at_bound``) further out taken as 0: the
    first-order optimality residual of the box-constrained problem."""
    us = us.detach().clone().requires_grad_(True)
    J = cost(rollout(x0, us, cfg), us, cfg)
    (g,) = torch.autograd.grad(J.sum(), us)
    u = us.detach()
    lb = torch.as_tensor(cfg["u_lb"], dtype=u.dtype, device=u.device)
    ub = torch.as_tensor(cfg["u_ub"], dtype=u.dtype, device=u.device)
    out = ((u <= lb + at_bound) & (g > 0)) | ((u >= ub - at_bound) & (g < 0))
    return torch.where(out, 0.0, g).abs().amax(dim=(-1, -2))


def plant_step(x, u, cfg: dict):
    """The closed loop's plant: one step of T by ``cfg["plant"]``."""
    return step(x, u, cfg["T"], cfg["plant"])
