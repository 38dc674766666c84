"""Plain reference of the planar quadrotor OCP, in PyTorch alone.

Drake's Quadrotor2D (Tedrake, Underactuated Robotics, ch. 3): states (x,
y, theta, x', y', theta'), the two rotors' thrusts u = (u1, u2), ``x'' =
-sin(theta) (u1 + u2) / m``, ``y'' = cos(theta) (u1 + u2) / m - g``,
``theta'' = arm (u1 - u2) / I``; one RK4 step of T per stage; stage cost
``(x - p)' Q (x - p) + (u - u_ref)' R (u - u_ref)`` over stages 0 .. N-1,
terminal cost ``terminal_weight (x_N - p)' Q (x_N - p)``, Q and R diagonal,
p the target; the box ``u_lb <= u <= u_ub``.  Every number comes from the
configuration's file; the functions run in the dtype of their inputs
(float64 for the check, a lower one for the control) on any device,
batched over a leading axis.  Nothing of the program is imported or read.
"""
from __future__ import annotations

import torch

# float32 products on the card stay float32 (no TF32), should a caller run
# the reference there in float32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rhs(x, u, cfg: dict):
    m, arm, inertia, g = (cfg[k] for k in ("m", "arm", "I", "g"))
    th = x[..., 2]
    thrust = u[..., 0] + u[..., 1]
    return torch.stack([x[..., 3], x[..., 4], x[..., 5],
                        -torch.sin(th) * thrust / m,
                        torch.cos(th) * thrust / m - g,
                        arm * (u[..., 0] - u[..., 1]) / inertia], dim=-1)


def step(x, u, cfg: dict):
    """One RK4 step of T from x under the thrusts u held constant."""
    if cfg["integrator"] != "rk4":
        raise ValueError(f"unknown integrator {cfg['integrator']!r}")
    T = cfg["T"]
    k1 = rhs(x, u, cfg)
    k2 = rhs(x + (0.5 * T) * k1, u, cfg)
    k3 = rhs(x + (0.5 * T) * k2, u, cfg)
    k4 = rhs(x + T * k3, u, cfg)
    return x + (T / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rollout(x0, us, cfg: dict):
    """(B, N+1, 6) states from x0 (B, 6) under us (B, N, 2)."""
    xs = [x0]
    for k in range(us.shape[1]):
        xs.append(step(xs[-1], us[:, k], cfg))
    return torch.stack(xs, dim=1)


def _weights(cfg: dict, like):
    t = lambda a: torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return t(cfg["Q"]), t(cfg["R"]), t(cfg["u_ref"]), t(cfg["target"])


def cost(xs, us, cfg: dict):
    """(B,) cost of the trajectories: the stage costs of stages 0 .. N-1
    and the terminal cost of x_N."""
    Q, R, u_ref, p = _weights(cfg, xs)
    e = xs - p
    du = us - u_ref
    stages = (e[:, :-1] * e[:, :-1] * Q).sum(dim=(-1, -2)) + (
        du * du * R).sum(dim=(-1, -2))
    return stages + cfg["terminal_weight"] * (e[:, -1] * e[:, -1] * Q).sum(-1)


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
