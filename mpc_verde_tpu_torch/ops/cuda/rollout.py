"""Fused parallel line search / pre-roll: CUDA kernel K2 and its PyTorch twin.

``linesearch_forward`` replaces the Pallas TPU kernel
``linesearch_forward_pallas`` (``mpc_verde_tpu/ops/pallas/rollout.py``).
For each problem and each step length alpha it rolls
``u = clip(u_nom + alpha*kff + K(x - x_nom))``, ``x' = F(x, u, p)``,
accumulating the cost, keeps the first minimum over ascending alpha, and
returns the winner's trajectory.  With zero gains and one alpha it is the
pre-roll of a problem queue.

Its kernel is ``csrc/rollout.cu``: one thread per problem runs A cost
passes and one re-roll of the winner, (A+1)*N sequential steps.  At the
bench shapes (B = 1024, N = 40, A = 8) the card is latency bound on that
per-thread chain; the (B, N, ...) loads do not coalesce.  A problem-fastest
layout and alpha passes spread over threads are left for a later change.

The Pallas kernel inlines the OCP's jaxprs.  A CUDA kernel cannot inline a
Python callable, so the kernel evaluates a ``UnicycleDeviceModel`` carried on
the OCP: plain numbers describing the same dynamics, cost and box as the
OCP's torch callables.  Its ``step`` / ``stage_cost`` / ``terminal_cost``
methods are those formulas in PyTorch, in the kernel's order, so a test can
tie the two definitions together.

``linesearch_forward_torch`` is the plain PyTorch version: the JAX
materialising line search (``mpc_verde_tpu/solver/batched.py``) on the
OCP's own callables, with alpha as a batch dimension.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from .build import check_args, check_launch, load_library

MAX_ALPHAS = 32  # kMaxAlphas in csrc/rollout.cu


@dataclasses.dataclass(frozen=True)
class UnicycleDeviceModel:
    """Kernel-side description of a unicycle OCP (nx = 3, nu = 2, npar >= 3).

    Dynamics: unicycle kinematics, ``integrator`` "rk4" (``substeps`` equal
    substeps over ``dt``) or "euler" (one step).  Stage cost
    ``(x - p[:3])' Q (x - p[:3]) + u' R u``; terminal cost
    ``(x - p[:3])' Qf (x - p[:3])`` when ``Qf`` is given.  Control box
    ``lb <= u <= ub``, constant over the horizon.
    """

    dt: float
    Q: np.ndarray
    R: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    Qf: Optional[np.ndarray] = None
    substeps: int = 1
    integrator: str = "rk4"

    def __post_init__(self):
        if self.integrator not in ("rk4", "euler"):
            raise ValueError(f"unknown integrator {self.integrator!r}")
        if self.integrator == "euler" and self.substeps != 1:
            raise ValueError("the euler device model takes one step")
        shapes = {"Q": (3, 3), "R": (2, 2), "lb": (2,), "ub": (2,)}
        if self.Qf is not None:
            shapes["Qf"] = (3, 3)
        for name, shape in shapes.items():
            if np.shape(getattr(self, name)) != shape:
                raise ValueError(f"{name} must have shape {shape}")

    def _consts(self):
        """(h, h/2, h/6), computed in double as the torch integrator does."""
        h = self.dt / self.substeps
        return h, 0.5 * h, h / 6.0

    def packed(self) -> np.ndarray:
        """float32 [h, h/2, h/6, Q, R, Qf, lb, ub], the kernel's layout."""
        Qf = np.zeros((3, 3)) if self.Qf is None else self.Qf
        return np.concatenate([
            np.asarray(self._consts()), np.ravel(self.Q), np.ravel(self.R),
            np.ravel(Qf), np.ravel(self.lb), np.ravel(self.ub),
        ]).astype(np.float32)

    # --- the kernel's formulas in PyTorch (batched over leading dims) -------
    def _t(self, a, like):
        return torch.as_tensor(np.asarray(a), dtype=like.dtype,
                               device=like.device)

    def step(self, x, u):
        h, hh, h6 = self._consts()

        def rhs(x):
            return torch.stack([u[..., 0] * torch.cos(x[..., 2]),
                                u[..., 0] * torch.sin(x[..., 2]),
                                u[..., 1]], dim=-1)

        if self.integrator == "euler":
            return x + h * rhs(x)
        for _ in range(self.substeps):
            k1 = rhs(x)
            k2 = rhs(x + hh * k1)
            k3 = rhs(x + hh * k2)
            k4 = rhs(x + h * k3)
            x = x + h6 * (((k1 + 2.0 * k2) + 2.0 * k3) + k4)
        return x

    def _quad(self, W, v):
        return ((v[..., :, None] * self._t(W, v)).sum(-2) * v).sum(-1)

    def stage_cost(self, x, u, p):
        return self._quad(self.Q, x - p[..., :3]) + self._quad(self.R, u)

    def terminal_cost(self, x, p):
        if self.Qf is None:
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        return self._quad(self.Qf, x - p[..., :3])


def linesearch_forward_torch(x0, xs, us, ps, kffs, Ks, alphas: Sequence[float],
                             *, ocp):
    """Plain PyTorch line search on ``ocp``'s callables (same contract as the kernel).

    Args:
      x0: (B, nx); xs: (B, N+1, nx) nominal states; us: (B, N, nu) nominal
        controls; ps: (B, N+1, npar); kffs: (B, N, nu); Ks: (B, N, nu, nx).
      alphas: step lengths; the first minimum of the cost wins.

    Returns (xs (B, N+1, nx), us (B, N, nu), cost (B,), best (B,) int32):
    the winner's trajectory, its cost and its alpha index.
    """
    if x0.is_cuda:
        linesearch_forward_torch.cuda_calls += 1
    B, N, nu = us.shape
    nx = x0.shape[-1]
    A = len(alphas)
    al = torch.tensor(list(alphas), dtype=x0.dtype, device=x0.device)
    F = vmap(ocp.dynamics)
    l = vmap(ocp.stage_cost)
    cb = ocp.control_bounds
    cbv = None if cb is None else vmap(cb, in_dims=(0, 0, None))
    rep = lambda t: t.expand((A,) + t.shape).reshape((A * B,) + t.shape[1:])

    x = rep(x0)
    xs_c, us_c, cs = [], [], []
    for k in range(N):
        p = rep(ps[:, k])
        u = (rep(us[:, k]) + (al[:, None, None] * kffs[None, :, k]).reshape(
            A * B, nu)) + (rep(Ks[:, k]) @ (x - rep(xs[:, k]))[..., None])[..., 0]
        if cbv is not None:
            lb, ub = cbv(x, p, k)
            u = torch.clamp(u, lb, ub)
        xs_c.append(x)
        us_c.append(u)
        cs.append(l(x, u, p))
        x = F(x, u, p)
    xs_c.append(x)
    cost = torch.stack(cs, dim=-1).sum(-1)
    if ocp.terminal_cost is not None:
        cost = cost + vmap(ocp.terminal_cost)(x, rep(ps[:, N]))
    cost = cost.reshape(A, B)
    best = torch.argmin(cost, dim=0)              # first minimum, like jnp
    pick = best * B + torch.arange(B, device=x0.device)
    xs_b = torch.stack(xs_c, dim=1)[pick]
    us_b = torch.stack(us_c, dim=1)[pick]
    return xs_b, us_b, cost.reshape(-1)[pick], best.to(torch.int32)


linesearch_forward_torch.cuda_calls = 0


def linesearch_forward(x0, xs, us, ps, kffs, Ks, alphas: Sequence[float], *,
                       ocp):
    """Fused line search: the CUDA kernel for CUDA tensors.

    Same arguments and results as ``linesearch_forward_torch``, which is
    what runs when the tensors lie on the CPU.  On the card the kernel
    evaluates ``ocp.device_model``; an OCP without one raises
    ``NotImplementedError``.  CUDA tensors must be contiguous float32.
    """
    if x0.device.type == "cpu":
        return linesearch_forward_torch(x0, xs, us, ps, kffs, Ks, alphas,
                                        ocp=ocp)
    if not x0.is_cuda:
        raise ValueError(f"linesearch_forward: unsupported device {x0.device}")
    model = ocp.device_model
    if model is None:
        raise NotImplementedError(
            "linesearch_forward on CUDA needs ocp.device_model (the kernel "
            "cannot evaluate Python callables)")
    B, N, nu = us.shape
    nx, npar = x0.shape[-1], ps.shape[-1]
    A = len(alphas)
    if (nx, nu) != (3, 2) or npar < 3:
        raise ValueError("the unicycle device model needs nx=3, nu=2, npar>=3")
    if not 1 <= A <= MAX_ALPHAS:
        raise ValueError(f"linesearch_forward takes 1..{MAX_ALPHAS} alphas")
    named = [("x0", x0, (B, nx)), ("xs", xs, (B, N + 1, nx)),
             ("us", us, (B, N, nu)), ("ps", ps, (B, N + 1, npar)),
             ("kffs", kffs, (B, N, nu)), ("Ks", Ks, (B, N, nu, nx))]
    check_args("linesearch_forward", x0.device, named)

    lib = load_library()
    opts = dict(dtype=torch.float32, device=x0.device)
    xs_o = torch.empty((B, N + 1, nx), **opts)
    us_o = torch.empty((B, N, nu), **opts)
    cost = torch.empty((B,), **opts)
    best = torch.empty((B,), dtype=torch.int32, device=x0.device)
    packed = model.packed()
    c_model = packed.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    c_alphas = (ctypes.c_float * A)(*map(float, alphas))
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mv_linesearch_forward(
            B, N, npar, x0.data_ptr(), xs.data_ptr(), us.data_ptr(),
            ps.data_ptr(), kffs.data_ptr(), Ks.data_ptr(), c_model,
            model.substeps, int(model.integrator == "euler"),
            int(model.Qf is not None), c_alphas, A, xs_o.data_ptr(),
            us_o.data_ptr(), cost.data_ptr(), best.data_ptr(), stream)
    check_launch(rc, "mv_linesearch_forward")
    linesearch_forward.launches += 1
    return xs_o, us_o, cost, best


linesearch_forward.launches = 0
