"""Stage-wise linearization / quadratization by ``torch.func`` autodiff.

Port of ``mpc_verde_tpu.ops.linearize``: ``jacfwd`` on the discrete dynamics
and a forward-over-reverse Hessian of the stage cost, batched with ``vmap``
over every stage of every problem at once.  Same dict keys and layouts as the
JAX package.

``jacfwd`` can return float64 for float32 inputs: forward mode promotes the
tangent of a 0-d tensor times a Python float (``u[0] / L`` in the Frenet
model) to float64 (torch 2.13).  Every forward-mode result is cast back to
the inputs' type, as JAX keeps it.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, jacfwd, vmap


def linearize_dynamics(F: Callable):
    """Return ``(x, u, p) -> (fx, fu)``, Jacobians of the discrete step."""

    def lin(x, u, p):
        fx = jacfwd(F, argnums=0)(x, u, p)
        fu = jacfwd(F, argnums=1)(x, u, p)
        return fx.to(x.dtype), fu.to(x.dtype)

    return lin


def quadratize_cost(l: Callable):
    """Return ``(x, u, p) -> (lx, lu, lxx, luu, lux)``; ``lux`` is (nu, nx)."""

    def quad(x, u, p):
        nx = x.shape[-1]
        z = torch.cat([x, u])

        def lz(zz):
            return l(zz[:nx], zz[nx:], p)

        g = grad(lz)(z)
        H = jacfwd(grad(lz))(z).to(z.dtype)
        return g[:nx], g[nx:], H[:nx, :nx], H[nx:, nx:], H[nx:, :nx]

    return quad


def dynamics_hessians(F: Callable):
    """Return ``(x, u, p) -> (fxx, fux, fuu)`` with ``fxx[i, j, k] = d2F_i/dx_j dx_k``;
    fux (nx, nu, nx), fuu (nx, nu, nu)."""

    def hess(x, u, p):
        nx = x.shape[-1]
        z = torch.cat([x, u])

        def Fz(zz):
            return F(zz[:nx], zz[nx:], p)

        H = jacfwd(jacfwd(Fz))(z).to(z.dtype)  # (nx_out, nz, nz)
        return H[:, :nx, :nx], H[:, nx:, :nx], H[:, nx:, nx:]

    return hess


def linearize_trajectory(F: Callable, l: Callable, xs, us, ps,
                         second_order: bool = False):
    """Linearize dynamics + quadratize cost along trajectories.

    Args:
      F: discrete dynamics ``(x, u, p) -> x_next``.
      l: stage cost ``(x, u, p) -> scalar``.
      xs: (..., nx) states; us: (..., nu) controls; ps: (..., npar) params,
        with the same leading dims (e.g. (N,) or (B, N)).
      second_order: also return dynamics Hessians (DDP).

    Returns a dict of contiguous derivative tensors with the leading dims of
    ``xs`` (the layout the CUDA Riccati kernel reads).
    """
    lead = xs.shape[:-1]
    n = xs[..., 0].numel()   # not -1: a zero-width params tensor (npar 0)
    flat = lambda t: t.reshape((n,) + t.shape[len(lead):])
    x, u, p = flat(xs), flat(us), flat(ps)
    fx, fu = vmap(linearize_dynamics(F))(x, u, p)
    lx, lu, lxx, luu, lux = vmap(quadratize_cost(l))(x, u, p)
    out = {"fx": fx, "fu": fu, "lx": lx, "lu": lu, "lxx": lxx, "luu": luu,
           "lux": lux}
    if second_order:
        fxx, fux, fuu = vmap(dynamics_hessians(F))(x, u, p)
        out.update({"fxx": fxx, "fux": fux, "fuu": fuu})
    return {k: v.reshape(lead + v.shape[1:]).contiguous() for k, v in out.items()}


def trajectory_derivatives(ocp, xs, us, ps, second_order: bool):
    """Everything the Riccati backward pass reads, along (B, ...) trajectories.

    Args:
      ocp: the OCP whose callables are differentiated.
      xs: (B, N+1, nx); us: (B, N, nu); ps: (B, N+1, npar).
      second_order: also the dynamics Hessians (DDP).

    Returns ``(d, gN, HN, dlb, dub)``: the stage derivatives of
    ``linearize_trajectory``, the terminal cost's gradient (B, nx) and Hessian
    (B, nx, nx) at x_N (zeros without a terminal cost), and the control box
    minus us, (B, N, nu) each (+-inf without bounds).
    """
    B, N = us.shape[:2]
    nx, nu = ocp.nx, ocp.nu
    lf, cb = ocp.terminal_cost, ocp.control_bounds
    d = linearize_trajectory(ocp.dynamics, ocp.stage_cost, xs[:, :N], us,
                             ps[:, :N], second_order=second_order)
    if lf is None:
        gN = torch.zeros((B, nx), dtype=xs.dtype, device=xs.device)
        HN = torch.zeros((B, nx, nx), dtype=xs.dtype, device=xs.device)
    else:
        gN = vmap(grad(lf))(xs[:, N], ps[:, N])
        # jacfwd lays the Hessian out transposed; the kernels take it
        # contiguous
        HN = vmap(jacfwd(grad(lf)))(xs[:, N], ps[:, N]).to(xs.dtype).contiguous()
    if cb is None:
        lbs = torch.full_like(us, -torch.inf)
        ubs = torch.full_like(us, torch.inf)
    else:
        ks = torch.arange(N, device=xs.device).expand(B, N).reshape(-1)
        lbs, ubs = vmap(cb)(xs[:, :N].reshape(B * N, nx),
                            ps[:, :N].reshape(B * N, ps.shape[-1]), ks)
        lbs, ubs = lbs.reshape(B, N, nu), ubs.reshape(B, N, nu)
    return d, gN, HN, lbs - us, ubs - us
