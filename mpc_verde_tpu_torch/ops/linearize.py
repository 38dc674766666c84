"""Stage-wise linearization / quadratization by ``torch.func`` autodiff.

Port of ``mpc_verde_tpu.ops.linearize``: ``jacfwd`` on the discrete dynamics
and a forward-over-reverse Hessian of the stage cost, batched with ``vmap``
over every stage of every problem at once.  Same dict keys and layouts as the
JAX package.
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
        return fx, fu

    return lin


def quadratize_cost(l: Callable):
    """Return ``(x, u, p) -> (lx, lu, lxx, luu, lux)``; ``lux`` is (nu, nx)."""

    def quad(x, u, p):
        nx = x.shape[-1]
        z = torch.cat([x, u])

        def lz(zz):
            return l(zz[:nx], zz[nx:], p)

        g = grad(lz)(z)
        H = jacfwd(grad(lz))(z)
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

        H = jacfwd(jacfwd(Fz))(z)  # (nx_out, nz, nz)
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
    flat = lambda t: t.reshape((-1,) + t.shape[len(lead):])
    x, u, p = flat(xs), flat(us), flat(ps)
    fx, fu = vmap(linearize_dynamics(F))(x, u, p)
    lx, lu, lxx, luu, lux = vmap(quadratize_cost(l))(x, u, p)
    out = {"fx": fx, "fu": fu, "lx": lx, "lu": lu, "lxx": lxx, "luu": luu,
           "lux": lux}
    if second_order:
        fxx, fux, fuu = vmap(dynamics_hessians(F))(x, u, p)
        out.update({"fxx": fxx, "fux": fux, "fuu": fuu})
    return {k: v.reshape(lead + v.shape[1:]).contiguous() for k, v in out.items()}
