"""Batch-first box-DDP solver (port of ``mpc_verde_tpu.solver.batched``).

One solver instance owns the whole batch.  Each iteration linearizes every
stage of every problem (``torch.func``), runs the Riccati backward pass with
exact stage box QPs, and a parallel line search over ``n_alphas`` step
lengths, then accepts per problem.  The pieces are shared with the streaming
solver (``solver/streaming.py``), so both run the same per-iteration math.

Backends:
  * ``"torch"`` — the plain PyTorch versions everywhere, on any device and
    dtype: the counterpart of the JAX ``"xla"`` backend and the reference
    the kernels are held against.
  * ``"cuda"``  — the hand-written kernels: Riccati backward
    (``ops/cuda/riccati.py``) and fused line search / pre-roll
    (``ops/cuda/rollout.py``).  Needs a float32 OCP on a CUDA device with a
    ``device_model``.

Not ported yet: state bounds (the augmented-Lagrangian outer loop),
``backend="scan"`` and the fused derivs+backward kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from ..ocp.spec import OCP
from ..ops.cuda.riccati import (SUPPORTED, riccati_backward,
                                riccati_backward_torch)
from ..ops.cuda.rollout import linesearch_forward, linesearch_forward_torch
from ..ops.linearize import linearize_trajectory
from .ilqr import ILQROptions, ILQRResult

BACKENDS = ("torch", "cuda")


@dataclasses.dataclass
class _Parts:
    """Building blocks of one batched DDP iteration."""

    rollout: Callable      # (x0s, us, ps) -> xs, us_clipped, cost
    derivs: Callable       # (xs, us, ps) -> d, gN, HN, dlb, dub
    backward: Callable     # (d, gN, HN, dlb, dub, reg, ddp) -> kffs, Ks, dV1, dV2, gmax
    linesearch: Callable   # (x0s, xs, us, ps, kffs, Ks) -> xs_b, us_b, new_cost


def _check_ocp(ocp: OCP, backend: str):
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    if ocp.has_state_bounds:
        raise NotImplementedError(
            "state bounds need the augmented-Lagrangian loop, not ported yet")
    if ocp.nu > 4:
        raise NotImplementedError(
            "the stage box QP enumerates 3^nu patterns; nu <= 4")
    if backend == "cuda":
        if ocp.device_model is None:
            raise NotImplementedError(
                "backend='cuda' needs ocp.device_model: the line-search "
                "kernel cannot evaluate Python callables")
        if ocp.dtype != torch.float32:
            raise TypeError("backend='cuda' runs float32 kernels; build the "
                            f"OCP in float32, not {ocp.dtype}")
        if (ocp.nx, ocp.nu) not in SUPPORTED:
            raise NotImplementedError(
                f"no Riccati kernel for (nx, nu) = ({ocp.nx}, {ocp.nu})")


def _make_parts(ocp: OCP, opt: ILQROptions, backend: str) -> _Parts:
    _check_ocp(ocp, backend)
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    F, l, lf, cb = (ocp.dynamics, ocp.stage_cost, ocp.terminal_cost,
                    ocp.control_bounds)
    alphas = tuple(float(opt.alpha_decay) ** i for i in range(opt.n_alphas))
    if backend == "cuda":
        bw_fn, ls_fn = riccati_backward, linesearch_forward
    else:
        bw_fn, ls_fn = riccati_backward_torch, linesearch_forward_torch

    def linesearch(x0s, xs, us, ps, kffs, Ks):
        xs_b, us_b, cost, _ = ls_fn(x0s, xs, us, ps, kffs, Ks, alphas, ocp=ocp)
        return xs_b, us_b, cost

    def rollout(x0s, us, ps):
        # the line search with zero gains and one step is the plain rollout
        B = x0s.shape[0]
        z = dict(dtype=x0s.dtype, device=x0s.device)
        xs_b, us_b, cost, _ = ls_fn(
            x0s, torch.zeros((B, N + 1, nx), **z), us, ps,
            torch.zeros((B, N, nu), **z), torch.zeros((B, N, nu, nx), **z),
            (1.0,), ocp=ocp)
        return xs_b, us_b, cost

    def derivs(xs, us, ps):
        B = xs.shape[0]
        d = linearize_trajectory(F, l, xs[:, :N], us, ps[:, :N],
                                 second_order=opt.use_ddp)
        if lf is None:
            gN = torch.zeros((B, nx), dtype=xs.dtype, device=xs.device)
            HN = torch.zeros((B, nx, nx), dtype=xs.dtype, device=xs.device)
        else:
            lfx = lambda x, p: lf(x, p)
            gN = vmap(grad(lfx))(xs[:, N], ps[:, N])
            HN = vmap(jacfwd(grad(lfx)))(xs[:, N], ps[:, N])
        if cb is None:
            lbs = torch.full_like(us, -torch.inf)
            ubs = torch.full_like(us, torch.inf)
        else:
            ks = torch.arange(N, device=xs.device).expand(B, N).reshape(-1)
            lbs, ubs = vmap(cb)(xs[:, :N].reshape(B * N, nx),
                                ps[:, :N].reshape(B * N, -1), ks)
            lbs, ubs = lbs.reshape(B, N, nu), ubs.reshape(B, N, nu)
        return d, gN, HN, lbs - us, ubs - us

    def backward(d, gN, HN, dlb, dub, reg, ddp_scale):
        return bw_fn(d, dlb, dub, gN, HN, reg, ddp_scale, nx=nx, nu=nu,
                     use_ddp=opt.use_ddp, tol=opt.boxqp_tol)

    return _Parts(rollout=rollout, derivs=derivs, backward=backward,
                  linesearch=linesearch)


def _as_tensor(a, z):
    """Tensor on the OCP's device and dtype; numpy input is copied (it may
    be a read-only broadcast view)."""
    return torch.as_tensor(a if torch.is_tensor(a) else np.array(a), **z)


def _broadcast_params(ocp: OCP, ps, B):
    """Normalize a params argument to a contiguous (B, N+1, npar) tensor."""
    N = ocp.N
    z = dict(dtype=ocp.dtype, device=ocp.device)
    if ps is None:
        return torch.zeros((B, N + 1, max(ocp.npar, 1)), **z)
    ps = _as_tensor(ps, z)
    # (npar,) shared across stages+batch, or (N+1, npar) shared across batch
    if ps.ndim == 1:
        ps = ps.expand(B, N + 1, ps.shape[0])
    elif ps.ndim == 2:
        ps = ps.expand((B,) + ps.shape)
    return ps.contiguous()


def _bcast(mask, like):
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


def _accept_and_update(opt: ILQROptions, carry, gmax, xs_b, us_b, new_cost):
    """Per-iteration acceptance / convergence / freeze logic.

    ``carry`` is the 10-tuple (xs, us, cost, reg, it, done, gnorm, stall,
    fail, ddp_on), every entry with a leading batch axis.  Frozen (done)
    problems keep their state.
    """
    xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on = carry
    improved = new_cost < cost - 1e-12
    small_step = ((cost - new_cost).abs()
                  < opt.tol_cost * (1.0 + cost.abs()))
    stall_n = torch.where(improved, 0, stall + 1)
    stalled = stall_n >= opt.stall_iters
    # DDP -> Gauss-Newton fallback on a stalled line search
    ddp_off_now = (stalled & ddp_on
                   & (gmax > opt.tol_grad * opt.ddp_fallback_factor))
    ddp_on_n = ddp_on & ~ddp_off_now
    stall_n = torch.where(ddp_off_now, 0, stall_n)
    # reg exhaustion is a failure only while the gradient is still large
    new_fail = (((~improved) & (reg >= opt.reg_max) & ~ddp_off_now
                 & (gmax > opt.tol_grad * opt.ddp_fallback_factor))
                | ~torch.isfinite(cost))
    new_done = ((gmax < opt.tol_grad)
                | (improved & small_step)
                | (stalled & ~ddp_off_now)
                | new_fail)

    keep = done
    sel = lambda old, new: torch.where(_bcast(keep, old), old, new)
    xs_n = sel(xs, torch.where(_bcast(improved, xs), xs_b, xs))
    us_n = sel(us, torch.where(_bcast(improved, us), us_b, us))
    cost_n = sel(cost, torch.where(improved, new_cost, cost))
    reg_n = sel(reg, torch.where(
        improved,
        torch.clamp(reg / opt.reg_down, min=opt.reg_min),
        torch.clamp(reg * opt.reg_up, max=opt.reg_max)))
    # fresh Gauss-Newton steps start from reg_init
    reg_n = torch.where(ddp_off_now & ~keep, opt.reg_init, reg_n)
    it_n = torch.where(keep, it, it + 1)
    stall_out = torch.where(keep, stall, stall_n)
    done_n = done | new_done
    fail_n = fail | (~keep & new_fail)
    gnorm_n = torch.where(keep, gnorm, gmax)
    ddp_out = torch.where(keep, ddp_on, ddp_on_n)
    return (xs_n, us_n, cost_n, reg_n, it_n, done_n, gnorm_n,
            stall_out, fail_n, ddp_out)


def make_batched_ilqr_solver(ocp: OCP, options: ILQROptions = ILQROptions(),
                             backend: str = "torch"):
    """Build ``solve(x0s, params, us_init) -> ILQRResult`` over a batch.

    Args of ``solve`` have a leading batch axis: x0s (B, nx), params
    (B, N+1, npar) (or (npar,) / (N+1, npar), broadcast), us_init (B, N, nu);
    they are cast to the OCP's device and dtype.  The loop runs on the host
    and reads one flag from the device per iteration.
    """
    N, nu = ocp.N, ocp.nu
    opt = options
    parts = _make_parts(ocp, opt, backend)
    z = dict(dtype=ocp.dtype, device=ocp.device)

    def solve(x0s, params=None, us_init=None):
        x0s = _as_tensor(x0s, z).contiguous()
        B = x0s.shape[0]
        ps = _broadcast_params(ocp, params, B)
        if us_init is None:
            us_init = torch.zeros((B, N, nu), **z)
        us_init = _as_tensor(us_init, z).contiguous()

        xs0, us0, cost0 = parts.rollout(x0s, us_init, ps)
        dev = ocp.device
        carry = (xs0, us0, cost0, torch.full((B,), opt.reg_init, **z),
                 torch.zeros((B,), dtype=torch.int32, device=dev),
                 torch.zeros((B,), dtype=torch.bool, device=dev),
                 torch.full((B,), torch.inf, **z),
                 torch.zeros((B,), dtype=torch.int32, device=dev),
                 torch.zeros((B,), dtype=torch.bool, device=dev),
                 torch.full((B,), bool(opt.use_ddp), device=dev))

        def running(carry):
            it, done = carry[4], carry[5]
            go = bool(((it < opt.max_iters) & ~done).any())
            if opt.quorum >= 1.0:
                return go
            # quorum exit: stop once `quorum` of the batch is done
            return go and float(done.float().mean()) < opt.quorum

        while running(carry):
            xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on = carry
            d, gN, HN, dlb, dub = parts.derivs(xs, us, ps)
            kffs, Ks, dV1, dV2, gmax = parts.backward(
                d, gN, HN, dlb, dub, reg, ddp_on.to(cost.dtype))
            xs_b, us_b, new_cost = parts.linesearch(x0s, xs, us, ps, kffs, Ks)
            carry = _accept_and_update(opt, carry, gmax, xs_b, us_b, new_cost)

        xs, us, cost, _, it, done, gnorm, _, fail, _ = carry
        return ILQRResult(
            xs=xs, us=us, cost=cost, grad_norm=gnorm, iterations=it,
            converged=done & ~fail & torch.isfinite(cost),
            max_violation=torch.zeros((B,), **z))

    return solve
