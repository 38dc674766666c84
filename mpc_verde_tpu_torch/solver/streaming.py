"""Streaming (persistent-batch) DDP solver (port of ``mpc_verde_tpu.solver.streaming``).

A fixed-width slot batch works through a queue of M problems: every slot
runs the same per-iteration math as ``make_batched_ilqr_solver`` (shared
``batched._make_parts`` / ``batched._accept_and_update``); when a slot's
problem converges, fails or exhausts its budget, its result goes to the
packed output buffer and the slot reloads the next queued problem.  Total
work is ~(mean iterations x M / B) iterations of the batch instead of the
batched solver's ~(max iterations x M / B).

As in the JAX solver:

* the queue is pre-rolled: one batched rollout of the whole queue gives each
  problem's initial trajectory and cost, stored in one packed row per
  problem, so a refilled slot's first pass is a real DDP iteration;
* one packed output buffer holds ``[xs | us | cost gnorm it conv]`` per
  problem, with a dummy row M as the target of idle slots;
* a problem that fails or exhausts its budget restarts in place (fresh
  regularization, stall counters and DDP mode, warm-started at its best
  iterate) up to ``restarts`` times before it is reported unconverged.

The JAX device-side ``lax.while_loop`` becomes a host loop over one refill
and ``refill_every`` compute iterations; it reads one flag from the device
per loop turn.
"""
from __future__ import annotations

import torch

from ..ocp.spec import OCP
from .batched import (_accept_and_update, _as_tensor, _broadcast_params,
                      _make_parts)
from .ilqr import ILQROptions, ILQRResult


def make_streaming_solver(ocp: OCP, options: ILQROptions = ILQROptions(),
                          backend: str = "torch",
                          batch_width: int = 2048,
                          restarts: int = 0,
                          refill_every: int = 1,
                          rounds=None,
                          tol_scale_fn=None):
    """Build ``solve(x0s, params, us_init, max_iters, restarts_n) -> ILQRResult``.

    Args of ``solve`` have a leading queue axis of length M: x0s (M, nx),
    params (M, N+1, npar) (or the broadcast conveniences of the batched
    solver), us_init (M, N, nu).  ``max_iters`` / ``restarts_n`` override the
    per-problem iteration budget and in-place restart budget for one call.
    Results come back in queue order.

    ``batch_width`` is the number of resident slots.  ``restarts``: how many
    times a failed or budget-capped problem restarts in place.
    ``refill_every``: run the refill once per this many solver iterations; a
    finished slot then idles at most ``refill_every - 1`` iterations.
    ``rounds`` and ``tol_scale_fn`` (continuation solvers) are not ported yet.
    """
    if rounds is not None or tol_scale_fn is not None:
        raise NotImplementedError(
            "rounds= / tol_scale_fn= continuation is not ported yet")
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    opt = options
    B = int(batch_width)
    R = int(refill_every)
    if R < 1:
        raise ValueError("refill_every must be >= 1")
    parts = _make_parts(ocp, opt, backend)
    z = dict(dtype=ocp.dtype, device=ocp.device)
    dev = ocp.device
    i32 = dict(dtype=torch.int32, device=dev)

    def solve(x0q, params=None, us_init=None, max_iters=None, restarts_n=None):
        mi = opt.max_iters if max_iters is None else int(max_iters)
        rs = restarts if restarts_n is None else int(restarts_n)
        x0q = _as_tensor(x0q, z).contiguous()
        M = x0q.shape[0]
        psq = _broadcast_params(ocp, params, M)
        if us_init is None:
            us_init = torch.zeros((M, N, nu), **z)
        us0q = _as_tensor(us_init, z).contiguous()

        npar = psq.shape[-1]
        sx, su, sp = (N + 1) * nx, N * nu, (N + 1) * npar
        # pre-roll the whole queue, then pack [x0 | ps | us0 | xs0 | cost0]
        xs0q, usc0q, c0q = parts.rollout(x0q, us0q, psq)
        qpk = torch.cat([x0q, psq.reshape(M, sp), usc0q.reshape(M, su),
                         xs0q.reshape(M, sx), c0q[:, None]], dim=1)

        idx0 = torch.arange(B, **i32)
        n0 = min(B, M)
        active0 = idx0 < n0
        prob = torch.where(active0, idx0, M)
        g0 = prob.clamp(max=M - 1)

        # slot state, the batched solver's carry
        xs, us, cost = xs0q[g0], usc0q[g0], c0q[g0]
        reg = torch.full((B,), opt.reg_init, **z)
        it = torch.zeros((B,), **i32)
        done = ~active0
        gnorm = torch.full((B,), torch.inf, **z)
        stall = torch.zeros((B,), **i32)
        fail = torch.zeros((B,), dtype=torch.bool, device=dev)
        ddp_on = torch.full((B,), bool(opt.use_ddp), device=dev)
        # bookkeeping: slot inputs, restart state, queue pointer
        x0s, ps = x0q[g0], psq[g0]
        capped = torch.zeros((B,), dtype=torch.bool, device=dev)
        rst = torch.zeros((B,), **i32)
        iacc = torch.zeros((B,), **i32)
        nq = torch.tensor(n0, **i32)
        out = torch.zeros((M + 1, sx + su + 4), **z)

        while bool((prob < M).any()):
            # ---- refill: scatter finished problems, load queued ones -------
            fin = done & (prob < M)
            widx = torch.where(fin, prob, M)
            conv = ~fail & torch.isfinite(cost) & ~capped
            row = torch.cat(
                [xs.reshape(B, sx), us.reshape(B, su), cost[:, None],
                 gnorm[:, None], (iacc + it.clamp(min=0)).to(z["dtype"])[:, None],
                 conv.to(z["dtype"])[:, None]], dim=1)
            out[widx] = row

            rank = torch.cumsum(fin.to(torch.int32), 0, dtype=torch.int32) - 1
            cand = nq + rank
            has = fin & (cand < M)
            qrow = qpk[cand.clamp(0, M - 1)]
            h2, h3 = has[:, None], has[:, None, None]
            x0s = torch.where(h2, qrow[:, :nx], x0s)
            ps = torch.where(h3, qrow[:, nx:nx + sp].reshape(B, N + 1, npar), ps)
            us = torch.where(
                h3, qrow[:, nx + sp:nx + sp + su].reshape(B, N, nu), us)
            xs = torch.where(
                h3, qrow[:, nx + sp + su:nx + sp + su + sx].reshape(B, N + 1, nx),
                xs)
            cost = torch.where(has, qrow[:, -1], cost)
            reg = torch.where(has, opt.reg_init, reg)
            it = torch.where(has, 0, it)
            gnorm = torch.where(has, torch.inf, gnorm)
            stall = torch.where(has, 0, stall)
            fail = fail & ~has
            ddp_on = torch.where(has, bool(opt.use_ddp), ddp_on)
            capped = capped & ~has
            done = done & ~has
            prob = torch.where(has, cand, torch.where(fin, M, prob))
            rst = torch.where(has, 0, rst)
            iacc = torch.where(has, 0, iacc)
            nq = nq + has.sum(dtype=torch.int32)
            x0s, ps = x0s.contiguous(), ps.contiguous()

            for _ in range(R):
                # ---- one shared solver iteration ---------------------------
                d, gN, HN, dlb, dub = parts.derivs(xs, us, ps)
                kffs, Ks, dV1, dV2, gmax = parts.backward(
                    d, gN, HN, dlb, dub, reg, ddp_on.to(z["dtype"]))
                xs_b, us_b, new_cost = parts.linesearch(
                    x0s, xs.contiguous(), us.contiguous(), ps, kffs, Ks)
                (xs, us, cost, reg, it, done, gnorm, stall, fail,
                 ddp_on) = _accept_and_update(
                    opt, (xs, us, cost, reg, it, done, gnorm, stall, fail,
                          ddp_on), gmax, xs_b, us_b, new_cost)

                # per-slot iteration budget, then in-place restarts of
                # budget-capped or failed problems, warm-started at the
                # accepted (xs, us, cost), which stay consistent
                newly_capped = ~done & (it >= mi)
                bad_now = newly_capped | (done & fail & (prob < M))
                redo = bad_now & (rst < rs)
                newly_capped = newly_capped & ~redo
                fail = fail & ~redo
                done = done & ~redo
                iacc = torch.where(redo, iacc + it, iacc)
                rst = rst + redo.to(torch.int32)
                reg = torch.where(redo, opt.reg_init, reg)
                it = torch.where(redo, 0, it)
                stall = torch.where(redo, 0, stall)
                gnorm = torch.where(redo, torch.inf, gnorm)
                ddp_on = torch.where(redo, bool(opt.use_ddp), ddp_on)
                done = done | newly_capped
                capped = capped | newly_capped

        o = out[:M]
        return ILQRResult(
            xs=o[:, :sx].reshape(M, N + 1, nx),
            us=o[:, sx:sx + su].reshape(M, N, nu),
            cost=o[:, sx + su], grad_norm=o[:, sx + su + 1],
            iterations=o[:, sx + su + 2].to(torch.int32),
            converged=o[:, sx + su + 3] > 0.5,
            max_violation=torch.zeros((M,), **z))

    return solve
