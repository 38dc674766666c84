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
  problem, with a dummy row M (the plain refill's target of idle slots);
* a problem that fails or exhausts its budget restarts in place (fresh
  regularization, stall counters and DDP mode, warm-started at its best
  iterate) up to ``restarts`` times before it is reported unconverged.

* continuation rounds (``rounds=``, and the augmented-Lagrangian loop that
  state bounds install) run in place: a slot that finishes a round below the
  last gets its params advanced and restarts fresh, its cost re-based to the
  new params without a re-roll.

The JAX device-side ``lax.while_loop`` becomes a host loop over one refill
and ``refill_every`` compute iterations; it reads one flag from the device
per loop turn.  The refill is ``ops.cuda.refill.refill_slots``: on the card
one hand-written kernel call that moves the finished and loaded slots alone
and updates the slot tensors in place, on the CPU its PyTorch twin.  The
spans and counters of ``utils.profiling`` mark and count the turns and
their parts.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ocp.spec import OCP
from ..ops.cuda.refill import refill_slots
from ..ops.cuda.rollout import trajectory_cost_torch
from .batched import (_accept_and_update, _al_cvals, _as_tensor,
                      _augment_ocp_al, _broadcast_params, _lam_update,
                      _make_parts, _search_direction, _violation,
                      backend_options, resolve_backend)
from ..utils.profiling import count, span, spanned
from .ilqr import ILQROptions, ILQRResult


def make_streaming_solver(ocp: OCP, options: ILQROptions = ILQROptions(),
                          backend: Optional[str] = None,
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

    ``backend``: as in ``make_batched_ilqr_solver``; None (the default)
    resolves by ``resolve_backend`` on the OCP the slots run, the AL-derived
    one under state bounds: ``"torch"`` on the CPU; on a CUDA device
    ``"cuda_fused"`` for a float32 OCP with a ``device_model`` or whose
    callables lower to a traced one (its library built once per program
    text, at the first solve), else ``"cuda_bw"``; nu > 4 raises there.
    ``batch_width`` is the number of resident slots.  ``restarts``: how many
    times a failed or budget-capped problem restarts in place; with rounds,
    each round has its own budget.  ``refill_every``: run the refill once
    per this many solver iterations; a finished slot then idles at most
    ``refill_every - 1`` iterations.

    ``rounds``: optional ``(n_rounds, advance)`` continuation.  A slot whose
    inner solve ends (converged, failed or capped) at round r < n_rounds - 1
    gets its params rewritten by ``advance(ps, xs, r) -> ps_new`` ((B, N+1,
    npar), (B, N+1, nx), (B,) int32) and restarts fresh in place.  Its
    (xs, us) stay and its cost is re-based to the new params by evaluating
    the cost elementwise, without a re-roll: so ``advance`` may rewrite only
    params that the cost reads.  One that rewrites params the dynamics read
    leaves xs that are no longer the rollout of us, and the re-based cost is
    then wrong (the JAX solver has the same limit).  State bounds install
    the augmented-Lagrangian rounds themselves (``options.al_iters``) and
    cannot be combined with ``rounds``.

    ``tol_scale_fn``: optional ``ps (B, N+1, npar) -> (B,)`` multiplier
    (>= 1) of ``tol_grad`` and ``tol_cost``, evaluated every iteration on
    the slots' current params, so that early rounds are solved inexactly;
    the last round's params must map to 1.

    With state bounds the result holds the true (penalty-free) cost and the
    state-box violation in ``max_violation``.
    """
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    opt = options
    B = int(batch_width)
    R = int(refill_every)
    if R < 1:
        raise ValueError("refill_every must be >= 1")
    has_xb = ocp.has_state_bounds
    if has_xb and opt.al_iters < 1:
        raise ValueError(
            "streaming solver with state bounds needs options.al_iters >= 1")
    if has_xb and rounds is not None:
        raise ValueError("rounds= cannot be combined with state bounds "
                         "(state bounds install the AL continuation)")
    ocp_in = ocp
    npar = max(ocp_in.npar, 1)
    if has_xb:
        # the PHR multipliers [lam (2 nx), mu] ride the slot params, and the
        # AL outer loop is the round machinery
        cvals = _al_cvals(ocp)
        ocp = _augment_ocp_al(ocp)
        nlam = 2 * nx

        def _al_advance(ps, xs, alr):
            lam, mu = ps[..., npar:npar + nlam], ps[..., npar + nlam:]
            return torch.cat([ps[..., :npar], _lam_update(lam, mu, cvals(xs)),
                              mu * opt.al_mu_factor], dim=-1)

        n_rounds, advance = opt.al_iters, _al_advance
    elif rounds is not None:
        n_rounds, advance = int(rounds[0]), rounds[1]
        if n_rounds < 1:
            raise ValueError("rounds[0] must be >= 1")
    else:
        n_rounds, advance = 1, None
    # the rule reads the OCP that the parts run: the AL-derived one under
    # state bounds
    backend = resolve_backend(ocp, backend)
    opt = backend_options(opt, backend)
    parts = _make_parts(ocp, opt, backend)
    z = dict(dtype=ocp.dtype, device=ocp.device)
    dev = ocp.device
    i32 = dict(dtype=torch.int32, device=dev)

    @spanned("mpc.solve")
    def solve(x0q, params=None, us_init=None, max_iters=None, restarts_n=None):
        mi = opt.max_iters if max_iters is None else int(max_iters)
        rs = restarts if restarts_n is None else int(restarts_n)
        x0q = _as_tensor(x0q, z).contiguous()
        M = x0q.shape[0]
        with span("mpc.preroll"):
            psq_in = _broadcast_params(ocp_in, params, M)
            psq = psq_in
            if has_xb:   # every problem starts with lam = 0, mu = al_mu0
                psq = torch.cat([psq, torch.zeros((M, N + 1, nlam), **z),
                                 torch.full((M, N + 1, 1), opt.al_mu0, **z)],
                                -1)
            if us_init is None:
                us_init = torch.zeros((M, N, nu), **z)
            us0q = _as_tensor(us_init, z).contiguous()

            npar_q = psq.shape[-1]
            sx, su, sp = (N + 1) * nx, N * nu, (N + 1) * npar_q
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
            alr = torch.zeros((B,), **i32)     # the slot's round
            nq = torch.tensor(n0, **i32)
            out = torch.zeros((M + 1, sx + su + 4), **z)

        def running():
            with span("mpc.flag"):
                count(flag_reads=1)
                return bool((prob < M).any())

        while running():
            with span("mpc.turn"):
                # ---- refill: scatter finished problems, load queued ones ---
                # (on the card in place, in one kernel call)
                with span("mpc.refill"):
                    slots, nq = refill_slots(
                        (xs, us, cost, reg, it, done, gnorm, stall, fail,
                         ddp_on, x0s, ps, capped, rst, iacc, alr, prob), nq,
                        out, qpk, reg_init=opt.reg_init, use_ddp=opt.use_ddp)
                    (xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on,
                     x0s, ps, capped, rst, iacc, alr, prob) = slots

                for _ in range(R):
                    # ---- one shared solver iteration -----------------------
                    with span("mpc.direction"):
                        kffs, Ks, dV1, dV2, gmax = _search_direction(
                            parts, xs, us, ps, reg, ddp_on.to(z["dtype"]))
                    with span("mpc.linesearch"):
                        xs_b, us_b, new_cost = parts.linesearch(
                            x0s, xs.contiguous(), us.contiguous(), ps, kffs,
                            Ks)
                    with span("mpc.accept"):
                        (xs, us, cost, reg, it, done, gnorm, stall, fail,
                         ddp_on) = _accept_and_update(
                            opt, (xs, us, cost, reg, it, done, gnorm, stall,
                                  fail, ddp_on), gmax, xs_b, us_b, new_cost,
                            tol_scale=None if tol_scale_fn is None
                            else tol_scale_fn(ps))

                        # per-slot iteration budget, then in-place restarts
                        # of budget-capped or failed problems, warm-started
                        # at the accepted (xs, us, cost), which stay
                        # consistent
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

                    if n_rounds == 1:
                        continue
                    with span("mpc.rebase"):
                        # the continuation in place: a slot whose round
                        # ended below the last advances its params and
                        # starts the next round fresh, with its cost
                        # re-based (no re-roll) and a full restart budget
                        adv = done & (prob < M) & (alr < n_rounds - 1)
                        a3 = adv[:, None, None]
                        ps = torch.where(a3, advance(ps, xs, alr),
                                         ps).contiguous()
                        alr = alr + adv.to(torch.int32)
                        iacc = torch.where(adv, iacc + it.clamp(min=0), iacc)
                        cost = parts.cost(xs, us, ps, adv, cost)
                        reg = torch.where(adv, opt.reg_init, reg)
                        it = torch.where(adv, 0, it)
                        stall = torch.where(adv, 0, stall)
                        gnorm = torch.where(adv, torch.inf, gnorm)
                        fail = fail & ~adv
                        ddp_on = torch.where(adv, bool(opt.use_ddp), ddp_on)
                        capped = capped & ~adv
                        rst = torch.where(adv, 0, rst)
                        done = done & ~adv
            count(turns=1, iterations=R, slot_iterations=R * B)
        # every problem's row out once, every problem past the first load in
        count(refill_rows=2 * M - n0)

        with span("mpc.unpack"):
            o = out[:M]
            xs_q = o[:, :sx].reshape(M, N + 1, nx)
            us_q = o[:, sx:sx + su].reshape(M, N, nu)
            cost_q = o[:, sx + su]
            viol_q = torch.zeros((M,), **z)
            if has_xb:
                # the loop's cost is the augmented one at the last
                # multipliers
                cost_q = trajectory_cost_torch(xs_q, us_q, psq_in, ocp=ocp_in)
                viol_q = _violation(cvals(xs_q))
            return ILQRResult(
                xs=xs_q, us=us_q, cost=cost_q, grad_norm=o[:, sx + su + 1],
                iterations=o[:, sx + su + 2].to(torch.int32),
                converged=o[:, sx + su + 3] > 0.5, max_violation=viol_q)

    return solve
