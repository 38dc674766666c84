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
  * ``"cuda_bw"`` — the counterpart of the JAX ``"pallas_bw"`` backend:
    stage derivatives by ``torch.func`` (``ops/linearize.py``), the Riccati
    backward kernel K1 (``ops/cuda/riccati.py``), and the plain PyTorch
    line search and rollout on the OCP's own callables
    (``linesearch_forward_torch``: every candidate materialised, then the
    first minimum, as the JAX ``"materialize"`` line search).  It needs no
    ``device_model`` and takes any nx and nu <= 4 in any float dtype: a
    float64 OCP runs K1 on float32 copies and casts its results back, as
    ``riccati_backward_pallas`` does; the rest stays in the OCP's dtype.
    ``backend=None`` takes it on a card only for a float64 OCP or one whose
    callables do not lower to a traced device model.
  * ``"cuda"``  — the hand-written kernels: Riccati backward
    (``ops/cuda/riccati.py``) and fused line search / pre-roll
    (``ops/cuda/rollout.py``).  Needs a float32 OCP on a CUDA device.  The
    line search evaluates the OCP's ``device_model``, or for an OCP given
    only by its callables the model generated from their trace
    (``ops/cuda/trace.py``, ``ops/cuda/codegen.py``; its library builds at
    the first launch), as JAX's ``"pallas"`` inlines the callables' jaxpr.
  * ``"cuda_fused"`` — the fused derivs+backward kernel
    (``ops/cuda/fused.py``) in place of derivs -> backward, and the same
    line search / pre-roll kernel as ``"cuda"``.  Same requirements, and the
    same device model, traced where the OCP has none.  The
    JAX ``"pallas_fused"`` backend keeps the XLA scan line search (its
    forward kernel runs only under ``"pallas"``); PyTorch has no scan
    compiler, so here the line-search kernel stands in for it: it computes
    the same function as the twin it is tested against.

  * ``"scan"`` — the associative-scan backward pass
    (``ops/parallel_riccati.lq_backward_parallel``, O(log N) depth, plain
    PyTorch as the JAX package leaves it to XLA) and the line-search kernel
    of ``"cuda"``.  Gauss-Newton on the unbounded LQ subproblem: an OCP
    with a control box raises (compose bounds with the barrier or AL
    solvers), and ``use_ddp`` is forced off.  On a CUDA device it needs a
    float32 OCP, as the line search does.

On CPU tensors every kernel wrapper runs its twin, so ``"cuda_bw"``,
``"cuda"``, ``"cuda_fused"`` and ``"scan"`` on the CPU give the ``"torch"``
results (``"scan"`` up to the round-off of its other backward pass).

``backend=None``, the default of the solver factories that reach a kernel
in the JAX package (there ``"pallas_bw"``), resolves by ``resolve_backend``
on the OCP that the solver's parts run (for state bounds the AL-derived OCP,
in the barrier solver the barrier-derived one): ``"torch"`` on the CPU;
on a CUDA device ``"cuda_fused"`` for a float32 OCP with a
``device_model`` or whose callables lower to a traced one, else
``"cuda_bw"`` (float64, or callables that do not lower, with a warning)
for nu <= 4; nu > 4 on a CUDA device raises, as JAX's default does.  A
traced model's library builds once per program text, at the first solve
(``ops/cuda/build.py``), and is cached.

State box bounds (``ocp.x_lb`` / ``x_ub``) run the augmented-Lagrangian
outer loop (``options.al_iters`` PHR rounds): the multipliers ride the
per-stage param tensor of a derived OCP (``_augment_ocp_al``), so every
inner round is the unmodified iteration, kernels included.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..ocp.spec import OCP
from ..ops.cuda.fused import fused_backward
from ..ops.cuda.build import check_riccati_size
from ..ops.cuda.riccati import (riccati_backward, riccati_backward_cast,
                                riccati_backward_torch)
from ..ops.cuda.rollout import (kernel_model, linesearch_forward,
                                linesearch_forward_torch, traced_device_model,
                                trajectory_cost, trajectory_cost_torch)
from ..ops.linearize import trajectory_derivatives
from ..ops.parallel_riccati import lq_backward_parallel
from ..utils.profiling import count, span, spanned
from .ilqr import ILQROptions, ILQRResult

BACKENDS = ("torch", "cuda_bw", "cuda", "cuda_fused", "scan")


@dataclasses.dataclass
class _Parts:
    """Building blocks of one batched DDP iteration."""

    rollout: Callable      # (x0s, us, ps) -> xs, us_clipped, cost
    derivs: Callable       # (xs, us, ps) -> d, gN, HN, dlb, dub
    backward: Callable     # (d, gN, HN, dlb, dub, reg, ddp) -> kffs, Ks, dV1, dV2, gmax
    linesearch: Callable   # (x0s, xs, us, ps, kffs, Ks) -> xs_b, us_b, new_cost
    # the rounds' cost re-base, priced by what prices the line search:
    # (xs, us, ps, mask, cost) -> the cost of the masked trajectories,
    # ``cost`` elsewhere
    cost: Callable
    # derivs + backward in one kernel ("cuda_fused"), None otherwise:
    # (xs, us, ps, reg, ddp) -> kffs, Ks, dV1, dV2, gmax
    fused: Optional[Callable] = None


def resolve_backend(ocp: OCP, backend: Optional[str]) -> str:
    """The backend a solver factory runs on ``ocp``, the OCP its parts run:
    ``backend`` itself when given; for None, ``"torch"`` unless the OCP
    lives on a CUDA device, and there ``"cuda_fused"`` (K3 and K2) for a
    float32 OCP with a ``device_model`` or whose callables lower to the
    model traced from them (``traced_device_model``, traced here without a
    card and kept on the OCP, so the kernels run this trace), else
    ``"cuda_bw"`` (K1 on the OCP's own callables, any nx, any float dtype):
    a float64 OCP, or callables that do not lower, which warns with the op
    and the callable.  A CUDA OCP with nu > 4 raises, as the JAX default
    ``"pallas_bw"`` does: the plain twins run it only when asked for with
    ``backend="torch"``."""
    if backend is not None:
        return backend
    if ocp.device.type != "cuda":
        return "torch"
    if ocp.nu > 4:
        raise NotImplementedError(
            f"this OCP lies on a CUDA device and has nu = {ocp.nu}; the "
            "Riccati kernel supports nu <= 4 (3^nu active-set enumeration). "
            'Pass backend="torch" to run the plain PyTorch versions on the '
            "card")
    if ocp.dtype != torch.float32:
        return "cuda_bw"
    if ocp.device_model is None:
        try:
            traced_device_model(ocp)
        except NotImplementedError as exc:
            warnings.warn(
                f"backend=None runs \"cuda_bw\" (the plain line search) on "
                f"this OCP: its callables do not lower to a traced device "
                f"model, so K2 and K3 cannot run it: {exc}", stacklevel=3)
            return "cuda_bw"
    return "cuda_fused"


def _check_ocp(ocp: OCP, backend: str):
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    # "torch" enumerates the 3^nu box-QP patterns for any nu; K1 takes any
    # nx and nu <= 4
    if backend in ("cuda_bw", "cuda", "cuda_fused"):
        check_riccati_size(ocp.nx, ocp.nu)
    if backend in ("cuda", "cuda_fused"):
        if ocp.dtype != torch.float32:
            raise TypeError(f"backend={backend!r} runs float32 kernels; build "
                            f"the OCP in float32, not {ocp.dtype}, or pass "
                            f'backend="cuda_bw" or "torch"')
    if backend == "scan":
        if ocp.control_bounds is not None:
            raise NotImplementedError(
                "backend='scan' solves the unbounded LQ subproblem; use "
                "'torch'/'cuda' for exact control boxes, or compose bounds "
                "via the IPM/AL outer loops")
        if ocp.device.type == "cuda" and ocp.dtype != torch.float32:
            raise TypeError("backend='scan' on a CUDA device runs the float32 "
                            f"line-search kernel, not {ocp.dtype}")
    if backend in ("cuda", "cuda_fused") or (backend == "scan"
                                             and ocp.device.type == "cuda"):
        # the model the kernels evaluate: the OCP's own, or the one traced
        # from its callables, traced now so that a callable that does not
        # lower raises here (NotImplementedError), before any solve
        kernel_model(ocp)


def backend_options(opt: ILQROptions, backend: str) -> ILQROptions:
    """``opt`` as ``backend`` runs it: ``"scan"`` is Gauss-Newton by
    construction (the Vx fxx recursion is sequential), so it runs with
    ``use_ddp=False`` and computes no second-order derivatives."""
    if backend == "scan" and opt.use_ddp:
        return dataclasses.replace(opt, use_ddp=False)
    return opt


def _make_parts(ocp: OCP, opt: ILQROptions, backend: str) -> _Parts:
    _check_ocp(ocp, backend)
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    alphas = tuple(float(opt.alpha_decay) ** i for i in range(opt.n_alphas))
    if backend == "torch":
        bw_fn, ls_fn = riccati_backward_torch, linesearch_forward_torch
    elif backend == "cuda_bw":
        bw_fn, ls_fn = riccati_backward_cast, linesearch_forward_torch
    elif backend == "scan":
        def bw_fn(d, dlb, dub, gN, HN, reg, ddp_scale, **_):
            return lq_backward_parallel(d["fx"], d["fu"], d["lx"], d["lu"],
                                        d["lxx"], d["luu"], d["lux"], gN, HN,
                                        reg)

        ls_fn = linesearch_forward
    else:
        bw_fn, ls_fn = riccati_backward, linesearch_forward

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

    def cost(xs, us, ps, mask, cost_in):
        if ls_fn is linesearch_forward:
            return trajectory_cost(xs.contiguous(), us.contiguous(), ps, mask,
                                   cost_in, ocp=ocp)
        return torch.where(mask, trajectory_cost_torch(xs, us, ps, ocp=ocp),
                           cost_in)

    def derivs(xs, us, ps):
        return trajectory_derivatives(ocp, xs, us, ps,
                                      second_order=opt.use_ddp)

    def backward(d, gN, HN, dlb, dub, reg, ddp_scale):
        return bw_fn(d, dlb, dub, gN, HN, reg, ddp_scale, nx=nx, nu=nu,
                     use_ddp=opt.use_ddp, tol=opt.boxqp_tol)

    fused = None
    if backend == "cuda_fused":
        def fused(xs, us, ps, reg, ddp_scale):
            return fused_backward(xs, us, ps, reg, ddp_scale, ocp=ocp,
                                  use_ddp=opt.use_ddp, tol=opt.boxqp_tol)

    return _Parts(rollout=rollout, derivs=derivs, backward=backward,
                  linesearch=linesearch, cost=cost, fused=fused)


def _search_direction(parts: _Parts, xs, us, ps, reg, ddp_scale):
    """kffs, Ks, dV1, dV2, gmax of one iteration: the fused kernel where the
    backend has one, derivs -> backward otherwise."""
    if parts.fused is not None:
        return parts.fused(xs, us, ps, reg, ddp_scale)
    d, gN, HN, dlb, dub = parts.derivs(xs, us, ps)
    return parts.backward(d, gN, HN, dlb, dub, reg, ddp_scale)


def _al_cvals(ocp: OCP):
    """Signed state-box constraint values ``(..., nx) -> (..., 2 nx)``,
    lower rows then upper rows; c(x) > 0 means violated, -inf marks an
    infinite bound."""
    x_low, x_high = ocp.state_box()

    def cvals(x):
        lo = torch.where(torch.isfinite(x_low), x_low - x, -torch.inf)
        hi = torch.where(torch.isfinite(x_high), x - x_high, -torch.inf)
        return torch.cat([lo, hi], dim=-1)

    return cvals


def _active_c(c):
    """Constraint values with the inactive (non-finite) rows at -1."""
    return torch.where(torch.isfinite(c), c, -1.0)


def _lam_update(lam, mu, c):
    """The PHR multiplier update ``max(0, lam + mu c)`` on the constraint
    values ``c`` (inactive rows at -1); ``mu`` broadcasts against ``lam``."""
    return (lam + mu * _active_c(c)).clamp(min=0.0)


def _violation(c):
    """max over every row and stage of max(0, c), non-finite rows 0: (B,)."""
    c = torch.where(torch.isfinite(c), c, 0.0).clamp(min=0.0)
    return c.reshape(c.shape[0], -1).amax(-1)


def _augment_ocp_al(ocp: OCP) -> OCP:
    """Rewrite a state-bounded OCP so the AL multipliers ride the params.

    The derived problem has ``npar + 2 nx + 1`` per-stage parameters laid
    out ``[p, lam (2 nx), mu]`` and no state bounds; its stage and terminal
    costs add the PHR augmented-Lagrangian penalty.  Its ``device_model``
    is the base one plus the same penalty (``with_al``), or None where the
    base has none or cannot take it.
    """
    npar = max(ocp.npar, 1)
    nlam = 2 * ocp.nx
    cvals = _al_cvals(ocp)
    l, lf, F, cb = (ocp.stage_cost, ocp.terminal_cost, ocp.dynamics,
                    ocp.control_bounds)

    def penalty(x, lam, mu):
        t = torch.maximum(torch.zeros_like(lam), lam + mu * _active_c(cvals(x)))
        return ((t * t).sum(-1) - (lam * lam).sum(-1)) / (2.0 * mu)

    def sc(x, u, p):
        return l(x, u, p[:npar]) + penalty(x, p[npar:npar + nlam], p[-1])

    def tc(x, p):
        pen = penalty(x, p[npar:npar + nlam], p[-1])
        return pen if lf is None else lf(x, p[:npar]) + pen

    model = ocp.device_model
    if model is not None:
        lo, hi = (b.detach().cpu().numpy() for b in ocp.state_box())
        model = model.with_al(lo, hi, lam_col=npar)
    return dataclasses.replace(
        ocp, dynamics=lambda x, u, p: F(x, u, p[:npar]), stage_cost=sc,
        terminal_cost=tc,
        control_bounds=None if cb is None else (
            lambda x, p, k: cb(x, p[:npar], k)),
        npar=npar + nlam + 1, x_lb=None, x_ub=None, device_model=model)


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


def _accept_and_update(opt: ILQROptions, carry, gmax, xs_b, us_b, new_cost,
                       tol_scale=None):
    """Per-iteration acceptance / convergence / freeze logic.

    ``carry`` is the 10-tuple (xs, us, cost, reg, it, done, gnorm, stall,
    fail, ddp_on), every entry with a leading batch axis.  Frozen (done)
    problems keep their state.  ``tol_scale`` (optional (B,) >= 1) scales
    ``tol_grad`` and ``tol_cost`` per problem, so that a continuation solver
    solves its early rounds inexactly; None is the strict test.
    """
    xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on = carry
    tsc = 1.0 if tol_scale is None else tol_scale
    improved = new_cost < cost - 1e-12
    small_step = ((cost - new_cost).abs()
                  < tsc * opt.tol_cost * (1.0 + cost.abs()))
    stall_n = torch.where(improved, 0, stall + 1)
    stalled = stall_n >= opt.stall_iters
    # DDP -> Gauss-Newton fallback on a stalled line search
    ddp_off_now = (stalled & ddp_on
                   & (gmax > tsc * opt.tol_grad * opt.ddp_fallback_factor))
    ddp_on_n = ddp_on & ~ddp_off_now
    stall_n = torch.where(ddp_off_now, 0, stall_n)
    # reg exhaustion is a failure only while the gradient is still large
    new_fail = (((~improved) & (reg >= opt.reg_max) & ~ddp_off_now
                 & (gmax > tsc * opt.tol_grad * opt.ddp_fallback_factor))
                | ~torch.isfinite(cost))
    new_done = ((gmax < tsc * opt.tol_grad)
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
                             backend: Optional[str] = None):
    """Build ``solve(x0s, params, us_init) -> ILQRResult`` over a batch.

    ``backend``: one of ``BACKENDS``; None (the default) resolves by
    ``resolve_backend`` on the OCP the solver runs, the AL-derived one under
    state bounds: ``"torch"`` on the CPU; on a CUDA device ``"cuda_fused"``
    for a float32 OCP with a ``device_model`` or whose callables lower to a
    traced one, else ``"cuda_bw"``; nu > 4 raises there.  So a rate-form
    OCP with a state box, whose AL-derived OCP has no device model, runs
    ``"cuda_fused"`` on the model traced from that OCP; its library builds
    once per program text at the first solve and is cached.

    Args of ``solve`` have a leading batch axis: x0s (B, nx), params
    (B, N+1, npar) (or (npar,) / (N+1, npar), broadcast), us_init (B, N, nu);
    they are cast to the OCP's device and dtype.  The loop runs on the host
    and reads one flag from the device per iteration (two under a quorum);
    its work is marked by the spans and counted by the counters of
    ``utils.profiling``.

    With state bounds, ``options.al_iters`` (>= 1) PHR rounds run in turn,
    each a full solve at fixed multipliers from the last one's controls:
    lam starts at 0 and mu at ``al_mu0``, and after a round
    ``lam <- max(0, lam + mu c(x))``, ``mu <- mu * al_mu_factor``.  The
    result holds the true (penalty-free) cost, the state-box violation in
    ``max_violation``, the iterations of all rounds, and the last round's
    ``converged`` and ``grad_norm``.
    """
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    opt = options
    has_xb = ocp.has_state_bounds
    if has_xb and opt.al_iters < 1:
        raise ValueError(
            "batched solver with state bounds needs options.al_iters >= 1")
    ocp_in = ocp
    if has_xb:
        cvals = _al_cvals(ocp)
        ocp = _augment_ocp_al(ocp)
    backend = resolve_backend(ocp, backend)
    opt = backend_options(opt, backend)
    parts = _make_parts(ocp, opt, backend)
    z = dict(dtype=ocp.dtype, device=ocp.device)
    dev = ocp.device

    def _inner(x0s, ps, us_init):
        """One full batched DDP solve at fixed params."""
        B = x0s.shape[0]
        with span("mpc.preroll"):
            xs0, us0, cost0 = parts.rollout(x0s, us_init, ps)
            carry = (xs0, us0, cost0, torch.full((B,), opt.reg_init, **z),
                     torch.zeros((B,), dtype=torch.int32, device=dev),
                     torch.zeros((B,), dtype=torch.bool, device=dev),
                     torch.full((B,), torch.inf, **z),
                     torch.zeros((B,), dtype=torch.int32, device=dev),
                     torch.zeros((B,), dtype=torch.bool, device=dev),
                     torch.full((B,), bool(opt.use_ddp), device=dev))

        def running(carry):
            with span("mpc.flag"):
                it, done = carry[4], carry[5]
                go = bool(((it < opt.max_iters) & ~done).any())
                count(flag_reads=1 + (go and opt.quorum < 1.0))
                if opt.quorum >= 1.0:
                    return go
                # quorum exit: stop once `quorum` of the batch is done
                return go and float(done.float().mean()) < opt.quorum

        while running(carry):
            with span("mpc.turn"):
                xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on = carry
                with span("mpc.direction"):
                    kffs, Ks, dV1, dV2, gmax = _search_direction(
                        parts, xs, us, ps, reg, ddp_on.to(cost.dtype))
                with span("mpc.linesearch"):
                    xs_b, us_b, new_cost = parts.linesearch(x0s, xs, us, ps,
                                                            kffs, Ks)
                with span("mpc.accept"):
                    carry = _accept_and_update(opt, carry, gmax, xs_b, us_b,
                                               new_cost)
            count(turns=1, iterations=1, slot_iterations=B)

        with span("mpc.unpack"):
            xs, us, cost, _, it, done, gnorm, _, fail, _ = carry
            return xs, us, cost, it, gnorm, done & ~fail & torch.isfinite(cost)

    @spanned("mpc.solve")
    def solve(x0s, params=None, us_init=None):
        x0s = _as_tensor(x0s, z).contiguous()
        B = x0s.shape[0]
        ps = _broadcast_params(ocp_in, params, B)
        if us_init is None:
            us_init = torch.zeros((B, N, nu), **z)
        us = _as_tensor(us_init, z).contiguous()

        if not has_xb:
            xs, us, cost, it, gnorm, conv = _inner(x0s, ps, us)
            return ILQRResult(xs=xs, us=us, cost=cost, grad_norm=gnorm,
                              iterations=it, converged=conv,
                              max_violation=torch.zeros((B,), **z))

        lam = torch.zeros((B, N + 1, 2 * nx), **z)
        mu = torch.full((B,), opt.al_mu0, **z)
        its = torch.zeros((B,), dtype=torch.int32, device=dev)
        for _ in range(opt.al_iters):
            with span("mpc.rebase"):
                ps_aug = torch.cat(
                    [ps, lam, mu[:, None, None].expand(B, N + 1, 1)], dim=-1)
            xs, us, _, it, gnorm, conv = _inner(x0s, ps_aug, us)
            with span("mpc.rebase"):
                its = its + it
                lam = _lam_update(lam, mu[:, None, None], cvals(xs))
                mu = mu * opt.al_mu_factor
        with span("mpc.unpack"):
            return ILQRResult(
                xs=xs, us=us,
                cost=trajectory_cost_torch(xs, us, ps, ocp=ocp_in),
                grad_norm=gnorm, iterations=its, converged=conv,
                max_violation=_violation(cvals(xs)))

    return solve
