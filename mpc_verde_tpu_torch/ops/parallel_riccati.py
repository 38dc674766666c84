"""Parallel-in-horizon Riccati: associative-scan LQT backward pass.

Port of ``mpc_verde_tpu.ops.parallel_riccati``.  The sequential backward
pass has depth N; this formulation (Särkkä & García-Fernández-style
five-tuple elements) composes the conditional value functions of adjacent
spans with an associative rule, so that a prefix scan yields the value
function of every stage in O(log N) depth.

Problem class: linear-quadratic tracking (LQT)

    x_{k+1} = F_k x_k + c_k + L_k u_k
    cost    = sum_k 1/2 (x_k - r_k)' X_k (x_k - r_k) + 1/2 u_k' U_k u_k
              + 1/2 (x_N - r_N)' X_N (x_N - r_N)

General LQ subproblems (linear control cost, Qux cross terms) reduce to it
by completing the square in u (``lq_backward_parallel``); box constraints
are not handled here.

Each element e = (A, b, C, eta, J) represents the conditional value function
between two times; composition of adjacent spans is the associative rule

    A = A_j (I + C_i J_j)^{-1} A_i
    b = A_j (I + C_i J_j)^{-1} (b_i + C_i eta_j) + b_j
    C = A_j (I + C_i J_j)^{-1} C_i A_j' + C_j
    eta = A_i' (I + J_j C_i)^{-1} (eta_j - J_j b_i) + eta_i
    J = A_i' (I + J_j C_i)^{-1} J_j A_i + J_i

and a reverse scan yields V_k(x) = 1/2 x'J_k x - eta_k'x at every stage.

Every function takes any number of leading batch dimensions before the
stage axis: ``Fs`` is (..., N, nx, nx), ``XN`` (..., nx, nx).  The prefix
scan is the Hillis-Steele doubling form on every device and dtype
(``_assoc_scan``); ``_assoc_fold`` is the sequential fold of the same
combine, the plain reference the tests hold it against.  The inverse
``(I + C J)^{-1}`` is a batched ``torch.linalg.solve``, plain PyTorch as
the JAX package leaves it to XLA: no kernel of this package runs here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class LQTElement(NamedTuple):
    A: torch.Tensor    # (..., n, nx, nx)
    b: torch.Tensor    # (..., n, nx)
    C: torch.Tensor    # (..., n, nx, nx)
    eta: torch.Tensor  # (..., n, nx)
    J: torch.Tensor    # (..., n, nx, nx)


def _map(fn, *elems):
    return LQTElement(*(fn(*leaves) for leaves in zip(*elems)))


def _assoc_scan(fn, elems: LQTElement, dim: int) -> LQTElement:
    """Inclusive prefix combine along ``dim`` (the stage axis of every leaf).

    ``fn(left, right)`` with ``left`` spanning earlier positions.
    Hillis-Steele doubling: log2(n) levels, each one shift, one full-width
    combine and one select, so the depth is O(log n) for O(n log n)
    combines.  The combines of rows k < d at a level run on the rows
    themselves and are discarded by the select.
    """
    n = elems.A.shape[dim]
    pos = torch.arange(n, device=elems.A.device)
    acc = elems
    d = 1
    while d < n:
        shifted = _map(lambda a: torch.cat([a.narrow(dim, 0, d),
                                            a.narrow(dim, 0, n - d)], dim),
                       acc)
        comb = fn(shifted, acc)
        keep = pos >= d
        acc = _map(lambda c, a: torch.where(
            keep.reshape((n,) + (1,) * (a.ndim - dim - 1)), c, a), comb, acc)
        d *= 2
    return acc


def _assoc_fold(fn, elems: LQTElement, dim: int) -> LQTElement:
    """The same prefix as ``_assoc_scan`` by a sequential fold of ``fn``
    (depth n): the plain reference."""
    n = elems.A.shape[dim]
    at = lambda k: _map(lambda a: a.select(dim, k), elems)
    out = [at(0)]
    for k in range(1, n):
        out.append(fn(out[-1], at(k)))
    return _map(lambda *rows: torch.stack(rows, dim), *out)


def _combine(ei: LQTElement, ej: LQTElement) -> LQTElement:
    """Associative composition: element i spans earlier stages than j."""
    nx = ei.A.shape[-1]
    I = torch.eye(nx, dtype=ei.A.dtype, device=ei.A.device)
    # (I + C_i J_j)^{-1}; with C and J symmetric, (I + J_j C_i)^{-1} is its
    # transpose, so one solve serves both
    M = I + ei.C @ ej.J
    Minv = torch.linalg.solve_ex(M, I.expand_as(M))[0]
    Mtinv = Minv.transpose(-1, -2)
    AjM = ej.A @ Minv
    AiT = ei.A.transpose(-1, -2)
    A = AjM @ ei.A
    b = (AjM @ (ei.b[..., None] + ei.C @ ej.eta[..., None]))[..., 0] + ej.b
    C = AjM @ ei.C @ ej.A.transpose(-1, -2) + ej.C
    eta = (AiT @ Mtinv @ (ej.eta[..., None] - ej.J @ ei.b[..., None]))[..., 0] \
        + ei.eta
    J = AiT @ Mtinv @ ej.J @ ei.A + ei.J
    return LQTElement(A, b, C, eta, J)


def _value_functions(elems: LQTElement, term: LQTElement, dim: int,
                     prefix=None):
    """(Js, etas) of stages 0..N from the N stage elements and the terminal
    one: a reverse scan, result k spanning stages k..N.  ``prefix`` is the
    scan (``_assoc_scan`` when None, ``_assoc_fold`` for the reference)."""
    prefix = prefix or _assoc_scan
    elems = _map(lambda a, t: torch.cat([a, t.unsqueeze(dim)], dim), elems,
                 term)
    rev = _map(lambda a: torch.flip(a, (dim,)), elems)
    acc = prefix(lambda a, b: _combine(b, a), rev, dim)
    out = _map(lambda a: torch.flip(a, (dim,)), acc)
    return out.J, out.eta


def _solve(A, B):
    return torch.linalg.solve_ex(A, B)[0]


def _lqt_elements(Fs, cs, Ls, Xs, rs, Us, XN, rN):
    """The stage elements and the terminal element of an LQT problem."""
    nu = Ls.shape[-1]
    Uinv = _solve(Us, torch.eye(nu, dtype=Ls.dtype,
                                device=Ls.device).expand_as(Us))
    Cs = Ls @ Uinv @ Ls.transpose(-1, -2)
    etas = (Xs @ rs[..., None])[..., 0]
    term = LQTElement(A=torch.zeros_like(XN), b=torch.zeros_like(rN),
                      C=torch.zeros_like(XN), eta=(XN @ rN[..., None])[..., 0],
                      J=XN)
    return LQTElement(A=Fs, b=cs, C=Cs, eta=etas, J=Xs), term


def lqt_backward_parallel(Fs, cs, Ls, Xs, rs, Us, XN, rN):
    """O(log N)-depth LQT backward pass.

    Args (stage-stacked, leading batch dims allowed):
      Fs (..., N, nx, nx), cs (..., N, nx), Ls (..., N, nx, nu): dynamics.
      Xs (..., N, nx, nx), rs (..., N, nx): state tracking cost per stage.
      Us (..., N, nu, nu): control cost.
      XN (..., nx, nx), rN (..., nx): terminal cost.

    Returns (Js (..., N+1, nx, nx), etas (..., N+1, nx)): the value function
    V_k(x) = 1/2 x'J_k x - eta_k'x for k = 0..N.
    """
    return _value_functions(*_lqt_elements(Fs, cs, Ls, Xs, rs, Us, XN, rN),
                            Fs.ndim - 3)


def lqt_gains(Fs, cs, Ls, Us, Js, etas):
    """Per-stage affine control laws from the scanned value functions.

    u_k*(x) = -K_k x + k_k with
      S_k = U_k + L' J_{k+1} L
      K_k = S^{-1} L' J_{k+1} F
      k_k = S^{-1} L' (eta_{k+1} - J_{k+1} c_k)

    All stages in one batched solve.  Returns (K (..., N, nu, nx),
    k (..., N, nu)).
    """
    dim = Fs.ndim - 3
    Jn = Js.narrow(dim, 1, Fs.shape[dim])
    en = etas.narrow(dim, 1, Fs.shape[dim])
    Lt = Ls.transpose(-1, -2)
    S = Us + Lt @ Jn @ Ls
    K = _solve(S, Lt @ Jn @ Fs)
    k = _solve(S, Lt @ (en[..., None] - Jn @ cs[..., None]))[..., 0]
    return K, k


def lq_backward_parallel(fxs, fus, lxs, lus, lxxs, luus, luxs, gN, HN, reg):
    """General-LQ backward pass in O(log N) depth: the batched solvers'
    ``backend="scan"`` engine.

    Solves the per-iteration LQ (Gauss-Newton) subproblem

        min sum_k lx'dx + lu'du + 1/2 dx'lxx dx + 1/2 du'luu du + du'lux dx
            + gN'dx_N + 1/2 dx_N' HN dx_N
        s.t. dx_{k+1} = fx dx_k + fu du_k,  dx_0 = 0

    by completing the square in du, running the associative-scan
    value-function recursion, and recovering the affine stage policies.

    Args: stage derivatives (..., N, ...) as ``linearize_trajectory`` lays
    them out (lux (..., N, nu, nx)); gN (..., nx), HN (..., nx, nx); ``reg``
    the Levenberg term added to luu, a number or a (...) tensor.

    Returns the sequential backward pass's contract:
    ``(kffs (..., N, nu), Ks (..., N, nu, nx), dV1 (...), dV2 (...),
    gmax (...))`` with du_k = kff_k + K_k dx_k, dV1 / dV2 the expected
    improvement terms sum kff'Qu / 0.5 sum kff'Quu kff, and gmax = max |Qu|
    (the controls are unbounded here).
    """
    dim = fxs.ndim - 3
    nx, nu = fxs.shape[-1], fus.shape[-1]
    dt, dev = fxs.dtype, fxs.device
    I_u = torch.eye(nu, dtype=dt, device=dev)
    reg = torch.as_tensor(reg, dtype=dt, device=dev)
    reg = reg.reshape(reg.shape + (1,) * (luus.ndim - reg.ndim))

    Luu = luus + reg * I_u
    luxT = luxs.transpose(-1, -2)
    fuT = fus.transpose(-1, -2)
    sol = _solve(Luu, torch.cat([lus[..., None], luxs, fuT], dim=-1))
    Li_lu = sol[..., 0]                      # Luu^{-1} lu        (..., N, nu)
    Li_lux = sol[..., 1:1 + nx]              # Luu^{-1} lux       (..., N, nu, nx)
    Li_fuT = sol[..., 1 + nx:]               # Luu^{-1} fu'       (..., N, nu, nx)

    # du = w - Luu^{-1}(lu + lux dx): dynamics and cost in (dx, w)
    F = fxs - fus @ Li_lux
    c = -(fus @ Li_lu[..., None])[..., 0]
    Cs = fus @ Li_fuT                        # fu Luu^{-1} fu'
    X = lxxs - luxT @ Li_lux
    X = 0.5 * (X + X.transpose(-1, -2))
    q = lxs - (luxT @ Li_lu[..., None])[..., 0]

    term = LQTElement(A=torch.zeros_like(HN), b=torch.zeros_like(gN),
                      C=torch.zeros_like(HN), eta=-gN, J=HN)
    Js, etas = _value_functions(LQTElement(A=F, b=c, C=Cs, eta=-q, J=X),
                                term, dim)

    # stage policies in w, then back-substitute to du
    N = fxs.shape[dim]
    Jn, en = Js.narrow(dim, 1, N), etas.narrow(dim, 1, N)
    S = Luu + fuT @ Jn @ fus                 # == Quu at the nominal
    S = 0.5 * (S + S.transpose(-1, -2))
    rhs = torch.cat([fuT @ (en[..., None] - Jn @ c[..., None]),
                     fuT @ Jn @ F], dim=-1)
    sol2 = _solve(S, rhs)
    # contiguous, as the line-search kernel takes its gains
    kffs = (sol2[..., 0] - Li_lu).contiguous()
    Ks = (-(sol2[..., 1:] + Li_lux)).contiguous()

    # expected-improvement terms at the nominal (dx = 0): Vx_{k+1} = -eta_{k+1}
    Qu = lus - (fuT @ en[..., None])[..., 0]
    dV1 = (kffs * Qu).sum((-1, -2))
    dV2 = 0.5 * (kffs[..., None, :] @ S @ kffs[..., None])[..., 0, 0].sum(-1)
    gmax = Qu.abs().amax((-1, -2))
    return kffs, Ks, dV1, dV2, gmax


def lqt_solve_parallel(x0, Fs, cs, Ls, Xs, rs, Us, XN, rN):
    """Full LQT solve: the O(log N) backward pass, then the rollout of the
    affine policies.  Returns (xs (..., N+1, nx), us (..., N, nu))."""
    dim = Fs.ndim - 3
    Js, etas = lqt_backward_parallel(Fs, cs, Ls, Xs, rs, Us, XN, rN)
    K, kff = lqt_gains(Fs, cs, Ls, Us, Js, etas)
    mv = lambda A, v: (A @ v[..., None])[..., 0]
    x, xs, us = x0, [x0], []
    for k in range(Fs.shape[dim]):
        at = lambda a: a.select(dim, k)
        u = at(kff) - mv(at(K), x)
        x = mv(at(Fs), x) + at(cs) + mv(at(Ls), u)
        us.append(u)
        xs.append(x)
    return torch.stack(xs, dim), torch.stack(us, dim)
