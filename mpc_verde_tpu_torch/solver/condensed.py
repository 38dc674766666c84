"""Condensed linear-MPC QP (port of ``mpc_verde_tpu.solver.condensed``).

The dense treatment of a linear-quadratic MPC step: eliminate the states
through the prediction matrices ``x = Sx x0 + Su U``, fold move blocking
(``Ntu`` free moves, the last one held for the tail: the pendulum's Du
pinning) into a column-blocking matrix, and solve the box QP over the free
moves exactly by Bertsekas projected Newton.  Stage-varying ``(A_t, B_t)``
stacks give the LTV form.

Everything is batched: ``prediction_matrices`` and ``condense`` take leading
batch dimensions on ``A`` / ``B`` before the stage axis, ``solve_dense_boxqp``
on all of its arguments, ``solve_condensed`` a batch of initial states.  The
products are ``torch.matmul`` / ``einsum``, plain products that the JAX
package leaves to XLA; no kernel of this package runs here.

Device rule: a tensor argument fixes the device and dtype; numpy input goes
to ``device`` (None: the CUDA device, raising where there is none; pass
``device="cpu"`` for the CPU) in ``dtype`` (None: float32).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.platform import scenario_device


def _placement(a, device, dtype, entry):
    """(device, dtype) of a computation whose first input is ``a``."""
    if torch.is_tensor(a):
        return (a.device if device is None else torch.device(device),
                a.dtype if dtype is None else dtype)
    return scenario_device(device, entry), dtype or torch.float32


def blocking_matrix(N: int, Ntu: int, dtype=torch.float32, device=None):
    """(N, Ntu) move-blocking matrix: u_k = U_min(k, Ntu-1).

    The Ntu free moves over the N-stage horizon, the last one held for the
    tail: the reference's "Du pinned to zero after Ntu".
    """
    dev = scenario_device(device, "blocking_matrix")
    hold = torch.clamp(torch.arange(N, device=dev), max=Ntu - 1)
    return (hold[:, None] == torch.arange(Ntu, device=dev)[None, :]).to(dtype)


def prediction_matrices(A, B, N: int, device=None, dtype=None):
    """Sx (..., N, nx, nx), Su (..., N, N, nx, nu) for x_{k+1} = A_k x_k +
    B_k u_k.

    ``A``: (nx, nx) LTI or (..., N, nx, nx) LTV; ``B``: (nx, nu) or
    (..., N, nx, nu).  The stacked predictions of x_1..x_N:
    x_{k+1} = Sx[k] @ x0 + sum_j Su[k, j] @ u_j (Su[k, j] = 0 for j > k).
    """
    dev, dt = _placement(A, device, dtype, "prediction_matrices")
    A = torch.as_tensor(A, dtype=dt, device=dev)
    B = torch.as_tensor(B, dtype=dt, device=dev)
    nx, nu = A.shape[-1], B.shape[-1]
    if A.ndim == 2:
        A = A.expand(N, nx, nx)
    if B.ndim == 2:
        B = B.expand(N, nx, nu)
    lead = torch.broadcast_shapes(A.shape[:-3], B.shape[:-3])
    A = A.expand(lead + (N, nx, nx))
    B = B.expand(lead + (N, nx, nu))
    Phi = torch.eye(nx, dtype=dt, device=dev).expand(lead + (nx, nx))
    Gamma = torch.zeros(lead + (N, nx, nu), dtype=dt, device=dev)
    Sx, Su = [], []
    for k in range(N):
        Ak = A[..., k, :, :]
        Phi = Ak @ Phi
        Gamma = Ak[..., None, :, :] @ Gamma
        Gamma[..., k, :, :] = B[..., k, :, :]
        Sx.append(Phi)
        Su.append(Gamma)
    # Sx: (..., N, nx, nx); Su: (..., N, N, nx, nu), Su[k, j] the j->k+1 map
    return torch.stack(Sx, -3), torch.stack(Su, -4)


def condense(A, B, Q, R, N: int, QN=None, Ntu: Optional[int] = None,
             du_weight: float = 0.0, device=None, dtype=None):
    """The condensed QP data of a linear-quadratic MPC step.

    Cost: sum_{k=1..N} (x_k - xref_k)'Q(x_k - xref_k)
          + sum_{k=0..N-1} (u_k - uref_k)'R(u_k - uref_k)
          + du_weight * sum ||u_k - u_{k-1}||^2   (u_{-1} = u_prev)
    with x_N weighted by ``QN`` (defaults to Q) and the controls blocked to
    ``Ntu`` free moves (default N).  ``A`` / ``B`` may carry leading batch
    dimensions (LTV stacks: (..., N, nx, nx)).

    Returns a dict for ``solve_condensed``.
    """
    dev, dt = _placement(A, device, dtype, "condense")
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    Q, R = t(Q), t(R)
    QN = Q if QN is None else t(QN)
    Ntu = N if Ntu is None else Ntu
    Sx, Su = prediction_matrices(A, B, N, dev, dt)
    nx, nu = Sx.shape[-1], Su.shape[-1]
    Tm = blocking_matrix(N, Ntu, dtype=dt, device=dev)       # (N, Ntu)
    # fold blocking into Su: Sub[k, m] = sum_j Su[k, j] * T[j, m]
    Sub = torch.einsum("...kjxu,jm->...kmxu", Su, Tm)        # (..., N, Ntu, nx, nu)
    Qbar = torch.cat([Q.expand(N - 1, nx, nx), QN[None]], dim=0)
    # H_uu = sum_k Sub[k]' Qbar[k] Sub[k]  -> (..., Ntu, nu, Ntu, nu)
    H = torch.einsum("...kmxu,kxy,...knyv->...munv", Sub, Qbar, Sub)
    # control cost: R on every stage; blocking makes T'T = diag(stage counts)
    w = Tm.sum(0)                                            # (Ntu,)
    eye_m = torch.eye(Ntu, dtype=dt, device=dev)
    H = H + torch.einsum("mn,m,uv->munv", eye_m, w, R)
    # Delta-u cost: first differences over the free moves (the blocked
    # tail has du = 0); u_prev enters the gradient
    if du_weight > 0.0:
        D = eye_m - torch.diag(torch.ones(Ntu - 1, dtype=dt, device=dev), -1)
        H = H + du_weight * torch.einsum(
            "mn,uv->munv", D.T @ D, torch.eye(nu, dtype=dt, device=dev))
    n = Ntu * nu
    return dict(Sx=Sx, Sub=Sub, Qbar=Qbar, R=R, Tm=Tm,
                H=H.reshape(H.shape[:-4] + (n, n)), N=N, Ntu=Ntu, nx=nx,
                nu=nu, du_weight=du_weight, w=w)


def solve_dense_boxqp(H, g, lb, ub, max_iters: int = 30, tol: float = 1e-10):
    """Exact dense box QP by Bertsekas projected Newton, batched.

    min 0.5 v'Hv + g'v  s.t.  lb <= v <= ub, H positive definite; every
    argument may carry leading batch dimensions (they broadcast; ``H`` and
    ``g`` fix the device and dtype).  Each iteration takes the binding set
    from the projected gradient at the current feasible point, a Newton step
    on the free subspace, and the best of 12 projected step lengths on the
    exact quadratic; a problem stops when its projected gradient is below
    ``tol`` or no step improves, and then keeps its point.
    """
    H = torch.as_tensor(H)
    z = dict(dtype=H.dtype, device=H.device)
    g = torch.as_tensor(g, **z)
    lead = torch.broadcast_shapes(H.shape[:-2], g.shape[:-1])
    n = H.shape[-1]
    H = H.expand(lead + (n, n))
    g = g.expand(lead + (n,))
    lb = torch.as_tensor(lb, **z).expand(lead + (n,))
    ub = torch.as_tensor(ub, **z).expand(lead + (n,))
    alphas = 0.5 ** torch.arange(12, **z)
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    q = lambda v: 0.5 * (v * mv(H[..., None, :, :], v)).sum(-1) \
        + (g[..., None, :] * v).sum(-1)
    v = torch.clamp(torch.zeros_like(g), lb, ub)
    done = torch.zeros(lead, dtype=torch.bool, device=H.device)
    for _ in range(max_iters):
        grad = mv(H, v) + g
        # binding set: at a bound with the gradient pushing outward
        at_lo = (v <= lb + 1e-12) & (grad > 0)
        at_up = (v >= ub - 1e-12) & (grad < 0)
        free = ~(at_lo | at_up)
        m = free.to(v.dtype)
        Hf = m[..., :, None] * H * m[..., None, :] + torch.diag_embed(1.0 - m)
        step = -torch.linalg.solve_ex(Hf, m * grad)[0]
        # projected line search on the exact quadratic
        cands = torch.clamp(v[..., None, :] + alphas[:, None] * step[..., None, :],
                            lb[..., None, :], ub[..., None, :])
        qs = q(cands)
        best = torch.argmin(qs, dim=-1, keepdim=True)
        v_new = cands.gather(-2, best[..., None].expand(lead + (1, n)))[..., 0, :]
        improved = qs.gather(-1, best)[..., 0] < q(v[..., None, :])[..., 0] - 1e-15
        pg = torch.where(free, grad, torch.where(at_lo, grad.clamp(max=0.0),
                                                 grad.clamp(min=0.0)))
        done_n = (pg.abs().amax(-1) < tol) | ~improved
        v = torch.where(done[..., None], v, v_new)
        done = done | done_n
        if bool(done.all()):
            break
    return v


def solve_condensed(data, x0, xref, uref=None, u_prev=None,
                    u_lb=None, u_ub=None, max_iters: int = 30):
    """Solve a condensed MPC step, batched over a leading axis of ``x0``.

    Args:
      data: output of ``condense`` (its matrices unbatched, or batched with
        the batch of ``x0``).
      x0: (nx,) or (B, nx) current state(s).
      xref: (N, nx) or (B, N, nx) state reference for stages 1..N.
      uref: optional (N, nu) / (B, N, nu) control reference.
      u_prev: optional (nu,) / (B, nu) previous control (Delta-u cost).
      u_lb / u_ub: optional (nu,) control box (broadcast over moves).

    Returns (us (B?, N, nu) expanded over the blocking, Ufree (B?, Ntu*nu)).
    """
    Sub, Sx, Qbar = data["Sub"], data["Sx"], data["Qbar"]
    Tm, H = data["Tm"], data["H"]
    N, Ntu, nx, nu = data["N"], data["Ntu"], data["nx"], data["nu"]
    R, du_w = data["R"], data["du_weight"]
    z = dict(dtype=H.dtype, device=H.device)
    x0 = torch.as_tensor(x0, **z)
    squeeze = x0.ndim == 1
    if squeeze:
        x0 = x0[None]
    B = x0.shape[0]
    xref = torch.as_tensor(xref, **z).expand(B, N, nx)
    uref = (torch.zeros((B, N, nu), **z) if uref is None
            else torch.as_tensor(uref, **z).expand(B, N, nu))
    u_prev = (torch.zeros((B, nu), **z) if u_prev is None
              else torch.as_tensor(u_prev, **z).expand(B, nu))

    # error of the zero-control prediction: e_k = Sx[k] x0 - xref_k
    e = (Sx @ x0[:, None, :, None])[..., 0] - xref          # (B, N, nx)
    Qe = (Qbar @ e[..., None])[..., 0]
    g = torch.einsum("...kmxu,...kx->...mu", Sub, Qe)       # (B, Ntu, nu)
    # control-reference gradient: -R uref summed per blocked move
    g = g - torch.einsum("km,bku->bmu", Tm, uref @ R.T)
    if du_w > 0.0:
        g = g.clone()
        g[:, 0] -= du_w * u_prev
    g = g.reshape(B, Ntu * nu)

    big = torch.full((Ntu * nu,), 1e30, **z)
    lb = (torch.as_tensor(u_lb, **z).expand(Ntu, nu).reshape(-1)
          if u_lb is not None else -big)
    ub = (torch.as_tensor(u_ub, **z).expand(Ntu, nu).reshape(-1)
          if u_ub is not None else big)
    U = solve_dense_boxqp(H.expand((B,) + H.shape[-2:]), g, lb, ub,
                          max_iters=max_iters)
    us = torch.einsum("km,bmu->bku", Tm, U.reshape(B, Ntu, nu))
    if squeeze:
        return us[0], U[0]
    return us, U
