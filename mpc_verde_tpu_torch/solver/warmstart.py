"""One-shot LQR warm start (port of ``mpc_verde_tpu.solver.warmstart``).

A time-varying LQR policy about per-stage reference points ``(xref_k,
uref)``: one horizon-length Riccati recursion on the linearized dynamics and
the quadratized stage cost (no constraints, a fixed Tikhonov term 1e-6 on
Quu), then one rollout of the policy on the exact dynamics with the controls
clipped to the box.  The result is dynamically feasible and inside the box
by construction; optimality is the solver's job.  For nonholonomic models
linearized about a stationary target, pass a small forward velocity as
``uref``: at v = 0 the lateral direction is uncontrollable.

On the card both steps are the kernels of the ``"cuda"`` backend (under
``"cuda_bw"``, K1 and the plain PyTorch rollout on the OCP's callables).  The
recursion is K1 (``riccati_backward``) with infinite bounds, no DDP terms,
no terminal value (gN = HN = 0) and reg = 1e-6: the box QP of every stage is
then its all-free Newton step, and K1's value update is the JAX
``bwd``'s term for term.  The rollout is K2 (``linesearch_forward``) with
one step length alpha = 1, the nominal trajectory ``x_nom = xr`` (N+1 rows,
the last one unread) and ``u_nom = uref``, and the recursion's gains:
K2's ``clip(u_nom + alpha kff + K (x - x_nom))`` is the policy.  With
``backend="torch"`` both steps run the kernels' plain PyTorch twins.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.func import vmap

from ..ocp.spec import OCP
from ..ops.cuda.riccati import (riccati_backward, riccati_backward_cast,
                                riccati_backward_torch)
from ..ops.cuda.rollout import linesearch_forward, linesearch_forward_torch
from ..ops.linearize import linearize_trajectory
from .batched import _as_tensor, _broadcast_params, _check_ocp, resolve_backend

WARM_REG = 1e-6


def make_lqr_warm_start(ocp: OCP,
                        xref_fn: Optional[Callable] = None,
                        uref=None,
                        backend: Optional[str] = None):
    """Build ``warm(x0s, params) -> us_init`` for a batch of problems.

    Args:
      ocp: the problem; ``dynamics`` / ``stage_cost`` are linearized about
        the per-stage reference points.
      xref_fn: ``p_k -> xref`` extracting the stage-k state reference from
        that stage's parameter vector (``lambda p: p[:3]`` for the
        diff-drive layout); defaults to zeros.
      uref: (nu,) control linearization point; defaults to zeros.
      backend: the port's one addition to the JAX signature, with
        ``resolve_backend``'s meaning: None is ``"torch"`` on the CPU and on
        a CUDA device ``"cuda_fused"`` for a float32 OCP with a
        ``device_model`` or whose callables lower to a traced one (K2 then
        runs on the traced model), else ``"cuda_bw"`` (nu <= 4; more
        raises).
        ``"cuda"`` and ``"cuda_fused"`` both run K1 and K2; ``"cuda_bw"``
        runs K1 (on float32 copies for a float64 OCP) and the rollout's
        twin on the OCP's callables; ``"torch"`` runs both twins on any
        device.

    Returns ``warm(x0s (B, nx), params (B, N+1, npar)) -> us_init
    (B, N, nu)``.
    """
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    backend = resolve_backend(ocp, backend)
    if backend == "scan":
        raise NotImplementedError(
            "the warm start runs K1 and K2 (\"cuda\" / \"cuda_fused\"), K1 "
            "and the rollout's twin (\"cuda_bw\") or both twins (\"torch\")")
    _check_ocp(ocp, backend)
    if backend == "torch":
        bw_fn, ls_fn = riccati_backward_torch, linesearch_forward_torch
    elif backend == "cuda_bw":
        bw_fn, ls_fn = riccati_backward_cast, linesearch_forward_torch
    else:
        bw_fn, ls_fn = riccati_backward, linesearch_forward
    npar = max(ocp.npar, 1)
    z = dict(dtype=ocp.dtype, device=ocp.device)
    u_ref = torch.as_tensor(np.zeros(nu) if uref is None
                            else np.asarray(uref, dtype=np.float64), **z)
    if xref_fn is None:
        def xref_fn(p):
            return torch.zeros((nx,), dtype=p.dtype, device=p.device)

    def warm(x0s, params=None):
        x0s = _as_tensor(x0s, z).contiguous()
        B = x0s.shape[0]
        ps = _broadcast_params(ocp, params, B)[..., :npar].contiguous()
        xr = vmap(xref_fn)(ps[:, :N].reshape(B * N, npar)).reshape(B, N, nx)
        ur = u_ref.expand(B, N, nu).contiguous()
        d = linearize_trajectory(ocp.dynamics, ocp.stage_cost, xr, ur,
                                 ps[:, :N])
        inf = torch.full((B, N, nu), torch.inf, **z)
        zx = torch.zeros((B, nx), **z)
        kffs, Ks, _, _, _ = bw_fn(
            d, -inf, inf, zx, torch.zeros((B, nx, nx), **z),
            torch.full((B,), WARM_REG, **z), None, nx=nx, nu=nu,
            use_ddp=False)
        x_nom = torch.cat([xr, xr[:, -1:]], dim=1).contiguous()
        _, us, _, _ = ls_fn(x0s, x_nom, ur, ps, kffs, Ks, (1.0,), ocp=ocp)
        return us

    return warm
