"""Control-rate (Delta-u) reformulation (port of ``mpc_verde_tpu.ocp.rate``).

``mpc.nmpc`` exposes rate constraints and rate costs through ``uprev=`` and
``"Du"`` bounds: move blocking (free Du for the first Ntu stages, pinned to 0
after: ``Inverted_pendulum/...mpctools.py:34-42``,
``Trajectory_tracking_le_LTI.py:66-74``) and steering-rate limits
(``test2.py:44-48``), with Du in the stage costs
(``Inverted_pendulum/...mpctools.py:51-53``).

The state is augmented with the previous control, ``z = [x; u_prev]``, and
the rate becomes the control, ``w = Du``:

    z_next = [ F(x, u_prev + w, p) ; u_prev + w ]

Du boxes are then plain control boxes on ``w``, and the u box becomes the
state-dependent box ``u_lb - u_prev <= w <= u_ub - u_prev``, which is what
``OCP.control_bounds(z, p, k)`` expresses.  Move blocking (Du == 0) is the
degenerate box lb = ub = 0, which the enumeration box QP solves exactly.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .spec import OCP


def to_rate_form(
    dynamics: Callable,
    stage_cost: Callable,
    N: int,
    nx: int,
    nu: int,
    npar: int = 0,
    terminal_cost: Optional[Callable] = None,
    u_lb=None,
    u_ub=None,
    du_lb=None,
    du_ub=None,
    x_lb=None,
    x_ub=None,
    *,
    device,
    dtype=torch.float32,
) -> OCP:
    """Build the augmented-state OCP.

    Args:
      dynamics: ``F(x, u, p) -> x_next`` on the *original* state.
      stage_cost: ``l(x, u, p, du) -> scalar`` (du available, as in
        mpctools' ``largs = ["x", "u", "p", "Du"]``).
      u_lb, u_ub: (nu,) or (N, nu) control magnitude bounds.
      du_lb, du_ub: (nu,) or (N, nu) rate bounds (move blocking via 0/0 rows).
      x_lb, x_ub: optional original-state box.
      device, dtype: where the bound tables live, and their type (the
        port's additions, as on ``OCP``).  The OCP carries no device model:
        the kernels run the model traced from its callables.

    Returns an ``OCP`` over z = [x; u_prev] with control w = Du.  Solve it
    with initial state ``z0 = concat([x0, uprev])``.  Missing bounds are
    +-inf; the stage index ``k`` of ``control_bounds`` may be an int or a
    tensor (the solvers batch it with ``torch.func.vmap``).
    """
    z = dict(dtype=dtype, device=device)
    inf = np.inf

    def _stage_arr(b, default):
        if b is None:
            return torch.full((N, nu), default, **z)
        b = torch.as_tensor(np.asarray(b, dtype=np.float64), **z)
        if b.ndim == 1:
            b = b.expand(N, nu)
        return b.contiguous()

    ulb = _stage_arr(u_lb, -inf)
    uub = _stage_arr(u_ub, inf)
    dlb = _stage_arr(du_lb, -inf)
    dub = _stage_arr(du_ub, inf)

    def z_dynamics(zz, w, p):
        x, u_prev = zz[:nx], zz[nx:]
        u = u_prev + w
        return torch.cat([dynamics(x, u, p), u])

    def z_cost(zz, w, p):
        x, u_prev = zz[:nx], zz[nx:]
        u = u_prev + w
        return stage_cost(x, u, p, w)

    z_terminal = None
    if terminal_cost is not None:
        def z_terminal(zz, p):
            return terminal_cost(zz[:nx], p)

    def w_bounds(zz, p, k):
        u_prev = zz[nx:]
        lb = torch.maximum(dlb[k], ulb[k] - u_prev)
        ub = torch.minimum(dub[k], uub[k] - u_prev)
        return lb, ub

    zx_lb = zx_ub = None
    if x_lb is not None or x_ub is not None:
        side = lambda b, fill: (torch.full((nx,), fill, **z) if b is None
                                else torch.as_tensor(np.asarray(b, np.float64),
                                                     **z))
        zx_lb = torch.cat([side(x_lb, -inf), torch.full((nu,), -inf, **z)])
        zx_ub = torch.cat([side(x_ub, inf), torch.full((nu,), inf, **z)])

    return OCP(
        dynamics=z_dynamics,
        stage_cost=z_cost,
        terminal_cost=z_terminal,
        N=N,
        nx=nx + nu,
        nu=nu,
        npar=npar,
        control_bounds=w_bounds,
        x_lb=zx_lb,
        x_ub=zx_ub,
        device=torch.device(device),
        dtype=dtype,
    )
