"""Fixed-step and adaptive integrators, discretization utilities and the plant
stepper (port of ``mpc_verde_tpu.ops.integrators``).

The step functions act on single vectors, as the models do; the solvers
batch them with ``torch.func.vmap``.  ``rk45_step`` and
``DiscreteSimulator.sim`` also take leading batch dimensions themselves.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap


def euler_step(f, dt: float):
    """Explicit Euler step ``x + dt * f(x, u, p)``."""

    def step(x, u, p=None):
        return x + dt * f(x, u, p)

    return step


def rk4_step(f, dt: float, M: int = 1):
    """Classic RK4 with ``M`` equal substeps over ``dt``."""
    h = dt / M

    def substep(x, u, p):
        k1 = f(x, u, p)
        k2 = f(x + 0.5 * h * k1, u, p)
        k3 = f(x + 0.5 * h * k2, u, p)
        k4 = f(x + h * k3, u, p)
        return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    def step(x, u, p=None):
        for _ in range(M):
            x = substep(x, u, p)
        return x

    return step


_DOPRI_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DOPRI_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DOPRI_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
             187 / 2100, 1 / 40)


def rk45_step(f, dt: float, rtol: float = 1e-8, atol: float = 1e-10,
              max_steps: int = 1000):
    """Adaptive embedded Dormand-Prince RK5(4) over one ``dt`` interval.

    Returns ``step(x, u, p=None) -> x(dt)``.  ``x`` is one state (nx,) or a
    batch (..., nx) with ``u`` (and ``p``, unless None) batched alike.  The
    JAX step runs lockstep under ``vmap`` inside ``lax.while_loop``;
    ``torch.func.vmap`` cannot run a loop whose length depends on the data,
    so here every member carries its own time, step size and substep count,
    accepts or rejects under a mask, and the loop runs until every member
    has reached ``dt`` or spent ``max_steps`` substeps.  Each substep reads
    one flag from the device to decide whether to go on.  On exhaustion a
    member keeps its partially advanced state, as in the JAX step.
    """
    dtf = float(dt)

    def step(x, u, p=None):
        x = torch.as_tensor(x)
        dtype = x.dtype if x.is_floating_point() else torch.get_default_dtype()
        x = x.to(dtype)
        lead = x.shape[:-1]
        nx = x.shape[-1]
        y = x.reshape(-1, nx)
        ub = torch.as_tensor(u, dtype=dtype, device=x.device)
        ub = ub.expand(lead + ub.shape[-1:]).reshape(y.shape[0], -1)
        if p is None:
            rhs_b = vmap(lambda yi, ui: f(yi, ui, None))
            rhs = lambda yy: rhs_b(yy, ub).to(dtype)
        else:
            pt = torch.as_tensor(p, device=x.device)
            pb = pt.expand(lead + pt.shape[-1:]).reshape(y.shape[0], -1)
            rhs_b = vmap(f)
            rhs = lambda yy: rhs_b(yy, ub, pb).to(dtype)

        B = y.shape[0]
        z = dict(dtype=dtype, device=x.device)
        t = torch.zeros((B,), **z)
        h = torch.full((B,), dtf, **z)
        n = torch.zeros((B,), dtype=torch.int32, device=x.device)
        k1 = rhs(y)
        while True:
            active = (t < dtf * (1.0 - 1e-12)) & (n < max_steps)
            if not bool(active.any()):
                break
            hs = torch.minimum(h, dtf - t)
            ks = [k1]
            for i in range(1, 7):
                ks.append(rhs(y + hs[:, None] * sum(
                    a * k for a, k in zip(_DOPRI_A[i], ks))))
            y5 = y + hs[:, None] * sum(b * k for b, k in zip(_DOPRI_B5, ks))
            y4 = y + hs[:, None] * sum(b * k for b, k in zip(_DOPRI_B4, ks))
            scale = atol + rtol * torch.maximum(y.abs(), y5.abs())
            err = torch.sqrt((((y5 - y4) / scale) ** 2).mean(-1))
            accept = err <= 1.0
            # PI-ish controller with the usual safety/clamp factors
            fac = torch.clamp(0.9 * (err + 1e-16) ** (-0.2), 0.2, 5.0)
            take = active & accept
            t = torch.where(take, t + hs, t)
            y = torch.where(take[:, None], y5, y)
            # FSAL: stage 7 of an accepted step is k1 of the next
            k1 = torch.where(take[:, None], ks[6], k1)
            h = torch.where(active, hs * fac, h)
            n = torch.where(active, n + 1, n)
        return y.reshape(x.shape)

    return step


def rk4_step_with_quadrature(f, l, dt: float, M: int = 1):
    """RK4 integrating state and running-cost quadrature jointly.

    ``step(x, u, p) -> (x_next, q)``: the Lagrange term ``l(x, u, p)`` is
    integrated with the same RK4 stages, in the JAX step's order of
    floating-point operations.
    """
    h = dt / M

    def step(x, u, p=None):
        q = torch.zeros((), dtype=x.dtype, device=x.device)
        for _ in range(M):
            k1 = f(x, u, p)
            k1_q = l(x, u, p)
            k2 = f(x + 0.5 * h * k1, u, p)
            k2_q = l(x + 0.5 * h * k1, u, p)
            k3 = f(x + 0.5 * h * k2, u, p)
            k3_q = l(x + 0.5 * h * k2, u, p)
            k4 = f(x + h * k3, u, p)
            k4_q = l(x + h * k3, u, p)
            x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
            q = q + (h / 6.0) * (k1_q + 2.0 * k2_q + 2.0 * k3_q + k4_q)
        return x, q

    return step


def discretize(model, dt: float, method: str = "rk4", M: int = 1):
    """Discretize a continuous ``Model`` (or bare RHS) into ``F(x, u, p) -> x_next``."""
    f = model.f if hasattr(model, "f") else model
    if method == "euler":
        return euler_step(f, dt)
    if method == "rk4":
        return rk4_step(f, dt, M=M)
    raise ValueError(f"unknown integration method: {method!r}")


def c2d(Ac, Bc, dt: float):
    """Zero-order-hold discretization via the augmented matrix exponential:
    ``expm([[Ac, Bc], [0, 0]] * dt)`` read off as (Ad, Bd).  Batched over
    leading dimensions; numpy input becomes float64 tensors."""
    Ac = torch.as_tensor(np.asarray(Ac) if not torch.is_tensor(Ac) else Ac)
    Bc = torch.as_tensor(np.asarray(Bc) if not torch.is_tensor(Bc) else Bc,
                         dtype=Ac.dtype, device=Ac.device)
    nx, nu = Ac.shape[-1], Bc.shape[-1]
    blk = torch.zeros(Ac.shape[:-2] + (nx + nu, nx + nu), dtype=Ac.dtype,
                      device=Ac.device)
    blk[..., :nx, :nx] = Ac
    blk[..., :nx, nx:] = Bc
    E = torch.linalg.matrix_exp(blk * dt)
    return E[..., :nx, :nx], E[..., :nx, nx:]


class DiscreteSimulator:
    """Plant stepper decoupled from the controller model: ``M`` RK4 substeps
    over ``dt`` (``method="rk4"``) or the adaptive ``rk45_step`` to
    ``rtol`` / ``atol`` (``method="rk45"``).  ``sim(x, u, p=None)`` takes
    one state or a batch with leading dimensions."""

    def __init__(self, ode, dt: float, sizes=None, names=None, M: int = 10,
                 method: str = "rk4", rtol: float = 1e-8, atol: float = 1e-10):
        f = ode.f if hasattr(ode, "f") else ode
        self.dt = float(dt)
        self.M = int(M)
        if method == "rk4":
            one = rk4_step(f, self.dt, M=self.M)

            def batched(x, u, p):
                if x.ndim == 1:
                    return one(x, u, p)
                lead, nx = x.shape[:-1], x.shape[-1]
                flat = lambda a: a.expand(lead + a.shape[-1:]).reshape(
                    -1, a.shape[-1])
                if p is None:
                    out = vmap(lambda xi, ui: one(xi, ui, None))(
                        x.reshape(-1, nx), flat(u))
                else:
                    out = vmap(one)(x.reshape(-1, nx), flat(u), flat(p))
                return out.reshape(x.shape)

            self._step = batched
        elif method == "rk45":
            # tolerance-adaptive plant integration (the CVODES role)
            self._step = rk45_step(f, self.dt, rtol=rtol, atol=atol)
        else:
            raise ValueError(f"unknown DiscreteSimulator method {method!r}")

    def sim(self, x, u, p=None):
        x = torch.as_tensor(x)
        u = torch.as_tensor(u, dtype=x.dtype, device=x.device)
        if p is not None:
            p = torch.as_tensor(p, dtype=x.dtype, device=x.device)
        return self._step(x, u, p)

    __call__ = sim
