"""Fixed-step integrators (port of ``mpc_verde_tpu.ops.integrators``, Euler and RK4)."""
from __future__ import annotations


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
