"""Nonlinear path-frame (Frenet) error dynamics (port of
``mpc_verde_tpu.models.frenet``).

Reference: ``Trajectory Tracking/test2.py:103-112``: states
(y, phi, v) = (lateral position, yaw, speed), controls (delta, a),
parameters (yt, phit, kappat, vdes):

    ydot   = v * sin(phi - phit)
    phidot = v * (tan(delta / L) - kappa * cos(phi - phit) / (1 - (y - yt) * kappa))
    vdot   = a

with wheelbase L = 3.5 (``test2.py:19``).  The reference literally writes
``tan(delta / L)`` (not ``tan(delta) / L``); the model reproduces that.
"""
from __future__ import annotations

import torch

from .base import Model

FRENET_L_DEFAULT = 3.5


def frenet_path_frame(L: float = FRENET_L_DEFAULT) -> Model:
    def f(x, u, p):
        y, phi, v = x[0], x[1], x[2]
        delta, a = u[0], u[1]
        yt, phit, kappat = p[0], p[1], p[2]
        cos_e = torch.cos(phi - phit)
        return torch.stack([
            v * torch.sin(phi - phit),
            v * (torch.tan(delta / L)
                 - (kappat / (1.0 - (y - yt) * kappat)) * cos_e),
            a,
        ])

    return Model(f=f, nx=3, nu=2, np=4, name="frenet_path_frame")
