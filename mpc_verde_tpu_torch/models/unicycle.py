"""Differential-drive (unicycle) kinematics: ``[v cos(theta), v sin(theta), omega]``.

Port of ``mpc_verde_tpu.models.unicycle``; states (x, y, theta), controls
(v, omega).
"""
from __future__ import annotations

import torch

from .base import Model

UNICYCLE_NX = 3
UNICYCLE_NU = 2


def _rhs(x, u, p=None):
    theta = x[2]
    v, omega = u[0], u[1]
    return torch.stack([v * torch.cos(theta), v * torch.sin(theta), omega])


unicycle = Model(f=_rhs, nx=UNICYCLE_NX, nu=UNICYCLE_NU, np=0, name="unicycle")
