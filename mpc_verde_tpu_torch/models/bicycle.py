"""Lateral-error bicycle models: LTI, LTV and the dynamic 4-state one (port
of ``mpc_verde_tpu.models.bicycle``).

References:
  * 3-state lateral-error model (y, phi, r) with one steering input:
    ``Trajectory Tracking/Trajectory_tracking_le_LTI.py:37-41``:
    ``Ac = [[0, uref, 0], [0, 0, 1], [0, 0, ar]]``, ``Bc = [0, 0, br]``,
    with ``ar = -23.55``, ``br = 61.99``.
  * The LTV variant rebuilds Ac each step from the time-varying speed
    ``c[t]`` (``Trjectory_tracking_le_LTV.py:126-128``); the ``leitura.py:140``
    variant multiplies the speed by the yaw reference.
  * 4-state dynamic bicycle (y, phi, v_lat, r) with m = 1200, a = 1.5, b = 2,
    Ca = 55000, Jz = 1350
    (``Trajectory_tracking_dynamic_model.py:37-42,119-128``).

The ``*_coeffs`` functions map a tensor of speeds with leading batch
dimensions to the continuous matrices of every speed at once, laid out
``(..., n, n)`` and ``(..., n, 1)``: the JAX functions stack the speed as the
last axis and their callers move it to the front, the port returns that
layout directly.
"""
from __future__ import annotations

import torch

from .base import LinearModel, linear_model

AR_DEFAULT = -23.55
BR_DEFAULT = 61.99


def lateral_error_lti(uref: float, ar: float = AR_DEFAULT,
                      br: float = BR_DEFAULT, *, device,
                      dtype=torch.float32) -> LinearModel:
    """LTI lateral-error model at fixed forward speed ``uref``."""
    Ac = [[0.0, float(uref), 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, float(ar)]]
    Bc = [[0.0], [0.0], [float(br)]]
    return linear_model(Ac, Bc, name="lateral_error_lti", device=device,
                        dtype=dtype)


def lateral_error_ltv_coeffs(speed, ar: float = AR_DEFAULT,
                             br: float = BR_DEFAULT, yaw_scale=1.0):
    """``speed (...,) -> (Ac (..., 3, 3), Bc (..., 3, 1))`` for the LTV
    lateral-error model.

    ``yaw_scale`` (a number or a tensor broadcasting against ``speed``)
    reproduces the ``leitura.py:140`` variant where ``Ac[0, 1] = speed *
    phi_ref`` instead of the plain speed (pass the per-step yaw reference).
    """
    speed = torch.as_tensor(speed)
    z = torch.zeros_like(speed)
    o = torch.ones_like(speed)
    a01 = speed * torch.as_tensor(yaw_scale, dtype=speed.dtype,
                                  device=speed.device)
    Ac = torch.stack([
        torch.stack([z, a01, z], -1),
        torch.stack([z, z, o], -1),
        torch.stack([z, z, ar * o], -1),
    ], -2)
    Bc = torch.stack([z, z, br * o], -1)[..., None]
    return Ac, Bc


def dynamic_bicycle_coeffs(vref, m=1200.0, a=1.5, b=2.0, Ca=55000.0,
                           Jz=1350.0):
    """``vref (...,) -> (Ac (..., 4, 4), Bc (..., 4, 1))`` for the 4-state
    dynamic bicycle.

    Coefficient formulas from
    ``Trajectory Tracking/Trajectory_tracking_dynamic_model.py:119-128``,
    including the reference's literal operator grouping of A34.
    """
    vref = torch.as_tensor(vref)
    A33 = -4.0 * Ca / (m * vref)
    A34 = (2.0 * Ca * (b - a) / m * vref) - vref
    A43 = 2.0 * Ca * ((b - a) / (Jz * vref))
    A44 = -2.0 * Ca * (a * a + b * b) / (Jz * vref)
    B31 = 2.0 * Ca / m
    B41 = 2.0 * Ca * a / Jz
    z = torch.zeros_like(vref)
    o = torch.ones_like(vref)
    Ac = torch.stack([
        torch.stack([z, vref, o, z], -1),
        torch.stack([z, z, z, o], -1),
        torch.stack([z, z, A33, A34], -1),
        torch.stack([z, z, A43, A44], -1),
    ], -2)
    Bc = torch.stack([z, z, B31 * o, B41 * o], -1)[..., None]
    return Ac, Bc


def dynamic_bicycle_ltv(vref_nominal: float = 1.0, *, device,
                        dtype=torch.float32, **params) -> LinearModel:
    """Dynamic bicycle frozen at a nominal speed (for LTI use and tests)."""
    Ac, Bc = dynamic_bicycle_coeffs(
        torch.tensor(float(vref_nominal), dtype=torch.float64), **params)
    return linear_model(Ac.numpy(), Bc.numpy(), name="dynamic_bicycle",
                        device=device, dtype=dtype)
