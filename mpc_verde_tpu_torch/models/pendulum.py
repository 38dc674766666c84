"""Inverted pendulum on a cart: the linear model of the MATLAB MPC example
(port of ``mpc_verde_tpu.models.pendulum``).

Reference: ``Inverted_pendulum/inverted_pendulum_single_shooting_mpctools.py:19-22``
builds ``Ac`` (transposed in the script) and ``Bc`` for states
(x, xdot, theta, thetadot) and a single force input, then discretizes with
``mpc.util.c2d(Ac, Bc, T)`` at T = 0.01.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import LinearModel, linear_model


def cart_pendulum_linear(device, dtype=torch.float32) -> LinearModel:
    # The script writes Ac row-major then transposes (:19-20); reproduce the
    # post-transpose matrix directly.
    Ac = np.array(
        [[0.0, 0.0, 0.0, 0.0],
         [1.0, -10.0, 0.0, -20.0],
         [0.0, 9.81, 0.0, 39.24],
         [0.0, 0.0, 1.0, 0.0]]
    ).T
    Bc = np.array([[0.0], [1.0], [0.0], [2.0]])
    return linear_model(Ac, Bc, name="cart_pendulum_linear", device=device,
                        dtype=dtype)
