"""Optimal-control-problem specification (PyTorch port of ``mpc_verde_tpu.ocp.spec``).

Discrete dynamics, stage / terminal costs, horizon, a control box and a
per-stage parameter vector.  The callables act on single vectors
(``x (nx,)``, ``u (nu,)``, ``p (npar,)``) exactly as in the JAX package; the
solvers batch them with ``torch.func.vmap``.

Two additions over the JAX spec:

* ``device`` / ``dtype``: the tensors the callables close over (weights,
  bounds) live there, and the solvers cast their inputs to them.
* ``device_model``: the plain-number description of the same problem that
  the CUDA line-search kernel evaluates (``ops/cuda/rollout.py``).  CUDA code
  cannot inline a Python callable the way the Pallas kernel inlines a jaxpr,
  so a ``"cuda"`` solver needs it and refuses an OCP without one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch


def box_bounds(lb, ub, *, device, dtype=torch.float32):
    """Build a ``control_bounds(x, p, k) -> (lb, ub)`` callable from arrays.

    ``lb``/``ub`` are (nu,) (constant) or (N, nu) (per-stage); they become
    tensors on ``device`` in ``dtype``.
    """
    lb = torch.atleast_1d(torch.as_tensor(np.asarray(lb), dtype=dtype,
                                          device=device))
    ub = torch.atleast_1d(torch.as_tensor(np.asarray(ub), dtype=dtype,
                                          device=device))

    if lb.ndim == 1:
        def bounds(x, p, k):
            return lb, ub
    else:
        def bounds(x, p, k):
            return lb[k], ub[k]

    return bounds


@dataclasses.dataclass(frozen=True)
class OCP:
    """Discrete-time OCP over horizon ``N``.

    Attributes:
      dynamics: ``F(x, u, p) -> x_next``.
      stage_cost: ``l(x, u, p) -> scalar`` for stages 0..N-1.
      terminal_cost: ``lf(x, p) -> scalar`` at stage N (may be ``None``).
      N, nx, nu, npar: static sizes.
      control_bounds: ``(x, p, k) -> (lb, ub)``, each (nu,).
      x_lb, x_ub: state box.  The augmented-Lagrangian path is not ported
        yet, so the solvers raise ``NotImplementedError`` when either is set.
      device, dtype: where the callables' constants live.
      device_model: kernel-side description of the same problem
        (``ops.cuda.rollout.UnicycleDeviceModel``) or ``None``.
    """

    dynamics: Callable
    stage_cost: Callable
    N: int
    nx: int
    nu: int
    npar: int = 0
    terminal_cost: Optional[Callable] = None
    control_bounds: Optional[Callable] = None
    x_lb: Optional[torch.Tensor] = None
    x_ub: Optional[torch.Tensor] = None
    device: torch.device = torch.device("cpu")
    dtype: torch.dtype = torch.float32
    device_model: Optional[object] = None

    @property
    def has_state_bounds(self) -> bool:
        return self.x_lb is not None or self.x_ub is not None
