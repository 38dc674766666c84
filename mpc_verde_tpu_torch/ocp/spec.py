"""Optimal-control-problem specification (PyTorch port of ``mpc_verde_tpu.ocp.spec``).

Discrete dynamics, stage / terminal costs, horizon, a control box and a
per-stage parameter vector.  The callables act on single vectors
(``x (nx,)``, ``u (nu,)``, ``p (npar,)``) exactly as in the JAX package; the
solvers batch them with ``torch.func.vmap``.

Two additions over the JAX spec:

* ``device`` / ``dtype``: the tensors the callables close over (weights,
  bounds) live there, and the solvers cast their inputs to them.
* ``device_model``: a hand-written plain-number description of the same
  problem that the CUDA kernels K2 and K3 evaluate (``ops/cuda/rollout.py``).
  CUDA code cannot inline a Python callable the way the Pallas kernels
  inline a jaxpr, so for an OCP without one the kernels run on a model
  generated from the trace of its callables (``ops/cuda/trace.py``,
  ``ops/cuda/codegen.py``), built at its first launch.  That model reads
  the current values of the float tensors the callables close over, so a
  weight or bound changed in place after the trace is followed by every
  backend alike; an integer or bool tensor they close over is compiled
  into the model, and changing one in place makes the next use raise.  A
  name rebound to a new tensor is not seen (the trace holds the tensor it
  read, as a JAX trace holds its constants), nor is a change to the values
  a hand-written ``device_model`` was built from: build a new OCP then.
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
      x_lb, x_ub: optional (nx,) state box, enforced by the solvers'
        augmented Lagrangian (``options.al_iters`` rounds).
      device, dtype: where the callables' constants live.
      device_model: hand-written kernel-side description of the same
        problem (``ops.cuda.rollout.UnicycleDeviceModel``, the unicycle's)
        or ``None`` (the kernels then trace the callables).
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

    def state_box(self):
        """State bounds as finite-or-inf (nx,) tensors on the OCP's device."""
        z = dict(dtype=self.dtype, device=self.device)

        def side(b, fill):
            if b is None:
                return torch.full((self.nx,), fill, **z)
            return torch.as_tensor(b if torch.is_tensor(b) else np.asarray(b),
                                   **z)

        return side(self.x_lb, -torch.inf), side(self.x_ub, torch.inf)
