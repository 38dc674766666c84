"""Model abstraction: continuous-time dynamics as plain torch functions.

Port of ``mpc_verde_tpu.models.base``: a model is ``f(x, u, p) -> xdot`` on
single vectors; ``torch.func`` differentiates and batches it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

# Continuous-time RHS: (x, u, p) -> dx/dt.  `p` may be ignored.
RHS = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
               torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Model:
    """A continuous-time dynamical system.

    Attributes:
      f: RHS function ``f(x, u, p) -> xdot``.
      nx: state dimension.
      nu: control dimension.
      np: per-stage parameter dimension consumed by ``f`` (0 if unused).
      name: identifier for logs.
    """

    f: RHS
    nx: int
    nu: int
    np: int = 0
    name: str = "model"

    def __call__(self, x, u, p=None):
        return self.f(x, u, p)
