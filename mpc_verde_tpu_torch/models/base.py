"""Model abstraction: continuous-time dynamics as plain torch functions.

Port of ``mpc_verde_tpu.models.base``: a model is ``f(x, u, p) -> xdot`` on
single vectors; ``torch.func`` differentiates and batches it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
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


@dataclasses.dataclass(frozen=True)
class LinearModel(Model):
    """LTI model ``xdot = Ac x + Bc u`` with its matrices kept for ``c2d``."""

    Ac: Optional[torch.Tensor] = None
    Bc: Optional[torch.Tensor] = None


def linear_model(Ac, Bc, name: str = "linear", *, device,
                 dtype=torch.float32) -> LinearModel:
    """A ``LinearModel`` whose matrices are tensors on ``device`` in
    ``dtype`` (the JAX package takes float64 under x64, else float32)."""
    Ac = torch.as_tensor(np.asarray(Ac), dtype=dtype, device=device)
    Bc = torch.as_tensor(np.asarray(Bc), dtype=dtype, device=device)
    nx, nu = Bc.shape

    def f(x, u, p=None):
        return Ac @ x + Bc @ u

    return LinearModel(f=f, nx=nx, nu=nu, np=0, name=name, Ac=Ac, Bc=Bc)
