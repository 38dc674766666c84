"""Data exchange with the JAX package, and the bench problem.

The JAX package (``mpc_verde_tpu``) is the reference; the port never imports
it.  Data crosses as numpy arrays: ``from_numpy`` turns what the JAX side
feeds or returns into tensors, ``result_to_numpy`` turns a port result back.
``bench_ocp`` builds the diff-drive point-stabilization OCP that the JAX
package's ``bench.py`` headlines (``build_ocp``), constants included.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import unicycle
from .ocp import OCP, box_bounds
from .ops import rk4_step
from .ops.cuda.rollout import UnicycleDeviceModel
from .solver.ilqr import ILQRResult

BENCH_DT = 0.2


def from_numpy(tree, device, dtype=torch.float32):
    """Turn the numpy arrays of a nested structure into tensors.

    Floating arrays become ``dtype``; integer and bool arrays keep their
    kind.  Dicts, lists and tuples are walked; a dataclass whose fields are
    ``ILQRResult``'s (the JAX result type, once converted with
    ``np.asarray``) becomes an ``ILQRResult``.  Anything array-like (a JAX
    array) goes through ``np.asarray`` first.
    """
    if isinstance(tree, dict):
        return {k: from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device, dtype) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(ILQRResult)]
        if {f.name for f in dataclasses.fields(tree)} >= set(names):
            return ILQRResult(**{n: from_numpy(getattr(tree, n), device, dtype)
                                 for n in names})
        raise TypeError(f"from_numpy: no counterpart for {type(tree).__name__}")
    a = np.array(tree)  # a copy: the source may be a read-only view
    t = torch.from_numpy(a).to(device)
    return t.to(dtype) if a.dtype.kind == "f" else t


def result_to_numpy(res: ILQRResult) -> ILQRResult:
    """An ``ILQRResult`` whose fields are numpy arrays on the host."""
    return ILQRResult(**{f.name: getattr(res, f.name).detach().cpu().numpy()
                         for f in dataclasses.fields(res)})


def bench_ocp(N: int, device, dtype=torch.float32) -> OCP:
    """The bench OCP: unicycle, RK4 at T = 0.2, Q = diag(1, 5, 0.1),
    R = diag(0.5, 0.05), target in p[:3], box v in [-1, 1] and
    omega in [-pi/4, pi/4].

    The weights and bounds are float32 numbers, as ``bench.py`` writes them,
    so a float64 build of this OCP equals the JAX one under x64.  The OCP
    carries the matching ``UnicycleDeviceModel`` for the CUDA line search.
    """
    device = torch.device(device)
    Qn = np.diag(np.array([1.0, 5.0, 0.1], dtype=np.float32))
    Rn = np.diag(np.array([0.5, 0.05], dtype=np.float32))
    lbn = np.array([-1.0, -np.pi / 4], dtype=np.float32)
    ubn = np.array([1.0, np.pi / 4], dtype=np.float32)
    Q = torch.as_tensor(Qn, dtype=dtype, device=device)
    R = torch.as_tensor(Rn, dtype=dtype, device=device)
    F = rk4_step(unicycle.f, BENCH_DT)

    def l(x, u, p):
        e = x - p[:3]
        return e @ Q @ e + u @ R @ u

    model = UnicycleDeviceModel(dt=BENCH_DT, Q=Qn, R=Rn, lb=lbn, ub=ubn)
    return OCP(dynamics=F, stage_cost=l, N=N, nx=3, nu=2, npar=3,
               control_bounds=box_bounds(lbn, ubn, device=device, dtype=dtype),
               device=device, dtype=dtype, device_model=model)
