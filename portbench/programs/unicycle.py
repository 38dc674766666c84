"""The system under test for a unicycle configuration: the port's OCP and
plant, built through the port's own entry points from the configuration's
numbers."""
from __future__ import annotations

import numpy as np
import torch


def build_ocp(cfg: dict, device: torch.device):
    """The port's unicycle OCP (``interop.unicycle_ocp``, which carries the
    hand-written device model) in the configuration's dtype, its weights
    and box written as float32 arrays, as the port's bench and fleet
    write them."""
    from mpc_verde_tpu_torch.interop import unicycle_ocp

    f32 = lambda a: np.array(a, dtype=np.float32)
    return unicycle_ocp(
        int(cfg["N"]), device, getattr(torch, cfg["dtype"]), dt=cfg["T"],
        Q=np.diag(f32(cfg["Q"])), R=np.diag(f32(cfg["R"])),
        lb=f32(cfg["u_lb"]), ub=f32(cfg["u_ub"]),
        integrator=cfg["integrator"])


def plant(cfg: dict):
    """The closed loop's plant as the port builds it: a single-robot step
    ``(x, u, p_plant) -> x_next`` of the configuration's integrator."""
    from mpc_verde_tpu_torch.models import unicycle
    from mpc_verde_tpu_torch.ops import discretize

    step = discretize(unicycle, cfg["T"], method=cfg["plant"])
    return lambda x, u, pp: step(x, u, None)
