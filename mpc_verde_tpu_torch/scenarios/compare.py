"""Method-vs-method agreement checks: the ``Casadi/difference.py`` analogue
(port of ``mpc_verde_tpu.scenarios.compare``).

The reference runs two transcriptions back to back and prints the rounded
trajectory deltas (``difference.py:604-619``); here the axis is the
integrator (Euler against RK4, v1 against v2), run through the diff-drive
closed loop.
"""
from __future__ import annotations

import numpy as np
import torch

from .diffdrive import build_diffdrive, run_diffdrive


def compare_diffdrive_methods(n_steps: int = 90, decimals: int = 0,
                              device=None, backend=None, dtype=torch.float32):
    """Run the diff-drive closed loop under each method and diff them.

    Returns a dict with per-method metrics and the pairwise rounded deltas
    of the state and control histories (the reference's
    ``np.around(a1 - a2)`` check).  ``device``, ``backend`` and ``dtype``
    go to ``build_diffdrive``.
    """
    runs = {}
    for name, kw in {
        "euler": dict(integrator="euler"),
        "rk4": dict(integrator="rk4"),
    }.items():
        m = run_diffdrive(build_diffdrive(n_steps=n_steps, device=device,
                                          backend=backend, dtype=dtype, **kw))
        runs[name] = {
            "xs": m["result"].xs.double().cpu().numpy(),
            "us": m["result"].us.double().cpu().numpy(),
            "steps_to_target": m["steps_to_target"],
            "ss_error": m["ss_error"],
        }

    names = list(runs)
    deltas = {}
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            a, b = runs[names[i]], runs[names[j]]
            dx = a["xs"] - b["xs"]
            du = a["us"] - b["us"]
            deltas[f"{names[i]}-{names[j]}"] = {
                "x_max_abs": float(np.abs(dx).max()),
                "u_max_abs": float(np.abs(du).max()),
                "x_rounded_nonzero": int(np.count_nonzero(np.around(dx, decimals))),
                "u_rounded_nonzero": int(np.count_nonzero(np.around(du, decimals))),
            }
    return {"runs": {k: {kk: vv for kk, vv in v.items() if kk not in ("xs", "us")}
                     for k, v in runs.items()},
            "deltas": deltas}
