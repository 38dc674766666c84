"""CSV path loading (port of ``mpc_verde_tpu.refgen.io``).

The tracking scripts read ``lane_change.csv`` / ``traj*.csv`` / ``out*.csv``
(columns x, y, uref; ``Trajectory_tracking_le_LTI.py:12-15``,
``leitura.py:14-20``).  The originals live in the reference checkout, named
by the ``MPC_VERDE_REFERENCE_DIR`` environment variable or found at the
reference checkout's own path; without either the scenarios fall back to
the synthetic courses (``trajectories.py``).  The
JAX loader reads with pandas; this one reads with the ``csv`` module and
keeps its column rules.
"""
from __future__ import annotations

import csv
import os
from pathlib import Path

import numpy as np


# Where the reference checkout keeps its tracking data when
# MPC_VERDE_REFERENCE_DIR is unset (the JAX loader's own fallback).
_FALLBACK_DIR = "/root/reference/Trajectory Tracking"


def reference_data_dir() -> Path | None:
    """The reference data directory: ``MPC_VERDE_REFERENCE_DIR``, else
    ``_FALLBACK_DIR``, the first of them that is a directory; None when
    neither is."""
    for d in (os.environ.get("MPC_VERDE_REFERENCE_DIR", ""), _FALLBACK_DIR):
        if d and Path(d).is_dir():
            return Path(d)
    return None


def load_path_csv(name_or_path: str):
    """Load a path CSV with columns (x, y, uref) as float arrays.

    ``name_or_path`` may be a path or a bare name like ``"lane_change.csv"``
    resolved against the reference data dir.  Columns are found by name,
    case-insensitively (``x``, ``y``, ``uref``), else x and y are the first
    two columns; ``uref`` is 0.4 everywhere when absent.  Returns a dict with
    keys x, y, uref.
    """
    p = Path(name_or_path)
    if not p.is_file():
        base = reference_data_dir()
        if base is None:
            raise FileNotFoundError(
                f"{name_or_path} not found and no reference data dir available; "
                "use refgen.synthetic_lane_change() for a self-contained path")
        p = base / name_or_path
    with open(p, newline="") as fh:
        rows = list(csv.reader(fh))
    header, body = rows[0], [r for r in rows[1:] if r]
    cols = {c.lower(): i for i, c in enumerate(header)}
    col = lambda i: np.array([float(r[i]) for r in body], dtype=float)
    x = col(cols.get("x", 0))
    y = col(cols.get("y", 1))
    uref = col(cols["uref"]) if "uref" in cols else np.full_like(x, 0.4)
    return {"x": x, "y": y, "uref": uref}
