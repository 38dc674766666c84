"""Closed-loop run export/import in the reference's table formats (port of
``mpc_verde_tpu.runtime.export``).

The reference dumps trajectories for later comparison:
  * diff-drive runs: columns (x, y, theta, v, w, t) to ``1/2/3exemplo.xlsx``
    (``Casadi/single_shooting_v2.py:292-301``,
    ``mpctools/multiple_shooting_mpctools.py:141-150``)
  * pendulum: (x, x_dot, theta, theta_dot, u, t)
    (``Inverted_pendulum/...mpctools.py:80-88``)
  * lane-change closed loops: ``dados2.csv`` = [x1, x2, x3, u, x, y, yref,
    phiref, rref, deltaref] (``Trajectory Tracking/Phiref.py:379-381``)

Paths ending in ``.xlsx`` are written with the stdlib writer
(``refgen.xlsx.write_xlsx``) in the reference's pandas ``to_excel`` shape
(leading unnamed index column); anything else is CSV with the same columns,
written by the ``csv`` module with ``repr`` floats (exact round trip).  A
table in memory is an insertion-ordered dict of column name -> numpy array,
with the columns the JAX package's DataFrame has, in its order.  Only legacy
Excel (``.xls`` / ``.xlsm``) needs pandas, imported when such a file is read.
Arrays may be tensors (on any device) or numpy arrays.
"""
from __future__ import annotations

import csv

import numpy as np

from ..refgen.xlsx import read_xlsx, write_xlsx
from ..utils.tree import to_numpy


def _write_csv(path: str, cols: dict):
    names = list(cols)
    data = [np.asarray(cols[k], dtype=float).ravel() for k in names]
    n = max((len(c) for c in data), default=0)
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")   # as pandas writes it
        w.writerow(names)
        for i in range(n):
            w.writerow(repr(float(c[i])) if i < len(c) else "" for c in data)


def _read_csv(path: str) -> dict:
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    header, body = rows[0], [r for r in rows[1:] if r]
    f = lambda v: float(v) if v != "" else np.nan
    return {name: np.array([f(r[j]) for r in body], dtype=float)
            for j, name in enumerate(header)}


def _write_table(path: str, cols: dict):
    if str(path).endswith(".xlsx"):
        # index column matches the committed exemplo goldens' layout
        # (Casadi/single_shooting_v2.py:292-301 uses the to_excel default)
        write_xlsx(path, cols, index=True)
    else:
        _write_csv(path, cols)
    return path


def export_run(path: str, xs, us, times, state_names=None, control_names=None):
    """Write a closed-loop run as a flat table (one row per step)."""
    xs, us, times = to_numpy(xs), to_numpy(us), to_numpy(times)
    n = len(us)
    cols = {}
    snames = state_names or [f"x{i}" for i in range(xs.shape[1])]
    unames = control_names or [f"u{i}" for i in range(us.shape[1] if us.ndim > 1 else 1)]
    us2 = us.reshape(n, -1)
    for i, s in enumerate(snames):
        cols[s] = xs[: n + 1, i]
    for i, c in enumerate(unames):
        cols[c] = np.append(us2[:, i], us2[-1, i])
    cols["t"] = times[: n + 1]
    return _write_table(path, cols)


def export_diffdrive_run(path: str, xs, us, T: float):
    """(x, y, theta, v, w, t) — the exemplo table layout."""
    n = len(to_numpy(us))
    times = np.arange(n + 1) * T
    return export_run(path, xs, us, times,
                      state_names=["x", "y", "theta"], control_names=["v", "w"])


def export_lane_change_run(path: str, xs, us, traj_xy, refs):
    """``dados2.csv`` layout: x1,x2,x3,u,x,y,yref,phiref,rref,deltaref
    (``Phiref.py:379-381``)."""
    xs = to_numpy(xs)
    us = to_numpy(us)
    us = us.reshape(len(us), -1)
    n = len(us)
    refs = to_numpy(refs)[:n]
    return _write_table(path, {
        "x1": xs[1: n + 1, 0], "x2": xs[1: n + 1, 1], "x3": xs[1: n + 1, 2],
        "u": us[:, 0],
        "x": to_numpy(traj_xy[0])[:n], "y": to_numpy(traj_xy[1])[:n],
        "yref": refs[:, 0], "phiref": refs[:, 1],
        "rref": refs[:, 2], "deltaref": refs[:, 3],
    })


def load_run(path: str) -> dict:
    """Read a run table into a dict of column name -> float array: csv,
    .xlsx via the stdlib reader, legacy Excel (.xls/.xlsm) via pandas, which
    must then be installed."""
    p = str(path)
    if p.endswith(".xlsx"):
        return read_xlsx(p)
    if p.endswith((".xls", ".xlsm")):
        try:
            import pandas as pd
        except ImportError as e:
            raise ImportError(
                f"load_run: reading {p!r} needs pandas (and an Excel engine); "
                "only .csv and .xlsx are read without it") from e
        df = pd.read_excel(p)
        return {str(c): df[c].to_numpy() for c in df.columns}
    if p.endswith(".csv"):
        return _read_csv(p)
    raise ValueError(
        f"load_run: unrecognized extension on {p!r}; supported formats are "
        ".csv, .xlsx, .xls, .xlsm")


def compare_runs(run_a: dict, run_b: dict, columns=None, decimals: int = 0):
    """``difference.py``-style agreement check: rounded per-column deltas
    (``Casadi/difference.py:604-619`` prints ``np.around(a1 - a2)``).

    ``run_a`` / ``run_b`` map column names to arrays (``load_run``'s
    tables).  Returns dict column -> (max_abs_diff,
    rounded_diff_nonzero_count).
    """
    out = {}
    cols = columns or [c for c in run_a if c in run_b]
    for c in cols:
        a, b = to_numpy(run_a[c]), to_numpy(run_b[c])
        n = min(len(a), len(b))
        d = a[:n] - b[:n]
        out[c] = {
            "max_abs_diff": float(np.abs(d).max()),
            "rounded_nonzero": int(np.count_nonzero(np.around(d, decimals))),
        }
    return out
