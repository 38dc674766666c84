"""Reference trajectory generators (port of ``mpc_verde_tpu.refgen.trajectories``).

A numpy copy: the JAX module is numpy-only, but importing it pulls in the
JAX package (``mpc_verde_tpu/__init__.py``), which the port never imports.
Re-implementations of the reference's course builders:
  * circular track parameters (``Trajectory Tracking/Trajectory_tracking.py:88-97``)
  * the single lane change (shape of ``lane_change.csv``: straight, smooth
    offset by ~3 m, straight; speed ramp in ``uref``)
  * the arc/straight course extension (``lane_change.py:10-53``)
  * the double-lane-change course with two 1.44 m-radius half-circles
    (``double_lane_chage.py:9-22``)

All generators return float arrays or dicts of them (x, y, uref).
"""
from __future__ import annotations

import numpy as np


def circular_reference_params(times, Nt: int, dt: float):
    """Per-step stage-parameter tensor for the circular tracking task.

    Vectorized form of the triple loop at ``Trajectory_tracking.py:88-97``:
    for each sim step t and horizon stage k the parameter row is
    (cos(0.1 tp), sin(0.1 tp), pi/2 + 0.1 tp, 1, 1) with
    tp = times[t] + times[k] (the reference indexes ``times[k]``, i.e. the
    *absolute* time grid, not k*dt — reproduced faithfully).

    Returns (Nsim, Nt, 5).
    """
    times = np.asarray(times, dtype=float)
    Nsim = times.shape[0]
    tp = times[:, None] + times[None, :Nt]  # (Nsim, Nt)
    par = np.stack([
        np.cos(0.1 * tp),
        np.sin(0.1 * tp),
        np.pi / 2 + 0.1 * tp,
        np.ones_like(tp),
        np.ones_like(tp),
    ], axis=-1)
    assert par.shape == (Nsim, Nt, 5)
    return par


def synthetic_lane_change(n: int = 500, dt: float = 0.05, offset: float = 3.0,
                          v0: float = 0.4, v1: float = 0.6):
    """Self-contained single lane change resembling ``lane_change.csv``.

    A smoothstep lateral offset of ``offset`` metres over the middle half of
    the horizon, with speed ramping v0 -> v1; arc length follows the speed
    profile (the CSV's x spacing grows with uref).
    """
    uref = np.linspace(v0, v1, n)
    x = np.concatenate([[0.0], np.cumsum(uref[:-1] * dt)])
    s = np.clip((np.arange(n) / n - 0.25) / 0.5, 0.0, 1.0)
    y = offset * (3.0 * s**2 - 2.0 * s**3)
    return {"x": x, "y": y, "uref": uref}


def _arc(cx, cy, r, t0, t1, k):
    t = np.linspace(t0, t1, int(k))
    return cx + r * np.cos(t), cy + r * np.sin(t)


def extend_lane_change_course(base=None, dt: float = 0.05, v: float = 0.6):
    """Arc/straight course extension ("trecho 2..7", ``lane_change.py:10-53``).

    Appends to the base lane change: a half circle up and back, a 10 m
    straight, two half circles of half radius forming an S, a straight back to
    x=0, and a final half circle closing the loop.  ``uref`` is the base's
    over its samples and ``v`` afterwards (``lane_change.py:74-76``).
    """
    if base is None:
        base = synthetic_lane_change(dt=dt)
    a, b, c = base["x"], base["y"], base["uref"]

    k = 500
    w = np.pi / (k * dt)
    r = v / w
    x2, y2 = _arc(a[-1], b[-1] + r, r, 1.5 * np.pi, 2.5 * np.pi, k)

    ds = 10.0
    k3 = int(ds / (v * dt))
    x3 = x2[-1] - np.linspace(0, ds, k3)
    y3 = np.full(k3, y2[-1])

    w4 = v / (r / 2)
    k4 = int(np.pi / (w4 * dt))
    x4, y4 = _arc(x3[-1], y3[-1] - r / 2, r / 2, 0.5 * np.pi, 1.5 * np.pi, k4)
    x5, y5 = _arc(x4[-1], y4[-1] - r / 2, r / 2, 0.5 * np.pi, -0.5 * np.pi, k4)

    d = x5[-1]
    k6 = int(d / (v * dt))
    x6 = d - v * np.linspace(0, k6 * dt, k6)
    y6 = np.full(k6, y5[-1])

    r7 = y6[-1] / 2
    k7 = int(np.pi / ((v / r7) * dt))
    x7, y7 = _arc(x6[-1], y6[-1] - r7, r7, 0.5 * np.pi, 1.5 * np.pi, k7)

    x_t = np.hstack([a, x2[1:], x3[1:], x4[1:], x5[1:], x6[1:], x7[1:]])
    y_t = np.hstack([b, y2[1:], y3[1:], y4[1:], y5[1:], y6[1:], y7[1:]])
    uref = np.full(x_t.size, v)
    uref[: c.size] = c
    return {"x": x_t, "y": y_t, "uref": uref}


def double_lane_change_course(base=None, dt: float = 0.05):
    """Double lane change: replayed lane-change tail + two 1.44 m-radius
    half-circles + straight run-out (``double_lane_chage.py:9-22,69-71``)."""
    if base is None:
        base = synthetic_lane_change(dt=dt)
    a, b, c = base["x"], base["y"], base["uref"]

    a0 = a[-1] + a[395:500] - a[395]
    b0 = b[-1] + b[395:500] - b[395]
    c0 = c[395:500]

    t = np.linspace(-1.5 * np.pi, -2.0 * np.pi, 113)
    a1 = a0[-1] + 1.44 * np.cos(t)
    b1 = b0[-1] - 1.44 + 1.44 * np.sin(t)
    c1 = np.full(a1.size, 0.4)

    t = np.linspace(np.pi, 1.5 * np.pi, 113)
    a2 = a1[-1] + 1.44 + 1.44 * np.cos(t)
    b2 = b1[-1] + 1.44 * np.sin(t)
    c2 = np.full(a2.size, 0.4)

    a3 = a2[-1] + a[355:500] - a[355]
    b3 = b2[-1] + np.zeros(500 - 355)
    c3 = c[355:500]

    x_t = np.hstack([a, a0[1:], a1[1:], a2[1:], a3[1:]])
    y_t = np.hstack([b, b0[1:], b1[1:], b2[1:], b3[1:]])
    uref = np.hstack([c, c0[1:], c1[1:], c2[1:], c3[1:]])
    return {"x": x_t, "y": y_t, "uref": uref}
