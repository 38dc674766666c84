"""Closed-loop animation — the ``simulation_code.simulate`` equivalent (port
of ``mpc_verde_tpu.viz.animation``).

The reference animates the robot as a triangle with its predicted horizon and
path trace via matplotlib FuncAnimation (``simulation_code.py:10-94``), with
an optional gif export.  Same surface here: ``simulate(cat_states,
cat_controls, t, step_horizon, N, reference, save=False)`` where
``cat_states`` is (nx, N+1, n_frames) — the dstack layout the reference
accumulates (``Casadi/single_shooting_v1.py:185-189``), a tensor (on any
device) or an array.  matplotlib is imported when ``simulate`` runs.
"""
from __future__ import annotations

import numpy as np

from ..utils.tree import to_numpy


def _triangle(state, h: float = 0.14, w: float = 0.09):
    """Robot marker vertices at (x, y, theta) — cf. create_triangle
    (simulation_code.py:11-28)."""
    x, y, th = state[0], state[1], state[2]
    pts = np.array([[h, 0], [-h / 2, w], [-h / 2, -w], [h, 0]])
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return pts @ rot.T + np.array([x, y])


def simulate(cat_states, cat_controls, t, step_horizon, N, reference,
             save=False, filename="animation.gif", interval_ms=100):
    """Animate the closed loop; returns the FuncAnimation object.

    Args mirror the reference call
    (``single_shooting_v1.py:232``): ``reference`` is
    (x_init, y_init, theta_init, x_target, y_target, theta_target).
    """
    import matplotlib

    if save:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    cat_states = to_numpy(cat_states)
    reference = to_numpy(reference)
    n_frames = cat_states.shape[2]

    fig, ax = plt.subplots(figsize=(6, 6))
    margin = 1.0
    xs_all = cat_states[0].ravel(); ys_all = cat_states[1].ravel()
    ax.set_xlim(xs_all.min() - margin, xs_all.max() + margin)
    ax.set_ylim(ys_all.min() - margin, ys_all.max() + margin)
    ax.set_aspect("equal")

    (path_line,) = ax.plot([], [], "b-", lw=1, alpha=0.6, label="path")
    (horizon_line,) = ax.plot([], [], "g--", lw=1, alpha=0.8, label="horizon")
    (robot_patch,) = ax.plot([], [], "r-", lw=2)
    target = reference[3:6]
    tri = _triangle(np.asarray(target))
    ax.plot(tri[:, 0], tri[:, 1], "k-", lw=1, label="target")
    ax.legend(fontsize=8)

    def init():
        return path_line, horizon_line, robot_patch

    def animate(i):
        path_line.set_data(cat_states[0, 0, : i + 1], cat_states[1, 0, : i + 1])
        horizon_line.set_data(cat_states[0, :, i], cat_states[1, :, i])
        tri = _triangle(cat_states[:, 0, i])
        robot_patch.set_data(tri[:, 0], tri[:, 1])
        return path_line, horizon_line, robot_patch

    anim = FuncAnimation(fig, animate, init_func=init, frames=n_frames,
                         interval=interval_ms, blit=True)
    if save:
        # the reference exports via ffmpeg (simulation_code.py:92-93); use
        # it when present, else the pillow gif writer (same .gif either way)
        import matplotlib.animation as manim

        writer = "ffmpeg" if manim.writers.is_available("ffmpeg") else "pillow"
        anim.save(filename, writer=writer,
                  fps=max(1, int(1000 / interval_ms)))
    return anim
