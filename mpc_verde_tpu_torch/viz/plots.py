"""Plot helpers mirroring ``mpctools.plots`` usage in the reference (port of
``mpc_verde_tpu.viz.plots``).

``mpcplot(x, u, t, xnames, unames)`` draws the stacked state/control panels
(``Casadi/single_shooting_v1.py:236-238``); ``showandsave`` writes the figure
(``mpc.plots.showandsave(fig, "my_mpc_code.pdf")``).  ``tracking_dashboard``
is the 3x2/4x2 actual-vs-reference grid every tracking script hand-builds
(``Trajectory_tracking_le_LTI.py:219-258``).  Every array argument may be
a tensor (on any device) or array-like.  matplotlib is imported when a
figure is drawn, so importing this module needs no matplotlib.
"""
from __future__ import annotations

import numpy as np

from ..utils.tree import to_numpy


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def mpcplot(x, u, t, xnames=None, unames=None):
    """States (lines) and controls (steps) vs time; returns the figure."""
    plt = _plt()
    x = to_numpy(x); u = to_numpy(u); t = to_numpy(t)
    nx = x.shape[1] if x.ndim > 1 else 1
    nu = u.shape[1] if u.ndim > 1 else 1
    x = x.reshape(len(x), nx); u = u.reshape(len(u), nu)
    rows = max(nx, nu)
    fig, axs = plt.subplots(rows, 2, figsize=(10, 2.2 * rows), squeeze=False)
    for i in range(nx):
        axs[i][0].plot(t[: len(x)], x[:, i])
        axs[i][0].set_ylabel((xnames or [f"x{j}" for j in range(nx)])[i])
        axs[i][0].set_xlabel("t [s]")
    for i in range(nu):
        tu = t[: len(u) + 1]
        axs[i][1].step(tu, np.append(u[: len(tu) - 1, i], u[len(tu) - 2, i]),
                       where="post")
        axs[i][1].set_ylabel((unames or [f"u{j}" for j in range(nu)])[i])
        axs[i][1].set_xlabel("t [s]")
    for i in range(nx, rows):
        axs[i][0].set_visible(False)
    for i in range(nu, rows):
        axs[i][1].set_visible(False)
    fig.tight_layout()
    return fig


def showandsave(fig, filename: str):
    fig.savefig(filename, bbox_inches="tight")
    return filename


def tracking_dashboard(t, x, refs, u, u_ref=None, state_names=None,
                       traj_actual=None, traj_ref=None):
    """Actual-vs-reference grid: one panel per state, one for the control,
    one for the x/y trajectory overlay."""
    plt = _plt()
    x = to_numpy(x); refs = to_numpy(refs); u = to_numpy(u); t = to_numpy(t)
    u_ref = None if u_ref is None else to_numpy(u_ref)
    traj_actual = None if traj_actual is None else [to_numpy(a) for a in traj_actual]
    traj_ref = None if traj_ref is None else [to_numpy(a) for a in traj_ref]
    nx = x.shape[1]
    rows = nx + 1
    fig, axs_arr = plt.subplots((rows + 1) // 2, 2,
                                figsize=(11, 2.4 * ((rows + 1) // 2)), squeeze=False)
    flat = axs_arr.ravel()
    names = state_names or [f"x{i}" for i in range(nx)]
    for i in range(nx):
        flat[i].plot(t[: len(x)], x[:, i], label="actual")
        flat[i].plot(t[: len(refs)], refs[:, i], "--", label="reference")
        flat[i].set_ylabel(names[i]); flat[i].set_xlabel("t [s]")
        flat[i].legend(fontsize=7)
    ax_u = flat[nx]
    ax_u.step(t[: len(u)], u, where="post", label="u")
    if u_ref is not None:
        ax_u.plot(t[: len(u_ref)], u_ref, "--", label="u ref")
    ax_u.set_ylabel("control"); ax_u.set_xlabel("t [s]"); ax_u.legend(fontsize=7)
    if traj_actual is not None and nx + 1 < len(flat):
        ax_t = flat[nx + 1]
        ax_t.plot(*traj_actual, label="actual trajectory")
        if traj_ref is not None:
            ax_t.plot(*traj_ref, "--", label="reference trajectory")
        ax_t.set_xlabel("x [m]"); ax_t.set_ylabel("y [m]"); ax_t.legend(fontsize=7)
    for j in range(nx + (2 if traj_actual is not None else 1), len(flat)):
        flat[j].set_visible(False)
    fig.tight_layout()
    return fig
