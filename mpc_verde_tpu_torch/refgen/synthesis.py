"""Reference synthesis: path -> per-stage tracking references, vectorized
(port of ``mpc_verde_tpu.refgen.synthesis``; numpy, host-side).

The reference computes lateral-error tracking references with a per-(t, k)
double loop of finite differences: y_ref from the path, phi_ref from atan2
of consecutive segments, r_ref from first differences of phi_ref, delta_ref
by inverting the model coefficients
(``Trajectory Tracking/Trajectory_tracking_le_LTI.py:104-128``), with +2pi
angle unwrapping for loop-the-loop courses (``leitura.py:98-114``).  Here the
pipeline is a few vectorized array operations computed once per course, and
a clamped-window gather builds the (Nsim, Nt, np) stage-parameter tensor.
"""
from __future__ import annotations

import numpy as np

from ..models.bicycle import AR_DEFAULT, BR_DEFAULT


def path_heading(x, y, unwrap: bool = False):
    """Heading phi[n] = atan2(y[n]-y[n-1], x[n]-x[n-1]), phi[0] = 0.

    ``unwrap=True`` applies the reference's +2pi correction for negative
    angles (``lane_change.py:59-67``, ``leitura.py:98-114``) so headings are
    continuous on closed courses.
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    phi = np.zeros_like(x)
    phi[1:] = np.arctan2(np.diff(y), np.diff(x))
    if unwrap:
        phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    return phi


def lateral_error_references(path, dt: float, ar: float = AR_DEFAULT,
                             br: float = BR_DEFAULT, unwrap: bool = False):
    """Per-sample reference rows (y_ref, phi_ref, r_ref, delta_ref), (n, 4).

    The finite-difference pipeline of ``Trajectory_tracking_le_LTI.py:104-128``:
      r_ref[n]     = (phi_ref[n+1] - phi_ref[n-1]) / (2 dt)   (central)
      delta_ref[n] = ((phi_ref[n+1] - 2 phi_ref[n] + phi_ref[n-1]) / dt^2
                       - ar * r_ref[n]) / br
    with one-sided differences at the ends.
    """
    x, y = np.asarray(path["x"], float), np.asarray(path["y"], float)
    n = x.size
    phi = path_heading(x, y, unwrap=unwrap)

    r = np.zeros(n)
    r[1:-1] = (phi[2:] - phi[:-2]) / (2 * dt)
    r[0] = (phi[1] - phi[0]) / dt
    r[-1] = (phi[-1] - phi[-2]) / dt

    phidd = np.zeros(n)
    phidd[1:-1] = (phi[2:] - 2 * phi[1:-1] + phi[:-2]) / dt**2
    phidd[0] = phidd[1]
    phidd[-1] = phidd[-2]

    delta = (phidd - ar * r) / br
    return np.stack([y, phi, r, delta], axis=-1)


def stage_param_tensor(refs, Nt: int, Nsim: int | None = None):
    """Window per-sample reference rows into the per-step stage tensor.

    ``refs`` is (T, np); returns (Nsim, Nt, np) with
    ``out[t, k] = refs[min(t + k, T - 1)]``: the horizon peeks ahead along
    the course and holds the last sample at the end, as the ``t + k > Nsim -
    1`` clamping branch of the reference loops does
    (``Trajectory_tracking_le_LTI.py:105-107``).
    """
    refs = np.asarray(refs)
    T = refs.shape[0]
    if Nsim is None:
        Nsim = T
    idx = np.minimum(np.arange(Nsim)[:, None] + np.arange(Nt)[None, :], T - 1)
    return refs[idx]
