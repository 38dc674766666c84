"""Port vs JAX: the viz layer (``viz/``, ``compat.plots``) draws the same
figures from tensors as the JAX package from arrays, and the animation
writes a gif (headless, Agg)."""
import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from mpc_verde_tpu import viz as jviz
from mpc_verde_tpu_torch import viz
from mpc_verde_tpu_torch.compat import plots as compat_plots


def _figure_data(fig):
    """Each axes' visibility, labels and line data, in order."""
    out = []
    for ax in fig.axes:
        out.append((ax.get_visible(), ax.get_xlabel(), ax.get_ylabel(),
                    [(np.asarray(l.get_xdata(), float),
                      np.asarray(l.get_ydata(), float), l.get_linestyle(),
                      l.get_label()) for l in ax.get_lines()]))
    return out


def _same_figures(fig, ref):
    got, want = _figure_data(fig), _figure_data(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        assert len(g[3]) == len(w[3])
        for (gx, gy, gs, gl), (wx, wy, ws, wl) in zip(g[3], w[3]):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
            assert (gs, gl) == (ws, wl)
    plt.close(fig)
    plt.close(ref)


@pytest.mark.parametrize("nu", [1, 2, 4])
def test_mpcplot_matches_jax(tmp_path, nu):
    rng = np.random.default_rng(nu)
    x = rng.normal(size=(30, 3))
    u = rng.normal(size=(29, nu))
    t = np.arange(30) * 0.2
    kw = dict(xnames=["x", "y", "theta"], unames=[f"u{i}" for i in range(nu)])
    fig = viz.mpcplot(torch.as_tensor(x), torch.as_tensor(u),
                      torch.as_tensor(t), **kw)
    out = compat_plots.showandsave(fig, str(tmp_path / "run.pdf"))
    assert out == str(tmp_path / "run.pdf")
    assert (tmp_path / "run.pdf").stat().st_size > 0
    _same_figures(fig, jviz.mpcplot(x, u, t, **kw))


@pytest.mark.parametrize("traj", [True, False])
def test_tracking_dashboard_matches_jax(traj):
    rng = np.random.default_rng(7)
    t = np.arange(50) * 0.05
    x = rng.normal(size=(50, 3))
    refs = x + 0.1
    u = rng.normal(size=(49, 1))
    u_ref = rng.normal(size=(49, 1))
    kw = lambda f: dict(
        u_ref=f(u_ref), state_names=["y", "phi", "r"],
        traj_actual=(f(t), f(x[:, 0])) if traj else None,
        traj_ref=(f(t), f(refs[:, 0])) if traj else None)
    T = torch.as_tensor
    fig = viz.tracking_dashboard(T(t), T(x), T(refs), T(u), **kw(T))
    _same_figures(fig, jviz.tracking_dashboard(t, x, refs, u, **kw(np.asarray)))


def test_animation_writes_a_gif(tmp_path):
    rng = np.random.default_rng(9)
    n_frames, N = 6, 5
    cat_states = rng.normal(size=(3, N + 1, n_frames))
    cat_controls = rng.normal(size=(n_frames, 2))
    anim = viz.simulate(torch.as_tensor(cat_states),
                        torch.as_tensor(cat_controls), None, 0.2, N,
                        torch.tensor([0, 0, 0, 5.0, 5.0, 0.0]), save=True,
                        filename=str(tmp_path / "a.gif"), interval_ms=50)
    assert (tmp_path / "a.gif").read_bytes()[:6] in (b"GIF87a", b"GIF89a")
    # the last frame's path trace is the whole first-stage trajectory
    path_line = anim._fig.axes[0].get_lines()[0]
    np.testing.assert_array_equal(path_line.get_xdata(), cat_states[0, 0])
    plt.close(anim._fig)
