"""The port's ctypes bindings of the native host engine (``native/``)
against the port's own numpy / PyTorch code: the CSV loader and the
reference synthesis against ``refgen``, the float64 LQR golden against
``make_ilqr_solver``.  The library is the one ``native/`` builds with cmake;
without it the fixture builds a private copy, and without a toolchain the
tests skip (as ``tests/test_native.py`` does)."""
import csv

import numpy as np
import pytest
import torch

import mpc_verde_tpu_torch as mt
from mpc_verde_tpu_torch import native
from mpc_verde_tpu_torch.refgen import (lateral_error_references,
                                        load_path_csv, stage_param_tensor,
                                        synthetic_lane_change)


@pytest.fixture(scope="module", autouse=True)
def _ensure_built(tmp_path_factory):
    if not native.available():
        try:
            from mpc_verde_tpu_torch.native.build import build

            # a build of its own: the shared native/build may be in use
            lib = build(verbose=False,
                        build_dir=tmp_path_factory.mktemp("native_build"))
            native._load(lib)
        except Exception:
            pytest.skip("native toolchain unavailable")
    assert native.available()


def test_csv_loader_matches_refgen(tmp_path):
    path = synthetic_lane_change(n=50)
    f = tmp_path / "p.csv"
    with open(f, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["x", "y", "uref"])
        w.writerows(zip(*(map(repr, map(float, path[k]))
                          for k in ("x", "y", "uref"))))
    got, ref = native.load_path_csv(str(f)), load_path_csv(str(f))
    for k in ("x", "y", "uref"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-15, atol=0)
        np.testing.assert_allclose(got[k], path[k], rtol=1e-15, atol=0)
    with pytest.raises(FileNotFoundError):
        native.load_path_csv(str(tmp_path / "missing.csv"))


@pytest.mark.parametrize("unwrap", [False, True])
def test_lateral_refs_match_refgen(unwrap):
    p = synthetic_lane_change(n=300)
    ours = native.lateral_error_refs(p["x"], p["y"], 0.05, -23.55, 61.99,
                                     unwrap=unwrap)
    ref = lateral_error_references(p, 0.05, -23.55, 61.99, unwrap=unwrap)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)


def test_stage_window_matches_refgen():
    refs = np.random.default_rng(3).normal(size=(40, 4))
    np.testing.assert_array_equal(native.stage_window(refs, 7, 40),
                                  stage_param_tensor(refs, 7, 40))


def test_native_lqr_matches_the_port_solver():
    dt = 0.1
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.5 * dt * dt], [dt]])
    Q = np.diag([1.0, 0.1]); R = np.array([[0.01]])
    N = 25
    x0 = np.array([1.0, -0.5])
    us_gold, cost_gold = native.lqr_riccati(A, B, Q, R, Q, N, x0)
    t = lambda a: torch.as_tensor(a)
    ocp = mt.OCP(dynamics=lambda x, u, p: t(A) @ x + t(B) @ u,
                 stage_cost=lambda x, u, p: x @ t(Q) @ x + u @ t(R) @ u,
                 terminal_cost=lambda x, p: x @ t(Q) @ x, N=N, nx=2, nu=1,
                 device=torch.device("cpu"), dtype=torch.float64)
    res = mt.make_ilqr_solver(ocp, mt.ILQROptions(tol_grad=1e-12))(t(x0))
    assert np.abs(res.us.numpy() - us_gold).max() < 1e-8
    assert abs(float(res.cost) - cost_gold) < 1e-8 * (1 + abs(cost_gold))
