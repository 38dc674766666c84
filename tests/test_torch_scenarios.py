"""Port vs JAX: the circular-track and diff-drive scenario families, the
method comparison, the solvers' default backend and nu > 4 on "torch".

The closed loops run at n_steps = 12 in float64 on the CPU, against the JAX
scenarios under x64: states and controls to 1e-6 (as
tests/test_torch_closed_loop.py holds the closed loops), and the JAX tests'
float64 gates (``converged_all``, ``converged_frac == 1.0``,
tests/test_scenarios.py) on both.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import bench
import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu import scenarios as js
from mpc_verde_tpu.models import linear_model as j_linear_model
from mpc_verde_tpu.ops import rk4_step as j_rk4_step
from mpc_verde_tpu.solver.batched import make_batched_ilqr_solver as j_batched
from mpc_verde_tpu_torch import scenarios as ts
from mpc_verde_tpu_torch.interop import bench_ocp
from mpc_verde_tpu_torch.models import linear_model
from mpc_verde_tpu_torch.ops import rk4_step
from mpc_verde_tpu_torch.solver import batched as batched_mod
from mpc_verde_tpu_torch.solver import ipm as ipm_mod
from mpc_verde_tpu_torch.solver import streaming as streaming_mod
from mpc_verde_tpu_torch.solver.batched import resolve_backend

STEPS = 12
CPU64 = dict(device="cpu", dtype=torch.float64)
DIFFDRIVE = {"rk4": {}, "euler": dict(integrator="euler"),
             "quadrature_m4": dict(cost="quadrature", M=4, plant="rk4")}


def _close_loops(res_t, res_j):
    for name in ("xs", "us"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(),
                                   np.asarray(getattr(res_j, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(res_t.converged.numpy(),
                                  np.asarray(res_j.converged))


def test_circular_tracking_matches_jax():
    built_t = ts.build_circular_tracking(n_steps=STEPS, **CPU64)
    built_j = js.build_circular_tracking(n_steps=STEPS)
    np.testing.assert_array_equal(built_t["params_seq"], built_j["params_seq"])
    assert built_t["ocp"].npar == 5 and built_t["ocp"].device_model.u_ref == 3
    m_t, m_j = ts.run_circular_tracking(built_t), js.run_circular_tracking(built_j)
    _close_loops(m_t["result"], m_j["result"])
    for key in ("rmse_xy", "max_err_xy", "mean_path_dist"):
        np.testing.assert_allclose(m_t[key], m_j[key], rtol=1e-6, err_msg=key)
    assert m_t["converged_frac"] == m_j["converged_frac"] == 1.0
    # the state box is live: two AL rounds a step
    assert float(m_t["result"].iterations.double().mean()) > 5


@pytest.mark.parametrize("variant", list(DIFFDRIVE))
def test_diffdrive_matches_jax(variant):
    kw = DIFFDRIVE[variant]
    m_t = ts.run_diffdrive(ts.build_diffdrive(n_steps=STEPS, **kw, **CPU64))
    m_j = js.run_diffdrive(js.build_diffdrive(n_steps=STEPS, **kw))
    _close_loops(m_t["result"], m_j["result"])
    for key in ("final_error", "ss_error"):
        np.testing.assert_allclose(m_t[key], m_j[key], rtol=1e-6, err_msg=key)
    assert m_t["steps_to_target"] == m_j["steps_to_target"]
    assert m_t["converged_all"] and m_j["converged_all"]
    assert m_t["converged_frac"] == 1.0
    assert float(m_t["result"].xs[-1, :2].norm()) > 1.0   # the robot moved


def test_compare_diffdrive_methods_matches_jax():
    out_t = ts.compare_diffdrive_methods(n_steps=STEPS, **CPU64)
    out_j = js.compare_diffdrive_methods(n_steps=STEPS)
    assert out_t["runs"].keys() == out_j["runs"].keys()
    for name, run in out_t["runs"].items():
        assert run["steps_to_target"] == out_j["runs"][name]["steps_to_target"]
        np.testing.assert_allclose(run["ss_error"], out_j["runs"][name]["ss_error"],
                                   rtol=1e-6)
    assert out_t["deltas"].keys() == out_j["deltas"].keys()
    for pair, d in out_t["deltas"].items():
        d_j = out_j["deltas"][pair]
        for key in ("x_max_abs", "u_max_abs"):
            np.testing.assert_allclose(d[key], d_j[key], rtol=0, atol=2e-6)
        for key in ("x_rounded_nonzero", "u_rounded_nonzero"):
            assert d[key] == d_j[key], (pair, key)


@pytest.mark.parametrize("entry", ["build_circular_tracking", "build_diffdrive",
                                   "run_diffdrive",
                                   "compare_diffdrive_methods"])
def test_scenarios_need_a_card_unless_asked_for_the_cpu(entry, monkeypatch):
    """As the fleet: the entry points run on the CUDA device by default, and
    where there is none they raise and name ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(ts, entry)(n_steps=STEPS)
    built = ts.build_diffdrive(n_steps=1, **CPU64)
    assert built["ocp"].device == torch.device("cpu")


class _Stop(Exception):
    pass


def _fake_cuda_ocp(model=True, dtype=torch.float32):
    """The bench OCP as if it lay on a CUDA device (nothing is allocated
    there until a solve runs), with or without its device model."""
    ocp = dataclasses.replace(bench_ocp(10, "cpu", dtype),
                              device=torch.device("cuda"))
    return ocp if model else dataclasses.replace(ocp, device_model=None)


FACTORIES = {
    "batched": mt.make_batched_ilqr_solver,
    "streaming": mt.make_streaming_solver,
    "ilqr": mt.make_ilqr_solver,
    "streaming_barrier": mt.make_streaming_barrier_solver,
}


@pytest.mark.parametrize("factory", list(FACTORIES))
def test_default_backend_follows_the_device(factory, monkeypatch):
    """backend=None runs "cuda_fused" for a float32 OCP on a CUDA device,
    with its device model or without one (on the model traced from its
    callables), "cuda_bw" (K1 on the OCP's callables) for a float64 one,
    and "torch" on the CPU; an explicit backend is honoured; a CUDA OCP
    with nu > 4 raises and names backend="torch"."""
    seen = []

    def spy_parts(ocp, opt, backend):
        seen.append(backend)
        raise _Stop

    real = resolve_backend

    def spy_resolve(ocp, backend):
        seen.append(real(ocp, backend))
        raise _Stop

    monkeypatch.setattr(batched_mod, "_make_parts", spy_parts)
    monkeypatch.setattr(streaming_mod, "_make_parts", spy_parts)
    # the barrier solver allocates on the OCP's device before its parts
    monkeypatch.setattr(ipm_mod, "resolve_backend", spy_resolve)
    make = FACTORIES[factory]
    for ocp, backend, expected in (
            (_fake_cuda_ocp(), None, "cuda_fused"),
            (_fake_cuda_ocp(), "cuda", "cuda"),
            (_fake_cuda_ocp(), "torch", "torch"),
            (_fake_cuda_ocp(model=False), None, "cuda_fused"),
            (_fake_cuda_ocp(model=False, dtype=torch.float64), None,
             "cuda_bw"),
            (bench_ocp(10, "cpu"), None, "torch")):
        with pytest.raises(_Stop):
            make(ocp, backend=backend)
        assert seen.pop() == expected, (factory, backend)
    monkeypatch.setattr(ipm_mod, "resolve_backend", real)
    with pytest.raises(NotImplementedError, match='backend="torch"'):
        make(dataclasses.replace(_fake_cuda_ocp(model=False), nu=5))


def test_barrier_solver_default_stays_torch(monkeypatch):
    """make_barrier_solver keeps "torch", as the JAX one keeps "xla"."""
    seen = []

    def spy_parts(ocp, opt, backend):
        seen.append(backend)
        raise _Stop

    monkeypatch.setattr(batched_mod, "_make_parts", spy_parts)
    with pytest.raises(_Stop):
        mt.make_barrier_solver(bench_ocp(10, "cpu"))
    assert seen == ["torch"]


def _nu5_ocps(N=4):
    """A tiny LTI OCP with nu = 5 (nx = 2), RK4 at 0.1, target in p, a box
    that clamps some controls: 3^5 = 243 stage-QP patterns."""
    rng = np.random.default_rng(8)
    Ac, Bc = 0.3 * rng.normal(size=(2, 2)), rng.normal(size=(2, 5))
    Qw, Rw = np.diag([2.0, 1.0]), 0.1 * np.eye(5)
    lb, ub = -0.3 * np.ones(5), 0.4 * np.ones(5)
    mj = j_linear_model(Ac, Bc)
    Fj = j_rk4_step(mj.f, 0.1)
    j_ocp = mv.OCP(dynamics=lambda x, u, p: Fj(x, u, p),
                   stage_cost=lambda x, u, p: (x - p) @ Qw @ (x - p) + u @ Rw @ u,
                   N=N, nx=2, nu=5, npar=2,
                   control_bounds=mv.box_bounds(lb, ub))
    mtm = linear_model(Ac, Bc, device="cpu", dtype=torch.float64)
    Ft = rk4_step(mtm.f, 0.1)
    Qt, Rt = torch.as_tensor(Qw), torch.as_tensor(Rw)
    t_ocp = mt.OCP(dynamics=lambda x, u, p: Ft(x, u, p),
                   stage_cost=lambda x, u, p: (x - p) @ Qt @ (x - p) + u @ Rt @ u,
                   N=N, nx=2, nu=5, npar=2,
                   control_bounds=mt.box_bounds(lb, ub, device="cpu",
                                                dtype=torch.float64),
                   dtype=torch.float64)
    return j_ocp, t_ocp


def test_nu5_on_torch_matches_jax():
    """nu > 4 solves on "torch", as on the JAX "xla" path and single-problem
    solver; the kernel backends refuse it."""
    j_ocp, t_ocp = _nu5_ocps()
    opts = dict(max_iters=30)
    rng = np.random.default_rng(9)
    x0s, target = rng.uniform(-1, 1, (3, 2)), np.array([2.0, -1.0])
    res_j = jax.jit(j_batched(j_ocp, mv.ILQROptions(**opts), backend="xla"))(
        x0s, target)
    res_t = mt.make_batched_ilqr_solver(t_ocp, mt.ILQROptions(**opts))(x0s, target)
    one_j = jax.jit(mv.make_ilqr_solver(j_ocp, mv.ILQROptions(**opts)))(
        x0s[0], target)
    one_t = mt.make_ilqr_solver(t_ocp, mt.ILQROptions(**opts))(x0s[0], target)
    assert bool(res_t.converged.all()) and bool(one_t.converged)
    for t, j in ((res_t, res_j), (one_t, one_j)):
        np.testing.assert_allclose(t.us.numpy(), np.asarray(j.us), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(t.cost.numpy(), np.asarray(j.cost), rtol=1e-8)
        np.testing.assert_array_equal(t.converged.numpy(), np.asarray(j.converged))
    us = res_t.us.numpy()
    assert np.isclose(us, -0.3).any() and np.isclose(us, 0.4).any()  # clamped
    for backend in ("cuda", "cuda_fused"):
        with pytest.raises(NotImplementedError):
            mt.make_batched_ilqr_solver(
                dataclasses.replace(t_ocp, dtype=torch.float32,
                                    device_model=bench_ocp(4, "cpu").device_model),
                backend=backend)
