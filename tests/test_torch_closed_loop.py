"""Port vs JAX: the "cuda_fused" solver path, the single-problem solver, the
receding-horizon driver and the fleet scenario, on the same numpy inputs.

On CPU tensors the ``"cuda_fused"`` backend runs the kernels' twins, so it
must equal ``"torch"`` exactly; everything else is held against its JAX
counterpart in float64 (x64): solver results as in
``tests/test_torch_solver.py``, closed-loop trajectories to 1e-6 as in
``tests/test_closed_loop.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu.models import unicycle as j_unicycle
from mpc_verde_tpu.ops import euler_step as j_euler_step
from mpc_verde_tpu.runtime import make_batched_receding_horizon as j_receding
from mpc_verde_tpu.runtime import make_receding_horizon as j_receding1
from mpc_verde_tpu.runtime import shift_warm_start as j_shift
from mpc_verde_tpu.scenarios.fleet import build_fleet as j_build_fleet
from mpc_verde_tpu.scenarios.fleet import run_fleet as j_run_fleet
from mpc_verde_tpu.solver.batched import make_batched_ilqr_solver as j_batched
from mpc_verde_tpu_torch.interop import bench_ocp, from_numpy, result_to_numpy
from mpc_verde_tpu_torch.models import unicycle
from mpc_verde_tpu_torch.ops import euler_step
from mpc_verde_tpu_torch.runtime import (make_batched_receding_horizon,
                                         make_receding_horizon,
                                         shift_warm_start)
from mpc_verde_tpu_torch.scenarios import build_fleet, run_fleet

T = 0.2
TARGET = np.array([10.0, 10.0, 0.0])
OPTS = dict(max_iters=60, tol_grad=1e-4, tol_cost=1e-6, n_alphas=8,
            alpha_decay=0.4)


def _queue(M, N, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-2.0, 2.0, (M, 3)).astype(np.float32)
    ps = np.broadcast_to(TARGET, (M, N + 1, 3)).astype(np.float32)
    return x0, ps, np.zeros((M, N, 2), np.float32)


@pytest.mark.parametrize("solver", ["batched", "streaming"])
def test_cuda_fused_on_cpu_equals_torch(solver):
    """CPU tensors: the fused part runs its twin, which is derivs -> backward."""
    N = 10
    ocp = bench_ocp(N, "cpu", torch.float32)
    opts = mt.ILQROptions(**OPTS)
    q = _queue(12, N)
    if solver == "batched":
        make = lambda b: mt.make_batched_ilqr_solver(ocp, opts, backend=b)
    else:
        make = lambda b: mt.make_streaming_solver(ocp, opts, backend=b,
                                                  batch_width=4, restarts=2)
    r_fused, r_torch = make("cuda_fused")(*q), make("torch")(*q)
    assert r_torch.converged.all()
    for name in ("xs", "us", "cost", "iterations", "converged"):
        assert torch.equal(getattr(r_fused, name), getattr(r_torch, name)), name


def test_cuda_fused_refuses_what_the_kernels_do_not_take():
    ocp = bench_ocp(10, "cpu", torch.float64)
    with pytest.raises(TypeError, match="float32"):
        mt.make_batched_ilqr_solver(ocp, backend="cuda_fused")
    ocp = bench_ocp(10, "cpu", torch.float32)
    # without a device model the kernels run the model traced from the
    # callables, which must lower to it
    atan2 = dataclasses.replace(ocp, device_model=None, dynamics=lambda x, u, p:
                                ocp.dynamics(x, u, p) + torch.atan2(x, u[:1]))
    with pytest.raises(NotImplementedError, match="dynamics.*atan2"):
        mt.make_streaming_solver(atan2, backend="cuda_fused")


def _close(res_t, res_j, iters=1):
    """Port result vs JAX result (numpy), as tests/test_torch_solver.py holds them."""
    rj = from_numpy(res_j, "cpu", torch.float64)
    np.testing.assert_array_equal(res_t.converged.numpy(), rj.converged.numpy())
    assert (res_t.iterations - rj.iterations).abs().max() <= iters
    np.testing.assert_allclose(res_t.us.numpy(), rj.us.numpy(), rtol=0, atol=1e-6)


def test_ilqr_solver_matches_jax():
    N = 10
    x0, ps, us0 = (a[1].astype(np.float64) for a in _queue(4, N, seed=3))
    res_j = jax.jit(mv.make_ilqr_solver(bench.build_ocp(N),
                                        mv.ILQROptions(**OPTS)))(x0, ps, us0)
    solve = mt.make_ilqr_solver(bench_ocp(N, "cpu", torch.float64),
                                mt.ILQROptions(**OPTS))
    res_t = solve(x0, ps, us0)
    assert res_t.xs.shape == (N + 1, 3) and res_t.cost.shape == ()
    assert bool(res_t.converged)
    _close(res_t, res_j)
    np.testing.assert_allclose(res_t.cost.numpy(), np.asarray(res_j.cost),
                               rtol=1e-8)
    # (npar,) params broadcast over the stages, as in the JAX solver
    np.testing.assert_array_equal(solve(x0, TARGET, us0).us.numpy(),
                                  res_t.us.numpy())


def test_shift_warm_start_matches_jax():
    us = np.arange(12.0).reshape(3, 2, 2)
    np.testing.assert_array_equal(shift_warm_start(torch.as_tensor(us)).numpy(),
                                  np.asarray(j_shift(jnp.asarray(us))))


def _plant_j():
    plant = j_euler_step(j_unicycle.f, T)
    return lambda x, u, gain: plant(x, gain * u, None)


def _plant_t():
    plant = euler_step(unicycle.f, T)
    return lambda x, u, gain: plant(x, gain * u, None)


def test_receding_horizon_matches_jax():
    """One plant, single-problem solver, predictions recorded."""
    Nh, Nsim = 8, 12
    x0 = np.array([0.3, -0.5, 0.2])
    params = np.broadcast_to(TARGET, (Nsim, Nh + 1, 3)).copy()
    gains = np.ones((Nsim, 1))
    opts = dict(max_iters=40)
    j_ocp = bench.build_ocp(Nh)
    res_j = jax.jit(j_receding1(
        j_ocp, mv.make_ilqr_solver(j_ocp, mv.ILQROptions(**opts)),
        _plant_j(), Nsim, record_predictions=True))(x0, params, gains)
    t_ocp = bench_ocp(Nh, "cpu", torch.float64)
    res_t = make_receding_horizon(
        t_ocp, mt.make_ilqr_solver(t_ocp, mt.ILQROptions(**opts)),
        _plant_t(), Nsim, record_predictions=True)(x0, params, gains)
    rj = from_numpy(res_j, "cpu", torch.float64)
    assert res_t.predicted.shape == (Nsim, Nh + 1, 3)
    assert float((res_t.xs[-1] - res_t.xs[0]).norm()) > 1.0   # the plant moved
    for name in ("xs", "us", "predicted", "final_warm"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(),
                                   getattr(rj, name).numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(res_t.converged.numpy(), rj.converged.numpy())
    assert bool(res_t.converged.all())


@pytest.mark.parametrize("per_plant", [False, True])
def test_batched_receding_horizon_matches_jax(per_plant):
    """The sizes of tests/test_closed_loop.py: shared plant parameters (a unit
    gain) at Nh = 8, Nsim = 12, B = 4; per-plant gains at Nh = 6, Nsim = 6,
    B = 3."""
    Nh, Nsim, B, iters = (6, 6, 3, 25) if per_plant else (8, 12, 4, 40)
    x0s = (np.zeros((B, 3)) if per_plant
           else np.random.default_rng(2).uniform(-1, 1, (B, 3)))
    params = np.broadcast_to(TARGET, (Nsim, Nh + 1, 3)).copy()
    gains = (np.broadcast_to(np.array([1.0, 0.5, 0.25]), (Nsim, B)).copy()
             if per_plant else np.ones((Nsim, 1)))
    opts = dict(max_iters=iters)

    j_ocp = bench.build_ocp(Nh)
    res_j = jax.jit(j_receding(
        j_ocp, j_batched(j_ocp, mv.ILQROptions(**opts), backend="xla"),
        _plant_j(), Nsim, plant_params_per_plant=per_plant))(x0s, params, gains)
    t_ocp = bench_ocp(Nh, "cpu", torch.float64)
    res_t = make_batched_receding_horizon(
        t_ocp, mt.make_batched_ilqr_solver(t_ocp, mt.ILQROptions(**opts)),
        _plant_t(), Nsim, plant_params_per_plant=per_plant)(x0s, params, gains)

    rj = from_numpy(res_j, "cpu", torch.float64)
    assert res_t.xs.shape == (Nsim + 1, B, 3) and res_t.us.shape == (Nsim, B, 2)
    assert res_t.final_warm.shape == (B, Nh, 2) and rj.predicted is None
    for name in ("xs", "us", "final_warm"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(),
                                   getattr(rj, name).numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(res_t.costs.numpy(), rj.costs.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(res_t.converged.numpy(), rj.converged.numpy())
    assert bool(res_t.converged.all())
    if per_plant:   # the gains differ, so the plants' trajectories do
        assert not torch.allclose(res_t.xs[:, 0], res_t.xs[:, 1])


def test_fleet_matches_jax():
    """The fleet at B = 8 over 24 steps: the same starts, and closed-loop
    trajectories and metrics that match JAX's."""
    B, Nsim = 8, 24
    built_j = j_build_fleet(B=B, n_steps=Nsim, backend="xla")
    built_t = build_fleet(B=B, n_steps=Nsim, device="cpu",
                          dtype=torch.float64)
    np.testing.assert_array_equal(built_t["x0s"], built_j["x0s"])
    np.testing.assert_array_equal(built_t["params"], built_j["params"])
    m_j, m_t = j_run_fleet(built_j), run_fleet(built_t)
    res_t = result_to_numpy(m_t["result"])
    np.testing.assert_allclose(res_t.xs, np.asarray(m_j["result"].xs),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(res_t.us, np.asarray(m_j["result"].us),
                               rtol=0, atol=1e-6)
    for key in ("final_err_max", "final_err_p99", "final_err_mean"):
        np.testing.assert_allclose(m_t[key], m_j[key], rtol=1e-6, err_msg=key)
    for key in ("B", "n_steps", "frac_reached", "converged_frac"):
        assert m_t[key] == m_j[key], key


@pytest.mark.parametrize("entry", ["build_fleet", "run_fleet"])
def test_fleet_needs_a_card_unless_asked_for_the_cpu(entry, monkeypatch):
    """The fleet's entry points run on the CUDA device by default: where
    there is none they raise and name ``device="cpu"``, and never carry on
    silently on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"build_fleet": build_fleet, "run_fleet": run_fleet}[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call(B=2, n_steps=1)
    built = build_fleet(B=2, n_steps=1, device="cpu", dtype=torch.float64)
    assert built["ocp"].device == torch.device("cpu")
