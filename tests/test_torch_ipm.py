"""Port vs JAX: the interior-point solvers (``solver/ipm.py``), float64.

The JAX side runs ``backend="xla"``, the port ``backend="torch"``, on the
bench OCP at N = 12 toward (5, 5, 0) as ``tests/test_ipm.py`` poses it.
Between the packages: converged equal, iterations within one, us to 1e-6,
cost to 1e-8 relative (the tolerances of ``tests/test_torch_solver.py``).
Within the port, the JAX tests' own claims at their own tolerances: the
streaming barrier lands on the exact box-DDP solution (us to 1e-4, cost to
1e-6 relative), the DDP-warm hybrid on the cold one, inexact early rounds
cost no accuracy.  Also the barrier term's boundary rules and the device
model's barrier formulas (what kernels K2 and K3 evaluate) against the
derived OCPs' callables.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.func import grad, hessian, vmap

import bench
import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu.solver.ipm import _barrier_term as j_barrier_term
from mpc_verde_tpu.solver.ipm import make_barrier_solver as j_barrier
from mpc_verde_tpu.solver.ipm import \
    make_streaming_barrier_solver as j_streaming_barrier
from mpc_verde_tpu_torch.interop import bench_ocp, derived_ocps, from_numpy
from mpc_verde_tpu_torch.solver.ipm import _barrier_term

N, M, W = 12, 6, 3


def _queue(m=M):
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-2, 2, (m, 3))
    ps = np.broadcast_to(np.array([5.0, 5.0, 0.0]), (m, N + 1, 3)).copy()
    return x0, ps, np.zeros((m, N, 2))


def _assert_close_to_jax(res_t, res_j):
    rj = from_numpy(res_j, "cpu", torch.float64)
    np.testing.assert_array_equal(res_t.converged.numpy(), rj.converged.numpy())
    assert res_t.converged.all()
    assert (res_t.iterations - rj.iterations).abs().max() <= 1
    np.testing.assert_allclose(res_t.us.numpy(), rj.us.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(res_t.cost.numpy(), rj.cost.numpy(), rtol=1e-8)


def _ddp(queue, opts):
    return mt.make_batched_ilqr_solver(bench_ocp(N, "cpu", torch.float64),
                                       opts)(*queue)


@pytest.mark.parametrize("kappa", [10.0, 0.0])
def test_streaming_barrier_matches_jax_and_exact_ddp(kappa):
    """tests/test_ipm.py:122-146 and :364-393: the streaming continuation
    (mu rounds in place, mu = 0 crossover) against JAX, and on the exact
    box-DDP solution; inexact early rounds (kappa 10) take no more
    iterations than exact ones and keep the accuracy."""
    queue = _queue()
    kw = dict(batch_width=W, restarts=1, inexact_kappa=kappa)
    res_j = jax.jit(j_streaming_barrier(
        bench.build_ocp(N), mv.ILQROptions(max_iters=80), backend="xla",
        **kw))(*queue)
    res_t = mt.make_streaming_barrier_solver(
        bench_ocp(N, "cpu", torch.float64), mt.ILQROptions(max_iters=80),
        **kw)(*queue)
    _assert_close_to_jax(res_t, res_j)

    rd = _ddp(queue, mt.ILQROptions(max_iters=80))
    assert rd.converged.all()
    assert np.isclose(rd.us[..., 0].abs().numpy(), 1.0, atol=1e-6).any()
    assert (res_t.us - rd.us).abs().max() < 1e-4
    np.testing.assert_allclose(res_t.cost.numpy(), rd.cost.numpy(), rtol=1e-6)
    assert (res_t.iterations > rd.iterations).all()
    if kappa == 0.0:
        exact_it = res_t.iterations.double().mean()
        inexact = mt.make_streaming_barrier_solver(
            bench_ocp(N, "cpu", torch.float64), mt.ILQROptions(max_iters=80),
            batch_width=W, restarts=1)(*queue)
        assert inexact.iterations.double().mean() <= exact_it


def test_streaming_barrier_ddp_warmstart_hybrid():
    """tests/test_ipm.py:149-181: warmstart="ddp" with one interior stage
    against JAX, on the cold continuation's optima, with fewer iterations in
    all and more than the DDP phase alone."""
    queue = _queue()
    kw = dict(mu_schedule=(1e-4,), batch_width=W, restarts=1,
              warmstart="ddp")
    res_j = jax.jit(j_streaming_barrier(
        bench.build_ocp(N), mv.ILQROptions(max_iters=80), backend="xla",
        **kw))(*queue)
    ocp = bench_ocp(N, "cpu", torch.float64)
    opts = mt.ILQROptions(max_iters=80)
    hyb = mt.make_streaming_barrier_solver(ocp, opts, **kw)(*queue)
    _assert_close_to_jax(hyb, res_j)

    cold = mt.make_streaming_barrier_solver(ocp, opts, batch_width=W,
                                            restarts=1)(*queue)
    np.testing.assert_allclose(hyb.cost.numpy(), cold.cost.numpy(), rtol=1e-6)
    assert (hyb.us - cold.us).abs().max() < 1e-4
    assert hyb.iterations.double().mean() < cold.iterations.double().mean()
    assert (hyb.iterations > _ddp(queue, opts).iterations).all()


def test_batched_barrier_matches_jax():
    """make_barrier_solver (batched continuation without the clip box, then
    the crossover) against JAX on a short schedule, and on the exact
    box-DDP solution (tests/test_ipm.py:38-58 at its crossover tolerances)."""
    queue = _queue(2)
    kw = dict(mu_schedule=(1e-2, 1e-4))
    opts = dict(max_iters=80)
    res_j = jax.jit(j_barrier(bench.build_ocp(N), mv.ILQROptions(**opts),
                              backend="xla", **kw))(*queue)
    res_t = mt.make_barrier_solver(bench_ocp(N, "cpu", torch.float64),
                                   mt.ILQROptions(**opts), **kw)(*queue)
    _assert_close_to_jax(res_t, res_j)
    rd = _ddp(queue, mt.ILQROptions(**opts))
    assert (res_t.us - rd.us).abs().max() < 1e-4
    np.testing.assert_allclose(res_t.cost.numpy(), rd.cost.numpy(), rtol=1e-6)


@pytest.mark.parametrize("mu", [1e-2, 0.0])
def test_barrier_term_boundary_semantics(mu):
    """tests/test_ipm.py:184-208: +inf on or outside the box while mu > 0,
    and exactly zero value and gradient at mu = 0, boundary included; the
    values and gradients equal JAX's."""
    lb, ub = np.array([-1.0, -0.5]), np.array([1.0, 0.5])
    points = {"interior": [0.3, -0.2], "on_bound": [1.0, 0.0],
              "outside": [1.2, 0.0]}
    for name, u in points.items():
        ut = torch.tensor(u, dtype=torch.float64)
        val = float(_barrier_term(ut, lb, ub, mu))
        g = grad(lambda v: _barrier_term(v, lb, ub, mu))(ut)
        val_j = float(j_barrier_term(np.array(u), lb, ub, mu))
        g_j = np.array(jax.grad(lambda v: j_barrier_term(v, lb, ub, mu))(
            np.array(u)))
        assert val == val_j or np.isclose(val, val_j, rtol=1e-14), name
        np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-14, err_msg=name)
        if mu == 0.0:
            assert val == 0.0
            np.testing.assert_array_equal(g.numpy(), 0.0)
        elif name == "interior":
            assert np.isfinite(val)
        else:
            assert val == np.inf and not val < 1e30


@pytest.mark.parametrize("box", ["pinned_tail", "mid_horizon", "none"])
def test_barrier_rejects_non_constant_or_pinned_boxes(box):
    """tests/test_ipm.py:283-307: stage-dependent, pinned or missing boxes
    raise in both barrier solvers."""
    ocp = bench_ocp(N, "cpu", torch.float64)
    lbs = np.tile(np.array([-1.0, -np.pi / 4]), (N, 1))
    ubs = np.tile(np.array([1.0, np.pi / 4]), (N, 1))
    if box == "pinned_tail":
        ubs[N // 2:] = lbs[N // 2:]
    elif box == "mid_horizon":
        ubs[1:-1, 0] = 0.5   # first and last stage as the others
    cb = None if box == "none" else mt.box_bounds(lbs, ubs, device="cpu",
                                                  dtype=torch.float64)
    bad = dataclasses.replace(ocp, control_bounds=cb)
    for make in (mt.make_barrier_solver, mt.make_streaming_barrier_solver):
        with pytest.raises(ValueError):
            make(bad)


@pytest.mark.parametrize("rule", ["barrier", "barrier_batched"])
def test_device_model_barrier_matches_derived_ocp(rule):
    """The barrier formulas the kernels evaluate (the derived device model's
    stage cost) equal the derived OCP's callable, with first and second
    derivatives, at mu > 0, at mu = 0 (streaming: exact zeros) and, for the
    streaming rule, on and outside the box (+inf)."""
    ocp = derived_ocps(bench_ocp(N, "cpu", torch.float64))[rule]
    model = ocp.device_model
    assert model.barrier == ("streaming" if rule == "barrier" else "batched")
    assert model.barrier_mu == 3 and ocp.npar == 4
    if rule == "barrier_batched":
        assert ocp.control_bounds is None and np.isinf(model.lb).all()
    else:
        np.testing.assert_array_equal(model.lb, model.barrier_lb)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.uniform(-3, 3, (16, 3)))
    u = torch.as_tensor(rng.uniform(-0.7, 0.7, (16, 2)))
    p = torch.as_tensor(np.c_[rng.uniform(-10, 10, (16, 3)),
                              np.repeat([1e-2, 1e-4, 0.0, 1.0], 4)])
    close = lambda a, b: np.testing.assert_allclose(
        a.detach().numpy(), b.detach().numpy(), rtol=1e-12, atol=1e-12)
    close(vmap(model.stage_cost)(x, u, p), vmap(ocp.stage_cost)(x, u, p))
    for argnums in (0, 1):
        close(vmap(grad(model.stage_cost, argnums))(x, u, p),
              vmap(grad(ocp.stage_cost, argnums))(x, u, p))
        close(vmap(hessian(model.stage_cost, argnums))(x, u, p),
              vmap(hessian(ocp.stage_cost, argnums))(x, u, p))
    at_mu0 = p[:, 3] == 0
    base = model._quad(model.Q, x - p[:, :3]) + model._quad(model.R, u)
    if rule == "barrier":
        assert torch.equal(model.stage_cost(x, u, p)[at_mu0], base[at_mu0])
        edge = torch.tensor([[1.0, 0.0], [1.3, 0.0]], dtype=torch.float64)
        pe = p[:2].clone()
        pe[:, 3] = 1e-2
        assert torch.isposinf(model.stage_cost(x[:2], edge, pe)).all()
        assert torch.isposinf(vmap(ocp.stage_cost)(x[:2], edge, pe)).all()


def test_derived_ocps_carry_derived_device_models():
    """No derived OCP keeps the base device model: each gets the base model
    with its term, or None where the base has none or cannot take another
    term of the same kind."""
    xb = dict(x_lb=[-np.inf, -0.4, -np.inf], x_ub=[np.inf, 0.4, np.inf])
    base = bench_ocp(N, "cpu", torch.float64, **xb)
    derived = derived_ocps(base)
    assert set(derived) == {"barrier", "barrier_batched", "al", "barrier_al"}
    for name, o in derived.items():
        m = o.device_model
        assert m is not base.device_model and m.min_npar == o.npar, name
        assert m.al == name.endswith("al")
        assert (m.barrier is not None) == name.startswith("barrier")
    bm = derived["barrier_al"].device_model
    assert (bm.barrier_mu, bm.al_lam, bm.al_mu) == (3, 4, 10)
    none = derived_ocps(dataclasses.replace(base, device_model=None))
    assert all(o.device_model is None for o in none.values())
    m = derived["barrier"].device_model
    assert m.with_barrier(m.barrier_lb, m.barrier_ub, 4, "streaming") is None
    assert derived["al"].device_model.with_al([0] * 3, [1] * 3, 10) is None
