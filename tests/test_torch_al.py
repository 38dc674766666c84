"""Port vs JAX: state bounds through the augmented-Lagrangian rounds, float64.

The bench OCP at N = 12 with the y box |y| <= 0.4 toward (2, 1.5, 0), so the
bound binds (as ``tests/test_batched_solver.py`` and
``tests/test_streaming.py`` pose it, with the bench weights).  The port's
``"torch"`` backend against JAX ``"xla"``: converged equal, iterations
within one, us to 1e-6, cost to 1e-8 relative, max_violation to 1e-9; and
the JAX tests' own gates (violation < 1e-2, the bound active).  Also the
``rounds=`` guard, the streaming barrier + AL composition, the
single-problem solver (the port's B = 1 batched call against JAX's
per-problem AL loop), and the device model's AL formulas (what kernels K2
and K3 evaluate) against the derived OCP's callables.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, hessian, vmap

import bench
import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu.solver.batched import make_batched_ilqr_solver as j_batched
from mpc_verde_tpu.solver.ipm import \
    make_streaming_barrier_solver as j_streaming_barrier
from mpc_verde_tpu.solver.streaming import make_streaming_solver as j_streaming
from mpc_verde_tpu_torch.interop import (bench_ocp, derived_ocps, from_numpy,
                                         result_to_numpy)

N = 12
X_LB = np.array([-20.0, -0.4, -np.inf])
X_UB = np.array([20.0, 0.4, np.inf])
OPTS = dict(max_iters=60, al_iters=3)


def _ocps():
    j_ocp = dataclasses.replace(bench.build_ocp(N), x_lb=jnp.asarray(X_LB),
                                x_ub=jnp.asarray(X_UB))
    return j_ocp, bench_ocp(N, "cpu", torch.float64, x_lb=X_LB, x_ub=X_UB)


def _queue(m, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.3, 0.3, (m, 3))
    ps = np.broadcast_to(np.array([2.0, 1.5, 0.0]), (m, N + 1, 3)).copy()
    return x0, ps, np.zeros((m, N, 2))


def _assert_close_to_jax(res_t, res_j):
    rj = from_numpy(res_j, "cpu", torch.float64)
    np.testing.assert_array_equal(res_t.converged.numpy(), rj.converged.numpy())
    assert res_t.converged.all()
    assert (res_t.iterations - rj.iterations).abs().max() <= 1
    np.testing.assert_allclose(res_t.us.numpy(), rj.us.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(res_t.cost.numpy(), rj.cost.numpy(), rtol=1e-8)
    np.testing.assert_allclose(res_t.max_violation.numpy(),
                               rj.max_violation.numpy(), rtol=0, atol=1e-9)


def _bound_binds(res):
    assert float(res.xs[:, :, 1].max()) > 0.35
    assert float(res.max_violation.max()) < 1e-2


def test_batched_al_matches_jax():
    """tests/test_batched_solver.py:150-176 on the port."""
    j_ocp, t_ocp = _ocps()
    queue = _queue(6, 3)
    res_j = jax.jit(j_batched(j_ocp, mv.ILQROptions(**OPTS),
                              backend="xla"))(*queue)
    res_t = mt.make_batched_ilqr_solver(t_ocp, mt.ILQROptions(**OPTS))(*queue)
    _assert_close_to_jax(res_t, res_j)
    _bound_binds(res_t)
    # the result crosses back to numpy with its violation
    np.testing.assert_array_equal(result_to_numpy(res_t).max_violation,
                                  res_t.max_violation.numpy())


@pytest.mark.parametrize("refill_every", [1, 2])
def test_streaming_al_matches_jax(refill_every):
    """tests/test_streaming.py:238-261 on the port: the AL rounds as in-place
    advances through several refill generations; equal to the port's own
    batched AL solve per problem."""
    j_ocp, t_ocp = _ocps()
    queue = _queue(6, 7)
    kw = dict(batch_width=3, refill_every=refill_every)
    res_j = jax.jit(j_streaming(j_ocp, mv.ILQROptions(**OPTS), backend="xla",
                                **kw))(*queue)
    res_t = mt.make_streaming_solver(t_ocp, mt.ILQROptions(**OPTS),
                                     **kw)(*queue)
    _assert_close_to_jax(res_t, res_j)
    _bound_binds(res_t)
    res_b = mt.make_batched_ilqr_solver(t_ocp, mt.ILQROptions(**OPTS))(*queue)
    np.testing.assert_array_equal(res_t.iterations.numpy(),
                                  res_b.iterations.numpy())
    np.testing.assert_allclose(res_t.us.numpy(), res_b.us.numpy(), rtol=0,
                               atol=1e-12)


def test_single_problem_al_matches_jax_per_problem_loop():
    """The port's make_ilqr_solver is a B = 1 call of the batched solver, so
    its AL rounds are the batched ones; JAX's make_ilqr_solver has its own
    per-problem loop (solver/ilqr.py:155-180, :385-420), with its own copy
    of the acceptance logic.  They do not differ here: iterations equal
    (34 and 46 over the 3 rounds), us within 2e-15, cost within 3e-16
    relative, violations equal, so the batched tolerances hold."""
    j_ocp, t_ocp = _ocps()
    x0, ps, us0 = _queue(2, 11)
    solve_t = mt.make_ilqr_solver(t_ocp, mt.ILQROptions(**OPTS))
    solve_j = jax.jit(mv.make_ilqr_solver(j_ocp, mv.ILQROptions(**OPTS)))
    for b in range(2):
        res_t = solve_t(x0[b], ps[b], us0[b])
        res_j = solve_j(x0[b], ps[b], us0[b])
        assert res_t.us.shape == (N, 2) and res_t.cost.ndim == 0
        batch = lambda r: dataclasses.replace(
            r, **{f.name: getattr(r, f.name)[None]
                  for f in dataclasses.fields(r)})
        _assert_close_to_jax(batch(res_t),
                             batch(jax.tree.map(np.asarray, res_j)))


def test_streaming_barrier_composes_with_al():
    """tests/test_ipm.py:310-361 at B = 2: the barrier and AL continuations
    as one product schedule, against JAX, with the y box enforced."""
    j_ocp, t_ocp = _ocps()
    rng = np.random.default_rng(9)
    x0 = rng.uniform(-0.5, 0.5, (2, 3))
    ps = np.broadcast_to(np.array([2.0, 2.0, 0.0]), (2, N + 1, 3)).copy()
    queue = (x0, ps, np.zeros((2, N, 2)))
    kw = dict(batch_width=2, restarts=1)
    res_j = jax.jit(j_streaming_barrier(j_ocp, mv.ILQROptions(**OPTS),
                                        backend="xla", **kw))(*queue)
    res_t = mt.make_streaming_barrier_solver(t_ocp, mt.ILQROptions(**OPTS),
                                             **kw)(*queue)
    _assert_close_to_jax(res_t, res_j)
    assert float(res_t.xs[:, :, 1].max()) <= 0.4 + 1e-2
    assert float(res_t.max_violation.max()) < 1e-2


@pytest.mark.parametrize("case", ["al_iters_0", "rounds_with_bounds",
                                  "barrier_al_iters_0"])
def test_state_bound_guards(case):
    """State bounds need al_iters >= 1 and install their own rounds."""
    _, t_ocp = _ocps()
    with pytest.raises(ValueError):
        if case == "al_iters_0":
            mt.make_batched_ilqr_solver(t_ocp, mt.ILQROptions(al_iters=0))
        elif case == "rounds_with_bounds":
            mt.make_streaming_solver(t_ocp, mt.ILQROptions(al_iters=2),
                                     rounds=(2, lambda ps, xs, r: ps))
        else:
            mt.make_streaming_barrier_solver(t_ocp,
                                             mt.ILQROptions(al_iters=0))


@pytest.mark.parametrize("name", ["al", "barrier_al"])
def test_device_model_al_matches_derived_ocp(name):
    """The AL formulas the kernels evaluate (the derived device model's stage
    and terminal cost, and the terminal gradient and Hessian K3 writes out)
    equal the derived OCP's callables, with states inside and outside the
    box, nonzero lam, and rows at a tie (lam + mu c = 0)."""
    ocp = derived_ocps(_ocps()[1])[name]
    model = ocp.device_model
    npar = ocp.npar
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.uniform(-1, 1, (16, 3)))
    u = torch.as_tensor(rng.uniform(-0.7, 0.7, (16, 2)))
    p = np.zeros((16, npar))
    p[:, :3] = rng.uniform(-3, 3, (16, 3))
    if name == "barrier_al":
        p[:, 3] = 1e-2
    p[:, model.al_lam:model.al_lam + 6] = rng.uniform(0, 2, (16, 6)) * (
        rng.uniform(size=(16, 6)) < 0.5)
    p[:, model.al_mu] = rng.choice([10.0, 100.0], 16)
    # a tie on the y-upper row: lam = 0 and x exactly on the bound
    p[0, model.al_lam + 4] = 0.0
    x[0, 1] = 0.4
    p = torch.as_tensor(p)
    assert (x[:, 1].abs() > 0.4).any() and (x[:, 1].abs() < 0.4).any()
    close = lambda a, b: np.testing.assert_allclose(
        a.detach().numpy(), b.detach().numpy(), rtol=1e-12, atol=1e-12)
    close(vmap(model.stage_cost)(x, u, p), vmap(ocp.stage_cost)(x, u, p))
    close(vmap(hessian(model.stage_cost, 0))(x, u, p),
          vmap(hessian(ocp.stage_cost, 0))(x, u, p))
    close(vmap(model.terminal_cost)(x, p), vmap(ocp.terminal_cost)(x, p))
    gN, HN = model.terminal_grad_hess(x, p)
    close(gN, vmap(grad(ocp.terminal_cost))(x, p))
    close(HN, vmap(hessian(ocp.terminal_cost))(x, p))
    assert gN.abs().max() > 0   # the penalty is active somewhere
