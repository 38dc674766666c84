"""Port vs JAX: the associative-scan LQT backward (``ops/parallel_riccati``)
and ``backend="scan"``, float64.

The port's prefix scan is the Hillis-Steele doubling form on every device
and dtype; the JAX package folds the prefix sequentially on the CPU in
float64 (``_assoc_scan``'s XLA:CPU workaround), so these tests hold the
doubling form that runs on the card against JAX's fold: the same algebra at
a different depth, to 1e-9 at N = 40 and N = 2048.  Within the port, the
doubling form against its own sequential fold (``_assoc_fold``) to 1e-10.
The solvers over ``"scan"`` against JAX's ``"scan"``: the unbounded
problem of ``tests/test_parallel_riccati.py`` (us to 1e-6, cost to 1e-8
relative), and the barrier and AL compositions of ``tests/test_ipm.py`` at
B = 1 (us to 1e-6, cost to 1e-8 relative).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu.models import unicycle as j_unicycle
from mpc_verde_tpu.ops import parallel_riccati as jp
from mpc_verde_tpu.ops import rk4_step as j_rk4_step
from mpc_verde_tpu.solver.batched import make_batched_ilqr_solver as j_batched
from mpc_verde_tpu.solver.ipm import make_barrier_solver as j_barrier
from mpc_verde_tpu_torch.interop import unicycle_ocp
from mpc_verde_tpu_torch.ops import parallel_riccati as tp
from mpc_verde_tpu_torch.solver.batched import resolve_backend

T = lambda a: torch.as_tensor(np.asarray(a))


def _random_lqt(seed, N, nx, nu):
    """tests/test_parallel_riccati.py's _random_lqt."""
    rng = np.random.default_rng(seed)
    Fs = np.tile(np.eye(nx), (N, 1, 1)) + 0.05 * rng.normal(size=(N, nx, nx))
    cs = 0.1 * rng.normal(size=(N, nx))
    Ls = 0.3 * rng.normal(size=(N, nx, nu))
    Xs = np.tile(np.eye(nx), (N, 1, 1)) * rng.uniform(0.1, 2.0, (N, 1, 1))
    rs = rng.normal(size=(N, nx))
    Us = np.tile(np.eye(nu), (N, 1, 1)) * rng.uniform(0.5, 2.0, (N, 1, 1))
    return (rng.normal(size=nx), Fs, cs, Ls, Xs, rs, Us, 2.0 * np.eye(nx),
            rng.normal(size=nx))


def _random_lq(seed, N, nx, nu):
    """tests/test_parallel_riccati.py's lq_backward data."""
    rng = np.random.default_rng(seed)
    lxx = np.tile(2 * np.eye(nx), (N, 1, 1)) + 0.1 * rng.normal(size=(N, nx, nx))
    return (np.tile(np.eye(nx), (N, 1, 1)) + 0.05 * rng.normal(size=(N, nx, nx)),
            0.3 * rng.normal(size=(N, nx, nu)), rng.normal(size=(N, nx)),
            rng.normal(size=(N, nu)), 0.5 * (lxx + lxx.transpose(0, 2, 1)),
            np.tile(np.eye(nu), (N, 1, 1)), 0.2 * rng.normal(size=(N, nu, nx)),
            rng.normal(size=nx), 1.5 * np.eye(nx), 1e-3)


SIZES = [(40, 4, 2), (2048, 3, 1)]


@pytest.mark.parametrize("N,nx,nu", SIZES)
def test_lqt_backward_and_gains_match_jax(N, nx, nu):
    x0, *prob = _random_lqt(N, N, nx, nu)
    Jj, ej = jax.jit(jp.lqt_backward_parallel)(*map(jnp.asarray, prob))
    Kj, kj = jax.jit(jp.lqt_gains)(*map(jnp.asarray, prob[:3] + prob[5:6]),
                                    Jj, ej)
    Jt, et = tp.lqt_backward_parallel(*map(T, prob))
    Kt, kt = tp.lqt_gains(*map(T, prob[:3] + prob[5:6]), Jt, et)
    for got, want in ((Jt, Jj), (et, ej), (Kt, Kj), (kt, kj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-9)
    xs_j, us_j = jax.jit(jp.lqt_solve_parallel)(jnp.asarray(x0),
                                                 *map(jnp.asarray, prob))
    xs_t, us_t = tp.lqt_solve_parallel(T(x0), *map(T, prob))
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("N,nx,nu", SIZES)
def test_lq_backward_parallel_matches_jax(N, nx, nu):
    data = _random_lq(N + 1, N, nx, nu)
    want = jax.jit(jp.lq_backward_parallel)(*map(jnp.asarray, data))
    got = tp.lq_backward_parallel(*map(T, data))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9)


@pytest.mark.parametrize("N,nx,nu", SIZES)
def test_doubling_form_matches_its_sequential_fold(N, nx, nu, monkeypatch):
    """W6 in float64: the deployed doubling form against the plain fold of
    the same combine, on the value functions and on the whole LQ backward."""
    _, *prob = _random_lqt(N + 2, N, nx, nu)
    elems, term = tp._lqt_elements(*map(T, prob))
    J, eta = tp._value_functions(elems, term, 0)
    Jf, etaf = tp._value_functions(elems, term, 0, prefix=tp._assoc_fold)
    assert float((J - Jf).abs().max()) <= 1e-10
    assert float((eta - etaf).abs().max()) <= 1e-10
    data = tuple(map(T, _random_lq(N + 3, N, nx, nu)))
    got = tp.lq_backward_parallel(*data)
    monkeypatch.setattr(tp, "_assoc_scan", tp._assoc_fold)
    for g, w in zip(got, tp.lq_backward_parallel(*data)):
        assert float(((g - w).abs() / w.abs().clamp(min=1.0)).max()) <= 1e-10


def test_leading_batch_axes_are_independent_problems():
    probs = [_random_lq(s, 24, 3, 2) for s in (7, 8, 9)]
    stacked = [torch.stack([T(p[i]) for p in probs]) for i in range(10)]
    got = tp.lq_backward_parallel(*stacked)
    for b, p in enumerate(probs):
        for g, w in zip(got, tp.lq_backward_parallel(*map(T, p))):
            assert float((g[b] - w).abs().max()) <= 1e-12


def _unicycle_pair(N, Q, R, **kw):
    """A float64 unicycle OCP for each package, RK4 at 0.2, target p[:3]."""
    F = j_rk4_step(j_unicycle.f, 0.2)
    Qj, Rj = jnp.asarray(Q), jnp.asarray(R)

    def l(x, u, p):
        e = x - p[:3]
        return e @ Qj @ e + u @ Rj @ u

    jo = mv.OCP(dynamics=lambda x, u, p: F(x, u, p), stage_cost=l, N=N, nx=3,
                nu=2, npar=3, **{k: jnp.asarray(v) for k, v in kw.items()})
    to = unicycle_ocp(N, "cpu", torch.float64, dt=0.2, Q=Q, R=R)
    return jo, dataclasses.replace(to, **{k: T(v) for k, v in kw.items()})


def _assert_close(rt, rj, us_tol=1e-6):
    assert bool(rt.converged.all()) and bool(np.asarray(rj.converged).all())
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us), rtol=0,
                               atol=us_tol)
    np.testing.assert_allclose(rt.cost.numpy(), np.asarray(rj.cost),
                               rtol=1e-8)


def test_scan_backend_matches_jax():
    """tests/test_parallel_riccati.py:131: the unbounded unicycle at N = 16,
    Gauss-Newton, six starts."""
    Nh, B = 16, 6
    jo, to = _unicycle_pair(Nh, np.diag([1.0, 5.0, 0.1]), np.diag([0.5, 0.05]))
    x0 = np.random.default_rng(13).uniform(-1, 1, (B, 3))
    ps = np.broadcast_to(np.array([3.0, 3.0, 0.0]), (B, Nh + 1, 3)).copy()
    us0 = np.zeros((B, Nh, 2))
    rj = jax.jit(j_batched(jo, mv.ILQROptions(max_iters=150, use_ddp=False),
                           backend="scan"))(x0, ps, us0)
    rt = mt.make_batched_ilqr_solver(
        to, mt.ILQROptions(max_iters=150, use_ddp=False), backend="scan")(
        x0, ps, us0)
    _assert_close(rt, rj)
    # use_ddp=True is forced off, as in the JAX solver: the same answers
    rd = mt.make_batched_ilqr_solver(to, mt.ILQROptions(max_iters=150),
                                     backend="scan")(x0, ps, us0)
    np.testing.assert_array_equal(rd.us.numpy(), rt.us.numpy())


def test_barrier_over_scan_matches_jax():
    """tests/test_ipm.py:212: the barrier subproblems have no clip box, so
    "scan" composes (nu = 3, N = 8, crossover off); B = 1."""
    nx = nu = 3
    Nh, dt = 8, 0.25
    target = np.array([2.0, -1.5, 1.0])
    ub = np.array([0.8, 0.5, 0.6])
    Q, R = np.diag([1.0, 2.0, 1.5]), 0.1 * np.eye(3)

    def callables(asarray):
        tg, Qx, Rx = (asarray(a) for a in (target, Q, R))

        def l(x, u, p):
            e = x - tg
            return e @ Qx @ e + u @ Rx @ u

        return dict(dynamics=lambda x, u, p: x + dt * u, stage_cost=l,
                    terminal_cost=lambda x, p: 10.0 * (x - tg) @ (x - tg),
                    N=Nh, nx=nx, nu=nu, npar=0)

    jo = mv.OCP(**callables(jnp.asarray),
                control_bounds=mv.box_bounds(jnp.asarray(-ub), jnp.asarray(ub)))
    to = mt.OCP(**callables(lambda a: torch.as_tensor(a, dtype=torch.float64)),
                control_bounds=mt.box_bounds(-ub, ub, device="cpu",
                                             dtype=torch.float64),
                dtype=torch.float64)
    rj = j_barrier(jo, mv.ILQROptions(max_iters=100), backend="scan",
                   crossover=False)(jnp.zeros((1, nx)))
    rt = mt.make_barrier_solver(to, mt.ILQROptions(max_iters=100),
                                backend="scan", crossover=False)(
        np.zeros((1, nx)))
    _assert_close(rt, rj)
    # crossover=True runs box-QP DDP on the boxed OCP, which "scan" refuses
    with pytest.raises(NotImplementedError):
        mt.make_barrier_solver(to, mt.ILQROptions(), backend="scan")


def test_al_state_bounds_over_scan_match_jax():
    """tests/test_ipm.py:245: the AL rounds over "scan" (the augmented
    subproblems are unbounded), the y box |y| <= 0.8, N = 10, B = 1."""
    Nh = 10
    box = dict(x_lb=np.array([-np.inf, -0.8, -np.inf]),
               x_ub=np.array([np.inf, 0.8, np.inf]))
    jo, to = _unicycle_pair(Nh, np.diag([1.0, 5.0, 0.1]),
                            np.diag([0.5, 0.05]), **box)
    opts = dict(max_iters=60, al_iters=3, use_ddp=False)
    x0 = np.random.default_rng(9).uniform(-0.5, 0.5, (1, 3))
    ps = np.broadcast_to(np.array([2.0, 2.0, 0.0]), (1, Nh + 1, 3)).copy()
    us0 = np.zeros((1, Nh, 2))
    rj = jax.jit(j_batched(jo, mv.ILQROptions(**opts), backend="scan"))(
        x0, ps, us0)
    rt = mt.make_batched_ilqr_solver(to, mt.ILQROptions(**opts),
                                     backend="scan")(x0, ps, us0)
    _assert_close(rt, rj)
    np.testing.assert_allclose(rt.max_violation.numpy(),
                               np.asarray(rj.max_violation), atol=1e-9)
    assert float(rt.xs[..., 1].abs().max()) <= 0.8 + 1e-2


def test_scan_backend_rejects_control_bounds_and_is_never_the_default():
    ocp = mt.OCP(dynamics=lambda x, u, p: x + u,
                 stage_cost=lambda x, u, p: x @ x + u @ u, N=4, nx=2, nu=2,
                 control_bounds=mt.box_bounds([-1.0, -1.0], [1.0, 1.0],
                                              device="cpu"))
    with pytest.raises(NotImplementedError):
        mt.make_batched_ilqr_solver(ocp, mt.ILQROptions(), backend="scan")
    with pytest.raises(NotImplementedError):
        mt.make_streaming_solver(ocp, mt.ILQROptions(), backend="scan")
    assert resolve_backend(ocp, None) == "torch"


def test_streaming_scan_matches_batched_scan():
    """The streaming solver reaches "scan" through the same parts: a queue
    of six through three slots lands on the batched solve's answers."""
    from mpc_verde_tpu_torch.interop import bench_ocp

    Nh = 10
    ocp = bench_ocp(Nh, "cpu", torch.float64, box=False)
    opts = mt.ILQROptions(max_iters=80, use_ddp=False)
    x0 = np.random.default_rng(14).uniform(-1, 1, (6, 3))
    ps = np.broadcast_to(np.array([3.0, 3.0, 0.0]), (6, Nh + 1, 3)).copy()
    rb = mt.make_batched_ilqr_solver(ocp, opts, backend="scan")(x0, ps)
    rs = mt.make_streaming_solver(ocp, opts, backend="scan", batch_width=3)(
        x0, ps)
    assert bool(rb.converged.all()) and bool(rs.converged.all())
    np.testing.assert_allclose(rs.cost.numpy(), rb.cost.numpy(), rtol=1e-10)
    np.testing.assert_allclose(rs.us.numpy(), rb.us.numpy(), atol=1e-8)
