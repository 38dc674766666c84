"""Port vs JAX, float64: the LQR warm start, the multiple-shooting (FDDP)
solver and the condensed QP.

* Warm start: K1's twin under the warm start's arguments (infinite bounds,
  no DDP, gN = HN = 0, reg = 1e-6) equals a transcription of the JAX
  ``bwd`` recursion to 1e-12: the identity that lets K1 carry the warm
  start on the card.  Then the port's warm start against JAX's on the
  double integrator and on its boxed variant (``tests/test_warmstart.py``),
  controls to 1e-10.
* FDDP on the bench OCP at N = 10: after three iterations and converged
  from the infeasible lifted start of ``tests/test_multiple_shooting.py``:
  costs to 1e-9 relative, controls to 1e-7, gaps to 1e-9, iterations equal.
* Condensed: each function against JAX to 1e-10 (the prediction matrices
  of a random LTV stack, the pendulum's condensed data with move blocking,
  the dense box QP), and ``solve_condensed`` on the pendulum step of
  ``tests/test_condensed.py:89`` against JAX and against the port's own
  box-DDP solution of the same LQ problem (controls to 1e-6).
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
from mpc_verde_tpu.ops import c2d as j_c2d
from mpc_verde_tpu.solver import condensed as jc
from mpc_verde_tpu.solver.multiple_shooting import make_ms_solver as j_ms
from mpc_verde_tpu.solver.warmstart import make_lqr_warm_start as j_warm
from mpc_verde_tpu_torch.interop import bench_ocp
from mpc_verde_tpu_torch.ops.cuda.riccati import riccati_backward_torch
from mpc_verde_tpu_torch.solver import condensed as tc
from mpc_verde_tpu_torch.solver.multiple_shooting import (
    make_batched_ms_solver, make_ms_solver)
from mpc_verde_tpu_torch.solver.warmstart import WARM_REG, make_lqr_warm_start

F64 = dict(dtype=torch.float64, device="cpu")
T = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _warm_bwd(d):
    """The JAX warm start's ``bwd`` (solver/warmstart.py:111-126),
    transcribed: the affine Riccati recursion with a fixed 1e-6 on Quu."""
    B, N, nx, nu = d["fu"].shape
    reg = WARM_REG * torch.eye(nu, **F64)
    Vx, Vxx = torch.zeros((B, nx), **F64), torch.zeros((B, nx, nx), **F64)
    kffs, Ks = [], []
    mv_ = lambda A, v: (A @ v[..., None])[..., 0]
    for k in reversed(range(N)):
        fx, fu, lx, lu, lxx, luu, lux = (d[n][:, k] for n in (
            "fx", "fu", "lx", "lu", "lxx", "luu", "lux"))
        fxT, fuT = fx.transpose(-1, -2), fu.transpose(-1, -2)
        Qx = lx + mv_(fxT, Vx)
        Qu = lu + mv_(fuT, Vx)
        Qxx = lxx + fxT @ Vxx @ fx
        Quu = luu + fuT @ Vxx @ fu + reg
        Qux = lux + fuT @ Vxx @ fx
        kff = -torch.linalg.solve(Quu, Qu)
        K = -torch.linalg.solve(Quu, Qux)
        KT, QuxT = K.transpose(-1, -2), Qux.transpose(-1, -2)
        Vx = Qx + mv_(KT @ Quu, kff) + mv_(KT, Qu) + mv_(QuxT, kff)
        Vxx = Qxx + KT @ Quu @ K + KT @ Qux + QuxT @ K
        Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
        kffs.append(kff)
        Ks.append(K)
    return torch.stack(kffs[::-1], 1), torch.stack(Ks[::-1], 1)


@pytest.mark.parametrize("nx,nu", [(3, 2), (4, 1), (5, 2)])
def test_k1_twin_under_warm_start_arguments_is_the_warm_start_backward(nx, nu):
    rng = np.random.default_rng(10 * nx + nu)
    B, N = 16, 12
    lxx = np.eye(nx) + 0.1 * rng.normal(size=(B, N, nx, nx))
    luu = np.eye(nu) + 0.1 * rng.normal(size=(B, N, nu, nu))
    d = {"fx": np.eye(nx) + 0.2 * rng.normal(size=(B, N, nx, nx)),
         "fu": 0.3 * rng.normal(size=(B, N, nx, nu)),
         "lx": rng.normal(size=(B, N, nx)), "lu": rng.normal(size=(B, N, nu)),
         "lxx": lxx @ lxx.transpose(0, 1, 3, 2),
         "luu": luu @ luu.transpose(0, 1, 3, 2),
         "lux": 0.1 * rng.normal(size=(B, N, nu, nx))}
    d = {k: T(v) for k, v in d.items()}
    inf = torch.full((B, N, nu), torch.inf, **F64)
    kff, K, _, _, _ = riccati_backward_torch(
        d, -inf, inf, torch.zeros((B, nx), **F64),
        torch.zeros((B, nx, nx), **F64), torch.full((B,), WARM_REG, **F64),
        None, nx=nx, nu=nu, use_ddp=False)
    kff_w, K_w = _warm_bwd(d)
    assert float((kff - kff_w).abs().max()) <= 1e-12
    assert float((K - K_w).abs().max()) <= 1e-12


def _double_integrator(box, N=20, dt=0.1):
    """tests/test_warmstart.py's problem for each package."""
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt * dt], [dt]])
    Q, R = np.diag([10.0, 1.0]), 0.1 * np.eye(1)

    def callables(asarray):
        Ax, Bx, Qx, Rx = map(asarray, (A, Bm, Q, R))

        def l(x, u, p):
            e = x - p[:2]
            return e @ Qx @ e + u @ Rx @ u

        return dict(dynamics=lambda x, u, p: Ax @ x + Bx @ u, stage_cost=l,
                    N=N, nx=2, nu=1, npar=2)

    jo = mv.OCP(**callables(jnp.asarray), control_bounds=(
        mv.box_bounds(jnp.array([-0.4]), jnp.array([0.4])) if box else None))
    to = mt.OCP(**callables(T), dtype=torch.float64, control_bounds=(
        mt.box_bounds([-0.4], [0.4], device="cpu", dtype=torch.float64)
        if box else None))
    return jo, to


@pytest.mark.parametrize("box", [False, True])
def test_warm_start_matches_jax(box):
    jo, to = _double_integrator(box)
    B = 8
    x0s = np.random.default_rng(4).uniform(-3, 3, (B, 2))
    ps = np.broadcast_to(np.array([1.0, 0.0]), (B, to.N + 1, 2)).copy()
    us_j = jax.jit(j_warm(jo, xref_fn=lambda p: p[:2]))(x0s, ps)
    us_t = make_lqr_warm_start(to, xref_fn=lambda p: p[:2])(x0s, ps)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=0,
                               atol=1e-10)
    if box:   # far starts: the clip is exercised
        assert np.isclose(np.abs(us_t.numpy()), 0.4, atol=1e-9).any()
        assert float(us_t.abs().max()) <= 0.4 + 1e-12


def test_warm_start_on_kernel_backends_runs_the_twins_on_the_cpu():
    """On CPU tensors "cuda" runs K1's and K2's twins: the "torch" answer
    (float32, the kernels' type); nu > 4, which K1 does not take, raises,
    as for the solvers."""
    ocp = bench_ocp(10, "cpu", torch.float32)
    x0 = np.random.default_rng(5).uniform(-2, 2, (6, 3))
    ps = np.broadcast_to(np.array([10.0, 10.0, 0.0]), (6, 11, 3)).copy()
    warm = lambda b: make_lqr_warm_start(ocp, lambda p: p[:3], backend=b)
    ut, uc = warm("torch")(x0, ps), warm("cuda")(x0, ps)
    np.testing.assert_array_equal(ut.numpy(), uc.numpy())
    _, to = _double_integrator(False)
    with pytest.raises(NotImplementedError):
        make_lqr_warm_start(dataclasses.replace(to, nu=5, dtype=torch.float32,
                                                device_model=ocp.device_model),
                            backend="cuda")


MS_OPTS = dict(tol_grad=1e-9, tol_cost=1e-13)


def _ms_pair(max_iters):
    jo = bench.build_ocp(10)
    return (j_ms(jo, mv.ILQROptions(max_iters=max_iters, **MS_OPTS)),
            bench_ocp(10, "cpu", torch.float64),
            mt.ILQROptions(max_iters=max_iters, **MS_OPTS))


def test_fddp_after_three_iterations_matches_jax():
    """The batched core against jax.vmap of the JAX solve, mid-run, from
    lifted states that are not the rollout."""
    j_solve, ocp, opts = _ms_pair(3)
    B = 4
    rng = np.random.default_rng(6)
    x0s = rng.uniform(-2, 2, (B, 3))
    ps = np.broadcast_to(np.array([10.0, 10.0, 0.0]), (B, 11, 3)).copy()
    us0 = np.zeros((B, 10, 2))
    xs0 = x0s[:, None] + rng.uniform(-1, 1, (B, 11, 3))
    rj = jax.jit(jax.vmap(j_solve))(x0s, ps, us0, xs0)
    rt = make_batched_ms_solver(ocp, opts)(x0s, ps, us0, xs0)
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_allclose(rt.cost.numpy(), np.asarray(rj.cost),
                               rtol=1e-9)
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us), atol=1e-7)
    np.testing.assert_allclose(rt.max_violation.numpy(),
                               np.asarray(rj.max_violation), atol=1e-9)


def test_fddp_from_an_infeasible_start_matches_jax():
    """tests/test_multiple_shooting.py:63: constant lifted states far from
    the rollout and nonzero controls; gaps close, single-problem solve."""
    j_solve, ocp, opts = _ms_pair(150)
    params = np.broadcast_to(np.array([10.0, 10.0, 0.0]), (11, 3)).copy()
    us0 = np.tile(np.array([[0.5, -0.3]]), (10, 1))
    xs0 = np.broadcast_to(np.array([2.0, -1.0, 0.5]), (11, 3)).copy()
    rj = jax.jit(j_solve)(np.zeros(3), params, us0, xs0)
    rt = make_ms_solver(ocp, opts)(np.zeros(3), params, us0, xs0)
    assert bool(rt.converged) and bool(rj.converged)
    assert float(rt.max_violation) < 1e-6
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-9)
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us), atol=1e-7)
    with pytest.raises(NotImplementedError):
        make_ms_solver(bench_ocp(10, "cpu", x_ub=[np.inf, 5.0, np.inf]))


def _pendulum_lti():
    """tests/test_condensed.py's cart-pendulum linearization."""
    Ac = np.array([[0.0, 1.0, 0.0, 0.0], [0.0, -0.1, 3.0, 0.0],
                   [0.0, 0.0, 0.0, 1.0], [0.0, -0.5, 30.0, 0.0]])
    Bc = np.array([[0.0], [2.0], [0.0], [5.0]])
    return tuple(np.asarray(a) for a in j_c2d(Ac, Bc, 0.05))


def test_prediction_matrices_and_blocking_match_jax():
    rng = np.random.default_rng(3)
    N, nx, nu = 6, 4, 2
    As = rng.normal(size=(N, nx, nx)) * 0.4 + np.eye(nx)
    Bs = rng.normal(size=(N, nx, nu))
    for got, want in zip(tc.prediction_matrices(T(As), T(Bs), N),
                         jc.prediction_matrices(jnp.array(As), jnp.array(Bs), N)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)
    # a batch of LTV stacks is a batch of independent predictions
    Sx2, Su2 = tc.prediction_matrices(T(np.stack([As, 2 * As])), T(Bs), N)
    Sx1, Su1 = tc.prediction_matrices(T(2 * As), T(Bs), N)
    np.testing.assert_allclose(Sx2[1].numpy(), Sx1.numpy(), rtol=1e-12)
    np.testing.assert_allclose(Su2[1].numpy(), Su1.numpy(), rtol=1e-12)
    np.testing.assert_array_equal(
        tc.blocking_matrix(10, 3, device="cpu").numpy(),
        np.asarray(jc.blocking_matrix(10, 3)))


def test_condense_and_dense_boxqp_match_jax():
    Ad, Bd = _pendulum_lti()
    Q, R = np.diag([1.0, 0.0, 10.0, 0.0]), 1e-3 * np.eye(1)
    dj = jc.condense(jnp.array(Ad), jnp.array(Bd), jnp.array(Q), jnp.array(R),
                     10, Ntu=3, du_weight=0.1)
    dt = tc.condense(T(Ad), T(Bd), Q, R, 10, Ntu=3, du_weight=0.1)
    for k in ("Sx", "Sub", "Qbar", "Tm", "H", "w"):
        np.testing.assert_allclose(dt[k].numpy(), np.asarray(dj[k]),
                                   atol=1e-10)
    rng = np.random.default_rng(7)
    n, B = 6, 5
    M = rng.normal(size=(B, n, n))
    H = M @ M.transpose(0, 2, 1) + n * np.eye(n)
    g = 3 * rng.normal(size=(B, n))
    vj = jc.solve_dense_boxqp(jnp.array(H), jnp.array(g),
                              jnp.full((B, n), -0.3), jnp.full((B, n), 0.4))
    vt = tc.solve_dense_boxqp(T(H), T(g), np.full((B, n), -0.3),
                              np.full((B, n), 0.4))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-10)
    assert np.isclose(vt.numpy(), -0.3).any() or np.isclose(vt.numpy(), 0.4).any()


def test_solve_condensed_pendulum_step_matches_jax_and_box_ddp():
    """tests/test_condensed.py:89: N = 12, four starts, the force box
    binding; with x_N weighted as the condensed cost weighs it, the
    box-DDP solve of the same LQ problem has the same argmin."""
    Ad, Bd = _pendulum_lti()
    N, ulim, B = 12, 2.0, 4
    Q, R = np.diag([1.0, 0.1, 10.0, 0.1]), 0.01 * np.eye(1)
    x0s = np.random.default_rng(11).uniform(-0.3, 0.3, (B, 4))
    us_j, _ = jc.solve_condensed(
        jc.condense(jnp.array(Ad), jnp.array(Bd), jnp.array(Q), jnp.array(R),
                    N), jnp.array(x0s), jnp.zeros((N, 4)),
        u_lb=jnp.array([-ulim]), u_ub=jnp.array([ulim]))
    us_t, _ = tc.solve_condensed(tc.condense(T(Ad), T(Bd), Q, R, N), T(x0s),
                                 torch.zeros((N, 4), **F64), u_lb=[-ulim],
                                 u_ub=[ulim])
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), atol=1e-10)
    assert np.isclose(np.abs(us_t.numpy()), ulim, atol=1e-8).any()

    At, Bt, Qt, Rt = map(T, (Ad, Bd, Q, R))
    ocp = mt.OCP(dynamics=lambda x, u, p: At @ x + Bt @ u,
                 stage_cost=lambda x, u, p: x @ Qt @ x + u @ Rt @ u,
                 terminal_cost=lambda x, p: x @ Qt @ x, N=N, nx=4, nu=1,
                 control_bounds=mt.box_bounds([-ulim], [ulim], device="cpu",
                                              dtype=torch.float64),
                 dtype=torch.float64)
    rd = mt.make_batched_ilqr_solver(ocp, mt.ILQROptions(max_iters=40))(
        x0s, None, np.zeros((B, N, 1)))
    assert bool(rd.converged.all())
    assert float((rd.us - us_t).abs().max()) < 1e-6
