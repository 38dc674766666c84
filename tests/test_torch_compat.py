"""Port vs JAX, float64: the mpctools and CasADi front ends (``compat``).

The reference scripts' programs run through both packages' compat layers
on the same numbers: ``getCasadiFunc`` with RK4 (to 1e-12), the mpctools
pendulum script (``tests/test_compat.py:36``) for its first 10 closed-loop
steps (states and controls to 1e-8), the var / par views and ``varsym``,
the CasADi column-major semantics and ``Function`` (numeric and symbolic),
and the single-shooting v1 closed loop (``tests/test_casadi_compat.py:128``)
at N = 8 for three steps (states and controls to 1e-8; the JAX test's
per-step checks on the port).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_verde_tpu.compat as j_mpc
import mpc_verde_tpu.compat.casadi as j_ca
import mpc_verde_tpu_torch.compat as mpc
import mpc_verde_tpu_torch.compat.casadi as ca
from mpc_verde_tpu_torch.compat.casadi import DM, SX
from mpc_verde_tpu_torch.models import unicycle
from mpc_verde_tpu_torch.ops import rk4_step, rk4_step_with_quadrature

F64 = dict(dtype=torch.float64, device="cpu")


def test_getcasadifunc_rk4_matches_ops_and_jax():
    def ode(x, u):
        return torch.stack([u[0] * torch.cos(x[2]), u[0] * torch.sin(x[2]),
                            u[1]])

    def j_ode(x, u):
        return jnp.stack([u[0] * jnp.cos(x[2]), u[0] * jnp.sin(x[2]), u[1]])

    F = mpc.getCasadiFunc(ode, [3, 2], ["x", "u"], "F", rk4=True, Delta=0.2,
                          M=1)
    x, u = np.array([0.1, 0.2, 0.3]), np.array([0.5, -0.2])
    got = F(torch.tensor(x, **F64), torch.tensor(u, **F64))
    ref = rk4_step(unicycle.f, 0.2, M=1)(torch.tensor(x, **F64),
                                         torch.tensor(u, **F64))
    j_F = j_mpc.getCasadiFunc(j_ode, [3, 2], ["x", "u"], "F", rk4=True,
                              Delta=0.2, M=1)
    assert float((got - ref).abs().max()) <= 1e-12
    np.testing.assert_allclose(got.numpy(), np.asarray(j_F(x, u)), atol=1e-12)
    A, B = mpc.util.c2d(np.eye(2), np.ones((2, 1)), 0.01)
    Aj, Bj = j_mpc.util.c2d(np.eye(2), np.ones((2, 1)), 0.01)
    np.testing.assert_allclose(A.numpy(), np.asarray(Aj), atol=1e-12)
    np.testing.assert_allclose(B.numpy(), np.asarray(Bj), atol=1e-12)


def _pendulum_script(m, nsim):
    """tests/test_compat.py:36-95 through the compat module ``m``, for
    ``nsim`` steps; returns (xcl, ucl, statuses)."""
    Nx, Nu = 4, 1
    T, Nt = 0.01, 50
    Ac = np.array([[0, 0, 0, 0], [1, -10, 0, -20],
                   [0, 9.81, 0, 39.24], [0, 0, 1, 0]]).T
    Bc = np.array([[0.0], [1.0], [0.0], [2.0]])
    A, B = m.util.c2d(Ac, Bc, T)
    A, B = np.asarray(A), np.asarray(B)

    def ffunc(x, u):
        return m.mtimes(A, x) + m.mtimes(B, u)

    f = m.getCasadiFunc(ffunc, [Nx, Nu], ["x", "u"], "f")
    Dulb, Duub = np.tile(-np.inf, (5, 1)), np.tile(np.inf, (5, 1))
    Dub = np.tile(0, (45, 1))
    lb = {"u": np.array([-200]), "Du": np.vstack((Dulb, Dub))}
    ub = {"u": np.array([200]), "Du": np.vstack((Duub, Dub))}
    xt, Q, R1 = np.array([10, 0, 0, 0]), np.diag([1.2, 0, 1, 0]), 0.01

    def lfunc(x, u, du):
        return ((Q[0, 0] * (x[0] - xt[0])) ** 2 + (Q[2, 2] * x[2]) ** 2
                + (R1 * du[0]) ** 2)

    l = m.getCasadiFunc(lfunc, [Nx, Nu, Nu], ["x", "u", "Du"])
    x0 = np.array([0.0, 0, 0, 0])
    solver = m.nmpc(f, l, {"x": Nx, "u": Nu, "t": Nt}, x0, lb, ub, isQP=True,
                    verbosity=0, uprev=np.array([0.0]),
                    funcargs={"l": ["x", "u", "Du"]}, device="cpu")
    xcl, ucl, statuses = np.zeros((Nx, nsim + 1)), np.zeros((Nu, nsim)), []
    xcl[:, 0] = x0
    for k in range(nsim):
        solver.fixvar("x", 0, x0)
        sol = m.callSolver(solver)
        statuses.append(sol["status"])
        xcl[:, k] = sol["x"][0, :]
        ucl[:, k] = sol["u"][0, :]
        x0 = ffunc(x0, ucl[:, k])
    xcl[:, nsim] = x0
    return xcl, ucl, statuses


def test_pendulum_script_matches_jax():
    xt, ut, st = _pendulum_script(mpc, 10)
    xj, uj, sj = _pendulum_script(j_mpc, 10)
    assert st == sj == ["Solve_Succeeded"] * 10
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-8)
    assert np.abs(ut).max() <= 200 + 1e-6


def _views_solver(m, xp):
    """The JAX test's script; its functions in the package's array module
    (torch's operators take no numpy matrix operand)."""
    def ode(x, u):
        return xp.stack([u[0] * xp.cos(x[2]), u[0] * xp.sin(x[2]), u[1]])

    F = m.getCasadiFunc(ode, [3, 2], ["x", "u"], "F", rk4=True, Delta=0.2)
    Q, R = (xp.diag(xp.asarray(d, dtype=xp.float64))
            for d in ([1.0, 1.0, 0.1], [0.5, 0.05]))

    def lfunc(x, u, p):
        return (x - p[:3]) @ Q @ (x - p[:3]) + (u - p[3:5]) @ R @ (u - p[3:5])

    l = m.getCasadiFunc(lfunc, [3, 2, 5], ["x", "u", "p"], "l")
    solver = m.nmpc(f=F, l=l, N={"x": 3, "u": 2, "t": 8, "p": 5},
                    x0=np.zeros(3), lb={"u": np.array([-1, -np.pi / 4])},
                    ub={"u": np.array([1, np.pi / 4])}, p=np.zeros((8, 5)),
                    funcargs={"l": ["x", "u", "p"]}, inferargs=True,
                    device="cpu")
    for k in range(8):
        solver.par["p", k] = np.array([1.0, 0.0, 0.0, 0.5, 0.0])
    return solver


def test_var_and_par_views_match_jax():
    """tests/test_compat.py:98: the struct views, saveguess and fixvar."""
    out = {}
    for name, m, xp in (("port", mpc, torch), ("jax", j_mpc, jnp)):
        solver = _views_solver(m, xp)
        solver.solve()
        assert solver.stats["status"] == "Solve_Succeeded"
        u0 = np.array(solver.var["u", 0, :]).flatten()
        xs = np.array(solver.var["x", :, :])
        assert u0.shape == (2,) and xs.shape == (9, 3)
        solver.saveguess()
        solver.fixvar("x", 0, solver.var["x", 1])
        solver.solve()
        assert solver.stats["status"] == "Solve_Succeeded"
        out[name] = (xs, np.array(solver.var["u", :, :]))
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)


def test_varsym_descriptors():
    F = mpc.getCasadiFunc(lambda x, u: torch.stack([u[0], x[0]]), [2, 1],
                          ["x", "u"], "F", rk4=True, Delta=0.1)
    l = mpc.getCasadiFunc(lambda x, u: (x ** 2).sum() + (u ** 2).sum(), [2, 1],
                          ["x", "u"], "l")
    solver = mpc.nmpc(f=F, l=l, N={"x": 2, "u": 1, "t": 5}, x0=np.zeros(2),
                      lb={"u": np.array([-1.0])}, ub={"u": np.array([1.0])},
                      uprev=np.array([0.0]), device="cpu")
    vs = solver.varsym
    assert len(vs["x"]) == 6 and vs["x"][0].shape == (2,)
    assert len(vs["u"]) == 5 and vs["u"][0].shape == (1,)
    assert "Du" in vs and vs["Du"][0].shape == (1,)
    assert vs["x"][0].dtype == torch.float64


def test_column_major_semantics():
    """tests/test_casadi_compat.py:49, on the port's copy of the layer."""
    d = DM(np.array([[1.0, 3.0], [2.0, 4.0]]))
    r = ca.reshape(d, 4, 1)
    np.testing.assert_allclose(r.full().ravel(), [1, 2, 3, 4])
    np.testing.assert_allclose(ca.reshape(r, -1, 2).full(), [[1, 3], [2, 4]])
    lbx = DM.zeros((6, 1))
    lbx[0:6:2] = -1.5
    lbx[1:6:2] = -0.5
    np.testing.assert_allclose(lbx.full().ravel(), [-1.5, -0.5] * 3)
    u = DM(np.arange(6.0).reshape(2, 3))
    np.testing.assert_allclose(u[:, -1].full().ravel(), [2.0, 5.0])
    np.testing.assert_allclose(
        ca.horzcat(u[:, 1:], ca.reshape(u[:, -1], -1, 1)).full(),
        np.c_[u.full()[:, 1:], u.full()[:, -1]])
    assert float(ca.norm_2(DM([3.0, 4.0]))) == pytest.approx(5.0)
    np.testing.assert_allclose(ca.repmat(DM([1.0, 2.0]), 1, 3).full(),
                               [[1, 1, 1], [2, 2, 2]])
    np.testing.assert_allclose(ca.diagcat(1.0, 5.0, 0.1).full(),
                               np.diag([1.0, 5.0, 0.1]))


def _diffdrive_symbols(c):
    x, y, theta = c.SX.sym("x"), c.SX.sym("y"), c.SX.sym("theta")
    v, omega = c.SX.sym("v"), c.SX.sym("omega")
    return (c.vertcat(x, y, theta), c.vertcat(v, omega),
            c.vertcat(v * c.cos(theta), v * c.sin(theta), omega))


def test_function_numeric_and_symbolic_paths():
    states, controls, rhs = _diffdrive_symbols(ca)
    f = ca.Function("f", [states, controls], [rhs], ["x", "u"], ["rhs"])
    np.testing.assert_allclose(f(DM([1.0, 2.0, 0.0]), DM([0.5, 0.1])).full()
                               .ravel(), [0.5, 0.0, 0.1])
    sym_out = f(states + DM([0.0, 0.0, np.pi / 2]), controls)
    assert isinstance(sym_out, SX)
    f2 = ca.Function("f2", [states, controls], [sym_out])
    np.testing.assert_allclose(f2(DM([0.0, 0.0, 0.0]), DM([1.0, 0.0])).full()
                               .ravel(), [0.0, 1.0, 0.0], atol=1e-12)
    d = f(x=DM([1.0, 2.0, 0.0]), u=DM([0.5, 0.1]))
    np.testing.assert_allclose(d["rhs"].full().ravel(), [0.5, 0.0, 0.1])
    # the nlpsol path: the graph evaluated as torch functions of tensors
    st_j, co_j, rhs_j = _diffdrive_symbols(j_ca)
    fj = j_ca.Function("f", [st_j, co_j], [rhs_j])
    x, u = np.array([0.3, -0.2, 0.7]), np.array([0.4, -0.1])
    np.testing.assert_allclose(f(DM(x), DM(u)).full(), fj(j_ca.DM(x),
                                                          j_ca.DM(u)).full(),
                               atol=1e-15)
    leaves = [n for n in states.data.ravel()] + [n for n in controls.data.ravel()]
    env = {id(n): torch.tensor(v, **F64) for n, v in zip(leaves, [*x, *u])}
    vals = ca._eval_nodes(list(rhs.data.ravel()), env, torch)
    np.testing.assert_allclose([float(v) for v in vals],
                               f(DM(x), DM(u)).full().ravel(), atol=1e-15)


def test_rk4_quadrature_function_composition():
    """tests/test_casadi_compat.py:229: RK4 of state and cost quadrature by
    Function composition, against the port's integrator."""
    states, controls, rhs = _diffdrive_symbols(ca)
    P, U = ca.SX.sym("P", 6), ca.SX.sym("U", 2)
    Qd, Rd = (1.0, 5.0, 0.1), (0.5, 0.05)
    e = states - P[3:]
    L = (e.T @ ca.diagcat(*Qd) @ e + controls.T @ ca.diagcat(*Rd) @ controls)[0, 0]
    f = ca.Function("f", [states, controls, P], [rhs, L])
    X, Qacc, M, DT = P[:3], 0, 4, 0.2 / 4
    for _ in range(M):
        k1, k1_q = f(X, U, P)
        k2, k2_q = f(X + DT / 2 * k1, U, P)
        k3, k3_q = f(X + DT / 2 * k2, U, P)
        k4, k4_q = f(X + DT * k3, U, P)
        X = X + DT / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        Qacc = Qacc + DT / 6 * (k1_q + 2 * k2_q + 2 * k3_q + k4_q)
    F = ca.Function("F", [P, U], [X, Qacc], ["x0", "p"], ["xf", "qf"])
    Fk = F(x0=ca.DM([0.0, 0.0, 0.0, 1.0, 1.0, 0.0]), p=ca.DM([0.5, 0.1]))
    Qt, Rt = torch.diag(torch.tensor(Qd, **F64)), torch.diag(torch.tensor(Rd, **F64))

    def lt(x, u, p):
        ee = x - p[:3]
        return ee @ Qt @ ee + u @ Rt @ u

    xf, qf = rk4_step_with_quadrature(unicycle.f, lt, 0.2, M=M)(
        torch.zeros(3, **F64), torch.tensor([0.5, 0.1], **F64),
        torch.tensor([1.0, 1.0, 0.0], **F64))
    np.testing.assert_allclose(Fk["xf"].full().ravel(), xf.numpy(), atol=1e-10)
    assert float(Fk["qf"]) == pytest.approx(float(qf), rel=1e-10)


def _ss_v1(c, N, **kw):
    """tests/test_casadi_compat.py:88: the single_shooting_v1 program."""
    states, controls, rhs = _diffdrive_symbols(c)
    f = c.Function("f", [states, controls], [rhs], ["x", "u"], ["rhs"])
    P, U, X = c.SX.sym("P", 6), c.SX.sym("U", 2, N), c.SX.sym("X", 3, N + 1)
    X[:, 0] = P[:3]
    for k in range(N):
        X[:, k + 1] = X[:, k] + f(X[:, k], U[:, k]) * 0.2
    ff = c.Function("ff", [U, P], [X])
    Q, R = c.diagcat(1.0, 5.0, 0.1), c.diagcat(0.5, 0.05)
    obj = 0
    for k in range(N):
        e = X[:, k] - P[3:]
        obj = obj + (e.T @ Q @ e + U[:, k].T @ R @ U[:, k])
    solver = c.nlpsol("solver", "ipopt", {
        "f": obj[0, 0], "x": c.vertcat(U.reshape((-1, 1))),
        "g": c.reshape(X, (N + 1) * 3, 1), "p": P},
        {"ipopt": {"acceptable_tol": 1e-8}}, **kw)
    lbx, ubx = c.DM.zeros((2 * N, 1)), c.DM.zeros((2 * N, 1))
    lbx[0:2 * N:2], ubx[0:2 * N:2] = -0.6, 0.6
    lbx[1:2 * N:2], ubx[1:2 * N:2] = -np.pi / 4, np.pi / 4
    return f, ff, solver, lbx, ubx


def _ss_v1_loop(c, N, steps, **kw):
    f, ff, solver, lbx, ubx = _ss_v1(c, N, **kw)
    state, target = c.DM([0.0, 0.0, 0.0]), c.DM([1.5, 1.5, 0.0])
    u0 = c.DM.zeros((2, N))
    states, us = [np.ravel(state.full())], []
    for _ in range(steps):
        p = c.vertcat(state, target)
        sol = solver(x0=c.reshape(u0, 2 * N, 1), lbx=lbx, ubx=ubx,
                     lbg=-c.inf, ubg=c.inf, p=p)
        assert solver.stats()["success"]
        u = c.reshape(sol["x"], 2, N)
        uf = u.full()
        assert (np.abs(uf[0]) <= 0.6 + 1e-9).all()
        assert (np.abs(uf[1]) <= np.pi / 4 + 1e-9).all()
        Xpred = ff(u, p)
        state = c.DM.full(state + 0.2 * f(state, u[:, 0]))
        np.testing.assert_allclose(Xpred.full()[:, 1], np.ravel(state),
                                   atol=1e-8)
        u0 = c.horzcat(u[:, 1:], c.reshape(u[:, -1], -1, 1))
        states.append(np.ravel(state))
        us.append(uf)
    return np.array(states), np.array(us)


def test_single_shooting_v1_closed_loop_matches_jax():
    xs_t, us_t = _ss_v1_loop(ca, 8, 3, device="cpu")
    xs_j, us_j = _ss_v1_loop(j_ca, 8, 3)
    np.testing.assert_allclose(us_t, us_j, rtol=0, atol=1e-8)
    np.testing.assert_allclose(xs_t, xs_j, rtol=0, atol=1e-8)
    assert np.linalg.norm(xs_t[-1] - [1.5, 1.5, 0.0]) < np.linalg.norm(
        xs_t[0] - [1.5, 1.5, 0.0])


def test_nlpsol_batch_solve_is_the_serial_solves():
    x, p = ca.SX.sym("x", 3), ca.SX.sym("p", 3)
    d = x - p
    solver = ca.nlpsol("s", "ipopt", {"f": (d.T @ d)[0, 0], "x": x, "p": p,
                                      "g": x[0] + x[1] + x[2]}, device="cpu")
    ps = np.random.default_rng(8).normal(size=(4, 3))
    res = solver.batch_solve(np.zeros((4, 3)), ps, lbg=0.0, ubg=0.0)
    assert bool(res.converged.all())
    for b in (0, 3):
        sol = solver(x0=np.zeros(3), p=ps[b], lbg=0.0, ubg=0.0)
        np.testing.assert_allclose(res.x[b].numpy(), sol["x"].full().ravel(),
                                   atol=1e-10)
    np.testing.assert_allclose(res.x.numpy(), ps - ps.mean(1, keepdims=True),
                               atol=1e-6)
