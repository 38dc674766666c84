"""Port vs JAX, float64: the augmented-Lagrangian projected-Newton NLP
solver (``solver/nlp.py``) on the seven cases of ``tests/test_nlp.py``.

Each case runs the JAX solve (jitted; ``jax.vmap`` for the batch) and the
port's on the same numpy data: converged flags equal; x, f, the
multipliers, the KKT and violation norms to 1e-8 (the solvers' own
tolerance); and the JAX test's own claim on the port's answer at its
tolerance.  The inner iteration counts are not compared: near the solution
an inner step is accepted on an augmented-Lagrangian decrease of 1e-16, a
round-off-level event, so on the nonlinear constraint the two packages'
counts differ by tens while their answers agree far inside 1e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import minimize, rosen, rosen_der

from mpc_verde_tpu.solver.nlp import make_nlpsol as j_nlpsol
from mpc_verde_tpu_torch.solver.nlp import NLPOptions, NLPResult, make_nlpsol

T = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _spd(rng, n):
    M = rng.normal(size=(n, n))
    return M @ M.T + n * np.eye(n)


def _quadratic(rng, n):
    Q, c = _spd(rng, n), rng.normal(size=n)
    return Q, c, (lambda asarray: lambda x, p: 0.5 * x @ asarray(Q) @ x
                  + asarray(c) @ x)


def _unconstrained():
    Q, c, f = _quadratic(np.random.default_rng(0), 7)
    return dict(f=f, g=None, n=7, m=0, args=(np.zeros(7),),
                check=lambda r: np.testing.assert_allclose(
                    r.x.numpy(), np.linalg.solve(Q, -c), atol=1e-7))


def _box_quadratic():
    rng = np.random.default_rng(1)
    n = 6
    Q, c = _spd(rng, n), 3.0 * rng.normal(size=n)
    lb, ub = -0.3 * np.ones(n), 0.4 * np.ones(n)
    ref = minimize(lambda x: 0.5 * x @ Q @ x + c @ x, np.zeros(n),
                   jac=lambda x: Q @ x + c, bounds=list(zip(lb, ub)),
                   method="L-BFGS-B", options={"ftol": 1e-15, "gtol": 1e-12})
    return dict(f=lambda asarray: lambda x, p: 0.5 * x @ asarray(Q) @ x
                + asarray(c) @ x, g=None, n=n, m=0,
                args=(np.zeros(n), None, lb, ub),
                check=lambda r: np.testing.assert_allclose(r.x.numpy(), ref.x,
                                                           atol=1e-6))


def _equality_qp():
    rng = np.random.default_rng(2)
    n, m = 8, 3
    Q, c = _spd(rng, n), rng.normal(size=n)
    A, b = rng.normal(size=(m, n)), rng.normal(size=m)
    sol = np.linalg.solve(np.block([[Q, A.T], [A, np.zeros((m, m))]]),
                          np.concatenate([-c, b]))

    def check(r):
        np.testing.assert_allclose(r.x.numpy(), sol[:n], atol=1e-6)
        np.testing.assert_allclose(r.lam_g.numpy(), sol[n:], atol=1e-4)

    return dict(f=lambda asarray: lambda x, p: 0.5 * x @ asarray(Q) @ x
                + asarray(c) @ x,
                g=lambda asarray: lambda x, p: asarray(A) @ x - asarray(b),
                n=n, m=m, args=(np.zeros(n), None, None, None, np.zeros(m),
                                np.zeros(m)), check=check)


def _active_inequality():
    t = (2.0 - 1.0 - 0.5) / 2.0

    def check(r):
        np.testing.assert_allclose(r.x.numpy(), [2.0 - t, -1.0 - t], atol=1e-6)
        assert float(r.lam_g[0]) > 0

    return dict(f=lambda asarray: lambda x, p: (x[0] - 2.0) ** 2
                + (x[1] + 1.0) ** 2,
                g=lambda asarray: lambda x, p: (x[0] + x[1]).reshape(1),
                n=2, m=1, args=(np.zeros(2), None, None, None, None,
                                np.array([0.5])), check=check)


def _rosenbrock():
    n = 4
    lb, ub = np.full(n, -0.5), np.full(n, 0.8)
    ref = minimize(rosen, np.zeros(n), jac=rosen_der, bounds=list(zip(lb, ub)),
                   method="L-BFGS-B", options={"ftol": 1e-15, "gtol": 1e-12})
    return dict(f=lambda asarray: lambda x, p: (
                    100.0 * (x[1:] - x[:-1] ** 2) ** 2
                    + (1.0 - x[:-1]) ** 2).sum(),
                g=None, n=n, m=0, args=(np.zeros(n), None, lb, ub),
                check=lambda r: np.testing.assert_allclose(r.x.numpy(), ref.x,
                                                           atol=1e-6))


def _nonlinear_constraint():
    return dict(f=lambda asarray: lambda x, p: -(x[0] + x[1]),
                g=lambda asarray: lambda x, p: (x[0] ** 2 + x[1] ** 2).reshape(1),
                n=2, m=1, args=(np.array([0.5, 0.1]), None, None, None,
                                np.ones(1), np.ones(1)),
                check=lambda r: np.testing.assert_allclose(
                    r.x.numpy(), np.ones(2) / np.sqrt(2), atol=1e-6))


CASES = {"unconstrained": _unconstrained, "box": _box_quadratic,
         "equality": _equality_qp, "active_inequality": _active_inequality,
         "rosenbrock": _rosenbrock, "nonlinear_constraint": _nonlinear_constraint}


def _assert_same(rt: NLPResult, rj):
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    assert bool(rt.converged.all())
    for k in ("x", "f", "g", "lam_g", "kkt", "viol"):
        np.testing.assert_allclose(getattr(rt, k).numpy(),
                                   np.asarray(getattr(rj, k)), rtol=0,
                                   atol=1e-8, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_case_matches_jax(case):
    c = CASES[case]()
    g = lambda asarray: None if c["g"] is None else c["g"](asarray)
    args = c["args"]
    rj = jax.jit(j_nlpsol(c["f"](jnp.asarray), g(jnp.asarray), c["n"],
                          c["m"]))(*args)
    rt = make_nlpsol(c["f"](T), g(T), c["n"], c["m"], device="cpu")(*args)
    _assert_same(rt, rj)
    c["check"](rt)


def test_batch_matches_jax_vmap():
    """tests/test_nlp.py:98: one solver, 16 shifted problems; the port's
    leading batch axis against jax.vmap of the JAX solve."""
    targets = np.random.default_rng(3).normal(size=(16, 3))
    f = lambda x, p: ((x - p) ** 2).sum()
    j_solve = j_nlpsol(f, lambda x, p: jnp.array([jnp.sum(x)]), 3, 1)
    rj = jax.jit(jax.vmap(lambda p: j_solve(
        jnp.zeros(3), p=p, lbg=jnp.zeros(1), ubg=jnp.zeros(1))))(targets)
    solve = make_nlpsol(f, lambda x, p: x.sum().reshape(1), 3, 1,
                        device="cpu")
    rt = solve(np.zeros((16, 3)), targets, lbg=np.zeros(1), ubg=np.zeros(1))
    _assert_same(rt, rj)
    np.testing.assert_allclose(rt.x.numpy(),
                               targets - targets.mean(1, keepdims=True),
                               atol=1e-6)
    # each batch member is its own single solve
    one = solve(np.zeros(3), targets[5], lbg=np.zeros(1), ubg=np.zeros(1))
    np.testing.assert_allclose(one.x.numpy(), rt.x[5].numpy(), atol=1e-12)


def test_options_default_like_jax():
    from mpc_verde_tpu.solver.nlp import NLPOptions as JOptions

    assert NLPOptions().__dict__ == JOptions().__dict__
