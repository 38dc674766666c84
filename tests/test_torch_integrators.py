"""Port vs JAX: the integrators, the linear model and the reference
generators, float64 on the same numpy inputs.

``rk4_step_with_quadrature``, ``discretize`` and ``DiscreteSimulator`` run
the JAX step's floating-point operations in the same order (1e-12);
``c2d``'s matrix exponential is another algorithm than ``jsl.expm``
(1e-12); ``rk45_step``'s adaptive loop accepts and rejects the same
substeps, single and batched (1e-10).  ``refgen`` is a numpy copy: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import mpc_verde_tpu.ops as jops
import mpc_verde_tpu.refgen as jref
from mpc_verde_tpu.models import linear_model as j_linear_model
from mpc_verde_tpu.models import unicycle as j_unicycle
from mpc_verde_tpu_torch import ops
from mpc_verde_tpu_torch import refgen
from mpc_verde_tpu_torch.models import LinearModel, linear_model, unicycle

Q = np.diag([1.0, 5.0, 0.1])
R = np.diag([0.5, 0.05])


def _states(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 2, (n, 3)), rng.uniform(-1, 1, (n, 2)),
            rng.uniform(-5, 5, (n, 3)))


def _close(a, b, tol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("M", [1, 4])
def test_rk4_step_with_quadrature_matches_jax(M):
    def L_t(x, u, p):
        e = x - p[:3]
        return e @ torch.as_tensor(Q) @ e + u @ torch.as_tensor(R) @ u

    def L_j(x, u, p):
        e = x - p[:3]
        return e @ Q @ e + u @ R @ u

    x, u, p = _states(32, 1)
    t = torch.as_tensor
    xq_t = vmap(ops.rk4_step_with_quadrature(unicycle.f, L_t, 0.2, M=M))(
        t(x), t(u), t(p))
    xq_j = jax.vmap(jops.rk4_step_with_quadrature(j_unicycle.f, L_j, 0.2, M=M))(
        x, u, p)
    for a, b in zip(xq_t, xq_j):
        _close(a.numpy(), b)


@pytest.mark.parametrize("method,M", [("euler", 1), ("rk4", 1), ("rk4", 3)])
def test_discretize_matches_jax(method, M):
    x, u, p = _states(32, 2)
    t = torch.as_tensor
    F_t = ops.discretize(unicycle, 0.2, method=method, M=M)
    F_j = jops.discretize(j_unicycle, 0.2, method=method, M=M)
    _close(vmap(F_t)(t(x), t(u), t(p)).numpy(), jax.vmap(F_j)(x, u, p))
    with pytest.raises(ValueError, match="unknown integration method"):
        ops.discretize(unicycle, 0.2, method="rk2")


def test_c2d_matches_jax_expm():
    rng = np.random.default_rng(3)
    Ac, Bc = rng.normal(size=(4, 4)), rng.normal(size=(4, 2))
    for a, b in zip(ops.c2d(Ac, Bc, 0.1), jops.c2d(Ac, Bc, 0.1)):
        _close(a.numpy(), b)
    # batched over leading dimensions, as the LTV scenarios call it
    Ab, Bb = rng.normal(size=(5, 3, 3)), rng.normal(size=(5, 3, 1))
    for a, b in zip(ops.c2d(torch.as_tensor(Ab), torch.as_tensor(Bb), 0.05),
                    jops.c2d(Ab, Bb, 0.05)):
        _close(a.numpy(), b)


@pytest.mark.parametrize("batched", [False, True])
def test_rk45_step_matches_jax(batched):
    """One interval of the adaptive Dormand-Prince step: single, and a batch
    whose members need different numbers of substeps (the JAX step under
    vmap runs them lockstep; the port masks each member's own loop); a
    member with a short max_steps keeps its partly advanced state."""
    x, u, _ = _states(6, 4)
    u = u * np.array([4.0, 6.0])      # fast turns: several substeps
    kw = dict(rtol=1e-9, atol=1e-11)
    for max_steps in (1000, 3):
        step_t = ops.rk45_step(unicycle.f, 0.5, max_steps=max_steps, **kw)
        step_j = jops.rk45_step(j_unicycle.f, 0.5, max_steps=max_steps, **kw)
        if batched:
            out_t = step_t(torch.as_tensor(x), torch.as_tensor(u))
            out_j = jax.jit(jax.vmap(step_j))(x, u)
        else:
            out_t = step_t(torch.as_tensor(x[0]), torch.as_tensor(u[0]))
            out_j = jax.jit(step_j)(x[0], u[0])
        assert out_t.shape == np.shape(out_j)
        _close(out_t.numpy(), out_j, 1e-10)
    # the adaptive step lands on the fine fixed-step answer
    fine = ops.rk4_step(unicycle.f, 0.5, M=200)(torch.as_tensor(x[0]),
                                                torch.as_tensor(u[0]))
    full = ops.rk45_step(unicycle.f, 0.5, **kw)(torch.as_tensor(x[0]),
                                                 torch.as_tensor(u[0]))
    _close(full.numpy(), fine.numpy(), 1e-8)


@pytest.mark.parametrize("method", ["rk4", "rk45"])
def test_discrete_simulator_matches_jax(method):
    x, u, _ = _states(8, 5)
    sim_t = ops.DiscreteSimulator(unicycle, 0.2, M=10, method=method)
    sim_j = jops.DiscreteSimulator(j_unicycle, 0.2, M=10, method=method)
    tol = 1e-12 if method == "rk4" else 1e-10
    _close(sim_t.sim(x[0], u[0]).numpy(), sim_j.sim(x[0], u[0]), tol)
    # a batch in one call, against the JAX simulator per member
    _close(sim_t(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
           jax.vmap(sim_j.sim)(x, u), tol)
    with pytest.raises(ValueError, match="unknown DiscreteSimulator method"):
        ops.DiscreteSimulator(unicycle, 0.2, method="euler")


def test_linear_model_matches_jax():
    rng = np.random.default_rng(6)
    Ac, Bc = rng.normal(size=(4, 4)), rng.normal(size=(4, 2))
    m_t = linear_model(Ac, Bc, name="lti", device="cpu", dtype=torch.float64)
    m_j = j_linear_model(Ac, Bc, name="lti")
    assert isinstance(m_t, LinearModel)
    assert (m_t.nx, m_t.nu, m_t.np, m_t.name) == (m_j.nx, m_j.nu, m_j.np, m_j.name)
    np.testing.assert_array_equal(m_t.Ac.numpy(), np.asarray(m_j.Ac))
    np.testing.assert_array_equal(m_t.Bc.numpy(), np.asarray(m_j.Bc))
    x, u = rng.normal(size=(16, 4)), rng.normal(size=(16, 2))
    _close(vmap(m_t)(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
           jax.vmap(m_j)(x, u))
    # its continuous matrices discretize as the JAX model's do
    for a, b in zip(ops.c2d(m_t.Ac, m_t.Bc, 0.1), jops.c2d(m_j.Ac, m_j.Bc, 0.1)):
        _close(a.numpy(), b)
    assert linear_model(Ac, Bc, device="cpu").Ac.dtype == torch.float32


def test_refgen_is_the_jax_generators():
    times = 0.2 * np.arange(40)
    np.testing.assert_array_equal(refgen.circular_reference_params(times, 10, 0.2),
                                  jref.circular_reference_params(times, 10, 0.2))
    # fewer sim steps than horizon stages: both assert
    for mod in (refgen, jref):
        with pytest.raises(AssertionError):
            mod.circular_reference_params(times[:8], 10, 0.2)
    for name in ("synthetic_lane_change", "extend_lane_change_course",
                 "double_lane_change_course"):
        a, b = getattr(refgen, name)(), getattr(jref, name)()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}[{k}]")
