"""Port vs JAX: the exact stage box QP and its free-subspace gain, nu = 1..4, float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_verde_tpu.solver.boxqp import solve_boxqp as j_solve_boxqp
from mpc_verde_tpu.solver.ilqr import _stage_boxqp_with_gain as j_gain
from mpc_verde_tpu_torch.solver.boxqp import solve_boxqp
from mpc_verde_tpu_torch.solver.ilqr import _stage_boxqp_with_gain

NX, B = 3, 48


def _problems(nu):
    """Random SPD stage QPs: a third with a box that binds, a third pinned
    by lb = ub (move blocking), a third unbounded."""
    rng = np.random.default_rng(10 + nu)
    A = rng.normal(size=(B, nu, nu))
    H = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(nu)
    g = 2.0 * rng.normal(size=(B, nu))
    Qux = rng.normal(size=(B, nu, NX))
    lb = np.full((B, nu), -0.7)
    ub = np.full((B, nu), 0.5)
    lb[B // 3:2 * B // 3] = ub[B // 3:2 * B // 3] = 0.2
    lb[2 * B // 3:] = -np.inf
    ub[2 * B // 3:] = np.inf
    return H, g, Qux, lb, ub


@pytest.mark.parametrize("nu", [1, 2, 3, 4])
def test_boxqp_matches_jax(nu):
    H, g, Qux, lb, ub = _problems(nu)
    v_j, m_j = jax.vmap(j_solve_boxqp)(*(jnp.asarray(a) for a in (H, g, lb, ub)))
    k_j, K_j, f_j = jax.vmap(lambda *a: j_gain(*a, 1e-8))(
        *(jnp.asarray(a) for a in (H, g, Qux, lb, ub)))
    t = torch.as_tensor
    v_t, m_t = solve_boxqp(t(H), t(g), t(lb), t(ub))
    k_t, K_t, f_t = _stage_boxqp_with_gain(t(H), t(g), t(Qux), t(lb), t(ub),
                                           1e-8)

    # the box binds somewhere, and pinned stages sit on their bound
    assert (m_t[:B // 3] == 0).any()
    np.testing.assert_array_equal(v_t[B // 3:2 * B // 3].numpy(), 0.2)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-10)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), atol=1e-10)
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), atol=1e-10)


def test_nu5_rejected():
    with pytest.raises(NotImplementedError):
        solve_boxqp(torch.eye(5), torch.zeros(5), torch.zeros(5),
                    torch.ones(5))
