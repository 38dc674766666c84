"""Port vs JAX: unicycle rollouts of the bench OCP (RK4 and Euler), float64."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import bench
import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu.models import unicycle as j_unicycle
from mpc_verde_tpu.ops import euler_step as j_euler
from mpc_verde_tpu.solver.batched import _make_parts as j_make_parts
from mpc_verde_tpu_torch.interop import BENCH_DT, bench_ocp
from mpc_verde_tpu_torch.models import unicycle
from mpc_verde_tpu_torch.ops import euler_step
from mpc_verde_tpu_torch.solver.batched import _make_parts

N, B = 40, 6


def _ocps(integrator):
    """The bench OCP in both packages, with its dynamics swapped to Euler."""
    j_ocp = bench.build_ocp(N)
    t_ocp = bench_ocp(N, "cpu", torch.float64)
    if integrator == "euler":
        F = j_euler(j_unicycle.f, BENCH_DT)
        j_ocp = dataclasses.replace(j_ocp, dynamics=lambda x, u, p: F(x, u, p))
        t_ocp = dataclasses.replace(t_ocp,
                                    dynamics=euler_step(unicycle.f, BENCH_DT))
    return j_ocp, t_ocp


def _inputs():
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-2, 2, (B, 3))
    us = rng.uniform(-1.2, 1.2, (B, N, 2))   # some beyond the box
    ps = np.broadcast_to(np.array([10.0, 10.0, 0.0]), (B, N + 1, 3)).copy()
    return x0, us, ps


@pytest.mark.parametrize("integrator", ["rk4", "euler"])
def test_step_by_step_rollout_matches_jax(integrator):
    j_ocp, t_ocp = _ocps(integrator)
    x0, us, ps = _inputs()
    jF = jax.vmap(j_ocp.dynamics)
    tF = vmap(t_ocp.dynamics)
    xj, xt = jnp.asarray(x0), torch.as_tensor(x0)
    for k in range(N):
        xj = jF(xj, jnp.asarray(us[:, k]), jnp.asarray(ps[:, k]))
        xt = tF(xt, torch.as_tensor(us[:, k]), torch.as_tensor(ps[:, k]))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12,
                                   atol=1e-12)
    cj = jax.vmap(j_ocp.stage_cost)(xj, jnp.asarray(us[:, 0]),
                                    jnp.asarray(ps[:, 0]))
    ct = vmap(t_ocp.stage_cost)(xt, torch.as_tensor(us[:, 0]),
                                torch.as_tensor(ps[:, 0]))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-12)


@pytest.mark.parametrize("integrator", ["rk4", "euler"])
def test_preroll_matches_jax(integrator):
    """The solver's clipped rollout (the queue pre-roll) against JAX's."""
    j_ocp, t_ocp = _ocps(integrator)
    x0, us, ps = _inputs()
    xs_j, us_j, c_j = j_make_parts(j_ocp, mv.ILQROptions(), "xla",
                                   "materialize").rollout(x0, us, ps)
    xs_t, us_t, c_t = _make_parts(t_ocp, mt.ILQROptions(), "torch").rollout(
        torch.as_tensor(x0), torch.as_tensor(us), torch.as_tensor(ps))
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-12)
