"""Port vs JAX: stage derivatives along a trajectory, float64.

Every entry of fx ... fuu against ``linearize_trajectory(second_order=True)``,
and the solver's whole derivative step (terminal gN/HN and the delta bounds)
on the bench OCP with a quadratic terminal cost added.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu.ops import linearize_trajectory as j_linearize
from mpc_verde_tpu.solver.batched import _make_parts as j_make_parts
from mpc_verde_tpu_torch.interop import bench_ocp
from mpc_verde_tpu_torch.ops import linearize_trajectory
from mpc_verde_tpu_torch.solver.batched import _make_parts

N, B = 7, 5
KEYS = ("fx", "fu", "lx", "lu", "lxx", "luu", "lux", "fxx", "fux", "fuu")
QF = np.diag([2.0, 10.0, 0.2])


def _traj():
    rng = np.random.default_rng(21)
    xs = rng.uniform(-2, 2, (B, N + 1, 3))
    us = rng.uniform(-1, 1, (B, N, 2))
    ps = np.concatenate([rng.uniform(5, 10, (B, N + 1, 2)),
                         rng.uniform(-1, 1, (B, N + 1, 1))], axis=-1)
    return xs, us, ps


@pytest.mark.parametrize("key", KEYS)
def test_linearize_trajectory_matches_jax(key):
    j_ocp, t_ocp = bench.build_ocp(N), bench_ocp(N, "cpu", torch.float64)
    xs, us, ps = _traj()
    d_j = j_linearize(j_ocp.dynamics, j_ocp.stage_cost, jnp.asarray(xs[0, :N]),
                      jnp.asarray(us[0]), jnp.asarray(ps[0, :N]),
                      second_order=True)
    d_t = linearize_trajectory(t_ocp.dynamics, t_ocp.stage_cost,
                               torch.as_tensor(xs[0, :N]), torch.as_tensor(us[0]),
                               torch.as_tensor(ps[0, :N]), second_order=True)
    assert tuple(d_t[key].shape) == np.asarray(d_j[key]).shape
    np.testing.assert_allclose(d_t[key].numpy(), np.asarray(d_j[key]),
                               atol=1e-10)


def test_solver_derivs_match_jax():
    """(d, gN, HN, dlb, dub) of the batched solver's derivative step."""
    Qj = jnp.asarray(QF)
    j_ocp = dataclasses.replace(
        bench.build_ocp(N),
        terminal_cost=lambda x, p: (x - p[:3]) @ Qj @ (x - p[:3]))
    Qt = torch.as_tensor(QF)
    t_ocp = dataclasses.replace(
        bench_ocp(N, "cpu", torch.float64),
        terminal_cost=lambda x, p: (x - p[:3]) @ Qt @ (x - p[:3]))
    xs, us, ps = _traj()
    d_j, *rest_j = j_make_parts(j_ocp, mv.ILQROptions(), "xla",
                                "materialize").derivs(xs, us, ps)
    d_t, *rest_t = _make_parts(t_ocp, mt.ILQROptions(), "torch").derivs(
        *(torch.as_tensor(a) for a in (xs, us, ps)))
    for k in KEYS:
        np.testing.assert_allclose(d_t[k].numpy(), np.asarray(d_j[k]),
                                   atol=1e-10, err_msg=k)
    for name, a, b in zip(("gN", "HN", "dlb", "dub"), rest_t, rest_j):
        assert np.abs(np.asarray(b)).max() > 0, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10,
                                   err_msg=name)
