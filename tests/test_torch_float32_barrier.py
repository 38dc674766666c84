"""The port's float32 barrier paths at N = 40 against JAX float64.

On the bench OCP at N = 40 the port's float32 twin lands on the float64
answers of the interior-point and barrier + AL paths, where JAX's own
float32 does not.  Measured over the first 128 starts of
``default_rng(0).uniform(-2, 2)`` (budgets 60 iterations, 2 restarts), mean
iterations, float64 (both packages) / JAX float32 / port float32: IPM cold
37.375 / 44.391 / 37.383, IPM hybrid 22.484 / 32.586 / 25.852; barrier + AL
with the box y <= 5 and six AL rounds over 64 starts: max_violation 6.0e-4 /
0.547 / 4.9e-4, iterations 120.5 / 128.2 / 124.0.  These tests hold the
port's float32 "torch" path on the first 8 of those starts against JAX
float64 on the same 8, with margins between the port's float32 and JAX's
float32 behaviour, so that the port cannot drift to the latter unseen:
mean iterations at most 1.10x float64 (cold, barrier + AL) and 1.30x
(hybrid), every problem converged, final costs within 1e-4 relative of
float64 (barrier + AL 1e-3), and max_violation at most 2e-3 and at most 5x
float64's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import bench
import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu.solver.ipm import \
    make_streaming_barrier_solver as j_streaming_barrier
from mpc_verde_tpu_torch.interop import bench_ocp

N, M = 40, 8
OPTS = dict(max_iters=60, tol_grad=1e-4, tol_cost=1e-6, n_alphas=8,
            alpha_decay=0.4)
Y_MAX = 5.0
CASES = {  # (solver keywords, AL rounds, iteration margin, cost margin)
    "cold": ({}, 0, 1.10, 1e-4),
    "hybrid": (dict(mu_schedule=(1e-4,), warmstart="ddp"), 0, 1.30, 1e-4),
    "barrier_al": ({}, 6, 1.10, 1e-3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_float32_barrier_path_against_jax_float64(case):
    kw, al_iters, it_margin, cost_margin = CASES[case]
    kw = dict(batch_width=M, restarts=2, inexact_kappa=10.0, **kw)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-2.0, 2.0, (M, 3))
    ps = np.broadcast_to(np.array([10.0, 10.0, 0.0]), (M, N + 1, 3)).copy()
    us0 = np.zeros((M, N, 2))
    box = [np.inf, Y_MAX, np.inf] if al_iters else None

    j_ocp = bench.build_ocp(N)
    if box is not None:
        j_ocp = dataclasses.replace(j_ocp, x_ub=np.array(box))
    res_j = jax.jit(j_streaming_barrier(
        j_ocp, mv.ILQROptions(**OPTS, al_iters=al_iters), backend="xla",
        **kw))(x0, ps, us0)
    res_t = mt.make_streaming_barrier_solver(
        bench_ocp(N, "cpu", torch.float32, x_ub=box),
        mt.ILQROptions(**OPTS, al_iters=al_iters), **kw)(x0, ps, us0)

    assert res_t.cost.dtype == torch.float32
    assert bool(np.asarray(res_j.converged).all())
    assert bool(res_t.converged.all())
    it_j = float(np.asarray(res_j.iterations).mean())
    it_t = float(res_t.iterations.double().mean())
    assert it_t <= it_margin * it_j, (it_t, it_j)
    cost_j = np.asarray(res_j.cost)
    rel = np.abs(res_t.cost.double().numpy() - cost_j) / np.abs(cost_j)
    assert rel.max() <= cost_margin, rel.max()
    if al_iters:
        viol_j = float(np.asarray(res_j.max_violation).max())
        viol_t = float(res_t.max_violation.max())
        assert viol_t <= 2e-3 and viol_t <= 5.0 * viol_j, (viol_t, viol_j)
        # the box binds: the unconstrained trajectories pass y = 5
        assert float(res_t.xs[..., 1].amax()) >= Y_MAX - 1e-2
