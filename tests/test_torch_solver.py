"""Port vs JAX: the batched and streaming box-DDP solvers on the bench OCP, float64.

The port's ``"torch"`` backend against JAX ``backend="xla"`` (converged
equal, iterations within one, us to 1e-6, cost to 1e-8 relative); the
port's streaming solver against its own batched solver per problem; and the
``"cuda"`` backend on CPU tensors (every kernel wrapper runs its twin)
against ``"torch"``.
"""
import jax
import numpy as np
import pytest
import torch

import bench
import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu.solver.batched import make_batched_ilqr_solver as j_batched
from mpc_verde_tpu.solver.streaming import make_streaming_solver as j_streaming
from mpc_verde_tpu_torch.interop import bench_ocp, from_numpy, result_to_numpy

N, M, W = 10, 12, 4
OPTS = dict(max_iters=60, tol_grad=1e-4, tol_cost=1e-6, n_alphas=8,
            alpha_decay=0.4)


def _queue():
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-2.0, 2.0, (M, 3))
    ps = np.broadcast_to(np.array([10.0, 10.0, 0.0]), (M, N + 1, 3)).copy()
    return x0, ps, np.zeros((M, N, 2))


def _assert_close_to_jax(res_t, res_j):
    rj = from_numpy(res_j, "cpu", torch.float64)
    rt = res_t
    np.testing.assert_array_equal(rt.converged.numpy(), rj.converged.numpy())
    assert rt.converged.all()
    assert (rt.iterations - rj.iterations).abs().max() <= 1
    np.testing.assert_allclose(rt.us.numpy(), rj.us.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rt.cost.numpy(), rj.cost.numpy(), rtol=1e-8)


def test_batched_matches_jax():
    x0, ps, us0 = (a[:8] for a in _queue())
    res_j = jax.jit(j_batched(bench.build_ocp(N), mv.ILQROptions(**OPTS),
                              backend="xla"))(x0, ps, us0)
    res_t = mt.make_batched_ilqr_solver(
        bench_ocp(N, "cpu", torch.float64), mt.ILQROptions(**OPTS))(x0, ps, us0)
    _assert_close_to_jax(res_t, res_j)


@pytest.mark.parametrize("refill_every", [1, 2])
def test_streaming_matches_jax(refill_every):
    x0, ps, us0 = _queue()
    res_j = jax.jit(j_streaming(bench.build_ocp(N), mv.ILQROptions(**OPTS),
                                backend="xla", batch_width=W, restarts=2,
                                refill_every=refill_every))(x0, ps, us0)
    res_t = mt.make_streaming_solver(
        bench_ocp(N, "cpu", torch.float64), mt.ILQROptions(**OPTS),
        batch_width=W, restarts=2, refill_every=refill_every)(x0, ps, us0)
    _assert_close_to_jax(res_t, res_j)


def test_streaming_equals_batched():
    """Refills, restarts and cadence change the schedule, not the results."""
    ocp = bench_ocp(N, "cpu", torch.float64)
    opts = mt.ILQROptions(**OPTS)
    x0, ps, us0 = _queue()
    rb = result_to_numpy(mt.make_batched_ilqr_solver(ocp, opts)(x0, ps, us0))
    rs = result_to_numpy(mt.make_streaming_solver(
        ocp, opts, batch_width=W, refill_every=3)(x0, ps, us0))
    assert rs.converged.all()
    np.testing.assert_array_equal(rs.iterations, rb.iterations)
    np.testing.assert_array_equal(rs.converged, rb.converged)
    np.testing.assert_allclose(rs.cost, rb.cost, rtol=1e-13)
    np.testing.assert_allclose(rs.us, rb.us, rtol=0, atol=1e-12)
    np.testing.assert_allclose(rs.xs, rb.xs, rtol=0, atol=1e-12)


def test_cuda_backend_on_cpu_runs_the_twins():
    ocp = bench_ocp(N, "cpu", torch.float32)
    opts = mt.ILQROptions(**OPTS)
    x0, ps, us0 = (a.astype(np.float32) for a in _queue())
    r_cuda = mt.make_streaming_solver(ocp, opts, backend="cuda",
                                      batch_width=W, restarts=2)(x0, ps, us0)
    r_torch = mt.make_streaming_solver(ocp, opts, backend="torch",
                                       batch_width=W, restarts=2)(x0, ps, us0)
    for name in ("xs", "us", "cost", "iterations", "converged"):
        assert torch.equal(getattr(r_cuda, name), getattr(r_torch, name)), name


def test_unported_options_raise():
    ocp = bench_ocp(N, "cpu", torch.float64)
    with pytest.raises(NotImplementedError):
        mt.make_streaming_solver(ocp, rounds=(2, lambda ps, xs, r: ps))
    with pytest.raises(NotImplementedError):
        mt.make_streaming_solver(ocp, tol_scale_fn=lambda ps: ps[:, 0, 0])
    bounded = mt.OCP(**{**ocp.__dict__, "x_lb": torch.zeros(3)})
    with pytest.raises(NotImplementedError):
        mt.make_batched_ilqr_solver(bounded)
    with pytest.raises(TypeError):
        mt.make_batched_ilqr_solver(ocp, backend="cuda")   # float64 OCP
