"""Port vs JAX: the sharded batched solve (``parallel/``) over
``torch.distributed`` on the CPU, in float64.

World size 1 runs in this process; two ranks run as two subprocesses of
this file (``python tests/test_torch_parallel.py RANK WORLD STORE OUT``)
joined by gloo through a ``FileStore``, against JAX's ``make_sharded_solver``
on a 2-device CPU mesh (as ``tests/test_parallel.py``) on the same 16
problems.  The worker imports no JAX: JAX is imported inside the tests.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
T, N, B = 0.2, 8, 16
TARGET = (5.0, 5.0, 0.0)


def _problems():
    rng = np.random.default_rng(7)
    x0s = rng.uniform(-1, 1, (B, 3))
    params = np.broadcast_to(np.array(TARGET), (B, N + 1, 3)).copy()
    return x0s, params, np.zeros((B, N, 2))


def _ocp():
    """tests/test_parallel.py's OCP: the unicycle, RK4 at T, the box."""
    from mpc_verde_tpu_torch.interop import unicycle_ocp

    return unicycle_ocp(N, "cpu", torch.float64, dt=T,
                        Q=np.diag([1.0, 5.0, 0.1]), R=np.diag([0.5, 0.05]),
                        lb=[-1.0, -np.pi / 4], ub=[1.0, np.pi / 4])


def _solve_sharded(batched):
    """Both sharded solves on this rank's group: (local result, stats,
    gathered result)."""
    from mpc_verde_tpu_torch import make_batched_ilqr_solver, make_ilqr_solver
    from mpc_verde_tpu_torch.parallel import gather_result, make_sharded_solver

    solve = (make_batched_ilqr_solver if batched else make_ilqr_solver)(_ocp())
    args = [torch.as_tensor(a) for a in _problems()]
    res, stats = make_sharded_solver(solve, batched=batched)(*args)
    return res, stats, gather_result(res)


def _worker(rank, world, store_path, out):
    from mpc_verde_tpu_torch.parallel import distributed_init

    distributed_init(store=dist.FileStore(store_path, world), world_size=world,
                     rank=rank, backend="gloo")
    try:
        arrays = {}
        for batched in (False, True):
            res, stats, full = _solve_sharded(batched)
            tag = "batched" if batched else "loop"
            assert res.us.shape == (B // world, N, 2)
            arrays.update({f"{tag}_{k}": getattr(full, k).numpy()
                           for k in ("us", "cost", "converged")})
            arrays.update({f"{tag}_stat_{k}": np.asarray(getattr(stats, k))
                           for k in ("n_total", "n_converged", "mean_cost",
                                     "max_grad_norm", "max_iterations")})
        # the batch must split evenly over the ranks (both raise, before
        # any collective)
        from mpc_verde_tpu_torch import make_batched_ilqr_solver
        from mpc_verde_tpu_torch.parallel import make_sharded_solver

        odd = [torch.as_tensor(a)[:B - 1] for a in _problems()]
        try:
            make_sharded_solver(make_batched_ilqr_solver(_ocp()),
                                batched=True)(*odd)
        except ValueError:
            arrays["odd_batch_refused"] = np.array(True)
        if rank == 0:
            np.savez(out, **arrays)
    finally:
        dist.destroy_process_group()


def test_world_size_one_in_process(tmp_path):
    """One rank on gloo: the sharded solves equal the unsharded batched
    solve, and the statistics its local reductions."""
    from mpc_verde_tpu_torch import make_batched_ilqr_solver
    from mpc_verde_tpu_torch.parallel import batch_group, distributed_init

    store = dist.FileStore(str(tmp_path / "store"), 1)
    group = distributed_init(store=store, world_size=1, rank=0,
                             backend="gloo")
    try:
        assert distributed_init() is group   # safe to call twice
        assert batch_group() is group and batch_group(1) is group
        ref = make_batched_ilqr_solver(_ocp())(
            *[torch.as_tensor(a) for a in _problems()])
        for batched in (False, True):
            res, stats, full = _solve_sharded(batched)
            if batched:
                assert torch.equal(res.us, ref.us)
                assert torch.equal(res.cost, ref.cost)
            else:
                torch.testing.assert_close(res.us, ref.us, rtol=0, atol=1e-9)
            assert torch.equal(full.us, res.us)
            assert int(stats.n_total) == B
            assert int(stats.n_converged) == int(res.converged.sum())
            assert float(stats.mean_cost) == float(res.cost.sum() / B)
            assert float(stats.max_grad_norm) == float(res.grad_norm.max())
            assert int(stats.max_iterations) == int(res.iterations.max())
    finally:
        dist.destroy_process_group()


def test_two_ranks_on_gloo_match_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    import mpc_verde_tpu as mv
    from mpc_verde_tpu.models import unicycle
    from mpc_verde_tpu.ops import rk4_step
    from mpc_verde_tpu.parallel import batch_mesh
    from mpc_verde_tpu.parallel import make_sharded_solver as j_sharded

    store, out = tmp_path / "store", tmp_path / "out.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), "2", str(store), str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]

    # JAX on a 2-device CPU mesh, while the ranks run
    F = rk4_step(unicycle.f, T)
    Q = jnp.diag(jnp.array([1.0, 5.0, 0.1]))
    R = jnp.diag(jnp.array([0.5, 0.05]))

    def l(x, u, p):
        e = x - p[:3]
        return e @ Q @ e + u @ R @ u

    ocp = mv.OCP(dynamics=lambda x, u, p: F(x, u, p), stage_cost=l, N=N,
                 nx=3, nu=2, npar=3,
                 control_bounds=mv.box_bounds(jnp.array([-1.0, -np.pi / 4]),
                                              jnp.array([1.0, np.pi / 4])))
    j_res, j_stats = j_sharded(mv.make_ilqr_solver(ocp), batch_mesh(2))(
        *[jnp.asarray(a) for a in _problems()])

    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
    got = np.load(out)
    assert bool(got["odd_batch_refused"])
    for tag in ("loop", "batched"):
        np.testing.assert_allclose(got[f"{tag}_us"], np.asarray(j_res.us),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(got[f"{tag}_cost"], np.asarray(j_res.cost),
                                   rtol=1e-9, atol=0)
        np.testing.assert_array_equal(got[f"{tag}_converged"],
                                      np.asarray(j_res.converged))
        assert int(got[f"{tag}_stat_n_total"]) == int(j_stats.n_total) == B
        assert int(got[f"{tag}_stat_n_converged"]) == int(j_stats.n_converged)
        assert int(got[f"{tag}_stat_max_iterations"]) == int(
            j_stats.max_iterations)
        np.testing.assert_allclose(got[f"{tag}_stat_mean_cost"],
                                   float(j_stats.mean_cost), rtol=1e-12)
        np.testing.assert_allclose(got[f"{tag}_stat_max_grad_norm"],
                                   float(j_stats.max_grad_norm), rtol=1e-6,
                                   atol=1e-12)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
