"""Port vs JAX: the fused line search (the twin of CUDA kernel K2).

``linesearch_forward`` (the twin, for CPU tensors) against the Pallas kernel
in interpret mode in float32 at the shapes of tests/test_pallas_rollout.py,
and against the JAX materialising XLA line search in float64; and the
kernel's device-model formulas, as ``csrc/rollout.cu`` computes them,
against the OCP's own callables.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch.func import vmap

import bench
import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu.ops.pallas.rollout import linesearch_forward_pallas
from mpc_verde_tpu.solver.batched import _make_parts as j_make_parts
from mpc_verde_tpu_torch.interop import BENCH_DT, bench_ocp
from mpc_verde_tpu_torch.models import unicycle
from mpc_verde_tpu_torch.ops import euler_step, rk4_step
from mpc_verde_tpu_torch.ops.cuda.rollout import (linesearch_forward,
                                                  linesearch_forward_torch)

NX, NU, NPAR, N, B = 3, 2, 3, 5, 3
QF = np.diag(np.array([2.0, 10.0, 0.2], np.float32))


def _ocps(N, dtype):
    """The bench OCP plus a terminal cost, in both packages."""
    Qj = jnp.asarray(QF)
    j_ocp = dataclasses.replace(
        bench.build_ocp(N),
        terminal_cost=lambda x, p: (x - p[:3]) @ Qj @ (x - p[:3]))
    t_ocp = bench_ocp(N, "cpu", dtype)
    Qt = torch.as_tensor(QF, dtype=dtype)
    t_ocp = dataclasses.replace(
        t_ocp, terminal_cost=lambda x, p: (x - p[:3]) @ Qt @ (x - p[:3]),
        device_model=dataclasses.replace(t_ocp.device_model, Qf=QF))
    return j_ocp, t_ocp


def _data(N, B, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 2, (B, NX)), rng.uniform(-2, 2, (B, N + 1, NX)),
            rng.uniform(-0.8, 0.8, (B, N, NU)),
            np.broadcast_to(np.array([10.0, 10.0, 0.0]), (B, N + 1, NPAR)).copy(),
            0.3 * rng.normal(size=(B, N, NU)),
            0.2 * rng.normal(size=(B, N, NU, NX)))


def test_wrapper_matches_pallas_interpret():
    j_ocp, t_ocp = _ocps(N, torch.float32)
    data = _data(N, B)
    alphas = tuple(0.4 ** i for i in range(6))
    cb = j_ocp.control_bounds
    with pltpu.force_tpu_interpret_mode():
        xs_p, us_p, c_p = linesearch_forward_pallas(
            *(jnp.asarray(a, jnp.float32) for a in data), alphas=alphas,
            dynamics=j_ocp.dynamics, stage_cost=j_ocp.stage_cost,
            terminal_cost=j_ocp.terminal_cost, control_bounds=cb,
            nx=NX, nu=NU)
    xs_t, us_t, c_t, _ = linesearch_forward(
        *(torch.as_tensor(a, dtype=torch.float32) for a in data), alphas,
        ocp=t_ocp)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_p), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_p), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_p), rtol=1e-5)


def test_twin_matches_jax_materialize():
    NL, BL = 12, 16
    j_ocp, t_ocp = _ocps(NL, torch.float64)
    data = _data(NL, BL, seed=8)
    xs_j, us_j, c_j = j_make_parts(
        j_ocp, mv.ILQROptions(n_alphas=8, alpha_decay=0.4), "xla",
        "materialize").linesearch(*data)
    parts = mt.solver.batched._make_parts(
        t_ocp, mt.ILQROptions(n_alphas=8, alpha_decay=0.4), "torch")
    xs_t, us_t, c_t = parts.linesearch(*(torch.as_tensor(a) for a in data))
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-10)
    # the winners differ across problems: the alpha choice is exercised
    _, _, _, best = linesearch_forward_torch(
        *(torch.as_tensor(a) for a in data), tuple(0.4 ** i for i in range(8)),
        ocp=t_ocp)
    assert len(set(best.tolist())) > 1


@pytest.mark.parametrize("integrator", ["rk4", "rk4_m3", "euler"])
def test_device_model_formulas_match_ocp_callables(integrator):
    """What the kernel computes (model.step / stage_cost / terminal_cost)
    equals the OCP callables the twin evaluates."""
    _, ocp = _ocps(N, torch.float64)
    model = ocp.device_model
    if integrator == "rk4_m3":
        model = dataclasses.replace(model, substeps=3)
        F = rk4_step(unicycle.f, BENCH_DT, M=3)
    elif integrator == "euler":
        model = dataclasses.replace(model, integrator="euler")
        F = euler_step(unicycle.f, BENCH_DT)
    else:
        F = ocp.dynamics
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.uniform(-3, 3, (64, NX)))
    u = torch.as_tensor(rng.uniform(-1, 1, (64, NU)))
    p = torch.as_tensor(rng.uniform(-10, 10, (64, NPAR)))
    np.testing.assert_allclose(model.step(x, u).numpy(),
                               vmap(F)(x, u, p).numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(model.stage_cost(x, u, p).numpy(),
                               vmap(ocp.stage_cost)(x, u, p).numpy(), rtol=1e-12)
    np.testing.assert_allclose(model.terminal_cost(x, p).numpy(),
                               vmap(ocp.terminal_cost)(x, p).numpy(),
                               rtol=1e-12)
    lb, ub = ocp.control_bounds(x[0], p[0], 0)
    np.testing.assert_array_equal(lb.numpy(), model.lb)
    np.testing.assert_array_equal(ub.numpy(), model.ub)
    packed = model.packed()
    assert packed.dtype == np.float32 and packed.shape == (39,)
