"""Port vs JAX: the fused line search (the twin of CUDA kernel K2).

``linesearch_forward`` (the twin, for CPU tensors) against the Pallas kernel
in interpret mode in float32 at the shapes of tests/test_pallas_rollout.py,
and against the JAX materialising XLA line search in float64; and the
kernel's device-model formulas, as ``csrc/rollout.cu`` computes them,
against the OCP's own callables.
"""
import dataclasses

import jax
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
    assert packed.dtype == np.float32 and packed.shape == (42,)
    assert model.packed_ints().shape == (10,)


# The control-reference and quadrature terms, on the JAX scenarios' own OCPs
# (mpc_verde_tpu/scenarios/circular.py, diffdrive.py) and the port's
# counterparts: the circular track's control reference (npar 5), its derived
# AL OCP (npar 12), and the diff-drive quadrature cost at M = 1 and 4 under
# RK4 dynamics and at M = 2 under Euler dynamics (one Euler step of the
# state, two RK4 substeps of the cost's own chain).
TERM_CASES = ["u_ref", "u_ref_al", "quad_m1", "quad_m4", "quad_m2_euler"]


def term_case_ocps(case, dtype=torch.float64):
    """(JAX OCP, port OCP) of a new-term case, N = 10."""
    from mpc_verde_tpu.scenarios import circular as j_circular
    from mpc_verde_tpu.scenarios import diffdrive as j_diffdrive
    from mpc_verde_tpu.solver.batched import _augment_ocp_al as j_augment
    from mpc_verde_tpu_torch.scenarios.circular import circular_ocp
    from mpc_verde_tpu_torch.scenarios.diffdrive import diffdrive_ocp
    from mpc_verde_tpu_torch.solver.batched import _augment_ocp_al

    if case.startswith("u_ref"):
        al = case == "u_ref_al"
        j_ocp = j_circular.build_circular_tracking(
            n_steps=10, use_state_bounds=al)["ocp"]
        t_ocp = circular_ocp(10, "cpu", dtype, use_state_bounds=al)
        if al:
            j_ocp, t_ocp = j_augment(j_ocp), _augment_ocp_al(t_ocp)
        return j_ocp, t_ocp
    M = int(case.split("_")[1][1:])
    integrator = "euler" if case.endswith("euler") else "rk4"
    return (j_diffdrive.build_diffdrive(n_steps=1, cost="quadrature", M=M,
                                        integrator=integrator)["ocp"],
            diffdrive_ocp(10, "cpu", dtype, integrator, "quadrature", M))


def term_case_params(ocp, B, N, rng):
    """Stage params for a case: targets and control references near the
    circle's, and for the AL OCP multipliers on about half the rows, mu 10
    to 1000."""
    ps = np.zeros((B, N + 1, ocp.npar))
    ps[..., :2] = rng.uniform(-1.5, 1.5, (B, 1, 2))
    ps[..., 2] = rng.uniform(-np.pi, np.pi, (B, 1))
    if ocp.npar >= 5:
        ps[..., 3:5] = rng.uniform(0.5, 1.5, (B, N + 1, 2))
    if ocp.npar == 12:
        ps[..., 5:11] = rng.uniform(0, 2, (B, N + 1, 6)) * (
            rng.uniform(size=(B, N + 1, 6)) < 0.5)
        ps[..., 11] = rng.choice([10.0, 100.0, 1000.0], (B, 1))
    return ps


@pytest.mark.parametrize("case", TERM_CASES)
def test_device_model_new_terms_match_ocp_callables(case):
    """The kernels' formulas for the control reference and the quadrature
    cost (model.step / stage_cost / terminal_cost) equal the port OCP's
    callables, which equal the JAX scenarios' OCPs."""
    j_ocp, ocp = term_case_ocps(case)
    model = ocp.device_model
    assert ocp.npar == model.min_npar == {"u_ref": 5, "u_ref_al": 12}.get(case, 3)
    rng = np.random.default_rng(14)
    x = rng.uniform(-2, 2, (64, NX))
    u = rng.uniform(-1, 1, (64, NU))
    p = term_case_params(ocp, 64, 0, rng)[:, 0]
    t = lambda a: torch.as_tensor(a)
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-12)
    close(model.step(t(x), t(u)), vmap(ocp.dynamics)(t(x), t(u), t(p)))
    close(model.stage_cost(t(x), t(u), t(p)),
          vmap(ocp.stage_cost)(t(x), t(u), t(p)))
    close(vmap(ocp.stage_cost)(t(x), t(u), t(p)),
          jax.vmap(j_ocp.stage_cost)(x, u, p))
    close(vmap(ocp.dynamics)(t(x), t(u), t(p)),
          jax.vmap(j_ocp.dynamics)(x, u, p))
    if ocp.terminal_cost is not None:
        close(model.terminal_cost(t(x), t(p)),
              vmap(ocp.terminal_cost)(t(x), t(p)))
        close(vmap(ocp.terminal_cost)(t(x), t(p)),
              jax.vmap(j_ocp.terminal_cost)(x, p))


@pytest.mark.parametrize("case", TERM_CASES)
def test_twin_on_new_terms_matches_jax_materialize(case):
    """The line-search twin (K2's reference) on the new terms against the
    JAX materialising XLA line search, float64."""
    NL, BL = 10, 12
    j_ocp, t_ocp = term_case_ocps(case)
    rng = np.random.default_rng(15)
    data = (rng.uniform(-1.5, 1.5, (BL, NX)),
            rng.uniform(-1.5, 1.5, (BL, NL + 1, NX)),
            rng.uniform(-0.8, 0.8, (BL, NL, NU)),
            term_case_params(t_ocp, BL, NL, rng),
            0.3 * rng.normal(size=(BL, NL, NU)),
            0.2 * rng.normal(size=(BL, NL, NU, NX)))
    opts = dict(n_alphas=8, alpha_decay=0.4)
    xs_j, us_j, c_j = j_make_parts(j_ocp, mv.ILQROptions(**opts), "xla",
                                   "materialize").linesearch(*data)
    parts = mt.solver.batched._make_parts(t_ocp, mt.ILQROptions(**opts),
                                          "torch")
    xs_t, us_t, c_t = parts.linesearch(*(torch.as_tensor(a) for a in data))
    for o, r in ((xs_t, xs_j), (us_t, us_j), (c_t, c_j)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-10,
                                   atol=1e-10)
