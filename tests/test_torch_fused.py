"""Port vs JAX: the fused derivs+backward pass (the twin of CUDA kernel K3).

``fused_backward`` on CPU tensors runs its twin, ``fused_backward_torch``.
In float64 it is held against the JAX ``"xla"`` derivs -> backward (x64) at
1e-9, and against the JAX ``"pallas_fused"`` kernel in TPU interpret mode
(float32) at that kernel's own test tolerance, 2e-4
(``tests/test_pallas_fused.py``), on the OCP forms of that test.  A second
test ties the ``UnicycleDeviceModel`` that the CUDA kernel differentiates
(step, stage cost, terminal gradient and Hessian, box) to ``torch.func`` on
the OCP's own callables.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch.func import grad, hessian, jacfwd, vmap

import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu.solver.batched import _make_parts as j_make_parts
from mpc_verde_tpu_torch.interop import unicycle_ocp
from mpc_verde_tpu_torch.ops.cuda.fused import (fused_backward,
                                                fused_backward_torch)
from test_pallas_fused import B, N, NPAR, NU, NX, T
from test_pallas_fused import _ocp as j_ocp
from test_torch_rollout import TERM_CASES, term_case_ocps, term_case_params

Q = np.diag(np.array([1.0, 5.0, 0.1], np.float32))   # as test_pallas_fused
R = np.diag(np.array([0.5, 0.05], np.float32))
FORMS = [  # (bounded, use_ddp, use_terminal), as tests/test_pallas_fused.py
    (True, True, True),
    (True, False, True),
    (False, False, False),
]


def t_ocp(bounded, use_terminal, dtype=torch.float64):
    """The port's counterpart of ``test_pallas_fused._ocp``: its terminal cost
    2 e'Qe is the weight Qf = 2Q."""
    box = dict(lb=np.array([-1.0, -np.pi / 4], np.float32),
               ub=np.array([1.0, np.pi / 4], np.float32)) if bounded else {}
    return unicycle_ocp(N, "cpu", dtype, dt=T, Q=Q, R=R,
                        Qf=2.0 * Q if use_terminal else None, **box)


def _trajectories(ocp_j, opt, seed):
    """Rolled-out (xs, us, ps) as the JAX test makes them, and reg, ddp."""
    rng = np.random.default_rng(seed)
    x0s = rng.uniform(-2, 2, (B, NX))
    ps = np.broadcast_to(np.array([10.0, 10.0, 0.0]), (B, N + 1, NPAR)).copy()
    us = 0.2 * rng.standard_normal((B, N, NU))
    xs, us_c, _ = jax.jit(j_make_parts(ocp_j, opt, "xla",
                                       "materialize").rollout)(x0s, us, ps)
    ddp = np.ones((B,))
    ddp[1] = 0.0   # one problem on Gauss-Newton
    return np.array(xs), np.array(us_c), ps, np.full((B,), 1e-5), ddp


@pytest.mark.parametrize("bounded,use_ddp,use_terminal", FORMS)
def test_fused_twin_matches_jax(bounded, use_ddp, use_terminal):
    ocp_j = j_ocp(bounded, use_terminal)
    opt = mv.ILQROptions(use_ddp=use_ddp)
    data = _trajectories(ocp_j, opt, seed=11)

    xla = j_make_parts(ocp_j, opt, "xla", "materialize")
    d, gN, HN, dlb, dub = jax.jit(xla.derivs)(*data[:3])
    ref = jax.jit(xla.backward)(d, gN, HN, dlb, dub, *data[3:])
    with pltpu.force_tpu_interpret_mode():
        ker = j_make_parts(ocp_j, opt, "pallas_fused",
                           "materialize").fused(*(jnp.asarray(a) for a in data))

    launches = fused_backward.launches
    out = fused_backward(*(torch.as_tensor(a) for a in data),
                         ocp=t_ocp(bounded, use_terminal), use_ddp=use_ddp,
                         tol=opt.boxqp_tol)
    assert fused_backward.launches == launches   # CPU tensors: the twin
    for name, o, r, k in zip(("kff", "K", "dV1", "dV2", "gmax"), out, ref, ker):
        o = o.numpy()
        np.testing.assert_allclose(o, np.asarray(r), rtol=1e-9, atol=1e-9,
                                   err_msg=name)
        np.testing.assert_allclose(o, np.asarray(k), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("bounded,use_terminal", [(True, True), (False, False)])
def test_device_model_matches_ocp_callables(bounded, use_terminal):
    """The functions the fused kernel differentiates (the device model's) and
    their first and second derivatives equal the OCP callables' ones."""
    ocp = t_ocp(bounded, use_terminal)
    model = ocp.device_model
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.uniform(-3, 3, (16, NX)))
    u = torch.as_tensor(rng.uniform(-1, 1, (16, NU)))
    p = torch.as_tensor(rng.uniform(-10, 10, (16, NPAR)))
    close = lambda a, b: np.testing.assert_allclose(
        a.detach().numpy(), b.detach().numpy(), rtol=1e-12, atol=1e-12)

    step = lambda x, u, p: model.step(x, u)
    for argnums in (0, 1):
        close(vmap(jacfwd(step, argnums))(x, u, p),
              vmap(jacfwd(ocp.dynamics, argnums))(x, u, p))
        close(vmap(jacfwd(jacfwd(step, argnums), argnums))(x, u, p),
              vmap(jacfwd(jacfwd(ocp.dynamics, argnums), argnums))(x, u, p))
        close(vmap(hessian(model.stage_cost, argnums))(x, u, p),
              vmap(hessian(ocp.stage_cost, argnums))(x, u, p))
    close(vmap(step)(x, u, p), vmap(ocp.dynamics)(x, u, p))
    close(vmap(model.stage_cost)(x, u, p), vmap(ocp.stage_cost)(x, u, p))

    gN, HN = model.terminal_grad_hess(x, p)
    if use_terminal:
        close(gN, vmap(grad(ocp.terminal_cost))(x, p))
        close(HN, vmap(hessian(ocp.terminal_cost))(x, p))
    else:
        assert ocp.terminal_cost is None and model.Qf is None
        assert not gN.any() and not HN.any()
    if bounded:
        lb, ub = ocp.control_bounds(x[0], p[0], 0)
        np.testing.assert_array_equal(lb.numpy(), model.lb)
        np.testing.assert_array_equal(ub.numpy(), model.ub)
    else:
        assert ocp.control_bounds is None
        assert np.isneginf(model.lb).all() and np.isposinf(model.ub).all()


def test_fused_parts_on_cpu_are_the_twins():
    """The "cuda_fused" solver part is the fused wrapper, and on CPU tensors
    it returns exactly what derivs -> backward return."""
    ocp = t_ocp(True, True, torch.float32)
    opt = mt.ILQROptions()
    parts = mt.solver.batched._make_parts(ocp, opt, "cuda_fused")
    xs, us, ps, reg, ddp = (torch.as_tensor(a, dtype=torch.float32) for a in
                            _trajectories(j_ocp(True, True), mv.ILQROptions(),
                                          seed=5))
    fused = parts.fused(xs, us, ps, reg, ddp)
    split = parts.backward(*parts.derivs(xs, us, ps), reg, ddp)
    direct = fused_backward_torch(xs, us, ps, reg, ddp, ocp=ocp)
    for f, s, d in zip(fused, split, direct):
        assert torch.equal(f, s) and torch.equal(f, d)


@pytest.mark.parametrize("case,use_ddp", [
    ("u_ref", True), ("u_ref_al", True), ("u_ref_al", False), ("quad_m1", True),
    ("quad_m4", True), ("quad_m2_euler", False)])
def test_fused_twin_on_new_terms_matches_jax(case, use_ddp):
    """The fused twin (K3's reference) on the control-reference and
    quadrature terms against the JAX "xla" derivs -> backward, float64,
    along rolled-out trajectories of random controls (Gauss-Newton on two
    cases: it shares the cost's derivatives with DDP)."""
    j_ocp, t_ocp = term_case_ocps(case)
    NL, BL = 10, 6
    rng = np.random.default_rng(16)
    ps = term_case_params(t_ocp, BL, NL, rng)
    opt = mv.ILQROptions(use_ddp=use_ddp)
    xs, us, _ = jax.jit(j_make_parts(j_ocp, opt, "xla", "materialize").rollout)(
        rng.uniform(-1.5, 1.5, (BL, NX)), 0.4 * rng.standard_normal((BL, NL, NU)),
        ps)
    ddp = np.ones((BL,))
    ddp[1] = 0.0
    data = (np.array(xs), np.array(us), ps, np.full((BL,), 1e-5), ddp)
    xla = j_make_parts(j_ocp, opt, "xla", "materialize")
    ref = jax.jit(xla.backward)(*jax.jit(xla.derivs)(*data[:3]), *data[3:])
    out = fused_backward_torch(*(torch.as_tensor(a) for a in data), ocp=t_ocp,
                               use_ddp=use_ddp, tol=opt.boxqp_tol)
    for name, o, r in zip(("kff", "K", "dV1", "dV2", "gmax"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-9, err_msg=name)


@pytest.mark.parametrize("case", TERM_CASES)
def test_device_model_new_terms_derivatives_match_ocp_callables(case):
    """What K3 differentiates on the new terms: the device model's stage
    cost and dynamics, first and second derivatives, against torch.func on
    the port OCP's callables."""
    _, ocp = term_case_ocps(case)
    model = ocp.device_model
    rng = np.random.default_rng(17)
    x = torch.as_tensor(rng.uniform(-2, 2, (16, NX)))
    u = torch.as_tensor(rng.uniform(-1, 1, (16, NU)))
    p = torch.as_tensor(term_case_params(ocp, 16, 0, rng)[:, 0])
    close = lambda a, b: np.testing.assert_allclose(
        a.detach().numpy(), b.detach().numpy(), rtol=1e-12, atol=1e-12)
    step = lambda x, u, p: model.step(x, u)
    for argnums in (0, 1):
        close(vmap(jacfwd(jacfwd(step, argnums), argnums))(x, u, p),
              vmap(jacfwd(jacfwd(ocp.dynamics, argnums), argnums))(x, u, p))
        close(vmap(hessian(model.stage_cost, argnums))(x, u, p),
              vmap(hessian(ocp.stage_cost, argnums))(x, u, p))
    close(vmap(jacfwd(grad(model.stage_cost, 1), 0))(x, u, p),
          vmap(jacfwd(grad(ocp.stage_cost, 1), 0))(x, u, p))
    if ocp.terminal_cost is not None:
        gN, HN = model.terminal_grad_hess(x, p)
        close(gN, vmap(grad(ocp.terminal_cost))(x, p))
        close(HN, vmap(hessian(ocp.terminal_cost))(x, p))
