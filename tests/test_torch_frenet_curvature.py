"""Port vs JAX: the Frenet and curvature families and their device models.

The models traced from the rate-form OCPs' own callables (what K2 and K3
evaluate: step, stage cost, stage box, first and second derivatives)
against those callables and the JAX scenarios' OCPs to 1e-12; the twins of
the dual numbers' tan and reciprocal against ``torch.func.hessian``; the
line-search and fused twins on both OCPs against the JAX "xla" reference
paths in float64 (1e-10 and 1e-9, as for the linear families); and each
family's closed loop at 16 steps against JAX's at atol 1e-6, with the JAX
tests' float64 gates.  The synthetic lane change is cut to start just
before its maneuver (sample 118 of 500), so that 16 steps track a turn.
"""
import jax
import numpy as np
import pytest
import torch
from torch.func import hessian, jacfwd

from chip_smoke import _pinned
import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu import scenarios as js
from mpc_verde_tpu.refgen import double_lane_change_course as j_double
from mpc_verde_tpu.refgen import synthetic_lane_change as j_lane_change
from mpc_verde_tpu.solver.batched import _make_parts as j_make_parts
from mpc_verde_tpu_torch import scenarios as ts
from mpc_verde_tpu_torch.ops.cuda.fused import (CHAIN_COEFFS, dual_chain,
                                                fused_backward_torch)
from mpc_verde_tpu_torch.ops.cuda.rollout import (linesearch_forward_torch,
                                                  traced_device_model)
from test_torch_linear_families import _hold_traced_model

CPU64 = dict(device="cpu", dtype=torch.float64)
STEPS = 16
LANE = {k: np.asarray(v)[118:] for k, v in j_lane_change(n=500, dt=0.05).items()}
DOUBLE = j_double()

# family -> (builder, npar, N, (nx, nu), scale of the state's (y, phi, third)
# about the reference, rate scale)
FAMILIES = {
    "frenet": ("build_frenet", 4, 20, (5, 2), (0.4, 0.3, 0.5), 0.15),
    "curvature": ("build_curvature_ltv", 16, 20, (4, 1), (0.4, 0.3, 0.5), 0.1),
}


def _built(family, pkg, n_steps=STEPS, path=LANE):
    dev = CPU64 if pkg is ts else {}
    return getattr(pkg, FAMILIES[family][0])(path=path, n_steps=n_steps, **dev)


def _stage_data(family, B, rng, built_t):
    """Random states about the scenario's own references (u_prev on both
    sides of the steering box), rates, and stage params drawn from the
    scenario's table, (B, N+1, ...).  For the Frenet model |(y - y_t)
    kappa| stays below 0.4, away from the pole of its 1 / (1 - (y - y_t)
    kappa); the curvature model's steering (u_prev up to 0.65, then three
    free rates) stays below 1.2 rad, away from the poles of its tan."""
    _, npar, N, (nx, nu), scale, du = FAMILIES[family]
    spec = built_t["spec"]
    table = np.asarray(built_t["params_seq"])
    ps = table[rng.integers(0, len(table), B)]
    z = np.zeros((B, N + 1, nx))
    z[..., 0] = ps[..., 0] + rng.uniform(-scale[0], scale[0], (B, N + 1))
    z[..., 1] = ps[..., 1] + rng.uniform(-scale[1], scale[1], (B, N + 1))
    third = ps[..., 3] if family == "frenet" else 0.0   # v about v_des; r
    z[..., 2] = third + rng.uniform(-scale[2], scale[2], (B, N + 1))
    u_max = np.minimum([spec["delta_max"], spec.get("a_max", 0.0)][:nu], 0.5)
    z[..., 3:] = rng.uniform(-1.3 * u_max, 1.3 * u_max, (B, N + 1, nu))
    w = rng.uniform(-du, du, (B, N, nu))
    return z, w, ps


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _close(a, b, tol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_device_model_matches_rate_form_callables(family):
    """What K2 and K3 evaluate (the model traced from the rate-form OCP's
    callables and its first and second derivatives) equals those callables,
    which equal the JAX scenario's OCP."""
    built_t = _built(family, ts, n_steps=4)
    ocp, j_ocp = built_t["ocp"], _built(family, js, n_steps=4)["ocp"]
    assert ocp.device_model is None   # the callables are the whole model
    model = traced_device_model(ocp)
    _, npar, N, (nx, nu), *_ = FAMILIES[family]
    assert (ocp.nx, ocp.nu, ocp.npar) == (nx, nu, npar)
    assert (model.nx, model.nu, model.min_npar) == (nx, nu, npar)
    assert (j_ocp.nx, j_ocp.nu, j_ocp.npar, j_ocp.N) == (nx, nu, npar, N)
    rng = np.random.default_rng(81)
    z, w, ps = _stage_data(family, 32, rng, built_t)
    z, w, p = z[:, 0], w[:, 0], ps[:, 0]
    ks = rng.integers(0, N, 32)
    lo, hi = _hold_traced_model(model, ocp, j_ocp, z, w, p, ks)
    if family == "curvature":   # move blocking: the rate pinned after Ntu
        blocked = _t(ks >= 3)
        assert (lo[blocked] == 0.0).all() and (hi[blocked] == 0.0).all()
        assert torch.equal(lo[~blocked], -20.0 - _t(z)[~blocked][:, 3:])
        assert _pinned(ocp).tolist() == [False] * 3 + [True] * 17
    else:                       # the steering rate's box is never empty
        assert (lo < hi).all() and not _pinned(ocp).any()
    assert ocp.terminal_cost is None and j_ocp.terminal_cost is None
    assert "terminal_cost" not in model.program.outputs


@pytest.mark.parametrize("name", ["tan", "recip", "sin", "cos", "log", "exp",
                                  "sqrt", "abs"])
def test_dual_chain_matches_hessian(name):
    """The dual numbers' chain rule (csrc/dual.cuh's chain with each mv_*
    function's coefficients) through its PyTorch twin, on a = q(v) of three
    variables, against torch.func's gradient and Hessian of f(q(v)), to
    1e-12."""
    fns = {"tan": torch.tan, "recip": lambda a: 1.0 / a, "sin": torch.sin,
           "cos": torch.cos, "log": torch.log, "exp": torch.exp,
           "sqrt": torch.sqrt, "abs": torch.abs}
    q = lambda v: 0.3 + 0.4 * v[0] * v[1] + 0.2 * torch.sin(v[2]) + 0.1 * v[2] ** 2
    rng = np.random.default_rng(83)
    for v in _t(rng.uniform(-1.0, 1.0, (8, 3))):
        f0, g, H = dual_chain(name, q(v), jacfwd(q)(v), hessian(q)(v))
        f = lambda v: fns[name](q(v))
        _close(f0, f(v))
        _close(g, jacfwd(f)(v))
        _close(H, hessian(f)(v))
    assert set(CHAIN_COEFFS) == set(fns)


def _data(family, B, seed):
    built_t = _built(family, ts, n_steps=40)
    rng = np.random.default_rng(seed)
    z, w, ps = _stage_data(family, B, rng, built_t)
    _, _, N, (nx, nu), _, du = FAMILIES[family]
    kff = 0.5 * du * rng.normal(size=(B, N, nu))
    K = 0.1 * du * rng.normal(size=(B, N, nu, nx))
    return built_t, (z[:, 0], z, w, ps, kff, K)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_linesearch_twin_matches_jax_materialize(family):
    """K2's twin on the two models against the JAX materialising XLA line
    search, float64, with gains that clip candidates onto the
    state-dependent box (and, for curvature, pin them on the blocked
    stages)."""
    built_t, data = _data(family, 6, seed=84)
    j_ocp = _built(family, js, n_steps=4)["ocp"]
    opts = dict(n_alphas=8, alpha_decay=0.4)
    xs_j, us_j, c_j = j_make_parts(j_ocp, mv.ILQROptions(**opts), "xla",
                                   "materialize").linesearch(*data)
    parts = mt.solver.batched._make_parts(built_t["ocp"],
                                          mt.ILQROptions(**opts), "torch")
    xs_t, us_t, c_t = parts.linesearch(*(_t(a) for a in data))
    assert np.isfinite(c_t.numpy()).all()
    for o, r in ((xs_t, xs_j), (us_t, us_j), (c_t, c_j)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-10,
                                   atol=1e-10)
    _, us_1, _, _ = linesearch_forward_torch(
        *(_t(a) for a in data), (1.0,), ocp=built_t["ocp"])
    assert (us_1 != _t(data[2]) + _t(data[4])).any()   # the box clipped some


@pytest.mark.parametrize("family,use_ddp", [
    ("frenet", True), ("frenet", False), ("curvature", True),
    ("curvature", False)])
def test_fused_twin_matches_jax(family, use_ddp):
    """K3's twin on the two models against the JAX "xla" derivs ->
    backward, float64, along rolled-out trajectories."""
    built_t, data = _data(family, 5, seed=85)
    j_ocp = _built(family, js, n_steps=4)["ocp"]
    opt = mv.ILQROptions(use_ddp=use_ddp)
    z0, _, w, ps, _, _ = data
    xs, us, _ = jax.jit(j_make_parts(j_ocp, opt, "xla", "materialize").rollout)(
        z0, w, ps)
    ddp = np.ones((5,))
    ddp[1] = 0.0
    args = (np.array(xs), np.array(us), ps, np.full((5,), 1e-5), ddp)
    xla = j_make_parts(j_ocp, opt, "xla", "materialize")
    ref = jax.jit(xla.backward)(*jax.jit(xla.derivs)(*args[:3]), *args[3:])
    out = fused_backward_torch(*(_t(a) for a in args), ocp=built_t["ocp"],
                               use_ddp=use_ddp, tol=opt.boxqp_tol)
    for name, o, r in zip(("kff", "K", "dV1", "dV2", "gmax"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-9, err_msg=name)


LOOPS = {   # name -> (builder, runner, kwargs, the JAX tests' float64 gates)
    "frenet": ("build_frenet", "run_frenet", dict(path=LANE),
               dict(mse_y=1e-3, max_delta=0.384 + 1e-8,
                    max_delta_rate=0.1225 + 1e-8)),
    "frenet_double_lane_change": (
        "build_frenet", "run_frenet", dict(path=DOUBLE, max_iters=80),
        dict(max_delta=0.384 + 1e-8, max_delta_rate=0.1225 + 1e-8)),
    "curvature": ("build_curvature_ltv", "run_curvature_ltv", dict(path=LANE),
                  dict(mse_y=1.0, mse_phi=0.2)),
}


@pytest.mark.parametrize("name", list(LOOPS))
def test_closed_loop_matches_jax(name):
    build, run, kw, gates = LOOPS[name]
    m_t = getattr(ts, run)(getattr(ts, build)(n_steps=STEPS, **kw, **CPU64))
    m_j = getattr(js, run)(getattr(js, build)(n_steps=STEPS, **kw))
    for field in ("xs", "us"):
        np.testing.assert_allclose(getattr(m_t["result"], field).numpy(),
                                   np.asarray(getattr(m_j["result"], field)),
                                   rtol=0, atol=1e-6, err_msg=field)
    np.testing.assert_array_equal(m_t["result"].converged.numpy(),
                                  np.asarray(m_j["result"].converged))
    for key, v in m_t.items():
        if isinstance(v, float):
            np.testing.assert_allclose(v, m_j[key], rtol=1e-6, atol=1e-12,
                                       err_msg=key)
    assert m_t["converged_frac"] == m_j["converged_frac"] == 1.0
    for key, bound in gates.items():
        assert m_t[key] <= bound and m_j[key] <= bound, key
    assert float(m_t["result"].us.abs().max()) > 0.0


def test_float32_derivatives_stay_float32():
    """torch.func's forward mode turns the tangent of the Frenet model's
    u[0] / L (a 0-d tensor by a Python float) into float64; the port's
    derivatives come back in the OCP's float32, as JAX's do (the "torch"
    backend and the "cuda" path's eager derivatives need it)."""
    from mpc_verde_tpu_torch.ops.linearize import trajectory_derivatives

    built = ts.build_frenet(path=LANE, n_steps=2, device="cpu")
    ocp = built["ocp"]
    ps = torch.as_tensor(built["params_seq"][:2], dtype=torch.float32)
    xs = torch.zeros((2, ocp.N + 1, 5))
    us = torch.full((2, ocp.N, 2), 0.05)
    d, gN, HN, dlb, dub = trajectory_derivatives(ocp, xs, us, ps, True)
    assert {v.dtype for v in (*d.values(), gN, HN, dlb, dub)} == {torch.float32}
    d64 = trajectory_derivatives(_built("frenet", ts, n_steps=2)["ocp"],
                                 xs.double(), us.double(), ps.double(), True)[0]
    for k, v in d.items():
        np.testing.assert_allclose(v.numpy(), d64[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
