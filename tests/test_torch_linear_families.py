"""Port vs JAX: the linear rate-form families (LTI and LTV lane change,
leitura, the dynamic bicycle, the cart pendulum) and their device model.

The model traced from the OCP's own callables (what K2 and K3 evaluate:
step, stage cost, stage box, first and second derivatives) against those
callables from ``to_rate_form`` and JAX to 1e-12, the port OCPs against
the JAX scenarios' OCPs; the line-search and fused twins on these OCPs
against the JAX "xla" reference paths in float64; and each scenario's
closed loop at 16 steps against JAX's at atol 1e-6, with the JAX tests'
float64 gates.  The lane-change courses are cut to start just before the
maneuver (sample 118 of 500), so that 16 steps track a turn.
"""
import jax
import numpy as np
import pytest
import torch
from torch.func import hessian, jacfwd, vmap

from chip_smoke import _pinned
import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu import scenarios as js
from mpc_verde_tpu.refgen import extend_lane_change_course as j_extended
from mpc_verde_tpu.refgen import synthetic_lane_change as j_lane_change
from mpc_verde_tpu.solver.batched import _make_parts as j_make_parts
from mpc_verde_tpu_torch import scenarios as ts
from mpc_verde_tpu_torch.ops.cuda.fused import fused_backward_torch
from mpc_verde_tpu_torch.ops.cuda.rollout import (linesearch_forward_torch,
                                                  traced_device_model)

CPU64 = dict(device="cpu", dtype=torch.float64)
STEPS = 16
_cut = lambda p: {k: np.asarray(v)[118:] for k, v in p.items()}
LANE = _cut(j_lane_change(n=500, dt=0.05))
EXTENDED = _cut(j_extended())

# family -> (builder kwargs, npar, N, (nx, nu), state scale, control scale)
FAMILIES = {
    "lti": (dict(), 4, 5, (4, 1), 0.5, 0.3),
    "v1": (dict(N=20, Ntu=3), 4, 20, (4, 1), 0.5, 0.3),
    "ltv": (dict(), 16, 5, (4, 1), 0.5, 0.3),
    "dynamic": (dict(), 25, 10, (5, 1), 0.5, 0.3),
    "pendulum": (dict(), 0, 50, (5, 1), 2.0, 60.0),
}


def _built(family, pkg, n_steps=STEPS):
    kw, *_ = FAMILIES[family]
    dev = CPU64 if pkg is ts else {}
    if family in ("lti", "v1"):
        return pkg.build_lane_change_lti(path=LANE, n_steps=n_steps, **kw, **dev)
    if family == "ltv":
        return pkg.build_lane_change_ltv(path=LANE, n_steps=n_steps, **dev)
    if family == "dynamic":
        return pkg.build_dynamic_bicycle(path=LANE, n_steps=n_steps, **dev)
    return pkg.build_pendulum(n_steps=n_steps, **dev)


def _stage_data(family, B, rng, built_t):
    """Random states z (u_prev on both sides of the control box), rates w
    and stage params taken from the scenario's own table, (B, N+1, ...)."""
    _, npar, N, (nx, nu), xs_, us_ = FAMILIES[family]
    spec = built_t["spec"]
    u_max = float(spec["u_max"] if "u_max" in spec else spec["delta_max"])
    z = rng.uniform(-xs_, xs_, (B, N + 1, nx))
    z[..., -nu:] = rng.uniform(-1.3 * u_max, 1.3 * u_max, (B, N + 1, nu))
    w = rng.uniform(-us_, us_, (B, N, nu))
    if npar:
        table = np.asarray(built_t["params_seq"])
        ps = table[rng.integers(0, len(table), B)]
    else:
        ps = np.zeros((B, N + 1, 0))
    return z, w, ps


@pytest.mark.parametrize("family", list(FAMILIES))
def test_device_model_matches_rate_form_callables(family):
    """What K2 and K3 evaluate (the model traced from the rate-form OCP's
    callables: step, stage cost, stage box, first and second derivatives)
    equals those callables, which equal the JAX scenario's OCP."""
    built_t = _built(family, ts, n_steps=4)
    ocp, j_ocp = built_t["ocp"], _built(family, js, n_steps=4)["ocp"]
    assert ocp.device_model is None   # the callables are the whole model
    model = traced_device_model(ocp)
    _, npar, N, (nx, nu), *_ = FAMILIES[family]
    assert (ocp.nx, ocp.nu, ocp.npar) == (nx, nu, npar)
    assert (model.nx, model.nu, model.min_npar) == (nx, nu, npar)
    assert (j_ocp.nx, j_ocp.nu, j_ocp.npar, j_ocp.N) == (nx, nu, npar, N)
    rng = np.random.default_rng(21)
    z, w, ps = _stage_data(family, 32, rng, built_t)
    z, w, p = z[:, 0], w[:, 0], ps[:, 0]
    ks = rng.integers(0, N, 32)
    lo, hi = _hold_traced_model(model, ocp, j_ocp, z, w, p, ks)
    if _pinned(ocp).any():   # u_prev outside the box on a blocked
        assert (lo > hi).any()   # stage: the clip takes hi
    assert ocp.terminal_cost is None and j_ocp.terminal_cost is None
    assert "terminal_cost" not in model.program.outputs


def _hold_traced_model(model, ocp, j_ocp, z, w, p, ks):
    """The traced model's step, stage cost and box, and their first and
    second derivatives, against the OCP's callables and the JAX OCP's, at
    1e-12 in float64 (the boxes bit for bit); returns the traced box."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-12)
    Z, W, P = t(z), t(w), t(p)
    for fm, fo, fj in ((model.step, ocp.dynamics, j_ocp.dynamics),
                       (model.stage_cost, ocp.stage_cost, j_ocp.stage_cost)):
        close(fm(Z, W, P), vmap(fo)(Z, W, P))
        close(vmap(fo)(Z, W, P), jax.vmap(fj)(z, w, p))
    lo, hi = model.bounds(Z, P, t(ks))
    lo_o, hi_o = vmap(ocp.control_bounds)(Z, P, t(ks))
    lo_j, hi_j = jax.vmap(j_ocp.control_bounds)(z, p, ks)
    for a, b, c in ((lo, lo_o, lo_j), (hi, hi_o, hi_j)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(b.numpy(), np.asarray(c))
    for argnums in (0, 1):
        for d, jd, fm, fo, fj in (
                (jacfwd, jax.jacfwd, model.step, ocp.dynamics, j_ocp.dynamics),
                (hessian, jax.hessian, model.step, ocp.dynamics,
                 j_ocp.dynamics),
                (hessian, jax.hessian, model.stage_cost, ocp.stage_cost,
                 j_ocp.stage_cost)):
            close(vmap(d(fm, argnums))(Z, W, P), vmap(d(fo, argnums))(Z, W, P))
            close(vmap(d(fo, argnums))(Z, W, P),
                  jax.vmap(jd(fj, argnums))(z, w, p))
    mixed = lambda f, j: j(j(f, 1), 0)
    close(vmap(mixed(model.stage_cost, jacfwd))(Z, W, P),
          vmap(mixed(ocp.stage_cost, jacfwd))(Z, W, P))
    close(vmap(mixed(ocp.stage_cost, jacfwd))(Z, W, P),
          jax.vmap(mixed(j_ocp.stage_cost, jax.jacfwd))(z, w, p))
    return lo, hi


def _data(family, B, seed):
    built_t = _built(family, ts, n_steps=40)
    rng = np.random.default_rng(seed)
    z, w, ps = _stage_data(family, B, rng, built_t)
    _, _, N, (nx, nu), xs_, us_ = FAMILIES[family]
    kff = 0.5 * us_ * rng.normal(size=(B, N, nu))
    K = 0.3 * us_ / xs_ * rng.normal(size=(B, N, nu, nx))
    return built_t, (z[:, 0], z, w, ps, kff, K)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_linesearch_twin_matches_jax_materialize(family):
    """K2's twin on the linear model against the JAX materialising XLA line
    search, float64, with gains that clip candidates onto the state-dependent
    box and pin them on the blocked stages."""
    built_t, data = _data(family, 6, seed=22)
    j_ocp = _built(family, js, n_steps=4)["ocp"]
    opts = dict(n_alphas=8, alpha_decay=0.4)
    xs_j, us_j, c_j = j_make_parts(j_ocp, mv.ILQROptions(**opts), "xla",
                                   "materialize").linesearch(*data)
    parts = mt.solver.batched._make_parts(built_t["ocp"],
                                          mt.ILQROptions(**opts), "torch")
    xs_t, us_t, c_t = parts.linesearch(*(torch.as_tensor(a) for a in data))
    for o, r in ((xs_t, xs_j), (us_t, us_j), (c_t, c_j)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-10,
                                   atol=1e-10)
    pinned = _pinned(built_t["ocp"])
    if pinned.any():   # the move-blocked stages' rates are exactly 0
        assert (us_t.numpy()[:, pinned] == 0.0).all()
    # the rate-form box clipped some candidates
    _, us_1, _, _ = linesearch_forward_torch(
        *(torch.as_tensor(a) for a in data), (1.0,), ocp=built_t["ocp"])
    free = torch.as_tensor(data[2]) + torch.as_tensor(data[4])
    assert (us_1 != free).any()


@pytest.mark.parametrize("family,use_ddp", [
    ("lti", True), ("v1", False), ("ltv", True), ("dynamic", True),
    ("dynamic", False), ("pendulum", True)])
def test_fused_twin_matches_jax(family, use_ddp):
    """K3's twin on the linear model against the JAX "xla" derivs ->
    backward, float64, along rolled-out trajectories (the box QP meets
    lo == hi on the blocked stages)."""
    built_t, data = _data(family, 5, seed=23)
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
    out = fused_backward_torch(*(torch.as_tensor(a) for a in args),
                               ocp=built_t["ocp"], use_ddp=use_ddp,
                               tol=opt.boxqp_tol)
    for name, o, r in zip(("kff", "K", "dV1", "dV2", "gmax"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-9, err_msg=name)


def _close_loops(res_t, res_j):
    for name in ("xs", "us"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(),
                                   np.asarray(getattr(res_j, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(res_t.converged.numpy(),
                                  np.asarray(res_j.converged))


LOOPS = {   # name -> (builder, runner, kwargs, the JAX tests' gates)
    "lti": ("build_lane_change_lti", "run_lane_change_lti", dict(path=LANE),
            dict(mean_y=1e-3, mean_phi=1e-3)),
    "v1": ("build_lane_change_lti", "run_lane_change_lti",
           dict(path=LANE, N=20, Ntu=3), dict(mean_y=1e-3, mean_delta=1e-3)),
    "ltv": ("build_lane_change_ltv", "run_lane_change_ltv", dict(path=LANE),
            dict(mse=1e-2)),
    "leitura_course": ("build_lane_change_ltv", "run_lane_change_ltv",
                       dict(path=EXTENDED, unwrap=True), dict(mse=2e-2)),
    "leitura": ("build_leitura", "run_lane_change_ltv", dict(),
                dict(mse=2e-2, mean_path_dist=0.1)),
    "ltv_yaw_scale": ("build_lane_change_ltv", "run_lane_change_ltv",
                      dict(path=EXTENDED, unwrap=True, yaw_scale_mode=True),
                      dict(mse=2e-2)),
    "dynamic": ("build_dynamic_bicycle", "run_dynamic_bicycle",
                dict(path=LANE), dict()),
    "dynamic_corrected": ("build_dynamic_bicycle", "run_dynamic_bicycle",
                          dict(path=LANE, corrected=True),
                          dict(mse_y=1.0, max_err_y=2.5)),
    "pendulum": ("build_pendulum", "run_pendulum", dict(), dict(max_angle=1.2)),
}


@pytest.mark.parametrize("name", list(LOOPS))
def test_closed_loop_matches_jax(name):
    build, run, kw, gates = LOOPS[name]
    m_t = getattr(ts, run)(getattr(ts, build)(n_steps=STEPS, **kw, **CPU64))
    m_j = getattr(js, run)(getattr(js, build)(n_steps=STEPS, **kw))
    _close_loops(m_t["result"], m_j["result"])
    for key, v in m_t.items():
        if isinstance(v, float):
            np.testing.assert_allclose(v, m_j[key], rtol=1e-6, atol=1e-12,
                                       err_msg=key)
    assert m_t["converged_frac"] == m_j["converged_frac"] == 1.0
    for key, bound in gates.items():
        assert m_t[key] < bound and m_j[key] < bound, key
    assert np.isfinite(m_t["result"].xs.numpy()).all()
    if name != "leitura":   # the others move within their 16 steps
        assert float(m_t["result"].us.abs().max()) > 0.0


def test_move_blocking_pins_the_open_loop_plan():
    """The v1 variant's open-loop plan (tests/test_scenarios.py): the rates
    after Ntu = 3 are exactly 0, the free head moves."""
    built = ts.build_lane_change_lti(path=LANE, N=20, Ntu=3, n_steps=12,
                                     **CPU64)
    ocp = built["ocp"]
    res = built["solve"](np.zeros(4), built["params_seq"][8],
                         np.zeros((ocp.N, ocp.nu)))
    dus = res.us.numpy()
    assert np.abs(dus[3:]).max() == 0.0
    assert np.abs(dus[:3]).max() > 0.0


def test_run_all_runner_names_the_unported_families(capsys):
    """Every family is ported: Frenet and curvature are among the runner's
    families, none is named as unported, and an unknown name fails."""
    from mpc_verde_tpu_torch.scenarios import run_all

    assert run_all.NOT_PORTED == ()
    assert {"frenet", "curvature"} <= set(run_all.families(quick=True))
    assert run_all.main(["--family", "nope", "--cpu"]) == 1
    assert '"not_ported"' not in capsys.readouterr().out
