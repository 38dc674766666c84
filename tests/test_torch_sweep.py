"""Port vs JAX: the tuning sweep (``sweep.py``) and the weight it reads from
the params (``interop.linear_rate_ocp``'s ``q_param``), in float64 on the
CPU.

The lane change's reference leaves zero only at step 126 of the synthetic
course, so the sweep runs 200 steps: at fewer, every row would track a zero
reference and the q_y rows could not differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import hessian, jacfwd, vmap

import mpc_verde_tpu as mv
from mpc_verde_tpu.models import lateral_error_lti as j_lateral_error_lti
from mpc_verde_tpu.ops import c2d as j_c2d
from mpc_verde_tpu.scenarios.lane_change import SPEC as J_SPEC
from mpc_verde_tpu.sweep import sweep_lane_change as j_sweep
from mpc_verde_tpu_torch.ops.cuda.rollout import traced_device_model
from mpc_verde_tpu_torch.sweep import sweep_lane_change, sweep_ocp

N = 5
UREF = 0.4


def _j_ocp():
    """The JAX sweep's OCP at horizon N (``mpc_verde_tpu/sweep.py:50-71``)."""
    s = dict(J_SPEC)
    model = j_lateral_error_lti(UREF, s["ar"], s["br"])
    Ad, Bd = (jnp.asarray(m) for m in j_c2d(model.Ac, model.Bc, s["T"]))

    def l(x, u, p, du):
        e = x - p[:3]
        Q = jnp.diag(jnp.stack([p[4], jnp.asarray(s["Q"][1], e.dtype),
                                jnp.asarray(s["Q"][2], e.dtype)]))
        return e @ Q @ e + s["R"] * (u[0] - p[3]) ** 2

    du_lb = np.zeros((N, 1)); du_ub = np.zeros((N, 1))
    du_lb[: s["Ntu"]] = -np.inf; du_ub[: s["Ntu"]] = np.inf
    ocp = mv.to_rate_form(
        lambda x, u, p: Ad @ x + Bd @ u, l, N=N, nx=3, nu=1, npar=5,
        u_lb=jnp.array([-s["delta_max"]]), u_ub=jnp.array([s["delta_max"]]),
        du_lb=du_lb, du_ub=du_ub)
    return ocp, np.asarray(Ad), np.asarray(Bd)


def test_weight_term_and_its_derivatives_match_jax():
    """The stage cost with Q[0, 0] = p[4], in the OCP's callable and in the
    model traced from it (what K2 and K3 evaluate), its gradient and its
    Hessian in (z, w), against JAX's cost to 1e-12."""
    j_ocp, Ad, Bd = _j_ocp()
    ocp = sweep_ocp(N, Ad, Bd, "cpu", torch.float64)
    assert ocp.device_model is None
    model = traced_device_model(ocp)
    assert model.min_npar == ocp.npar == 5
    rng = np.random.default_rng(5)
    B = 64
    z = rng.uniform(-0.5, 0.5, (B, 4))
    w = rng.uniform(-0.3, 0.3, (B, 1))
    p = np.concatenate([rng.uniform(-0.5, 0.5, (B, 4)),
                        10.0 ** rng.uniform(-2, 2, (B, 1))], axis=1)
    t = lambda a: torch.as_tensor(a)
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-12)
    j_l = j_ocp.stage_cost
    for f in (ocp.stage_cost, model.stage_cost):
        close(vmap(f)(t(z), t(w), t(p)), jax.vmap(j_l)(z, w, p))
        for a in (0, 1):
            close(vmap(jacfwd(f, a))(t(z), t(w), t(p)),
                  jax.vmap(jax.grad(j_l, a))(z, w, p))
            close(vmap(hessian(f, a))(t(z), t(w), t(p)),
                  jax.vmap(jax.hessian(j_l, a))(z, w, p))
        close(vmap(jacfwd(jacfwd(f, 1), 0))(t(z), t(w), t(p)),
              jax.vmap(jax.jacfwd(jax.jacfwd(j_l, 1), 0))(z, w, p))
    # the weight column changes the cost: p[4] is not ignored
    p2 = p.copy(); p2[:, 4] *= 2.0
    assert not np.allclose(model.stage_cost(t(z), t(w), t(p2)).numpy(),
                           model.stage_cost(t(z), t(w), t(p)).numpy())


def test_sweep_rows_match_jax():
    kw = dict(q_y_values=(0.1, 10.0), horizons=(3, 5), n_steps=200)
    ref = j_sweep(**kw)
    rows = sweep_lane_change(**kw, device="cpu", dtype=torch.float64)
    assert [(r["horizon"], r["q_y"]) for r in rows] == [
        (r["horizon"], r["q_y"]) for r in ref]
    for r, j in zip(rows, ref):
        assert set(r) == set(j)
        for k in ("mean_y", "mean_phi", "mean_path_dist"):
            assert r[k] == pytest.approx(j[k], rel=1e-6), (r, j)
        assert r["converged_frac"] == j["converged_frac"]
    # the two weights track differently: the comparison is not of zeros
    for h in (0, 2):
        assert rows[h]["mean_y"] > 0.0
        assert rows[h]["mean_y"] != pytest.approx(rows[h + 1]["mean_y"],
                                                  rel=1e-3)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA device")
def test_sweep_runs_on_the_card_unless_told_otherwise():
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sweep_lane_change(horizons=(3,), n_steps=2)
