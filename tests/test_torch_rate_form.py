"""Port vs JAX: the models of the linear families, the lateral-error
reference synthesis and path loader, and the rate form (``ocp/rate.py``).

Models and coefficient functions (batched speeds) to 1e-12, the reference
synthesis exactly, ``load_path_csv`` against the JAX package's pandas
loader, and ``to_rate_form`` on JAX's four properties
(``tests/test_rate_form.py``), each also held to JAX's solve of the same
problem in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu import models as jm
from mpc_verde_tpu import refgen as jr
from mpc_verde_tpu.ops import rk4_step as j_rk4_step
from mpc_verde_tpu_torch import models as tm
from mpc_verde_tpu_torch import refgen as tr
from mpc_verde_tpu_torch.refgen import io as tr_io
from mpc_verde_tpu_torch.ocp import to_rate_form
from mpc_verde_tpu_torch.ops import rk4_step

CPU64 = dict(device="cpu", dtype=torch.float64)
close12 = lambda a, b: np.testing.assert_allclose(
    np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-12)


def test_linear_models_match_jax():
    for t, j in ((tm.cart_pendulum_linear(**CPU64), jm.cart_pendulum_linear()),
                 (tm.lateral_error_lti(0.7, **CPU64), jm.lateral_error_lti(0.7)),
                 (tm.lateral_error_lti(1.3, -20.0, 50.0, **CPU64),
                  jm.lateral_error_lti(1.3, -20.0, 50.0)),
                 (tm.dynamic_bicycle_ltv(2.5, **CPU64),
                  jm.dynamic_bicycle_ltv(2.5))):
        close12(t.Ac.numpy(), j.Ac)
        close12(t.Bc.numpy(), j.Bc)
        assert (t.nx, t.nu, t.name) == (j.nx, j.nu, j.name)
        rng = np.random.default_rng(1)
        x, u = rng.normal(size=t.nx), rng.normal(size=t.nu)
        close12(t.f(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
                j.f(x, u, None))


def test_coefficient_functions_match_jax_batched():
    rng = np.random.default_rng(2)
    speeds = rng.uniform(0.2, 3.0, 17)
    yaw = rng.uniform(-1.0, 1.0, 17)
    Ac, Bc = tm.lateral_error_ltv_coeffs(torch.as_tensor(speeds), yaw_scale=
                                         torch.as_tensor(yaw))
    Aj, Bj = jm.lateral_error_ltv_coeffs(jnp.asarray(speeds),
                                         yaw_scale=jnp.asarray(yaw))
    assert Ac.shape == (17, 3, 3) and Bc.shape == (17, 3, 1)
    close12(Ac.numpy(), np.moveaxis(np.asarray(Aj), -1, 0))
    close12(Bc.numpy(), np.broadcast_to(np.asarray(Bj), (17, 3, 1)))
    Ac1, _ = tm.lateral_error_ltv_coeffs(torch.tensor(0.9, dtype=torch.float64), -20.0, 50.0)
    close12(Ac1.numpy(), jm.lateral_error_ltv_coeffs(0.9, -20.0, 50.0)[0])

    Ac, Bc = tm.dynamic_bicycle_coeffs(torch.as_tensor(speeds))
    Aj, Bj = jm.dynamic_bicycle_coeffs(jnp.asarray(speeds))
    assert Ac.shape == (17, 4, 4) and Bc.shape == (17, 4, 1)
    close12(Ac.numpy(), np.moveaxis(np.asarray(Aj), -1, 0))
    close12(Bc.numpy(), np.moveaxis(np.asarray(Bj), -1, 0).reshape(17, 4, 1))
    kw = dict(m=900.0, a=1.2, b=1.6, Ca=40000.0, Jz=1100.0)
    close12(tm.dynamic_bicycle_coeffs(torch.tensor(1.7, dtype=torch.float64), **kw)[0].numpy(),
            jm.dynamic_bicycle_coeffs(1.7, **kw)[0])


def test_frenet_model_matches_jax():
    t, j = tm.frenet_path_frame(), jm.frenet_path_frame()
    assert (t.nx, t.nu, t.np) == (j.nx, j.nu, j.np) == (3, 2, 4)
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.5, 0.5, (32, 3)) + [0.0, 0.0, 1.0]
    u = rng.uniform(-0.3, 0.3, (32, 2))
    p = rng.uniform(-0.2, 0.2, (32, 4))
    close12(vmap(t.f)(*(torch.as_tensor(a) for a in (x, u, p))).numpy(),
            jax.vmap(j.f)(x, u, p))
    close12(vmap(tm.frenet_path_frame(2.0).f)(
        *(torch.as_tensor(a) for a in (x, u, p))).numpy(),
        jax.vmap(jm.frenet_path_frame(2.0).f)(x, u, p))


@pytest.mark.parametrize("course", ["lane_change", "extended"])
def test_reference_synthesis_matches_jax_exactly(course):
    path = (jr.synthetic_lane_change() if course == "lane_change"
            else jr.extend_lane_change_course())
    for unwrap in (False, True):
        np.testing.assert_array_equal(
            tr.path_heading(path["x"], path["y"], unwrap),
            jr.path_heading(path["x"], path["y"], unwrap))
        refs_t = tr.lateral_error_references(path, 0.05, unwrap=unwrap)
        refs_j = jr.lateral_error_references(path, 0.05, unwrap=unwrap)
        np.testing.assert_array_equal(refs_t, refs_j)
        np.testing.assert_array_equal(
            tr.lateral_error_references(path, 0.1, -20.0, 50.0, unwrap),
            jr.lateral_error_references(path, 0.1, -20.0, 50.0, unwrap))
    for Nt, Nsim in ((6, 40), (21, None), (11, len(refs_t) + 3)):
        np.testing.assert_array_equal(tr.stage_param_tensor(refs_t, Nt, Nsim),
                                      jr.stage_param_tensor(refs_j, Nt, Nsim))


@pytest.mark.parametrize("header", ["x,y,uref", "X,Y,URef", "px,py",
                                    "y,x,uref,extra"])
def test_load_path_csv_matches_pandas_loader(tmp_path, header):
    rng = np.random.default_rng(4)
    cols = header.split(",")
    rows = rng.normal(size=(9, len(cols)))
    f = tmp_path / "path.csv"
    f.write_text(header + "\n" + "\n".join(",".join(repr(float(v)) for v in r)
                                           for r in rows) + "\n")
    got, ref = tr.load_path_csv(str(f)), jr.load_path_csv(str(f))
    assert got.keys() == ref.keys()
    # pandas' default (fast) float parser may land a few ulp off the written
    # decimal; the csv module's float() reads it exactly
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-13, atol=1e-15)
    lower = [c.lower() for c in cols]
    xcol = lower.index("x") if "x" in lower else 0
    np.testing.assert_array_equal(got["x"], rows[:, xcol])
    if "uref" not in lower:
        np.testing.assert_array_equal(got["uref"], np.full(9, 0.4))


def test_load_path_csv_without_the_reference_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("MPC_VERDE_REFERENCE_DIR", raising=False)
    # the fallback directory, the JAX loader's, absent as well
    monkeypatch.setattr(tr_io, "_FALLBACK_DIR", str(tmp_path / "missing"))
    assert tr.reference_data_dir() is None
    with pytest.raises(FileNotFoundError):
        tr.load_path_csv("traj5.csv")


# JAX's rate-form problem (tests/test_rate_form.py): the unicycle in rate
# form, T = 0.2, N = 8, toward (5, 5, 0)
T, N = 0.2, 8
TARGET = np.array([5.0, 5.0, 0.0])
Qm = np.diag([1.0, 5.0, 0.1])
Rm = np.diag([0.5, 0.05])
U_BOX = ((-1.0, -np.pi / 4), (1.0, np.pi / 4))


def _pair(du_lb=None, du_ub=None):
    """The same rate-form OCP in both packages."""
    Fj = j_rk4_step(jm.unicycle.f, T)
    Ft = rk4_step(tm.unicycle.f, T)
    Qt, Rt = torch.as_tensor(Qm), torch.as_tensor(Rm)

    def lj(x, u, p, du):
        e = x - p[:3]
        return e @ jnp.array(Qm) @ e + u @ jnp.array(Rm) @ u

    def lt(x, u, p, du):
        e = x - p[:3]
        return e @ Qt @ e + u @ Rt @ u

    j = mv.to_rate_form(lambda x, u, p: Fj(x, u, p), lj, N=N, nx=3, nu=2,
                        npar=3, u_lb=jnp.array(U_BOX[0]),
                        u_ub=jnp.array(U_BOX[1]), du_lb=du_lb, du_ub=du_ub)
    t = to_rate_form(lambda x, u, p: Ft(x, u, p), lt, N=N, nx=3, nu=2,
                     npar=3, u_lb=U_BOX[0], u_ub=U_BOX[1], du_lb=du_lb,
                     du_ub=du_ub, **CPU64)
    return j, t


def _solve_both(du_lb=None, du_ub=None, z0=np.zeros(5), opts=None):
    j, t = _pair(du_lb, du_ub)
    params = np.broadcast_to(TARGET, (N + 1, 3))
    rj = jax.jit(mv.make_ilqr_solver(j, opts or mv.ILQROptions()))(
        jnp.asarray(z0), jnp.asarray(params))
    topts = None if opts is None else mt.ILQROptions(
        max_iters=opts.max_iters, tol_grad=opts.tol_grad,
        tol_cost=opts.tol_cost)
    rt = mt.make_ilqr_solver(t, topts or mt.ILQROptions())(z0, params)
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-9)
    return rt.us.numpy(), rt, rj


def test_rate_form_bounds_and_sizes_match_jax():
    Ntu = 3
    du_lb, du_ub = np.zeros((N, 2)), np.zeros((N, 2))
    du_lb[:Ntu], du_ub[:Ntu] = -0.4, 0.3
    j, t = _pair(du_lb, du_ub)
    assert (t.nx, t.nu, t.npar, t.N) == (j.nx, j.nu, j.npar, j.N) == (5, 2, 3, N)
    rng = np.random.default_rng(5)
    z = rng.uniform(-2, 2, (N, 5))
    w = rng.uniform(-1, 1, (N, 2))
    p = np.broadcast_to(TARGET, (N, 3))
    ks = np.arange(N)
    tz, tw, tp = (torch.as_tensor(a) for a in (z, w, p))
    # k as a tensor of stage indices under vmap, as the derivatives take it
    lt, ut = vmap(t.control_bounds)(tz, tp, torch.as_tensor(ks))
    lj, uj = jax.vmap(j.control_bounds)(z, p, ks)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    for k in range(N):   # and as an int, as the line search takes it
        lk, uk = t.control_bounds(tz[k], tp[k], k)
        np.testing.assert_array_equal(lk.numpy(), np.asarray(lj[k]))
        np.testing.assert_array_equal(uk.numpy(), np.asarray(uj[k]))
    close12(vmap(t.dynamics)(tz, tw, tp).numpy(), jax.vmap(j.dynamics)(z, w, p))
    close12(vmap(t.stage_cost)(tz, tw, tp).numpy(),
            jax.vmap(j.stage_cost)(z, w, p))
    # an open box is +-inf, a state box pads the u_prev rows with +-inf
    free = to_rate_form(t.dynamics, lambda x, u, p, du: u @ u, N=N, nx=3,
                        nu=2, **CPU64)
    lo, hi = free.control_bounds(tz[0], tp[0], 0)
    assert torch.isneginf(lo).all() and torch.isposinf(hi).all()
    boxed = to_rate_form(t.dynamics, lambda x, u, p, du: u @ u, N=N, nx=3,
                         nu=2, x_ub=[1.0, 2.0, 3.0], **CPU64)
    jb = mv.to_rate_form(j.dynamics, lambda x, u, p, du: u @ u, N=N, nx=3,
                         nu=2, x_ub=jnp.array([1.0, 2.0, 3.0]))
    np.testing.assert_array_equal(boxed.x_lb.numpy(), np.asarray(jb.x_lb))
    np.testing.assert_array_equal(boxed.x_ub.numpy(), np.asarray(jb.x_ub))


def test_move_blocking_freezes_tail():
    Ntu = 2
    du_lb, du_ub = np.zeros((N, 2)), np.zeros((N, 2))
    du_lb[:Ntu], du_ub[:Ntu] = -np.inf, np.inf
    us, _, _ = _solve_both(du_lb, du_ub)
    u_act = np.cumsum(us, axis=0)
    assert np.allclose(u_act[Ntu:], u_act[Ntu], atol=1e-9)
    assert np.abs(us[Ntu:]).max() == 0.0   # pinned exactly, by the clip
    assert np.abs(us[:Ntu]).max() > 0.0


def test_rate_bounds_respected():
    du_max = 0.1
    us, _, _ = _solve_both(np.full(2, -du_max), np.full(2, du_max))
    assert us.max() <= du_max + 1e-9
    assert us.min() >= -du_max - 1e-9
    assert np.cumsum(us, axis=0)[:, 0].max() <= 1.0 + 1e-7


def test_uprev_enters_via_initial_state():
    du_max = 0.05
    uprev = np.array([0.5, 0.1])
    us, _, _ = _solve_both(np.full(2, -du_max), np.full(2, du_max),
                           z0=np.concatenate([np.zeros(3), uprev]))
    assert np.abs(us[0]).max() <= du_max + 1e-9


def test_rate_form_equals_plain_when_unconstrained_rates():
    opts = mv.ILQROptions(max_iters=300, tol_grad=1e-10, tol_cost=1e-15)
    _, r_rate, _ = _solve_both(opts=opts)
    F = rk4_step(tm.unicycle.f, T)
    Qt, Rt = torch.as_tensor(Qm), torch.as_tensor(Rm)
    plain = mt.OCP(dynamics=F, stage_cost=lambda x, u, p: (
        (x - p[:3]) @ Qt @ (x - p[:3]) + u @ Rt @ u), N=N, nx=3, nu=2, npar=3,
        control_bounds=mt.box_bounds(*U_BOX, **CPU64),
        device=torch.device("cpu"), dtype=torch.float64)
    r_plain = mt.make_ilqr_solver(plain, mt.ILQROptions(
        max_iters=300, tol_grad=1e-10, tol_cost=1e-15))(
        np.zeros(3), np.broadcast_to(TARGET, (N + 1, 3)))
    assert abs(float(r_rate.cost) - float(r_plain.cost)) < 1e-6 * (
        1 + abs(float(r_plain.cost)))
