"""Data exchange with the JAX package, and the bench problem.

The JAX package (``mpc_verde_tpu``) is the reference; the port never imports
it.  Data crosses as numpy arrays: ``from_numpy`` turns what the JAX side
feeds or returns into tensors, ``result_to_numpy`` turns a port result back.
``unicycle_ocp`` builds a unicycle OCP with its matching device model,
``linear_rate_ocp`` the rate form of a linear plant, ``frenet_rate_ocp``
and ``curvature_rate_ocp`` those of the Frenet and curvature families (their
callables only: the kernels run them on the model traced from those),
``bench_ocp`` the diff-drive point-stabilization OCP that the JAX package's
``bench.py`` headlines (``build_ocp``), constants included, optionally with a
state box, and ``derived_ocps`` the OCPs that the interior-point and
state-bound solvers derive from it, each with its derived device model
(``derived_params`` lays out their params).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import frenet_path_frame, unicycle
from .ocp import OCP, box_bounds, to_rate_form
from .ops import discretize, rk4_step, rk4_step_with_quadrature
from .ops.cuda.rollout import UnicycleDeviceModel
from .runtime import ClosedLoopResult
from .solver.ilqr import ILQRResult

BENCH_DT = 0.2


_RESULTS = (ILQRResult, ClosedLoopResult)


def from_numpy(tree, device, dtype=torch.float32):
    """Turn the numpy arrays of a nested structure into tensors.

    Floating arrays become ``dtype``; integer and bool arrays keep their
    kind; ``None`` stays ``None``.  Dicts, lists and tuples are walked; a
    dataclass with the fields of ``ILQRResult`` or ``ClosedLoopResult`` (the
    JAX result types) becomes that port type.  Anything array-like (a JAX
    array) goes through ``np.asarray`` first.
    """
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device, dtype) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        have = {f.name for f in dataclasses.fields(tree)}
        for cls in _RESULTS:
            names = [f.name for f in dataclasses.fields(cls)]
            if have == set(names):
                return cls(**{n: from_numpy(getattr(tree, n), device, dtype)
                              for n in names})
        raise TypeError(f"from_numpy: no counterpart for {type(tree).__name__}")
    a = np.array(tree)  # a copy: the source may be a read-only view
    t = torch.from_numpy(a).to(device)
    return t.to(dtype) if a.dtype.kind == "f" else t


def result_to_numpy(res):
    """The same result type (``ILQRResult`` or ``ClosedLoopResult``) with
    numpy arrays on the host in place of tensors."""
    return type(res)(**{
        f.name: None if getattr(res, f.name) is None
        else getattr(res, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(res)})


def unicycle_ocp(N: int, device, dtype=torch.float32, *, dt: float, Q, R,
                 lb=None, ub=None, Qf=None, u_ref=None, cost="discrete",
                 quad_substeps: int = 1, integrator="rk4",
                 substeps: int = 1) -> OCP:
    """A unicycle OCP stepped by ``integrator`` at ``dt`` (``discretize``:
    "rk4" with ``substeps`` substeps, or one "euler" step), target in
    p[:3], control reference in p[u_ref : u_ref + 2] when ``u_ref`` is given
    (npar = max(3, u_ref + 2)), running cost L = (x - p[:3])' Q (x - p[:3])
    + (u - r)' R (u - r) (r = 0 without a reference), stage cost L
    (``cost="discrete"``) or its RK4 quadrature over ``dt`` with
    ``quad_substeps`` substeps (``cost="quadrature"``,
    ``rk4_step_with_quadrature``), terminal cost (x - p[:3])' Qf (x - p[:3])
    when ``Qf`` is given, and the control box [lb, ub] (none when both are
    None).

    The weights and bounds keep the values the caller gives (float32 arrays
    stay float32-rounded values), so a float64 build of the OCP equals the
    JAX one under x64: the JAX package's bench and fleet write them as
    float32 arrays, its scenario families as float64 numbers.  The OCP
    carries the matching ``UnicycleDeviceModel`` (an unbounded OCP's has
    infinite bounds) for the CUDA kernels, which take every number rounded
    to float32.
    """
    device = torch.device(device)
    num = lambda a: np.asarray(a, dtype=np.float64)
    Qn, Rn = num(Q), num(R)
    Qt = torch.as_tensor(Qn, dtype=dtype, device=device)
    Rt = torch.as_tensor(Rn, dtype=dtype, device=device)
    F = discretize(unicycle, dt, method=integrator, M=substeps)

    def L(x, u, p):
        e = x - p[:3]
        du = u if u_ref is None else u - p[u_ref:u_ref + 2]
        return e @ Qt @ e + du @ Rt @ du

    if cost == "discrete":
        l = L
    elif cost == "quadrature":
        quad = rk4_step_with_quadrature(unicycle.f, L, dt, M=quad_substeps)

        def l(x, u, p):
            return quad(x, u, p)[1]
    else:
        raise ValueError(f"unknown stage cost {cost!r}")

    lf = None
    if Qf is not None:
        Qf = num(Qf)
        Qft = torch.as_tensor(Qf, dtype=dtype, device=device)

        def lf(x, p):
            e = x - p[:3]
            return e @ Qft @ e

    cb = None
    if lb is None and ub is None:
        lb, ub = np.full(2, -np.inf), np.full(2, np.inf)
    else:
        lb, ub = num(lb), num(ub)
        cb = box_bounds(lb, ub, device=device, dtype=dtype)
    model = UnicycleDeviceModel(
        dt=dt, Q=Qn, R=Rn, lb=lb, ub=ub, Qf=Qf, integrator=integrator,
        substeps=substeps if integrator == "rk4" else 1, u_ref=u_ref,
        cost=cost, quad_substeps=quad_substeps)
    return OCP(dynamics=F, stage_cost=l, terminal_cost=lf, N=N, nx=3, nu=2,
               npar=model.min_npar, control_bounds=cb, device=device,
               dtype=dtype, device_model=model)


def linear_rate_ocp(N: int, device, dtype=torch.float32, *, Q, R, R_du=None,
                    u_lb=None, u_ub=None, du_lb=None, du_ub=None, Ad=None,
                    Bd=None, ab_col=None, x_ref=None, target=None,
                    u_ref=None, curvature=None, q_param=None) -> OCP:
    """The rate form (``to_rate_form``) of the linear plant ``x' = Ad x +
    Bd u`` with the cost ``(x - r)' Q (x - r) + (u - u_r)' R (u - u_r) + du'
    R_du du``.

    ``Ad`` (nx0, nx0) and ``Bd`` (nx0, nu) are constants, or with
    ``ab_col`` each stage's params hold them (``Ad`` row-major from column
    ``ab_col``, then ``Bd``).  ``r`` is ``p[x_ref : x_ref + nx0]`` or the
    constant ``target`` (zeros by default), ``u_r`` is ``p[u_ref : u_ref +
    nu]`` or zero; ``R_du`` defaults to zeros.  ``q_param = (i, col)``
    makes the weight ``Q[i, i]`` the stage parameter ``p[col]`` (the
    constant's entry is then unused).  ``u_lb`` / ``u_ub`` (nu,) and
    ``du_lb`` / ``du_ub`` ((nu,) or (N, nu)) are the magnitude and rate
    boxes (+-inf where None).  ``curvature = (L, lambda1, lambda2,
    lambda3)`` replaces the quadratic cost with the curvature family's
    (``scenarios/curvature.py``: nx0 3, nu 1, ``p[:4] = (y_t, phi_t,
    kappa_t, v_des)``).  The OCP's npar is the columns the callables read.
    The numbers keep the caller's values; the kernels take them rounded to
    float32.
    """
    device = torch.device(device)
    num = lambda a: np.asarray(a, dtype=np.float64)
    Qn, Rn = num(Q), num(R)
    nx0, nu = Qn.shape[0], Rn.shape[0]
    R_dun = np.zeros((nu, nu)) if R_du is None else num(R_du)
    cols = [0 if curvature is None else 4]
    if ab_col is not None:
        cols.append(ab_col + nx0 * (nx0 + nu))
    if x_ref is not None:
        cols.append(x_ref + nx0)
    if u_ref is not None:
        cols.append(u_ref + nu)
    if q_param is not None:
        cols.append(q_param[1] + 1)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    Qt, Rt, Rdt = t(Qn), t(Rn), t(R_dun)
    rt = t(np.zeros(nx0) if target is None else num(target))

    if ab_col is None:
        At, Bt = t(num(Ad)), t(num(Bd))

        def F(x, u, p):
            return At @ x + Bt @ u
    else:
        def F(x, u, p):
            A = p[ab_col:ab_col + nx0 * nx0].reshape(nx0, nx0)
            B = p[ab_col + nx0 * nx0:ab_col + nx0 * (nx0 + nu)].reshape(nx0, nu)
            return A @ x + B @ u

    if q_param is not None:   # Q[i, i] = p[col]: a mask, which torch.func takes
        Mq = torch.zeros_like(Qt)
        Mq[q_param[0], q_param[0]] = 1.0

    def Q_of(p):
        return Qt if q_param is None else Qt * (1.0 - Mq) + p[q_param[1]] * Mq

    def l(x, u, p, du):
        e = x - (rt if x_ref is None else p[x_ref:x_ref + nx0])
        eu = u if u_ref is None else u - p[u_ref:u_ref + nu]
        return e @ Q_of(p) @ e + eu @ Rt @ eu + du @ Rdt @ du

    if curvature is not None:
        L, lam1, lam2, lam3 = map(float, curvature)

        def l(x, u, p, du):
            # scenarios/curvature.py's cost: R_t = 1 / kappa_t is the turn
            # radius, which the reference writes in place of a weight
            y, phi, r = x[0], x[1], x[2]
            yt, phit, kappat, vdes = p[0], p[1], p[2], p[3]
            Rt = 1.0 / kappat
            z = torch.tan(u[0]) - L * kappat
            return (lam2 * (y - yt) ** 2 + lam3 * (phi - phit) ** 2
                    + lam1 * (r * Rt - vdes) ** 2 + Rt * z * z)

    return to_rate_form(F, l, N=N, nx=nx0, nu=nu, npar=max(cols), u_lb=u_lb,
                        u_ub=u_ub, du_lb=du_lb, du_ub=du_ub, device=device,
                        dtype=dtype)


def frenet_rate_ocp(N: int, device, dtype=torch.float32, *, T: float,
                    L: float, lambda1: float, lambda2: float, lambda3: float,
                    lambda4: float, lambda5: float, delta_max: float,
                    a_max: float, delta_dot_max: float) -> OCP:
    """The Frenet family's OCP (``scenarios/frenet.py``): the rate form of
    one RK4 step over ``T`` of the path-frame model (``models/frenet.py``,
    wheelbase ``L``), the cost ``(l1 (v - v_des)^2 + l2 (y - y_t)^2 + l3
    (phi - phi_t)^2 + l4 a^2 + l5 (tan(delta) - L kappa_t)^2) / (N + 1)``
    over ``p = (y_t, phi_t, kappa_t, v_des)``, the box ``|delta| <=
    delta_max``, ``|a| <= a_max``, ``|du_delta| <= delta_dot_max`` (``du_a``
    free), from one set of numbers (the JAX package's ``SPEC``)."""
    device = torch.device(device)
    u_lb, u_ub = np.array([-delta_max, -a_max]), np.array([delta_max, a_max])
    du_lb = np.array([-delta_dot_max, -np.inf])
    du_ub = np.array([delta_dot_max, np.inf])
    F = rk4_step(frenet_path_frame(L).f, T, M=1)

    def l(x, u, p, du):
        y, phi, v = x[0], x[1], x[2]
        delta, a = u[0], u[1]
        yt, phit, kappat, vdes_k = p[0], p[1], p[2], p[3]
        z = torch.tan(delta) - L * kappat
        return (lambda1 * (v - vdes_k) ** 2 + lambda2 * (y - yt) ** 2
                + lambda3 * (phi - phit) ** 2 + lambda4 * a ** 2
                + lambda5 * z ** 2) / (N + 1)

    return to_rate_form(F, l, N=N, nx=3, nu=2, npar=4, u_lb=u_lb, u_ub=u_ub,
                        du_lb=du_lb, du_ub=du_ub, device=device, dtype=dtype)


def curvature_rate_ocp(N: int, device, dtype=torch.float32, *, Ntu: int,
                       L: float, lambda1: float, lambda2: float,
                       lambda3: float, delta_max: float) -> OCP:
    """The curvature family's OCP (``scenarios/curvature.py``): the rate
    form of the LTV lateral-error model with each stage's (Ad, Bd) in
    ``p[4:16]`` (``ab_col`` 4, after ``(y_t, phi_t, kappa_t, v_des)``), the
    curvature cost (``linear_rate_ocp``'s ``curvature``), the steering box
    ``|delta| <= delta_max`` and move blocking after ``Ntu`` (free rates,
    then rates pinned to 0)."""
    du_lb, du_ub = np.zeros((N, 1)), np.zeros((N, 1))
    du_lb[:Ntu], du_ub[:Ntu] = -np.inf, np.inf
    return linear_rate_ocp(
        N, device, dtype, Q=np.zeros((3, 3)), R=np.zeros((1, 1)),
        u_lb=[-delta_max], u_ub=[delta_max], du_lb=du_lb, du_ub=du_ub,
        ab_col=4, curvature=(L, lambda1, lambda2, lambda3))


def bench_ocp(N: int, device, dtype=torch.float32, *, x_lb=None,
              x_ub=None, box: bool = True) -> OCP:
    """The bench OCP: unicycle, RK4 at T = 0.2, Q = diag(1, 5, 0.1),
    R = diag(0.5, 0.05), target in p[:3], box v in [-1, 1] and
    omega in [-pi/4, pi/4], no terminal cost (``unicycle_ocp``); with
    ``x_lb`` / ``x_ub`` ((3,), +-inf for no bound) also the state box, which
    the solvers enforce by their augmented Lagrangian.  ``box=False`` drops
    the control box (the JAX side: ``dataclasses.replace(bench.build_ocp(N),
    control_bounds=None)``), the problem the ``"scan"`` backend takes."""
    f32 = lambda a: np.array(a, dtype=np.float32)
    lb, ub = ((f32([-1.0, -np.pi / 4]), f32([1.0, np.pi / 4])) if box
              else (None, None))
    ocp = unicycle_ocp(N, device, dtype, dt=BENCH_DT,
                       Q=np.diag(f32([1.0, 5.0, 0.1])),
                       R=np.diag(f32([0.5, 0.05])), lb=lb, ub=ub)
    if x_lb is None and x_ub is None:
        return ocp
    box = lambda b: None if b is None else torch.as_tensor(
        np.asarray(b, np.float64), dtype=dtype, device=ocp.device)
    return dataclasses.replace(ocp, x_lb=box(x_lb), x_ub=box(x_ub))


def derived_ocps(ocp: OCP) -> dict:
    """The OCPs that the solvers run in place of ``ocp`` (which needs a
    constant control box), as they build them, device models included:
    ``"barrier"`` (``make_streaming_barrier_solver``, params [p, mu]),
    ``"barrier_batched"`` (``make_barrier_solver``, [p, mu], no clip box),
    and where ``ocp`` has a state box ``"al"`` (the AL rounds, [p, lam (6),
    mu_al]) and ``"barrier_al"`` (the streaming composition, [p, mu, lam,
    mu_al])."""
    from .solver.batched import _augment_ocp_al
    from .solver.ipm import _barrier_ocp

    plain = dataclasses.replace(ocp, x_lb=None, x_ub=None)
    out = {"barrier": _barrier_ocp(plain, "streaming"),
           "barrier_batched": _barrier_ocp(plain, "batched")}
    if ocp.has_state_bounds:
        out["al"] = _augment_ocp_al(ocp)
        out["barrier_al"] = _augment_ocp_al(_barrier_ocp(ocp, "streaming"))
    return out


def derived_params(name: str, ps, *, mu=1e-2, lam=None, mu_al=10.0):
    """Params of ``derived_ocps(...)[name]`` from the base params ``ps``
    (..., N+1, npar): ``ps`` with the barrier's ``mu`` column, and for the AL
    OCPs ``lam`` (..., N+1, 6) (zeros if None) and ``mu_al``.  ``mu`` and
    ``mu_al`` are numbers or tensors of ``ps``'s leading shape without its
    stage axis (one value a problem)."""
    lead, stages = ps.shape[:-2], ps.shape[-2]

    def col(v):
        v = torch.as_tensor(v, dtype=ps.dtype, device=ps.device).expand(lead)
        return v[..., None, None].expand(*lead, stages, 1)

    cols = [ps]
    if name.startswith("barrier"):
        cols.append(col(mu))
    if name.endswith("al"):
        cols.append(torch.zeros((*ps.shape[:-1], 6), dtype=ps.dtype,
                                device=ps.device) if lam is None else lam)
        cols.append(col(mu_al))
    return torch.cat(cols, dim=-1).contiguous()
