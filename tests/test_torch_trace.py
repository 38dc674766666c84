"""The traced device model: an OCP's own callables lowered to a scalar
program (``ops/cuda/trace.py``) and written as a CUDA model
(``ops/cuda/codegen.py``), on which K2 and K3 run for an OCP without a
hand-written device model, as the Pallas kernels inline the callables'
jaxpr.  Held here on the CPU:

* the program's evaluator in float64 against the callables themselves and
  against the JAX package's ``_hoist_consts`` pure functions of the same
  OCPs built in JAX from the same numbers (the bench OCP, the three user
  OCPs of ``chip_smoke.USER_OCPS``, the bench OCP's AL-derived OCP with the
  box y <= 5 and its two barrier-derived OCPs, a rate-form OCP's AL-derived
  and streaming barrier-derived OCPs), to 1e-12 of max(1, |ref|), first and
  second derivatives included;
* the twins ``fused_backward_torch`` and ``linesearch_forward_torch`` on an
  OCP whose callables are the evaluator's against JAX's "xla" parts in
  float64 (1e-9), also on the AL-derived and the streaming barrier-derived
  OCPs of a rate-form OCP (``test_torch_bw._rate_ocp``, which
  ``backend=None`` traces on a card), and against
  ``linesearch_forward_pallas`` in interpret mode (float32 there: JAX's own
  tolerances, 5e-5);
* JAX's two CSE regressions, a stage-varying box read at the traced stage
  index, and the refusals (an op outside the lowering table, a callable
  that branches on a value);
* the generated header compiled by the host ``g++`` with ``__device__``
  defined away: ``step`` / ``stage_cost`` / ``terminal_cost`` / the box in
  float and in double, and K3's dual-number derivatives (the stage cost and
  the step on second-order duals over z = [x; u], the terminal value over
  x_N), against the evaluator and ``torch.func``;
* a program's text does not depend on the table's values;
* each lowering no OCP here reaches, on a function of x (3,) against the
  function itself, the composites decomposed in the trace and the folds of
  the ops added beside Mosaic's table among them (tests/test_torch_trace_ops.py
  holds those ops on OCPs).
"""
import dataclasses
import gc
import shutil
import subprocess
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import hessian, jacfwd, vmap

import bench
import chip_smoke as cs
import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu.ops.pallas.rollout import (_hoist_consts,
                                              linesearch_forward_pallas)
from mpc_verde_tpu.solver.batched import _augment_ocp_al as j_augment_al
from mpc_verde_tpu.solver.batched import _make_parts as j_make_parts
from mpc_verde_tpu.solver.ipm import _barrier_term as j_barrier_term
from mpc_verde_tpu_torch.interop import bench_ocp, unicycle_ocp
from mpc_verde_tpu_torch.ocp.spec import box_bounds
from mpc_verde_tpu_torch.ops.cuda.codegen import (model_header, program_hash,
                                                  units)
from mpc_verde_tpu_torch.ops.cuda.fused import fused_backward_torch
from mpc_verde_tpu_torch.ops.cuda.rollout import (TracedDeviceModel,
                                                  linesearch_forward_torch,
                                                  traced_device_model)
from mpc_verde_tpu_torch.ops.cuda.trace import Tracer, trace_ocp
from mpc_verde_tpu_torch.solver.batched import _augment_ocp_al
from mpc_verde_tpu_torch.solver.ipm import _barrier_ocp, _barrier_term
from test_pallas_rollout import _problem as j_pallas_problem
from test_torch_bw import _j_rate_ocp, _jax_user_ocp, _rate_ocp

N = 6
F64 = torch.float64
Y_BOX = np.array([np.inf, 5.0, np.inf])   # chip_smoke phase 12's box y <= 5
BENCH_BOX = (np.array([-1.0, -np.pi / 4], np.float32),
             np.array([1.0, np.pi / 4], np.float32))


def _close(a, ref, tol, what=""):
    """|a - ref| <= tol max(1, |ref|), NaN and inf where ref has them."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape, (what, a.shape, ref.shape)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(ref), err_msg=what)
    np.testing.assert_array_equal(a[np.isinf(ref)], ref[np.isinf(ref)],
                                  err_msg=what)
    err = np.abs(a[fin] - ref[fin]) / np.maximum(1.0, np.abs(ref[fin]))
    assert not err.size or err.max() <= tol, (what, float(err.max()))


# ---- the OCPs, in the port and in JAX from the same numbers ---------------

def _j_barrier(ocp_j, rule, box=BENCH_BOX):
    """The barrier OCP the JAX solvers build (solver/ipm.py) on the constant
    control box ``box``, rule "streaming" (make_streaming_barrier_solver) or
    "batched" (make_barrier_solver)."""
    lb, ub = (np.asarray(b, np.float64) for b in box)
    npar = max(ocp_j.npar, 1)
    l, F, cb = ocp_j.stage_cost, ocp_j.dynamics, ocp_j.control_bounds
    if rule == "streaming":
        def stage_b(x, u, p):
            return l(x, u, p[:npar]) + j_barrier_term(u, lb, ub, p[npar])

        cb_b = lambda x, p, k: cb(x, p[:npar], k)
    else:
        def stage_b(x, u, p):
            barrier = jnp.sum(jnp.log(u - lb)) + jnp.sum(jnp.log(ub - u))
            return l(x, u, p[:npar]) - p[npar] * barrier

        cb_b = None
    return dataclasses.replace(
        ocp_j, stage_cost=stage_b, dynamics=lambda x, u, p: F(x, u, p[:npar]),
        control_bounds=cb_b, npar=npar + 1)


def _case(name):
    """(port OCP in float64 without a device model, JAX OCP)."""
    if name in cs.USER_OCPS:
        return cs.user_ocp(name, "cpu", F64), _jax_user_ocp(name)
    if name == "rate_al":
        return (_augment_ocp_al(_rate_ocp(F64, state_box=True)),
                j_augment_al(_j_rate_ocp(state_box=True)))
    if name == "rate_barrier":
        return (_barrier_ocp(_rate_ocp(F64), "streaming"),
                _j_barrier(_j_rate_ocp(), "streaming", ([-0.5], [0.5])))
    base = dataclasses.replace(bench_ocp(N, "cpu", F64), device_model=None)
    base_j = bench.build_ocp(N)
    if name == "bench":
        return base, base_j
    if name == "bench_al":
        return (_augment_ocp_al(dataclasses.replace(
            base, x_ub=torch.as_tensor(Y_BOX, dtype=F64))),
            j_augment_al(dataclasses.replace(base_j, x_ub=jnp.asarray(Y_BOX))))
    rule = name.split("_")[-1]
    return (dataclasses.replace(_barrier_ocp(base, rule), device_model=None),
            _j_barrier(base_j, rule))


CASES = ["bench", *cs.USER_OCPS, "bench_al", "bench_barrier_streaming",
         "bench_barrier_batched", "rate_al", "rate_barrier"]


def _inputs(name, ocp, B, seed):
    """Random (x, u, p) for ``ocp``: the barrier's mu column mixes positive
    values and the crossover's 0, with some controls outside the box; the
    AL's multipliers are >= 0 and its mu > 0."""
    rng = np.random.default_rng(seed)
    npar = max(ocp.npar, 1)
    x = rng.uniform(-2, 2, (B, ocp.nx))
    u = rng.uniform(-0.9, 0.9, (B, ocp.nu))
    p = rng.uniform(-1, 1, (B, npar))
    if name in ("bench_barrier_streaming", "bench_barrier_batched",
                "rate_barrier"):
        p[:, -1] = np.where(np.arange(B) % 3 == 0, 0.0, 10.0 ** -rng.integers(
            1, 4, B))
        u[::4] *= 3.0   # outside the box: +inf ("streaming") or NaN
    if name in ("bench_al", "rate_al"):
        lam = 3 if name == "bench_al" else 1   # the base OCP's columns
        p[:, lam:-1] = np.abs(p[:, lam:-1])
        p[:, -1] = 10.0 ** rng.uniform(0, 2, B)
    return x, u, p


def _evaluated(model, x, u, p, k):
    t = lambda a: torch.as_tensor(a, dtype=F64)
    x, u, p = t(x), t(u), t(p)
    out = {"step": model.step(x, u, p), "stage_cost": model.stage_cost(x, u, p),
           "terminal_cost": model.terminal_cost(x, p)}
    out["lb"], out["ub"] = model.bounds(x, p, k)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("name", CASES)
def test_program_matches_callables_and_jax(name):
    """The evaluator against the port's callables (vmapped) and against
    JAX's _hoist_consts pure functions, on 16 random points at every stage
    index, values and (for the dynamics and the costs) first and second
    derivatives, to 1e-12."""
    ocp, ocp_j = _case(name)
    model = traced_device_model(ocp)
    assert isinstance(model, TracedDeviceModel)
    assert model.min_npar <= max(ocp.npar, 1)
    B = 16
    x, u, p = _inputs(name, ocp, B, seed=len(name))
    k = np.arange(B) % N
    got = _evaluated(model, x, u, p, torch.as_tensor(k))
    t = lambda a: torch.as_tensor(a, dtype=F64)
    ref = {"step": vmap(ocp.dynamics)(t(x), t(u), t(p)),
           "stage_cost": vmap(ocp.stage_cost)(t(x), t(u), t(p)),
           "terminal_cost": (vmap(ocp.terminal_cost)(t(x), t(p))
                             if ocp.terminal_cost else torch.zeros(B, dtype=F64))}
    if ocp.control_bounds is not None:
        ref["lb"], ref["ub"] = vmap(ocp.control_bounds)(t(x), t(p),
                                                        torch.as_tensor(k))
    for key, r in ref.items():
        _close(got[key], r.numpy(), 1e-12, f"{name} {key} vs callables")

    # JAX: the same functions through _hoist_consts, vmapped
    def hoisted(fn, *args):
        pure, consts = _hoist_consts(fn, *(a[0] for a in args))
        return np.asarray(jax.vmap(lambda *a: pure(*a, *consts))(*args))

    j = lambda a: jnp.asarray(a, jnp.float64)
    _close(got["step"], hoisted(ocp_j.dynamics, j(x), j(u), j(p)), 1e-12,
           f"{name} step vs JAX")
    _close(got["stage_cost"], hoisted(ocp_j.stage_cost, j(x), j(u), j(p)),
           1e-12, f"{name} stage cost vs JAX")
    if ocp_j.terminal_cost is not None:
        _close(got["terminal_cost"], hoisted(ocp_j.terminal_cost, j(x), j(p)),
               1e-12, f"{name} terminal cost vs JAX")
    if ocp_j.control_bounds is not None:
        pure, consts = _hoist_consts(ocp_j.control_bounds, j(x)[0], j(p)[0],
                                     jnp.asarray(0))
        lb, ub = jax.vmap(lambda a, b, c: pure(a, b, c, *consts))(
            j(x), j(p), jnp.asarray(k))
        _close(got["lb"], np.asarray(lb), 1e-12, f"{name} lb vs JAX")
        _close(got["ub"], np.asarray(ub), 1e-12, f"{name} ub vs JAX")

    # derivatives where the values are finite (the derivative records K3
    # builds on duals; here torch.func on the evaluator and on the callables)
    fin = np.isfinite(got["stage_cost"])
    xf, uf, pf = (t(a[fin][:4]) for a in (x, u, p))
    z = torch.cat([xf, uf], -1)
    nx = ocp.nx
    for fn_ev, fn_ref, what in (
            (lambda zz, pp: model.step(zz[:nx], zz[nx:], pp),
             lambda zz, pp: ocp.dynamics(zz[:nx], zz[nx:], pp), "step"),
            (lambda zz, pp: model.stage_cost(zz[:nx], zz[nx:], pp),
             lambda zz, pp: ocp.stage_cost(zz[:nx], zz[nx:], pp), "stage")):
        _close(vmap(jacfwd(fn_ev))(z, pf).numpy(),
               vmap(jacfwd(fn_ref))(z, pf).numpy(), 1e-12, f"{name} d{what}")
        _close(vmap(jacfwd(jacfwd(fn_ev)))(z, pf).numpy(),
               vmap(jacfwd(jacfwd(fn_ref)))(z, pf).numpy(), 1e-12,
               f"{name} d2{what}")


def _evaluator_ocp(ocp):
    """``ocp`` with callables that evaluate its traced program."""
    m = traced_device_model(ocp)
    return dataclasses.replace(
        ocp, dynamics=m.step, stage_cost=m.stage_cost,
        terminal_cost=None if ocp.terminal_cost is None else m.terminal_cost,
        control_bounds=None if ocp.control_bounds is None else m.bounds)


@pytest.mark.parametrize("name", ["bench", *cs.USER_OCPS, "bench_al",
                                  "rate_al", "rate_barrier"])
def test_twins_on_the_evaluator_match_jax_xla(name):
    """fused_backward_torch and linesearch_forward_torch on the evaluator's
    callables against JAX's "xla" derivs -> backward and materialising line
    search in float64, on trajectories rolled out by JAX from random
    controls and random gains: 1e-9 of max(1, |ref|)."""
    ocp, ocp_j = _case(name)
    ev = _evaluator_ocp(ocp)
    opt = mv.ILQROptions(n_alphas=6, alpha_decay=0.4)
    B = 4
    x0, u0, p = _inputs(name, ocp, B, seed=3)
    rng = np.random.default_rng(5)
    ps = np.broadcast_to(p[:, None], (B, N + 1, p.shape[-1])).copy()
    us = np.broadcast_to(u0[:, None] * 0.5, (B, N, ocp.nu)) + 0.1 * \
        rng.standard_normal((B, N, ocp.nu))
    ocp_j = dataclasses.replace(ocp_j, N=N)
    xla = j_make_parts(ocp_j, opt, "xla", "materialize")
    xs, us_c, _ = jax.jit(xla.rollout)(x0, us, ps)
    reg, ddp = np.full(B, 1e-5), np.array([1.0, 0.0, 1.0, 1.0])
    d, gN, HN, dlb, dub = jax.jit(xla.derivs)(xs, us_c, ps)
    ref = jax.jit(xla.backward)(d, gN, HN, dlb, dub, reg, ddp)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=F64)
    ev = dataclasses.replace(ev, N=N)
    out = fused_backward_torch(t(xs), t(us_c), t(ps), t(reg), t(ddp), ocp=ev,
                               tol=opt.boxqp_tol)
    for key, o, r in zip(("kff", "K", "dV1", "dV2", "gmax"), out, ref):
        _close(o.numpy(), np.asarray(r), 1e-9, f"{name} {key}")

    kff = 0.3 * rng.standard_normal((B, N, ocp.nu))
    K = 0.1 * rng.standard_normal((B, N, ocp.nu, ocp.nx))
    alphas = tuple(float(opt.alpha_decay) ** i for i in range(opt.n_alphas))
    xs_r, us_r, c_r = jax.jit(xla.linesearch)(x0, xs, us_c, ps, kff, K)
    xs_t, us_t, c_t, _ = linesearch_forward_torch(
        t(x0), t(xs), t(us_c), t(ps), t(kff), t(K), alphas, ocp=ev)
    for key, o, r in (("xs", xs_t, xs_r), ("us", us_t, us_r),
                      ("cost", c_t, c_r)):
        _close(o.numpy(), np.asarray(r), 1e-9, f"{name} line search {key}")


def test_linesearch_twin_on_the_evaluator_matches_pallas_interpret():
    """tests/test_pallas_rollout.py's problem (terminal cost 2 e'Qe) and
    inputs: the twin on the evaluator of the port's OCP in float64 against
    linesearch_forward_pallas in interpret mode in float32, at that test's
    tolerances (us 5e-5, xs 5e-4 absolute, cost 5e-5 relative)."""
    from test_pallas_rollout import B as PB, N as PN, NPAR, NU, NX
    F, l, lf, cb = j_pallas_problem()
    rng = np.random.default_rng(3)
    x0s = rng.uniform(-2, 2, (PB, NX)).astype(np.float32)
    xs = rng.uniform(-2, 2, (PB, PN + 1, NX)).astype(np.float32)
    us = rng.uniform(-0.8, 0.8, (PB, PN, NU)).astype(np.float32)
    ps = np.broadcast_to(np.array([10.0, 10.0, 0.0], np.float32),
                         (PB, PN + 1, NPAR)).copy()
    kffs = (0.3 * rng.normal(size=(PB, PN, NU))).astype(np.float32)
    Ks = (0.2 * rng.normal(size=(PB, PN, NU, NX))).astype(np.float32)
    alphas = tuple(0.4 ** i for i in range(6))
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        xs_p, us_p, c_p = linesearch_forward_pallas(
            *(jnp.asarray(a) for a in (x0s, xs, us, ps, kffs, Ks)),
            alphas=alphas, dynamics=F, stage_cost=l, terminal_cost=lf,
            control_bounds=cb, nx=NX, nu=NU)
    Q = np.diag([1.0, 5.0, 0.1])
    ocp = dataclasses.replace(unicycle_ocp(
        PN, "cpu", F64, dt=0.2, Q=Q, R=np.diag([0.5, 0.05]), Qf=2.0 * Q,
        lb=[-1.0, -np.pi / 4], ub=[1.0, np.pi / 4]), device_model=None)
    t = lambda a: torch.as_tensor(a, dtype=F64)
    xs_t, us_t, c_t, _ = linesearch_forward_torch(
        *(t(a) for a in (x0s, xs, us, ps, kffs, Ks)), alphas,
        ocp=_evaluator_ocp(ocp))
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_p), rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_p), rtol=0,
                               atol=5e-4)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_p), rtol=5e-5)


def _trace_fn(fn, **sizes):
    """Trace one callable of inputs ``sizes`` (name -> length) and return
    (program, its output value numbers)."""
    tr = Tracer(F64, **sizes)
    out = np.asarray(tr.trace(fn, list(sizes), "fn"), dtype=object)
    prog = tr.program({"out": tuple(out.ravel())}, 1, 1, 1)
    return prog, prog.outputs["out"]


def test_cse_distinguishes_hash_colliding_params():
    """tests/test_pallas_rollout.py's regression: hash(-1) == hash(-2), so a
    CSE keyed on hashes would merge 1/x and x^-2 (and a derivative chain of
    1/x emits both); the CSE keys on the instructions themselves."""
    prog, out = _trace_fn(lambda x: torch.reciprocal(x[0]) + x[0] ** -2, x=1)
    x = torch.tensor([[2.0]], dtype=F64)
    assert float(prog.evaluate(out, like=x, x=x)[0]) == pytest.approx(0.75)
    g = torch.func.grad(lambda x: torch.reciprocal(x[0]) + x[0] ** -2)
    prog, out = _trace_fn(g, x=1)
    assert float(prog.evaluate(out, like=x, x=x)[0][0]) == pytest.approx(-0.5)


def test_cse_distinguishes_hash_colliding_literals():
    prog, out = _trace_fn(lambda x: x[0] * (-1.0) + x[0] * (-2.0), x=1)
    x = torch.tensor([[3.0]], dtype=F64)
    assert float(prog.evaluate(out, like=x, x=x)[0]) == -9.0
    lits = [o[1] for o in prog.ops if o[0] == "cf"]
    assert -1.0 in lits and -2.0 in lits


def test_stage_varying_box_is_a_table_read_at_k():
    """A per-stage (N, nu) box traced with a symbolic k: the program reads
    its table at the stage index (never a row baked in at trace time), and
    the evaluator gives lb[k], ub[k] at every k, as an int and as a tensor;
    a box that takes int(k) cannot be traced and raises."""
    rng = np.random.default_rng(7)
    lb = -rng.uniform(0.5, 1.5, (N, 2))
    ub = rng.uniform(0.5, 1.5, (N, 2))
    ocp = dataclasses.replace(bench_ocp(N, "cpu", F64), device_model=None,
                              control_bounds=box_bounds(lb, ub, device="cpu",
                                                        dtype=F64))
    prog = traced_device_model(ocp).program
    reads = [prog.ops[v] for v in prog.outputs["lb"] + prog.outputs["ub"]]
    assert all(o[0] == "tabi" and o[2] == 2 and o[3] == N for o in reads)
    model = traced_device_model(ocp)
    x, p = torch.zeros((N, 3), dtype=F64), torch.zeros((N, 3), dtype=F64)
    for k in range(N):
        got = model.bounds(x[:1], p[:1], k)
        np.testing.assert_array_equal(got[0].numpy()[0], lb[k])
        np.testing.assert_array_equal(got[1].numpy()[0], ub[k])
    got = model.bounds(x, p, torch.arange(N))
    np.testing.assert_array_equal(got[0].numpy(), lb)
    np.testing.assert_array_equal(got[1].numpy(), ub)

    lbt = torch.as_tensor(lb)
    baked = dataclasses.replace(ocp, control_bounds=lambda x, p, k: (
        lbt[int(k)], -lbt[int(k)]))
    with pytest.raises(NotImplementedError, match="control_bounds reads a value"):
        trace_ocp(baked)


def test_an_op_outside_the_lowering_table_raises():
    ocp = dataclasses.replace(bench_ocp(N, "cpu"), device_model=None)
    bad = dataclasses.replace(ocp, dynamics=lambda x, u, p: ocp.dynamics(
        x, u, p) + torch.atan2(x, x + 1.0))
    with pytest.raises(NotImplementedError,
                       match="dynamics: the ATen op aten.atan2"):
        trace_ocp(bad)


def _own_constants_ocp():
    """A (3, 1) OCP whose dynamics, stage cost and terminal cost each build a
    constant of one shape, (5,), inside their bodies (a ``_tensor_constant``
    that only that callable's trace holds; no input has that size).  The
    stage cost and the terminal cost collect garbage first, so that the
    constants of the callables traced before them are freed where nothing
    holds them, and their addresses are free to take."""
    def F(x, u, p):
        a = torch.tensor([0.9, 1.1, 0.7, 0.1, -0.2], dtype=F64)
        return a[:3] * x + a[2:] * u[0]

    def l(x, u, p):
        gc.collect()
        w = torch.tensor([3.0, 5.0, 7.0, 0.5, 2.0], dtype=F64)
        return (w[:3] * x * x).sum() + w[3] * u[0] ** 2 + w[4]

    def lf(x, p):
        gc.collect()
        v = torch.tensor([11.0, 13.0, 17.0, 19.0, 23.0], dtype=F64)
        return (v[:3] * x * x).sum() + v[3] * x[0] + v[4]

    return mt.OCP(dynamics=F, stage_cost=l, terminal_cost=lf, N=N, nx=3,
                  nu=1, npar=0, dtype=F64)


def test_constants_built_inside_each_callable_stay_apart(monkeypatch):
    """Each callable's own constants keep their own table entries, however
    the allocator places them: the program holds every hoisted tensor, so
    that no later constant can take the address that keys an earlier one,
    and the evaluator matches the callables exactly."""
    hoisted = []
    hoist = Tracer._hoist

    def held(self, t):
        hoisted.append(weakref.ref(t))
        return hoist(self, t)

    monkeypatch.setattr(Tracer, "_hoist", held)
    ocp = _own_constants_ocp()
    prog = trace_ocp(ocp)
    gc.collect()
    assert len(hoisted) == 3 and all(r() is not None for r in hoisted)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((16, 3)))
    u = torch.as_tensor(rng.standard_normal((16, 1)))
    p = torch.zeros((16, 1), dtype=F64)
    model = TracedDeviceModel(prog)
    _close(model.step(x, u, p), vmap(ocp.dynamics)(x, u, p), 0.0, "step")
    _close(model.stage_cost(x, u, p), vmap(ocp.stage_cost)(x, u, p), 0.0,
           "stage cost")
    _close(model.terminal_cost(x, p), vmap(ocp.terminal_cost)(x, p), 0.0,
           "terminal cost")


def test_weights_changed_in_place_are_followed():
    """A closed-over weight changed in place after the trace: the evaluator
    and the kernels' table (one buffer a device, refilled) read the new
    values, as the callables do; an integer tensor compiled in as literals
    that changes in place raises."""
    rng = np.random.default_rng(9)
    Q = torch.as_tensor(rng.uniform(0.5, 1.5, 3))
    idx = torch.tensor([2, 0, 1])

    def l(x, u, p):
        return (Q * x * x).sum() + x[idx].sum() * u[0] ** 2

    ocp = dataclasses.replace(bench_ocp(N, "cpu", F64), device_model=None,
                              stage_cost=l)
    model = traced_device_model(ocp)
    x = torch.as_tensor(rng.standard_normal((8, 3)))
    u = torch.as_tensor(rng.standard_normal((8, 2)))
    p = torch.zeros((8, 3), dtype=F64)
    buf = model.table("cpu")
    before = buf.clone()
    Q.mul_(3.0)
    _close(model.stage_cost(x, u, p), vmap(l)(x, u, p), 1e-15, "stage cost")
    after = model.table("cpu")
    assert after is buf and not torch.equal(after, before)
    torch.testing.assert_close(after, model.program.table(torch.float32),
                               rtol=0, atol=0)
    idx[0] = 1
    for read in (lambda: model.stage_cost(x, u, p),
                 lambda: model.table("cpu")):
        with pytest.raises(RuntimeError,
                           match="changed in place after the trace"):
            read()


def test_program_text_does_not_depend_on_a_move_to_the_inputs_device():
    """A callable that moves a closed-over tensor to its inputs' device (as
    ``solver/ipm._barrier_term`` does with the box) traces to the program
    of the same callable without the move: on the card the box lies there
    and the trace's inputs on the host, on the CPU both on the host, and
    one library serves both traces.  A float cast is no instruction."""
    lb, ub = torch.tensor([-0.5]), torch.tensor([0.5])
    sizes = dict(u=1, p=2)
    plain = _trace_fn(lambda u, p: _barrier_term(u, lb, ub, p[1]), **sizes)
    for move in (lambda t, u: torch.as_tensor(t, device="meta"),
                 lambda t, u: t.to("meta"), lambda t, u: t.to(u),
                 lambda t, u: t.to(device="meta", dtype=torch.float64),
                 lambda t, u: t.cpu()):
        prog, out = _trace_fn(lambda u, p: _barrier_term(
            u, move(lb, u), move(ub, u), p[1]), **sizes)
        assert (prog.ops, out) == (plain[0].ops, plain[1])
        assert all(c.device.type == "cpu" for c in prog.consts)


def test_program_text_does_not_depend_on_the_table():
    """Two OCPs that differ only in their weights share one header (and one
    build) and differ in their tables."""
    a = dataclasses.replace(bench_ocp(N, "cpu"), device_model=None)
    b = dataclasses.replace(unicycle_ocp(
        N, "cpu", dt=0.2, Q=np.diag([2.0, 3.0, 4.0]), R=np.diag([1.0, 2.0]),
        lb=[-2.0, -1.0], ub=[2.0, 1.0]), device_model=None)
    pa, pb = trace_ocp(a), trace_ocp(b)
    assert model_header(pa) == model_header(pb)
    assert program_hash(pa) == program_hash(pb)
    assert not torch.equal(pa.table(), pb.table())
    names = list(units(pa))
    assert names == [f"traced_rollout_{program_hash(pa)}.cu",
                     f"traced_fused_{program_hash(pa)}.cu"]
    assert all(f"_{program_hash(pa)}(" in text for text in units(pa).values())


# ---- the generated header on the host -------------------------------------

def _zoo_ocp():
    """An OCP (2, 1) that runs every new lowering: exp, sqrt, abs,
    reciprocal, tan, pow, maximum / minimum of two values, where, clamp,
    a mean, and a stage-varying box."""
    rng = np.random.default_rng(11)
    W = torch.as_tensor(rng.uniform(0.5, 1.5, (2, 2)), dtype=F64)

    def F(x, u, p):
        return torch.stack([
            x[0] + 0.1 * torch.tan(0.3 * x[1]) + u[0] * torch.exp(-x[0] ** 2),
            x[1] + torch.sqrt(1.0 + x[0] ** 2) * u[0]
            - torch.reciprocal(2.0 + torch.abs(x[1]))])

    def l(x, u, p):
        return (torch.maximum(x[0], p[0]) ** 2
                + torch.minimum(x[1], p[1]).pow(3)
                + torch.where(u[0] > 0, u[0] ** 2, 0.5 * u[0] ** 2)
                + torch.clamp(x[0] * x[1], -0.5, 0.5) + x.abs().mean()
                + x @ W @ x)

    def lf(x, p):
        return torch.exp(0.1 * x).sum() + torch.sqrt(x @ x + 1.0)

    return mt.OCP(dynamics=F, stage_cost=l, terminal_cost=lf, N=N, nx=2,
                  nu=1, npar=2, control_bounds=box_bounds(
                      -rng.uniform(0.5, 1.5, (N, 1)),
                      rng.uniform(0.5, 1.5, (N, 1)), device="cpu", dtype=F64),
                  dtype=F64)


_HOST_MAIN = r"""
#define __device__
#define __host__
#define __forceinline__ inline
#include <cmath>

// The double overloads of scalar.cuh's functions, for the model in double.
namespace {
double mv_sin(double a) { return std::sin(a); }
double mv_cos(double a) { return std::cos(a); }
double mv_tan(double a) { return std::tan(a); }
double mv_log(double a) { return std::log(a); }
double mv_exp(double a) { return std::exp(a); }
double mv_sqrt(double a) { return std::sqrt(a); }
double mv_abs(double a) { return std::fabs(a); }
double mv_recip(double a) { return 1.0 / a; }
double mv_value(double a) { return a; }
double mv_maximum(double a, double b) { return a > b || a != a ? a : b; }
double mv_minimum(double a, double b) { return a < b || a != a ? a : b; }
}  // namespace

#include "model.cuh"
#include <cstdio>
#include <vector>

constexpr int NX = TracedModel::kNX, NU = TracedModel::kNU, NZ = NX + NU;

// Reads the table, then per point x, u, p, k; prints per point the model in
// float (step, stage cost, terminal cost, box), in double (step, stage cost,
// terminal cost), and K3's duals in float: the stage cost and each step
// output on second-order duals over z = [x; u] (value, gradient, Hessian
// triangle), the terminal value (Vx, Vxx).
int main() {
  int ntab, npar, B;
  if (scanf("%d %d %d", &ntab, &npar, &B) != 3) return 1;
  std::vector<float> tab(ntab > 0 ? ntab : 1), p(npar);
  for (int i = 0; i < ntab; ++i) scanf("%f", &tab[i]);
  const TracedModel m{tab.data()};
  for (int b = 0; b < B; ++b) {
    float x[NX], u[NU], xf[NX], lo[NU], hi[NU], Vx[NX], Vxx[NX][NX];
    double xd[NX], ud[NU];
    int k;
    for (int i = 0; i < NX; ++i) scanf("%f", &x[i]);
    for (int i = 0; i < NU; ++i) scanf("%f", &u[i]);
    for (int i = 0; i < npar; ++i) scanf("%f", &p[i]);
    scanf("%d", &k);
    for (int i = 0; i < NX; ++i) xf[i] = xd[i] = x[i];
    for (int i = 0; i < NU; ++i) ud[i] = u[i];
    step(m, xf, u, p.data());
    step(m, xd, ud, p.data());
    model_box(m, x, p.data(), k, lo, hi);
    for (int i = 0; i < NX; ++i) printf("%.9g ", xf[i]);
    printf("%.9g %.9g ", stage_cost(m, x, u, p.data()), terminal_cost(m, x, p.data()));
    for (int i = 0; i < NU; ++i) printf("%.9g %.9g ", lo[i], hi[i]);
    for (int i = 0; i < NX; ++i) printf("%.17g ", xd[i]);
    for (int i = 0; i < NX; ++i) xd[i] = x[i];
    printf("%.17g %.17g ", stage_cost(m, xd, ud, p.data()), terminal_cost(m, xd, p.data()));
    Dual<NZ, true> xz[NX], uz[NU];
    for (int i = 0; i < NX; ++i) xz[i] = Dual<NZ, true>::var(x[i], i);
    for (int i = 0; i < NU; ++i) uz[i] = Dual<NZ, true>::var(u[i], NX + i);
    const Dual<NZ, true> L = stage_cost(m, xz, uz, p.data());
    step(m, xz, uz, p.data());
    for (const Dual<NZ, true>* d : {&L}) {
      printf("%.9g ", d->v);
      for (int i = 0; i < NZ; ++i) printf("%.9g ", d->g[i]);
      for (int e = 0; e < Dual<NZ, true>::kNH; ++e) printf("%.9g ", d->h[e]);
    }
    for (int o = 0; o < NX; ++o) {
      printf("%.9g ", xz[o].v);
      for (int i = 0; i < NZ; ++i) printf("%.9g ", xz[o].g[i]);
      for (int e = 0; e < Dual<NZ, true>::kNH; ++e) printf("%.9g ", xz[o].h[e]);
    }
    model_terminal_value(m, x, p.data(), Vx, Vxx);
    for (int i = 0; i < NX; ++i) printf("%.9g ", Vx[i]);
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j) printf("%.9g ", Vxx[i][j]);
    printf("\n");
  }
  return 0;
}
"""


def _tri(H):
    """The upper triangle of (..., n, n), row-major, as dual.cuh keeps it."""
    n = H.shape[-1]
    i, j = np.triu_indices(n)
    return H[..., i, j]


@pytest.mark.parametrize("name", ["zoo", "quadrotor", "bench_al",
                                  "bench_barrier_streaming"])
def test_generated_header_on_the_host(name, tmp_path):
    """The generated header compiled by g++ (``-x c++``, ``__device__`` and
    ``__forceinline__`` defined away): in double against the evaluator at
    1e-12 (inputs, params and table rounded to float, as the header reads
    them); in float at 2e-5; K3's duals in float against torch.func's first
    and second derivatives of the evaluator at 1e-3, all of max(1, |ref|)."""
    ocp = _zoo_ocp() if name == "zoo" else _case(name)[0]
    x, u, p = _inputs(name, ocp, 12, seed=21)
    if name == "zoo":
        x, u = 0.5 * x, 0.7 * u
    _check_header_on_the_host(ocp, x, u, p, tmp_path)


def _check_header_on_the_host(ocp, x, u, p, tmp_path, main=_HOST_MAIN):
    """The body of test_generated_header_on_the_host on ``ocp`` at the
    points (x, u, p), stage k = b mod N at point b; ``main`` is the host
    program (``_HOST_MAIN``, or one that defines more host functions before
    it includes the model)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    model = traced_device_model(ocp)
    prog = model.program
    csrc = mt.__path__[0] + "/csrc"
    (tmp_path / "cuda_runtime.h").write_text("#pragma once\n")
    (tmp_path / "model.cuh").write_text(model_header(prog))
    (tmp_path / "main.cpp").write_text(main)
    build = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-x", "c++", "-I", str(tmp_path), "-I",
         csrc, "-Wno-unknown-pragmas", str(tmp_path / "main.cpp"), "-o",
         str(tmp_path / "main")], capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-4000:]

    B = x.shape[0]
    k = np.arange(B) % N
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)
    x, u, p, table = f32(x), f32(u), f32(p), f32(prog.table().numpy())
    num = lambda vals: " ".join(f"{float(v):.17g}" for v in vals)
    lines = [f"{table.size} {p.shape[1]} {B}", num(table)]
    for b in range(B):
        lines.append(num([*x[b], *u[b], *p[b]]) + f" {k[b]}")
    run = subprocess.run([str(tmp_path / "main")], input="\n".join(lines),
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    out = np.array([[float(v) for v in line.split()]
                    for line in run.stdout.splitlines()])
    nx, nu = ocp.nx, ocp.nu
    nz, nh = nx + nu, (nx + nu) * (nx + nu + 1) // 2

    def take(n):
        nonlocal out
        part, out = out[:, :n], out[:, n:]
        return part

    tm = TracedDeviceModel(dataclasses.replace(
        prog, consts=(torch.as_tensor(table),)))
    ref = _evaluated(tm, x, u, p, torch.as_tensor(k))
    _close(take(nx), ref["step"], 2e-5, "float step")
    _close(take(1)[:, 0], ref["stage_cost"], 2e-5, "float stage cost")
    _close(take(1)[:, 0], ref["terminal_cost"], 2e-5, "float terminal cost")
    box = take(2 * nu).reshape(B, nu, 2)
    f32 = np.float32   # the box is the table's floats, printed to 9 digits
    _close(f32(box[..., 0]), f32(ref["lb"]), 0.0, "lb")
    _close(f32(box[..., 1]), f32(ref["ub"]), 0.0, "ub")
    _close(take(nx), ref["step"], 1e-12, "double step")
    _close(take(1)[:, 0], ref["stage_cost"], 1e-12, "double stage cost")
    _close(take(1)[:, 0], ref["terminal_cost"], 1e-12, "double terminal cost")

    fin = np.isfinite(ref["stage_cost"])
    t = lambda a: torch.as_tensor(a, dtype=F64)
    z, pt = t(np.concatenate([x, u], -1)), t(p)
    sc = lambda zz, pp: tm.stage_cost(zz[:nx], zz[nx:], pp)
    st = lambda zz, pp: tm.step(zz[:nx], zz[nx:], pp)
    L = take(1 + nz + nh)
    _close(L[fin, 1:1 + nz], vmap(jacfwd(sc))(z, pt).numpy()[fin], 1e-3,
           "dual stage cost gradient")
    _close(L[fin, 1 + nz:], _tri(vmap(hessian(sc))(z, pt).numpy())[fin], 1e-3,
           "dual stage cost Hessian")
    J, Hs = vmap(jacfwd(st))(z, pt).numpy(), vmap(jacfwd(jacfwd(st)))(
        z, pt).numpy()
    for o in range(nx):
        Fo = take(1 + nz + nh)
        _close(Fo[:, 0], ref["step"][:, o], 2e-5, f"dual step {o} value")
        _close(Fo[:, 1:1 + nz], J[:, o], 1e-3, f"dual step {o} gradient")
        _close(Fo[:, 1 + nz:], _tri(Hs[:, o]), 1e-3, f"dual step {o} Hessian")
    tc = lambda xx, pp: tm.terminal_cost(xx, pp)
    _close(take(nx), vmap(jacfwd(tc))(t(x), pt).numpy(), 1e-3, "Vx")
    _close(take(nx * nx).reshape(B, nx, nx),
           vmap(hessian(tc))(t(x), pt).numpy(), 1e-3, "Vxx")
    assert out.shape[1] == 0


def test_cuda_backends_on_the_cpu_run_the_twins_on_a_bare_ocp():
    """"cuda" and "cuda_fused" on a CPU OCP given only by its callables
    trace it (the model the card would run) and solve with the twins: the
    "torch" answers, bit for bit."""
    ocp = dataclasses.replace(cs.user_ocp("double_integrator", "cpu"), N=N)
    x0, ps, us0 = (a[:3, :N + 1 if i == 1 else N] if a.ndim == 3 else a[:3]
                   for i, a in enumerate(cs.user_queue("double_integrator", 3)))
    opt = mt.ILQROptions(max_iters=30)
    ref = mt.make_batched_ilqr_solver(ocp, opt, backend="torch")(x0, ps, us0)
    for backend in ("cuda", "cuda_fused"):
        res = mt.make_batched_ilqr_solver(ocp, opt, backend=backend)(x0, ps,
                                                                    us0)
        for key in ("xs", "us", "cost", "iterations"):
            assert torch.equal(getattr(res, key), getattr(ref, key)), key
    assert isinstance(ocp._traced_device_model, TracedDeviceModel)


# Each lowering of trace.LOWERINGS that the OCPs above do not reach, on a
# function of x (3,): the evaluator against the function itself in float64
# at random points, values to 1e-12.
LOWERING_CASES = {
    "relu": lambda x: torch.relu(x - 0.1),
    "rsqrt": lambda x: torch.rsqrt(2.0 + x),
    "square": lambda x: torch.square(x),
    "pow_half": lambda x: (3.0 + x) ** 0.5,
    "pow_real": lambda x: (3.0 + x) ** 1.7,
    "pow_neg": lambda x: (3.0 + x) ** -3,
    "clamp_min_max": lambda x: torch.clamp_min(x, -0.2) + torch.clamp_max(x, 0.3),
    "clamp_tensor": lambda x: torch.clamp(x, x[0] - 0.5, x[1] + 0.5),
    "isnan_where": lambda x: torch.where(torch.isnan(torch.log(x)), -x, x),
    "isfinite": lambda x: torch.where(torch.isfinite(1.0 / x), x, 2.0 * x),
    "logical": lambda x: torch.where(torch.logical_and(x > 0, ~(x > 0.5))
                                     | torch.logical_not(x < -0.5), x, -x),
    "bool_mul_add": lambda x: x * (x > 0) + (x < 0).float(),
    "compare_scalar": lambda x: torch.where(x >= 0.25, x, 0.0) + (x <= 0.1),
    "rsub_scalar_ops": lambda x: (1.0 - x) / 2.0 + x.add(1.5) * 3.0 - x.sub(
        0.5),
    "matmul": lambda x: torch.ones(2, 3, dtype=x.dtype) @ x,
    "mean_dim": lambda x: x.reshape(1, 3).mean(dim=1)[0],
    "norm": lambda x: torch.linalg.vector_norm(x),
    "new_factories": lambda x: x.new_zeros(3) + x.new_ones(3) + x.new_full(
        (3,), 2.0) + x,
    "views": lambda x: x.unsqueeze(0).expand(2, 3).t().reshape(-1)[1:5:2]
    .flip(0),
    "inplace": lambda x: _inplace(x),
    "minimum_maximum": lambda x: torch.minimum(x, x.flip(0))
    + torch.maximum(x, 0.1 * x),
    # beside the ops of Mosaic's table (tests/test_torch_trace_ops.py): the
    # composites decomposed in the trace that no OCP there calls, masked_fill
    # (logsumexp's), a scalar dividend, rounding an integer, and the folds
    # of each new op on literals (a program of no instruction but the sum)
    "logsumexp": lambda x: torch.logsumexp(x, 0),
    "mse_loss": lambda x: torch.nn.functional.mse_loss(x, 0.5 * x.flip(0)),
    "masked_fill": lambda x: x.masked_fill(x > 0.2, 0.7),
    "backward_ops": lambda x: torch.func.grad(lambda y: (
        torch.tanh(y) + torch.sigmoid(y)
        + torch.nn.functional.softplus(y, beta=2.0)).sum())(x),
    "remainder_scalar_dividend": lambda x: torch.remainder(2.5, x + 3.0),
    "rounding_of_integers": lambda x: x * (torch.sign(torch.tensor(
        [-2, 0, 3])) + torch.floor(torch.tensor([4, 5, 6]))),
    "folds": lambda x: _folds(x),
}


def _folds(x):
    """x plus every new op on literals, which the trace folds."""
    c = lambda v: torch.full((), v, dtype=x.dtype)
    return x + (c(0.5).tanh() + c(0.5).sigmoid() + c(0.5).log1p()
                + c(0.5).exp2() + c(0.5).erfinv() + c(2.5).round()
                + c(-2.5).floor() + c(-2.5).ceil() + c(-2.5).sign()
                + c(2.0).pow(c(1.5)) + torch.fmod(c(-5.5), 2.0)
                + torch.remainder(c(-5.5), 2.0))


def _inplace(x):
    y = x.clone()
    y[0] = y[0] * 2.0
    y[1:] += x[:2]
    return y


@pytest.mark.parametrize("case", sorted(LOWERING_CASES))
def test_each_lowering_matches_torch(case):
    fn = LOWERING_CASES[case]
    prog, out = _trace_fn(fn, x=3)
    if case == "folds":   # the constant folded to one literal
        assert sum(o[0] not in ("in", "cf") for o in prog.ops) == 3
    rng = np.random.default_rng(sorted(LOWERING_CASES).index(case))
    x = torch.as_tensor(rng.uniform(-1, 1, (9, 3)), dtype=F64)
    got = torch.stack(prog.evaluate(out, like=x, x=x), -1)
    ref = vmap(fn)(x).reshape(9, -1).to(F64)
    _close(got.numpy(), ref.numpy(), 1e-12, case)
