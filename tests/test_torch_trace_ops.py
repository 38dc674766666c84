"""The ops that the traced device model lowers beside the arithmetic, sin,
cos, tan, exp, log, sqrt and abs: every primitive that Mosaic lowers into
the JAX package's Pallas kernels (tanh, the sigmoid, log1p, exp2, erfinv,
floor, ceil, round, sign, pow with a tensor exponent, fmod, remainder, the
max / min reductions) and the composites JAX builds from them (softplus,
logaddexp, hypot, a Huber cost, smooth L1, silu), so that K2 and K3 run an
OCP whose callables use them, as the Pallas kernels inline its jaxpr.

One OCP an op (``chip_smoke.TRACED_OP_TERMS``: a (2, 1) double integrator
whose acceleration and stage cost add the op's term), built in torch and in
JAX from the same numbers, the jnp / jax.nn / lax spelling of each op
(``JAX_OPS``); also chip_smoke.py phase 23's (e4) obstacle OCP and (f) ops
OCP.  Where floor, ceil, round, sign, fmod or remainder take a value, it is
drawn from a params column at least 1e-3 from a jump of the op
(``chip_smoke.op_params`` keeps 0.1, a term moves it by at most 0.05):
float32 and float64 may round to either side of a jump, by design.  Held
here on the CPU, N = 6:

* the evaluator against the torch callables in float64, first and second
  derivatives included, and against JAX's ``_hoist_consts`` functions, to
  1e-12 of max(1, |ref|);
* ``fused_backward_torch`` and ``linesearch_forward_torch`` on the traced
  evaluator against JAX's "xla" parts in float64 (1e-9), and the line search
  against ``linesearch_forward_pallas`` in interpret mode in float32 (5e-5,
  as ``test_torch_trace.py``);
* the generated header compiled by the host ``g++`` in float and double,
  K3's duals against ``torch.func`` (``test_torch_trace``'s harness, with a
  host erfinv where CUDA has its own);
* (e4) solved in float64 by ``make_batched_ilqr_solver(backend="torch")``
  against JAX's batched solver;
* ``backend=None`` on each OCP relabelled as CUDA: ``"cuda_fused"`` with no
  warning, and the explicit kernel backends build; ops Mosaic does not lower
  (atan2 and the rest) still raise, and ``backend=None`` still warns;
* the new header, ``csrc/traced_math.cuh``, only where a program calls one
  of its functions: the seven programs of phase 23 before (e4) and (f), and
  the hand-written kernels' library, keep their texts and names.
"""
import dataclasses
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import jax.scipy.special
import numpy as np
import pytest
import torch
from torch.func import jacfwd, jacrev, vmap

import chip_smoke as cs
import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu.ops import rk4_step as j_rk4_step
from mpc_verde_tpu.ops.pallas.rollout import (_hoist_consts,
                                              linesearch_forward_pallas)
from mpc_verde_tpu.solver.batched import _make_parts as j_make_parts
from mpc_verde_tpu.solver.batched import make_batched_ilqr_solver as j_batched
from mpc_verde_tpu_torch.interop import from_numpy
from mpc_verde_tpu_torch.ocp.spec import box_bounds
from mpc_verde_tpu_torch.ops.cuda import build as build_mod
from mpc_verde_tpu_torch.ops.cuda import codegen
from mpc_verde_tpu_torch.ops.cuda.fused import fused_backward_torch
from mpc_verde_tpu_torch.ops.cuda.rollout import (TracedDeviceModel,
                                                  linesearch_forward_torch,
                                                  traced_device_model)
from mpc_verde_tpu_torch.ops.cuda.trace import trace_ocp
from mpc_verde_tpu_torch.solver.batched import resolve_backend
from test_torch_bw import OPTS, _on_cuda
from test_torch_trace import (_HOST_MAIN, _check_header_on_the_host, _close,
                              _evaluated, _evaluator_ocp)

N = 6
F64 = torch.float64
DT, QF = 0.1, 5.0
Q2, R1 = np.diag([1.0, 0.5]), 0.1


def _j_huber(d, delta):
    a = jnp.abs(d)
    return jnp.sum(jnp.where(a < delta, 0.5 * d * d,
                             delta * (a - 0.5 * delta)))


def _j_smooth_l1(d, beta):
    a = jnp.abs(d)
    return jnp.sum(jnp.where(a < beta, 0.5 * d * d / beta, a - 0.5 * beta))


# the jnp / jax.nn / lax spelling of chip_smoke.TORCH_OPS
JAX_OPS = SimpleNamespace(
    sin=jnp.sin, cos=jnp.cos, stack=jnp.stack, tanh=jnp.tanh,
    sigmoid=jax.nn.sigmoid, log1p=jnp.log1p, exp2=jnp.exp2,
    erfinv=jax.scipy.special.erfinv, floor=jnp.floor, ceil=jnp.ceil,
    round=jnp.round, sign=jnp.sign, pow=jnp.power, fmod=jnp.fmod,
    remainder=jnp.remainder, amax=jnp.max, amin=jnp.min, max=jnp.max,
    min=jnp.min, max_dim=lambda a: jnp.max(a, axis=0),
    min_dim=lambda a: jnp.min(a, axis=0),
    softplus=lambda z, beta: jax.nn.softplus(beta * z) / beta,
    hypot=jnp.hypot, logaddexp=jnp.logaddexp, huber=_j_huber,
    smooth_l1=_j_smooth_l1, silu=jax.nn.silu)

OP_CASES = list(cs.TRACED_OP_TERMS)
CASES = OP_CASES + ["ops", "obstacle"]


# ---- the OCPs, in the port and in JAX from the same numbers ---------------

def _op_ocp(name, dtype=F64):
    """The (2, 1) OCP of the term ``name`` in the port (no device model)."""
    term, m = cs.TRACED_OP_TERMS[name], cs.TORCH_OPS
    Q = torch.as_tensor(Q2, dtype=dtype)

    def F(x, u, p):
        return torch.stack([x[0] + DT * x[1],
                            x[1] + DT * (u[0] + 0.5 * term(x, u, p, m))])

    def l(x, u, p):
        return x @ Q @ x + R1 * u[0] ** 2 + 0.3 * term(x, u, p, m)

    def lf(x, p):
        return QF * (x @ Q @ x)

    return mt.OCP(dynamics=F, stage_cost=l, terminal_cost=lf, N=N, nx=2, nu=1,
                  npar=4, control_bounds=box_bounds([-1.0], [1.0],
                                                    device="cpu", dtype=dtype),
                  dtype=dtype)


def _j_op_ocp(name):
    term, m = cs.TRACED_OP_TERMS[name], JAX_OPS

    def F(x, u, p):
        return jnp.stack([x[0] + DT * x[1],
                          x[1] + DT * (u[0] + 0.5 * term(x, u, p, m))])

    def l(x, u, p):
        return x @ Q2 @ x + R1 * u[0] ** 2 + 0.3 * term(x, u, p, m)

    def lf(x, p):
        return QF * (x @ Q2 @ x)

    return mv.OCP(dynamics=F, stage_cost=l, terminal_cost=lf, N=N, nx=2, nu=1,
                  npar=4, control_bounds=mv.box_bounds(np.array([-1.0]),
                                                       np.array([1.0])))


def _j_ops_ocp():
    """chip_smoke.ops_ocp in JAX."""
    Q, R = np.diag([1.0, 0.5, 0.1]), np.diag([0.1, 0.1])

    def F(x, u, p):
        s = 0.1 * cs.ops_sum(x, u, p, JAX_OPS)
        return jnp.stack([x[0] + cs.OPS_DT * x[1],
                          x[1] + cs.OPS_DT * (u[0] + s),
                          x[2] + cs.OPS_DT * u[1]])

    def l(x, u, p):
        return x @ Q @ x + u @ R @ u + 0.1 * cs.ops_sum(x, u, p, JAX_OPS)

    return mv.OCP(dynamics=F, stage_cost=l, N=N, nx=3, nu=2, npar=4,
                  control_bounds=mv.box_bounds(np.array([-1.0, -1.0]),
                                               np.array([1.0, 1.0])))


def _j_obstacle_ocp(N=N):
    """chip_smoke.obstacle_ocp in JAX."""
    Q, R = cs.BENCH_Q, cs.BENCH_R
    return mv.OCP(
        dynamics=j_rk4_step(lambda x, u, p: cs.obstacle_rhs(x, u, JAX_OPS),
                            mt.interop.BENCH_DT),
        stage_cost=lambda x, u, p: cs.obstacle_cost(x, u, p, JAX_OPS, Q, R),
        N=N, nx=3, nu=2, npar=3,
        control_bounds=mv.box_bounds(*cs.BENCH_BOX))


def _case(name, dtype=F64):
    """(port OCP without a device model, JAX OCP)."""
    if name == "ops":
        return cs.ops_ocp("cpu", dtype, N), _j_ops_ocp()
    if name == "obstacle":
        return cs.obstacle_ocp("cpu", dtype, N), _j_obstacle_ocp()
    return _op_ocp(name, dtype), _j_op_ocp(name)


def _inputs(name, ocp, B, seed):
    """Random (x, u, p): near the disc and toward (10, 10, 0) for the
    obstacle, else x in [-1.5, 1.5], u in [-0.9, 0.9] and op_params."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.9, 0.9, (B, ocp.nu))
    if name == "obstacle":
        x = np.column_stack([rng.uniform(3.0, 6.0, (B, 2)),
                             rng.uniform(-1.0, 1.0, B)])
        return x, u, np.broadcast_to([10.0, 10.0, 0.0], (B, 3)).copy()
    x = rng.uniform(-1.5, 1.5, (B, ocp.nx))
    return x, u, cs.op_params(B, seed).astype(np.float64)


def _d2(fn):
    """Second derivatives by forward over forward, or by reverse over
    reverse where torch has no forward rule (huber_loss_backward)."""
    def d2(z, p):
        try:
            return jacfwd(jacfwd(fn))(z, p)
        except NotImplementedError:
            return jacrev(jacrev(fn))(z, p)
    return d2


# ---- the evaluator ---------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_evaluator_matches_callables_and_jax(name):
    """The evaluator against the port's callables (vmapped) and against
    JAX's _hoist_consts functions at 16 random points, every stage index:
    values, and first and second derivatives of the dynamics and the stage
    cost against torch.func on the callables, to 1e-12."""
    ocp, ocp_j = _case(name)
    model = traced_device_model(ocp)
    assert isinstance(model, TracedDeviceModel)
    B = 16
    x, u, p = _inputs(name, ocp, B, seed=len(name))
    k = np.arange(B) % N
    got = _evaluated(model, x, u, p, torch.as_tensor(k))
    t = lambda a: torch.as_tensor(a, dtype=F64)
    ref = {"step": vmap(ocp.dynamics)(t(x), t(u), t(p)),
           "stage_cost": vmap(ocp.stage_cost)(t(x), t(u), t(p))}
    if ocp.terminal_cost is not None:
        ref["terminal_cost"] = vmap(ocp.terminal_cost)(t(x), t(p))
    for key, r in ref.items():
        _close(got[key], r.numpy(), 1e-12, f"{name} {key} vs callables")

    def hoisted(fn, *args):
        pure, consts = _hoist_consts(fn, *(a[0] for a in args))
        return np.asarray(jax.vmap(lambda *a: pure(*a, *consts))(*args))

    j = lambda a: jnp.asarray(a, jnp.float64)
    _close(got["step"], hoisted(ocp_j.dynamics, j(x), j(u), j(p)), 1e-12,
           f"{name} step vs JAX")
    _close(got["stage_cost"], hoisted(ocp_j.stage_cost, j(x), j(u), j(p)),
           1e-12, f"{name} stage cost vs JAX")

    z, pt, nx = t(np.concatenate([x, u], -1)), t(p), ocp.nx
    for fn_ev, fn_ref, what in (
            (lambda zz, pp: model.step(zz[:nx], zz[nx:], pp),
             lambda zz, pp: ocp.dynamics(zz[:nx], zz[nx:], pp), "step"),
            (lambda zz, pp: model.stage_cost(zz[:nx], zz[nx:], pp),
             lambda zz, pp: ocp.stage_cost(zz[:nx], zz[nx:], pp), "stage")):
        _close(vmap(jacfwd(fn_ev))(z, pt).numpy(),
               vmap(jacrev(fn_ref))(z, pt).numpy(), 1e-12, f"{name} d{what}")
        _close(vmap(jacfwd(jacfwd(fn_ev)))(z, pt).numpy(),
               vmap(_d2(fn_ref))(z, pt).numpy(), 1e-12, f"{name} d2{what}")


# ---- the twins on the evaluator against JAX ---------------------------------

@pytest.mark.parametrize("name", CASES)
def test_twins_on_the_evaluator_match_jax_xla(name):
    """fused_backward_torch and linesearch_forward_torch on the evaluator's
    callables against JAX's "xla" derivs -> backward and materialising line
    search in float64, on trajectories rolled out by JAX from random
    controls and random gains: 1e-9 of max(1, |ref|)."""
    ocp, ocp_j = _case(name)
    ev = dataclasses.replace(_evaluator_ocp(ocp), N=N)
    opt = mv.ILQROptions(n_alphas=6, alpha_decay=0.4)
    B = 4
    x0, u0, p = _inputs(name, ocp, B, seed=3)
    rng = np.random.default_rng(5)
    ps = np.broadcast_to(p[:, None], (B, N + 1, p.shape[-1])).copy()
    us = np.broadcast_to(u0[:, None] * 0.5, (B, N, ocp.nu)) + 0.1 * \
        rng.standard_normal((B, N, ocp.nu))
    xla = j_make_parts(dataclasses.replace(ocp_j, N=N), opt, "xla",
                       "materialize")
    xs, us_c, _ = jax.jit(xla.rollout)(x0, us, ps)
    reg, ddp = np.full(B, 1e-5), np.array([1.0, 0.0, 1.0, 1.0])
    d, gN, HN, dlb, dub = jax.jit(xla.derivs)(xs, us_c, ps)
    ref = jax.jit(xla.backward)(d, gN, HN, dlb, dub, reg, ddp)
    t = lambda a: torch.as_tensor(np.array(a), dtype=F64)
    out = fused_backward_torch(t(xs), t(us_c), t(ps), t(reg), t(ddp), ocp=ev,
                               tol=opt.boxqp_tol)
    for key, o, r in zip(("kff", "K", "dV1", "dV2", "gmax"), out, ref):
        _close(o.numpy(), np.asarray(r), 1e-9, f"{name} {key}")

    kff = 0.3 * rng.standard_normal((B, N, ocp.nu))
    K = 0.1 * rng.standard_normal((B, N, ocp.nu, ocp.nx))
    alphas = tuple(float(opt.alpha_decay) ** i for i in range(opt.n_alphas))
    xs_r, us_r, c_r = jax.jit(xla.linesearch)(x0, xs, us_c, ps, kff, K)
    got = linesearch_forward_torch(t(x0), t(xs), t(us_c), t(ps), t(kff), t(K),
                                   alphas, ocp=ev)
    for key, o, r in zip(("xs", "us", "cost"), got, (xs_r, us_r, c_r)):
        _close(o.numpy(), np.asarray(r), 1e-9, f"{name} line search {key}")


@pytest.mark.parametrize("name", CASES)
def test_linesearch_twin_on_the_evaluator_matches_pallas_interpret(name):
    """The twin on the evaluator in float64 against linesearch_forward_pallas
    in interpret mode in float32 on the JAX OCP's own callables, on three
    problems: us 5e-5 and xs 5e-4 absolute, cost 5e-5 relative (the
    tolerances of tests/test_pallas_rollout.py)."""
    from jax.experimental.pallas import tpu as pltpu

    ocp, ocp_j = _case(name)
    B = 3
    x0, u0, p = (a.astype(np.float32) for a in _inputs(name, ocp, B, seed=7))
    rng = np.random.default_rng(9)
    f32 = lambda a: np.asarray(a, np.float32)
    xs = f32(x0[:, None] + 0.2 * rng.standard_normal((B, N + 1, ocp.nx)))
    us = f32(np.clip(u0[:, None] + 0.2 * rng.standard_normal((B, N, ocp.nu)),
                     -0.8, 0.8))
    ps = f32(np.broadcast_to(p[:, None], (B, N + 1, p.shape[-1])))
    kff = f32(0.3 * rng.standard_normal((B, N, ocp.nu)))
    K = f32(0.2 * rng.standard_normal((B, N, ocp.nu, ocp.nx)))
    alphas = tuple(0.4 ** i for i in range(6))
    with pltpu.force_tpu_interpret_mode():
        xs_p, us_p, c_p = linesearch_forward_pallas(
            *(jnp.asarray(a) for a in (x0, xs, us, ps, kff, K)),
            alphas=alphas, dynamics=ocp_j.dynamics,
            stage_cost=ocp_j.stage_cost,
            terminal_cost=ocp_j.terminal_cost or (lambda x, p: 0.0 * x[0]),
            control_bounds=ocp_j.control_bounds, nx=ocp.nx, nu=ocp.nu)
    t = lambda a: torch.as_tensor(a, dtype=F64)
    xs_t, us_t, c_t, _ = linesearch_forward_torch(
        *(t(a) for a in (x0, xs, us, ps, kff, K)), alphas,
        ocp=_evaluator_ocp(ocp))
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_p), rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_p), rtol=0,
                               atol=5e-4)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_p), rtol=5e-5)


# ---- the generated header on the host ---------------------------------------

# CUDA's erfinvf / erfinv, which the host's C library lacks: Giles's
# single-precision approximation (2010) refined by three Newton steps on
# std::erf, to double precision.
_HOST_ERFINV = r"""
#include <cmath>
#include <initializer_list>
double erfinv(double y) {
  if (!(y > -1.0 && y < 1.0)) return y == 1.0 ? INFINITY : y == -1.0 ? -INFINITY : NAN;
  double w = -std::log((1.0 - y) * (1.0 + y)), x;
  if (w < 5.0) {
    w -= 2.5;
    x = 2.81022636e-08;
    for (double c : {3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                     -0.00125372503, -0.00417768164, 0.246640727, 1.50140941})
      x = c + x * w;
  } else {
    w = std::sqrt(w) - 3.0;
    x = -0.000200214257;
    for (double c : {0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                     -0.0076224613, 0.00943887047, 1.00167406, 2.83297682})
      x = c + x * w;
  }
  x *= y;
  for (int i = 0; i < 3; ++i) x -= (std::erf(x) - y) / (1.1283791670955126 * std::exp(-x * x));
  return x;
}
float erfinvf(float y) { return static_cast<float>(erfinv(static_cast<double>(y))); }
"""
HOST_MAIN = _HOST_MAIN.replace('#include "model.cuh"',
                               _HOST_ERFINV + '#include "model.cuh"')


@pytest.mark.parametrize("name", CASES)
def test_generated_header_on_the_host(name, tmp_path):
    """The generated header (with csrc/traced_math.cuh where the program
    calls one of its functions; the max / min reductions, hypot and the
    Huber and smooth L1 costs lower to older instructions) compiled by g++
    with __device__ defined away: in double against the evaluator at 1e-12,
    in float at 2e-5, K3's duals in float against torch.func's first and
    second derivatives of the evaluator at 1e-3 (pow_negative_base at a base
    below 0: its derivative in the base finite, as torch's)."""
    ocp, _ = _case(name)
    x, u, p = _inputs(name, ocp, 12, seed=21)
    _check_header_on_the_host(ocp, x, u, p, tmp_path, main=HOST_MAIN)


# ---- (e4) solved against JAX --------------------------------------------------

def test_obstacle_solve_matches_jax():
    """(e4) at N = 6 in float64 from four starts near the disc toward (10,
    10, 0): make_batched_ilqr_solver(backend="torch") against JAX's batched
    solver ("xla"): converged equal, iterations within one, xs, us and cost
    to 1e-6 (tests/test_torch_bw.py's rule)."""
    B = 4
    rng = np.random.default_rng(11)
    x0 = np.column_stack([rng.uniform(3.2, 4.0, (B, 2)),
                          rng.uniform(0.5, 1.0, B)])
    ps = np.broadcast_to([10.0, 10.0, 0.0], (B, N + 1, 3)).copy()
    us0 = np.zeros((B, N, 2))
    res_j = jax.jit(j_batched(_j_obstacle_ocp(), mv.ILQROptions(**OPTS),
                              backend="xla"))(x0, ps, us0)
    res_t = mt.make_batched_ilqr_solver(
        cs.obstacle_ocp("cpu", F64, N), mt.ILQROptions(**OPTS),
        backend="torch")(x0, ps, us0)
    rj = from_numpy(res_j, "cpu", F64)
    assert bool(res_t.converged.all())
    np.testing.assert_array_equal(res_t.converged.numpy(), rj.converged.numpy())
    assert (res_t.iterations - rj.iterations).abs().max() <= 1
    for field in ("xs", "us", "cost"):
        np.testing.assert_allclose(getattr(res_t, field).numpy(),
                                   getattr(rj, field).numpy(), rtol=0,
                                   atol=1e-6, err_msg=field)
    # the answers pass by the disc: the penalty acts on them
    d = torch.hypot(res_t.xs[..., 0] - 5.0, res_t.xs[..., 1] - 5.0).numpy()
    assert d.min() < cs.OBSTACLE["radius"] + 0.5


# ---- the backend rule and the refusals --------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_default_backend_is_the_traced_cuda_fused(name):
    """backend=None on the float32 OCP relabelled as CUDA resolves to
    "cuda_fused" on the model traced from its callables, with no warning;
    an explicit "cuda" / "cuda_fused" builds a solver for it."""
    ocp, _ = _case(name, torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_backend(_on_cuda(ocp), None) == "cuda_fused"
    for backend in ("cuda", "cuda_fused"):
        mt.make_batched_ilqr_solver(ocp, backend=backend)


# Ops without a Mosaic lowering (the Pallas kernels do not run them either):
# each raises at the trace, and backend=None warns and takes "cuda_bw".
REFUSED = {"atan2": lambda x: torch.atan2(x[0], x[1] + 2.0),
           "atan": torch.atan, "asin": lambda x: torch.asin(0.5 * x),
           "acos": lambda x: torch.acos(0.5 * x), "sinh": torch.sinh,
           "cosh": torch.cosh, "erf": torch.erf, "expm1": torch.expm1}


@pytest.mark.parametrize("op", sorted(REFUSED))
def test_ops_mosaic_does_not_lower_stay_refused(op):
    fn = REFUSED[op]
    base = _op_ocp("tanh", torch.float32)
    bad = dataclasses.replace(base, stage_cost=lambda x, u, p: base.stage_cost(
        x, u, p) + fn(x).sum())
    with pytest.raises(NotImplementedError,
                       match=f"stage_cost: the ATen op aten.{op}"):
        trace_ocp(bad)
    with pytest.warns(UserWarning, match=f"cuda_bw.*stage_cost.*{op}"):
        assert resolve_backend(_on_cuda(bad), None) == "cuda_bw"


def test_the_indices_of_a_max_stay_refused():
    """max.dim's values lower; its indices, computed from values, do not."""
    base = _op_ocp("tanh")
    bad = dataclasses.replace(base, stage_cost=lambda x, u, p: base.stage_cost(
        x, u, p) + x.max(0).indices.to(x.dtype))
    with pytest.raises(NotImplementedError, match="indices of aten.max.dim"):
        trace_ocp(bad)


# ---- the header stays out of the older programs' names ----------------------

OLDER_PROGRAMS = ("bench", "bench_al", *cs.USER_OCPS, "lane_al",
                  "rate_barrier")


def test_traced_math_only_where_a_program_calls_it():
    """The seven programs of phase 23 before (e4) and (f) include no
    traced_math.cuh, so their texts, hashes and library names are what they
    were; the kernels library's header set does not hold it; (e4)'s and
    (f)'s programs include it, and their library names hash it."""
    ocps = cs.traced_ocps("cpu")
    assert set(OLDER_PROGRAMS) | {"obstacle", "ops"} == set(ocps)
    for name, ocp in ocps.items():
        prog = trace_ocp(ocp)
        header = codegen.model_header(prog)
        new = name in ("obstacle", "ops")
        assert ("traced_math.cuh" in header) == new, name
        assert codegen.uses_traced_math(prog) == new, name
        assert ("traced_math.cuh" in build_mod._headers(
            codegen.units(prog))) == new, name
    assert "traced_math.cuh" not in build_mod._headers(
        build_mod._kernels_units())
    assert (build_mod.CSRC / "traced_math.cuh").is_file()
