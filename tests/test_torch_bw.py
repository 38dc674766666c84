"""The "cuda_bw" backend, K1 at any (nx, nu <= 4) built per size, and the
reference directory's fallback.

"cuda_bw" is the counterpart of the JAX package's default backend
"pallas_bw": torch.func derivatives, the Riccati backward kernel K1, and the
plain PyTorch line search on the OCP's own callables.  Held here:

* the rule by which ``backend=None`` resolves, for every factory that
  resolves one, on OCPs that claim a CUDA device (nothing is allocated there
  before the spies stop the factory, the trace included): "cuda_fused" for
  a float32 OCP with a device model or whose callables lower to a traced
  one, "cuda_bw" in float64 or where a callable does not lower (with a
  warning naming the op), nu > 4 raising, an explicit backend honoured;
  and on the OCP the parts run, the AL- and barrier-derived ones (a
  rate-form OCP's have no device model and are traced);
* "cuda_bw" on the CPU (K1's twin and the line search's twin) against JAX's
  "xla" batched solve in float64 on three user OCPs at sizes K1 had no
  library for before it was built per size (``chip_smoke.USER_OCPS``):
  converged equal, iterations within one, xs, us and cost to 1e-6 absolute,
  the tolerance of ``tests/test_torch_closed_loop.py``'s ``_close``;
* K1's launch plan at those sizes and at (8, 4), its nu rule, and its
  generated translation units and library names (no nvcc needed);
* ``refgen.io.reference_data_dir``'s fallback to the JAX loader's directory.

``PYTHONPATH=. python tests/test_torch_bw.py --band`` prints the
converged_frac of JAX's float32 "xla" solve on the CPU over the first 1024 starts of each user OCP,
the band that ``chip_smoke.py`` phase 22 (b) holds the card to.
"""
import dataclasses
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import mpc_verde_tpu as mv
import mpc_verde_tpu_torch as mt
from mpc_verde_tpu import scenarios as js
from mpc_verde_tpu.models import linear_model as j_linear_model
from mpc_verde_tpu.ops import rk4_step as j_rk4_step
from mpc_verde_tpu.ops.integrators import c2d as j_c2d
from mpc_verde_tpu.refgen import io as j_io
from mpc_verde_tpu.solver import make_streaming_barrier_solver as j_barrier
from mpc_verde_tpu.solver import make_streaming_solver as j_streaming
from mpc_verde_tpu.solver.batched import make_batched_ilqr_solver as j_batched
from mpc_verde_tpu_torch.interop import bench_ocp, from_numpy
from mpc_verde_tpu_torch.ops.cuda import build as build_mod
from mpc_verde_tpu_torch.ops.cuda.build import SMEM_MAX_BYTES
from mpc_verde_tpu_torch.ops.cuda.riccati import (HELD_SIZES, riccati_backward,
                                                  riccati_backward_cast,
                                                  riccati_backward_torch,
                                                  riccati_launch_plan)
from mpc_verde_tpu_torch.ops.cuda.rollout import (TracedDeviceModel,
                                                  kernel_model)
from mpc_verde_tpu_torch.refgen import io as t_io
from mpc_verde_tpu_torch.scenarios import fleet as fleet_mod
from mpc_verde_tpu_torch.solver import batched as batched_mod
from mpc_verde_tpu_torch.solver import ipm as ipm_mod
from mpc_verde_tpu_torch.solver import streaming as streaming_mod
from mpc_verde_tpu_torch.solver import warmstart as warmstart_mod
from mpc_verde_tpu_torch.solver.batched import resolve_backend
from mpc_verde_tpu_torch.solver.warmstart import make_lqr_warm_start

CUDA = torch.device("cuda")
OPTS = dict(max_iters=60, tol_grad=1e-4, tol_cost=1e-6, n_alphas=8,
            alpha_decay=0.4)   # chip_smoke._opts()
PARITY_B = 4


class _Stop(Exception):
    pass


def _on_cuda(ocp, **kw):
    """``ocp`` as if it lay on a CUDA device (nothing is allocated there
    until a solve runs)."""
    return dataclasses.replace(ocp, device=CUDA, **kw)


def _spy_parts(monkeypatch, seen):
    def spy(ocp, opt, backend):
        seen.append(backend)
        raise _Stop

    monkeypatch.setattr(batched_mod, "_make_parts", spy)
    monkeypatch.setattr(streaming_mod, "_make_parts", spy)


def _spy_resolve(monkeypatch, module, seen):
    """Record what ``resolve_backend`` gives in ``module``, then stop."""
    def spy(ocp, backend):
        seen.append(resolve_backend(ocp, backend))
        raise _Stop

    monkeypatch.setattr(module, "resolve_backend", spy)


def _fleet(ocp, backend, opt):
    return fleet_mod.build_fleet(B=2, n_steps=1, backend=backend,
                                 device=ocp.device, dtype=ocp.dtype)


def _warm(ocp, backend, opt):
    return make_lqr_warm_start(ocp, backend=backend)


# factory(ocp, backend, options)
FACTORIES = {
    "batched": lambda ocp, backend, opt: mt.make_batched_ilqr_solver(
        ocp, opt, backend=backend),
    "streaming": lambda ocp, backend, opt: mt.make_streaming_solver(
        ocp, opt, backend=backend),
    "ilqr": lambda ocp, backend, opt: mt.make_ilqr_solver(ocp, opt,
                                                          backend=backend),
    "streaming_barrier": lambda ocp, backend, opt:
        mt.make_streaming_barrier_solver(ocp, opt, backend=backend),
    "warm_start": _warm,
    "fleet": _fleet,
}

BENCH = bench_ocp(10, "cpu")
RULE_CASES = {
    "cuda_float32_model": (_on_cuda(BENCH), None, "cuda_fused"),
    "cuda_float32_no_model": (_on_cuda(BENCH, device_model=None), None,
                              "cuda_fused"),
    # a callable outside trace.LOWERINGS: the plain line search, and a warning
    "cuda_float32_no_lowering": (_on_cuda(
        BENCH, device_model=None, stage_cost=lambda x, u, p: torch.atan2(
            x[1], x[0]) + BENCH.stage_cost(x, u, p)), None, "cuda_bw"),
    "cuda_float64": (_on_cuda(bench_ocp(10, "cpu", torch.float64)), None,
                     "cuda_bw"),
    "cuda_float64_no_model": (_on_cuda(bench_ocp(10, "cpu", torch.float64),
                                       device_model=None), None, "cuda_bw"),
    "cuda_nu5": (_on_cuda(BENCH, nu=5, device_model=None), None,
                 NotImplementedError),
    "cpu": (BENCH, None, "torch"),
    "explicit_cuda": (_on_cuda(BENCH), "cuda", "cuda"),
    "explicit_torch": (_on_cuda(BENCH, device_model=None), "torch", "torch"),
    "explicit_cuda_bw": (_on_cuda(BENCH), "cuda_bw", "cuda_bw"),
}


@pytest.mark.parametrize("factory,case", [
    (f, c) for f in FACTORIES for c in RULE_CASES
    # the fleet builds its own unicycle, with its device model
    if f != "fleet" or c not in ("cuda_float32_no_model", "cuda_nu5",
                                 "cuda_float32_no_lowering",
                                 "cuda_float64_no_model")])
def test_default_backend_rule(factory, case, monkeypatch):
    """backend=None on a CUDA OCP is "cuda_fused" in float32 with a device
    model or callables that lower to a traced one, else "cuda_bw" (float64,
    or a callable that does not lower: then a warning names the op and the
    callable); nu > 4 there raises and names backend="torch"; "torch" on the
    CPU; an explicit backend is honoured.  The fleet builds its own float32
    or float64 unicycle, so only its device, dtype and backend come from the
    case."""
    ocp, backend, expected = RULE_CASES[case]
    if factory == "fleet":
        real = fleet_mod.unicycle_ocp
        monkeypatch.setattr(fleet_mod, "unicycle_ocp", lambda N, device, *a, **k:
                            dataclasses.replace(real(N, "cpu", *a, **k),
                                                device=torch.device(device)))
    seen = []
    _spy_parts(monkeypatch, seen)
    # the barrier solver and the warm start allocate on the OCP's device
    # before their parts: the spy stops them at their first resolution
    if factory == "streaming_barrier":
        _spy_resolve(monkeypatch, ipm_mod, seen)
    if factory == "warm_start":
        def spy_check(ocp, backend):
            seen.append(backend)
            raise _Stop

        monkeypatch.setattr(warmstart_mod, "_check_ocp", spy_check)
    make = FACTORIES[factory]
    if isinstance(expected, type):
        with pytest.raises(expected, match='backend="torch"'):
            make(ocp, backend, mt.ILQROptions())
        return
    if case == "cuda_float32_no_lowering":
        with pytest.warns(UserWarning, match="cuda_bw.*stage_cost.*atan2"):
            with pytest.raises(_Stop):
                make(ocp, backend, mt.ILQROptions())
    else:
        with pytest.raises(_Stop):
            make(ocp, backend, mt.ILQROptions())
    assert seen == [expected], (factory, case)


def _rate_ocp(dtype=torch.float32, state_box=False):
    """A rate-form OCP (``chip_smoke.rate_di_ocp`` at N = 8: the double
    integrator at T = 0.1, rates boxed in [-0.5, 0.5], no magnitude box, so
    its control box is constant and a barrier can be derived), with a device
    model; ``state_box`` adds |position| <= 3, |velocity| <= 0.5."""
    return cs.rate_di_ocp(8, "cpu", dtype, state_box)


def _j_rate_ocp(state_box=False, N=8):
    """``_rate_ocp`` in JAX from the same numbers (``chip_smoke.RATE_DI``)."""
    s = cs.RATE_DI
    Ad, Bd = np.array(s["Ad"]), np.array(s["Bd"])
    Q, R = np.diag(s["Q"]), np.array([[s["R"]]])
    box = dict(x_lb=np.array(s["x_box"][0][:2]),
               x_ub=np.array(s["x_box"][1][:2])) if state_box else {}
    return mv.to_rate_form(lambda x, u, p: Ad @ x + Bd @ u,
                           lambda x, u, p, du: x @ Q @ x + u @ R @ u, N=N,
                           nx=2, nu=1, du_lb=[-s["du"]], du_ub=[s["du"]], **box)


DERIVED_CASES = {
    # (factory, base OCP (on the CPU), expected on a CUDA device)
    "batched_al_rate": ("batched", _rate_ocp(state_box=True), "cuda_fused"),
    "ilqr_al_rate": ("ilqr", _rate_ocp(state_box=True), "cuda_fused"),
    "streaming_al_rate": ("streaming", _rate_ocp(state_box=True),
                          "cuda_fused"),
    "barrier_rate": ("streaming_barrier", _rate_ocp(), "cuda_fused"),
    "barrier_al_rate": ("streaming_barrier", _rate_ocp(state_box=True),
                        "cuda_fused"),
    "batched_al_unicycle": ("batched", bench_ocp(10, "cpu", x_ub=[np.inf, 5.0,
                                                                  np.inf]),
                            "cuda_fused"),
    "barrier_unicycle": ("streaming_barrier", bench_ocp(10, "cpu"),
                         "cuda_fused"),
}


@pytest.mark.parametrize("case", list(DERIVED_CASES))
def test_default_backend_reads_the_derived_ocp(case, monkeypatch):
    """backend=None resolves on the OCP the parts run: the AL-derived OCP
    under state bounds, the barrier-derived one (and its AL-derived one) in
    the streaming barrier solver.  A rate-form model derives no barrier or
    AL term, so those OCPs run "cuda_fused" on the model traced from their
    callables; the unicycle's derived models keep "cuda_fused" on theirs.
    The derived OCPs are built on the CPU and resolved as if they lay on a
    CUDA device."""
    factory, ocp, expected = DERIVED_CASES[case]
    seen, ran_on = [], []
    module = streaming_mod if factory in ("streaming", "streaming_barrier") \
        else batched_mod

    def spy(run_ocp, backend):
        ran_on.append(_on_cuda(run_ocp))
        seen.append(resolve_backend(ran_on[-1], backend))
        raise _Stop

    monkeypatch.setattr(module, "resolve_backend", spy)
    with pytest.raises(_Stop):
        FACTORIES[factory](ocp, None, mt.ILQROptions(al_iters=3))
    assert seen == [expected]
    assert ran_on[0].npar > max(ocp.npar, 1)          # a derived OCP
    assert not ran_on[0].has_state_bounds
    # the kernels run the model the rule traced, kept on the OCP
    model = kernel_model(ran_on[0])
    if case.endswith("rate"):
        assert ran_on[0].device_model is None
        assert isinstance(model, TracedDeviceModel)
        assert model is ran_on[0].__dict__["_traced_device_model"]
    else:
        assert model is ran_on[0].device_model is not None
    # the same OCP on the CPU runs "torch"
    assert resolve_backend(dataclasses.replace(ran_on[0], device=torch.device(
        "cpu")), None) == "torch"


def test_the_rule_traces_without_a_card(monkeypatch):
    """backend=None decides "cuda_fused" by a trace at the factory that
    allocates nothing on the OCP's device (CUDA's lazy initialisation, which
    every CUDA allocation runs first, is never reached), and keeps that
    trace on the OCP for the kernels: the bench from its callables, the user
    OCPs and the rate-form AL- and barrier-derived OCPs.  A float64 OCP is
    decided without a trace."""
    def no_card():
        raise AssertionError("the rule reached CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_card)
    ocps = {"bench": _on_cuda(BENCH, device_model=None),
            **{n: _on_cuda(cs.user_ocp(n, "cpu")) for n in cs.USER_OCPS},
            "al_rate": _on_cuda(batched_mod._augment_ocp_al(
                _rate_ocp(state_box=True))),
            "barrier_rate": _on_cuda(ipm_mod._barrier_ocp(_rate_ocp(),
                                                          "streaming"))}
    for name, ocp in ocps.items():
        assert ocp.device_model is None, name
        assert resolve_backend(ocp, None) == "cuda_fused", name
        assert kernel_model(ocp) is ocp.__dict__["_traced_device_model"]
    ocp64 = _on_cuda(bench_ocp(10, "cpu", torch.float64), device_model=None)
    assert resolve_backend(ocp64, None) == "cuda_bw"
    assert "_traced_device_model" not in ocp64.__dict__


def test_explicit_kernel_backends_still_refuse_what_they_cannot_run():
    """"cuda" and "cuda_fused" keep their requirements: float32, and an OCP
    without a device model only where its callables lower to the model the
    kernels run (ops/cuda/trace.py); "cuda_bw" needs neither, and every
    kernel backend refuses nu > 4."""
    ocp64 = bench_ocp(10, "cpu", torch.float64)
    bare = dataclasses.replace(BENCH, device_model=None)
    atan2 = dataclasses.replace(bare, stage_cost=lambda x, u, p: torch.atan2(
        x[1], x[0]) + BENCH.stage_cost(x, u, p))
    for backend in ("cuda", "cuda_fused"):
        with pytest.raises(TypeError, match="float32"):
            mt.make_batched_ilqr_solver(ocp64, backend=backend)
        with pytest.raises(NotImplementedError, match="stage_cost.*atan2"):
            mt.make_batched_ilqr_solver(atan2, backend=backend)
        mt.make_batched_ilqr_solver(bare, backend=backend)
    mt.make_batched_ilqr_solver(ocp64, backend="cuda_bw")
    mt.make_batched_ilqr_solver(dataclasses.replace(BENCH, device_model=None),
                                backend="cuda_bw")
    for backend in ("cuda_bw", "cuda", "cuda_fused"):
        with pytest.raises(NotImplementedError, match="nu <= 4"):
            mt.make_batched_ilqr_solver(dataclasses.replace(BENCH, nu=5),
                                        backend=backend)


def _jax_user_ocp(name):
    """``chip_smoke.user_ocp(name)`` in the JAX package, from the same
    numbers (float64 under the tests' x64)."""
    s = cs.USER_OCPS[name]
    if name == "quadrotor":
        F = j_rk4_step(lambda x, u, p: cs.quadrotor_rhs(x, u, jnp), s["dt"])
    else:
        lm = j_linear_model(*cs.user_linear(name))
        Ad, Bd = j_c2d(lm.Ac, lm.Bc, s["dt"])

        def F(x, u, p):
            return Ad @ x + Bd @ u
    Q, R = np.diag(s["Q"]), np.diag(s["R"])
    ur = cs.user_u_ref(name)

    def l(x, u, p):
        du = u - ur
        return x @ Q @ x + du @ R @ du

    def lf(x, p):
        return cs.USER_QF * (x @ Q @ x)

    return mv.OCP(dynamics=F, stage_cost=l, terminal_cost=lf, N=cs.USER_N,
                  nx=s["nx"], nu=s["nu"], npar=0,
                  control_bounds=mv.box_bounds(np.array(s["lb"]),
                                               np.array(s["ub"])))


@pytest.mark.parametrize("name", list(cs.USER_OCPS))
def test_cuda_bw_on_user_ocps_matches_jax(name):
    """"cuda_bw" on the CPU (K1's twin, the twin line search) against JAX
    "xla" in float64 at (2, 1), (6, 2) and (6, 3): converged equal,
    iterations within one, xs, us and cost to 1e-6."""
    x0, ps, us0 = cs.user_queue(name, PARITY_B)
    res_j = jax.jit(j_batched(_jax_user_ocp(name), mv.ILQROptions(**OPTS),
                              backend="xla"))(x0, ps, us0)
    ocp = cs.user_ocp(name, "cpu", torch.float64)
    assert resolve_backend(_on_cuda(ocp), None) == "cuda_bw"
    res_t = mt.make_batched_ilqr_solver(ocp, mt.ILQROptions(**OPTS),
                                        backend="cuda_bw")(x0, ps, us0)
    rj = from_numpy(res_j, "cpu", torch.float64)
    assert bool(res_t.converged.all())
    np.testing.assert_array_equal(res_t.converged.numpy(), rj.converged.numpy())
    assert (res_t.iterations - rj.iterations).abs().max() <= 1
    for field in ("xs", "us", "cost"):
        np.testing.assert_allclose(getattr(res_t, field).numpy(),
                                   getattr(rj, field).numpy(), rtol=0,
                                   atol=1e-6, err_msg=field)


def test_cuda_bw_warm_start_on_the_cpu_is_the_twins():
    """make_lqr_warm_start on "cuda_bw": K1's twin and the rollout's twin
    on the CPU, so the "torch" controls exactly."""
    ocp = bench_ocp(10, "cpu", torch.float64)
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-2, 2, (5, 3))
    ps = np.broadcast_to(np.array([10.0, 10.0, 0.0]), (5, 11, 3)).copy()
    warm = lambda b: make_lqr_warm_start(ocp, xref_fn=lambda p: p[:3],
                                         backend=b)(x0, ps)
    assert torch.equal(warm("cuda_bw"), warm("torch"))


def test_k1_cast_wrapper_keeps_cpu_inputs_in_their_dtype():
    """riccati_backward_cast on CPU tensors is the twin in their dtype: the
    float32 copies are for the kernel only."""
    args = cs._random_riccati(np.random.default_rng(2), 5, 4, 6, 2, "cpu")
    f64 = lambda t: t.double()
    args64 = ({k: f64(v) for k, v in args[0].items()},
              *(f64(a) for a in args[1:]))
    out = riccati_backward_cast(*args64, nx=6, nu=2)
    ref = riccati_backward_torch(*args64, nx=6, nu=2)
    assert all(o.dtype == torch.float64 and torch.equal(o, r)
               for o, r in zip(out, ref))


@pytest.mark.parametrize("B", [1, 1024])
@pytest.mark.parametrize("N", [10, 40, 600])
@pytest.mark.parametrize("use_ddp", [True, False])
@pytest.mark.parametrize("nx,nu", [(2, 1), (6, 2), (6, 3), (8, 1), (8, 3),
                                   (8, 4)])
def test_riccati_launch_plan_at_new_sizes(nx, nu, use_ddp, N, B):
    """Every size gets a plan: "warps" where a problem's slabs fit in
    shared memory, the batch makes at most three blocks an SM and a
    candidate warp has at most three patterns, else "thread".  At nx = 8
    with DDP fxx alone is 512 floats a stage."""
    plan = riccati_launch_plan(N, nx, nu, use_ddp, B)
    assert plan.smem_bytes <= SMEM_MAX_BYTES
    if nu == 4:
        assert plan.variant == "thread"
    if plan.variant == "warps":
        assert -(-B // plan.problems) <= 3 * 132 and plan.problems >= 1
        assert plan.layout[-1] * 4 == plan.smem_bytes
    else:
        assert plan[:4] == ("thread", 64, 64, 0)
    try:
        forced = riccati_launch_plan(N, nx, nu, use_ddp, B, "warps")
    except ValueError as exc:
        assert "shared memory" in str(exc)
        assert plan.variant == "thread"
    else:
        assert forced.variant == "warps" and forced.smem_bytes <= SMEM_MAX_BYTES


def test_riccati_launch_plan_at_the_held_sizes():
    """The planned variants at the bench shape (B = 1024, N = 40, DDP):
    at (6, 3) two problems fit a block, and 512 blocks are more than three
    an SM, so it runs "thread"."""
    got = {s: riccati_launch_plan(40, *s, True, 1024)[:2] for s in HELD_SIZES}
    assert got == {(3, 1): ("warps", 8), (3, 2): ("warps", 8),
                   (4, 1): ("warps", 8), (4, 3): ("warps", 5),
                   (5, 1): ("warps", 6), (5, 2): ("warps", 4),
                   (5, 4): ("thread", 64), (2, 1): ("warps", 8),
                   (6, 2): ("warps", 3), (6, 3): ("thread", 64)}
    assert riccati_launch_plan(40, 8, 4, True, 1)[:2] == ("thread", 64)
    assert riccati_launch_plan(40, 8, 4, True, 1, "warps")[:2] == ("warps", 1)


def test_k1_refuses_nu_above_four_and_empty_sizes():
    """nu > 4 raises NotImplementedError on either device, as JAX's
    test_nu5_rejected holds its kernel to; nx or nu below 1 is no size."""
    args = cs._random_riccati(np.random.default_rng(1), 2, 3, 2, 5, "cpu")
    with pytest.raises(NotImplementedError, match="nu <= 4"):
        riccati_backward(*args, nx=2, nu=5)
    with pytest.raises(NotImplementedError):
        riccati_launch_plan(10, 2, 5, True)
    with pytest.raises(NotImplementedError):
        build_mod.riccati_units(2, 5)
    for nx, nu in ((0, 1), (3, 0)):
        with pytest.raises(ValueError):
            riccati_launch_plan(10, nx, nu, True)


def test_generated_k1_units():
    """The two units of one size: the "thread" unit writes the C entry of
    its size, the "warps" unit its launcher, from the templates."""
    units = build_mod.riccati_units(6, 3)
    assert list(units) == ["riccati_6x3.cu", "riccati_warps_6x3.cu"]
    thread, warps = units.values()
    assert '#include "riccati_entry.cuh"' in thread
    assert "MV_RICCATI_ENTRY(6, 3)" in thread
    assert '#include "riccati_warps.cuh"' in warps
    assert "mv_riccati_warps_launch_6x3(" in warps
    assert "riccati_warps_launch<6, 3>(" in warps
    assert build_mod._headers(units) == [
        "launch.cuh", "riccati.cuh", "riccati_entry.cuh", "riccati_warps.cuh",
        "tri.cuh"]
    # the kernels library holds K2 and K3 only
    assert not any(n.startswith("riccati") for n in build_mod._kernels_units())


def test_library_names_follow_units_headers_and_flags(tmp_path, monkeypatch):
    """A library's name hashes its units, every header they include and the
    flags: K1's changes with a header it includes, not with one it does
    not; the kernels library's with the headers of K2 and K3."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build_mod.CSRC, csrc)
    monkeypatch.setattr(build_mod, "CSRC", csrc)
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path / "_build")
    k1 = lambda: build_mod.riccati_library_path(6, 3)
    p0, kern0 = k1(), build_mod.library_path()
    assert p0.parent == tmp_path / "_build"
    assert p0.name.startswith("libmv_riccati_6x3_") and p0.suffix == ".so"
    assert build_mod.riccati_library_path(6, 2) != p0
    (csrc / "rollout.cuh").write_text((csrc / "rollout.cuh").read_text() + "\n")
    assert k1() == p0                                # not included
    kern1 = build_mod.library_path()
    assert kern1 != kern0
    (csrc / "tri.cuh").write_text((csrc / "tri.cuh").read_text() + "// x\n")
    p1 = k1()
    assert p1 != p0                                  # included by riccati.cuh
    assert build_mod.library_path() != kern1         # fused.cuh includes it too
    monkeypatch.setattr(build_mod, "NVCC_FLAGS", build_mod.NVCC_FLAGS + ("-g",))
    assert k1() != p1
    assert not (tmp_path / "_build").exists()        # naming builds nothing


_STAND_IN_NVCC = """#!/bin/sh
# writes an empty file at -o; fails on a source named bad.cu
prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  case "$a" in *bad.cu) echo "error: forced failure"; exit 1;; esac
  prev="$a"
done
sleep 0.2
echo "ptxas info: stand-in"
: > "$out"
"""


def test_compile_times_each_unit_in_its_own_directory(tmp_path, monkeypatch):
    """``_compile`` with a stand-in nvcc: each unit's log carries its own
    seconds and a library's seconds span its units and link; two threads
    building one library each use a directory of their own and leave none
    behind; a failed unit raises with its log and leaves no library."""
    import threading

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_STAND_IN_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(build_mod, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path / "_build")
    lib = tmp_path / "_build" / "libmv_test.so"
    units = {"a.cu": "// a\n", "b.cu": "// b\n"}
    out = {}
    threads = [threading.Thread(
        target=lambda i=i: out.setdefault(i, build_mod._compile({lib: units})))
        for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(2):
        res = out[i][lib]
        assert res.path == lib and lib.is_file()
        assert 0.2 <= res.seconds < 30
        for name in units:
            secs = float(res.log.split(f"== {name} (")[1].split(" s)")[0])
            assert 0.2 <= secs <= res.seconds
        assert "ptxas info: stand-in" in res.log
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == [lib.name]
    bad = tmp_path / "_build" / "libmv_bad.so"
    with pytest.raises(RuntimeError, match="forced failure"):
        build_mod._compile({bad: {"a.cu": "", "bad.cu": ""}})
    assert not bad.exists()
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == [lib.name]


def test_reference_dir_falls_back_as_jax_does(tmp_path, monkeypatch):
    """MPC_VERDE_REFERENCE_DIR first, then the reference checkout's own
    directory, the JAX loader's order and fallback path."""
    assert t_io._FALLBACK_DIR == j_io._DEF_DIRS[1]
    monkeypatch.delenv("MPC_VERDE_REFERENCE_DIR", raising=False)
    fallback = tmp_path / "Trajectory Tracking"
    monkeypatch.setattr(t_io, "_FALLBACK_DIR", str(fallback))
    assert t_io.reference_data_dir() is None
    fallback.mkdir()
    assert t_io.reference_data_dir() == fallback
    (fallback / "lane_change.csv").write_text("x,y\n0.0,1.0\n2.0,3.0\n")
    np.testing.assert_array_equal(t_io.load_path_csv("lane_change.csv")["y"],
                                  [1.0, 3.0])
    env = tmp_path / "env"
    env.mkdir()
    monkeypatch.setenv("MPC_VERDE_REFERENCE_DIR", str(env))
    assert t_io.reference_data_dir() == env


def _j_lane_box_ocp(N=cs.BENCH_N):
    """``chip_smoke.lane_box_ocp`` in JAX: the JAX lane change's OCP at N
    without move blocking, the same box on y."""
    ocp = js.build_lane_change_lti(N=N, Ntu=N, n_steps=1)["ocp"]
    lo, hi = cs.LANE_Y_BOX
    return dataclasses.replace(ocp, x_lb=jnp.array([lo, -np.inf, -np.inf,
                                                    -np.inf]),
                               x_ub=jnp.array([hi, np.inf, np.inf, np.inf]))


def _band(B=cs.USER_B):
    """converged_frac of JAX float32 "xla" on the CPU over the first B
    starts of each user OCP (chip_smoke.USER_JAX_BAND) and over the queues
    of chip_smoke.py phase 23 (e2) and (e3) (held to 0.99 there)."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    opts = mv.ILQROptions(**OPTS)
    for name, make, queue in (
            ("lane_al", lambda: j_streaming(
                _j_lane_box_ocp(), dataclasses.replace(
                    opts, al_iters=cs.AL_ITERS), backend="xla",
                batch_width=cs.WIDTH, restarts=2),
             cs.lane_box_queue(cs.WIDTH)),
            ("rate_barrier", lambda: j_barrier(
                _j_rate_ocp(N=cs.BENCH_N), opts, backend="xla",
                batch_width=cs.WIDTH, restarts=2),
             cs.rate_di_queue(cs.WIDTH))):
        res = make()(*queue, max_iters=60, restarts_n=2)
        viol = np.asarray(res.max_violation)
        print(f"{name}: JAX float32 \"xla\" on the CPU, M={cs.WIDTH} "
              f"N={cs.BENCH_N}: converged_frac "
              f"{float(np.mean(np.asarray(res.converged)))}, mean iterations "
              f"{float(np.mean(np.asarray(res.iterations)))}, max_violation "
              f"{float(viol.max())}", flush=True)
    for name in cs.USER_OCPS:
        x0, ps, us0 = (a.astype(np.float32) for a in cs.user_queue(name, B))
        res = jax.jit(j_batched(_jax_user_ocp(name), mv.ILQROptions(**OPTS),
                                backend="xla"))(x0, ps, us0)
        print(f"{name}: JAX float32 \"xla\" on the CPU, B={B} N={cs.USER_N}: "
              f"converged_frac {float(np.mean(np.asarray(res.converged)))}, "
              f"mean iterations {float(np.mean(np.asarray(res.iterations)))}, "
              f"cost {res.cost.dtype}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--band"]:
        _band()
