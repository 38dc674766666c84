"""The benchmark's planar quadrotor (``portbench/programs/quadrotor2d.py``),
an OCP written from plain callables, on the CPU in float64: its plain
reference (``portbench/reference/quadrotor2d.py``) against the port's
``"torch"`` path, the traced program (the generated device model's twin)
against the reference, the program's hash across builds, and the traced
path's counters (``utils.profiling``).  Sizes are tiny: B <= 16, N <= 8.
"""
import importlib.util
import json
from pathlib import Path

import pytest
import torch
from torch.func import vmap

from mpc_verde_tpu_torch import ILQROptions, make_batched_ilqr_solver
from mpc_verde_tpu_torch.ops.cuda import build as build_mod
from mpc_verde_tpu_torch.ops.cuda.codegen import program_hash
from mpc_verde_tpu_torch.ops.cuda.rollout import (TracedDeviceModel,
                                                  traced_device_model)
from mpc_verde_tpu_torch.ops.cuda.trace import trace_ocp
from mpc_verde_tpu_torch.utils.profiling import counters

BENCH = Path(__file__).resolve().parents[1] / "portbench"
F64 = torch.float64
B, N = 12, 8


def _load(kind):
    path = BENCH / kind / "quadrotor2d.py"
    spec = importlib.util.spec_from_file_location(f"quadrotor2d_{kind}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load("reference")
PROGRAM = _load("programs")


def _cfg(**over):
    with open(BENCH / "configs" / "quadrotor2d_n40.json") as fh:
        return {**json.load(fh), "N": N, **over}


def _ocp(cfg, dtype="float64"):
    return PROGRAM.build_ocp(dict(cfg, dtype=dtype), torch.device("cpu"))


def _points(seed, rows=B):
    """Seeded states in +-1 (the cell's start box), thrusts across the box
    and a little outside it, targets near the origin."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g, dtype=F64)
    ub = _cfg()["u_ub"][0]
    return (2.0 * r(rows, 6) - 1.0, (1.4 * r(rows, N, 2) - 0.2) * ub,
            0.2 * r(rows, 6) - 0.1)


def test_config_holds_the_model_and_its_numbers():
    cfg = _cfg()
    assert (cfg["m"], cfg["arm"], cfg["I"], cfg["g"]) == (0.486, 0.25,
                                                          0.00383, 9.81)
    mg = cfg["m"] * cfg["g"]
    assert cfg["u_ref"] == [mg / 2, mg / 2] and cfg["u_ub"] == [mg, mg]
    assert cfg["u_lb"] == [0.0, 0.0] and cfg["reduced"] == {}
    ocp = _ocp(dict(cfg, N=40), dtype="float32")
    assert (ocp.nx, ocp.nu, ocp.npar, ocp.N) == (6, 2, 6, 40)
    assert ocp.device_model is None   # nothing of the model is hand-written


def test_reference_rollout_and_cost_match_the_port():
    """float64 on both sides, the same RK4 and the same sums in another
    order: agreement to 1e-12, relative to max(1, |value|)."""
    cfg = _cfg()
    ocp = _ocp(cfg)
    x0, us, target = _points(5)
    cfg_t = [dict(cfg, target=t.tolist()) for t in target]
    xs = [x0]
    for k in range(N):
        xs.append(vmap(ocp.dynamics)(xs[-1], us[:, k], target))
    xs = torch.stack(xs, 1)
    port_cost = sum(vmap(ocp.stage_cost)(xs[:, k], us[:, k], target)
                    for k in range(N)) + vmap(ocp.terminal_cost)(xs[:, N],
                                                                 target)
    torch.testing.assert_close(REF.rollout(x0, us, cfg), xs, rtol=1e-12,
                               atol=1e-12)
    ref_cost = torch.cat([REF.cost(xs[i:i + 1], us[i:i + 1], cfg_t[i])
                          for i in range(B)])
    torch.testing.assert_close(ref_cost, port_cost, rtol=1e-12, atol=1e-12)


def test_port_converged_solve_is_optimal_by_the_reference():
    """A float64 solve of the port with tight tolerances, converged on every
    start; the reference's projected gradient of its controls is then the
    first-order residual of the box-constrained problem.  Bound 1e-4: the
    solver stops on its own gradient test (tol_grad 1e-9 of its scale) or a
    cost change of 1e-13 of the cost, which leave residuals far below it on
    costs of order 10-100, while a control a step off the optimum reads
    above 1e-2."""
    cfg = _cfg()
    ocp = _ocp(cfg)
    x0 = _points(7)[0]
    opts = ILQROptions(**dict(cfg["solver"], tol_grad=1e-9, tol_cost=1e-13,
                              max_iters=200))
    r = make_batched_ilqr_solver(ocp, opts)(
        x0, torch.tensor(cfg["target"], dtype=F64))
    assert bool(r.converged.all())
    grad = REF.projected_gradient(x0, r.us, cfg)
    assert float(grad.max()) < 1e-4
    # the answer is not trivially at a bound: a step off the optimum is seen
    off = r.us + 0.05 * (r.us < 0.5 * cfg["u_ub"][0])
    assert float(REF.projected_gradient(x0, off, cfg).max()) > 1e-2
    torch.testing.assert_close(REF.rollout(x0, r.us, cfg), r.xs, rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(REF.cost(r.xs, r.us, cfg), r.cost, rtol=1e-12,
                               atol=1e-12)


def test_traced_program_matches_the_reference():
    """The program the generated device model is written from, evaluated
    in PyTorch (``Program.evaluate``, the kernels' twin), against the
    reference at seeded points: step, stage cost, terminal cost and box to
    1e-12, so that a lowering error fails here."""
    cfg = _cfg()
    model = traced_device_model(_ocp(cfg))
    assert isinstance(model, TracedDeviceModel)
    x, us, p = _points(11)
    u = us[:, 0]
    torch.testing.assert_close(model.step(x, u, p), REF.step(x, u, cfg),
                               rtol=1e-12, atol=1e-12)
    for i in range(B):
        c = dict(cfg, target=p[i].tolist())
        # the reference's cost of a one-stage trajectory (x, u) -> x_N is the
        # stage cost at (x, u) plus the terminal cost at x_N
        xN = x[i:i + 1] + 0.5
        want = REF.cost(torch.stack([x[i:i + 1], xN], 1), u[i:i + 1, None], c)
        got = (model.stage_cost(x[i:i + 1], u[i:i + 1], p[i:i + 1])
               + model.terminal_cost(xN, p[i:i + 1]))
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
        # and of a trajectory of no stage the terminal cost alone
        want_term = REF.cost(xN[:, None], torch.zeros((1, 0, 2), dtype=F64),
                             c)
        torch.testing.assert_close(model.terminal_cost(xN, p[i:i + 1]),
                                   want_term, rtol=1e-12, atol=1e-12)
    for k in (0, N - 1):
        lb, ub = model.bounds(x, p, k)
        torch.testing.assert_close(lb, torch.tensor(cfg["u_lb"], dtype=F64)
                                   .expand(B, 2), rtol=0, atol=0)
        torch.testing.assert_close(ub, torch.tensor(cfg["u_ub"], dtype=F64)
                                   .expand(B, 2), rtol=0, atol=0)


def test_program_hash_is_the_same_across_builds():
    """Two builds of the OCP trace to the same text, so a checkout builds
    the program's library once; the float32 OCP the cell runs too."""
    cfg = _cfg(N=40)
    for dtype in ("float32", "float64"):
        a, b = (trace_ocp(_ocp(cfg, dtype)) for _ in range(2))
        assert program_hash(a) == program_hash(b)
    # other weights, the same program: they live in the table
    heavier = _cfg(N=40, Q=[20.0, 10.0, 10.0, 1.0, 1.0, 2.0])
    assert program_hash(trace_ocp(_ocp(heavier, "float32"))) == \
        program_hash(trace_ocp(_ocp(cfg, "float32")))


def test_one_trace_per_ocp():
    ocp = _ocp(_cfg())
    before = counters()["traced_traces"]
    first = traced_device_model(ocp)
    assert traced_device_model(ocp) is first
    assert counters()["traced_traces"] == before + 1
    traced_device_model(_ocp(_cfg()))
    assert counters()["traced_traces"] == before + 2


def test_table_fills_once_until_a_weight_changes_in_place():
    model = traced_device_model(_ocp(_cfg(), dtype="float32"))
    fills = lambda: counters()["traced_table_fills"]
    before = fills()
    first = model.table("cpu")
    for _ in range(5):
        assert model.table("cpu") is first
    assert fills() == before + 1
    weight = max(model.program.consts, key=lambda c: c.numel())  # Q
    old = first.clone()
    with torch.no_grad():
        weight.mul_(2.0)
    again = model.table("cpu")
    assert again is first and not torch.equal(again, old)
    for _ in range(3):
        model.table("cpu")
    assert fills() == before + 2


# writes an empty file at -o
_STAND_IN_NVCC = """#!/bin/sh
prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  prev="$a"
done
: > "$out"
"""


class _Library:
    """What ``ctypes.CDLL`` gives for the stand-in's empty library: any
    entry point, as an object that takes argtypes and restype."""

    def __getattr__(self, name):
        entry = type("Entry", (), {})()
        self.__dict__[name] = entry
        return entry


def test_traced_library_builds_and_loads_once_in_a_build_span(
        tmp_path, monkeypatch):
    """``build.traced_entry`` with a stand-in nvcc: the program's library
    is built (one ``traced_builds``) and opened (one ``traced_loads``) at
    the first entry point, inside one ``mpc.build`` span; the other entry
    points and a second model of the same program text reuse it."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_STAND_IN_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(build_mod, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build_mod, "_TRACED", {})
    monkeypatch.setattr(build_mod.ctypes, "CDLL", lambda path: _Library())
    keys = ("traced_builds", "traced_loads")
    before = {k: counters()[k] for k in keys}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for T in (0.05, 0.05, 0.1):   # another step, another program text
            model = traced_device_model(_ocp(_cfg(N=40, T=T), "float32"))
            for name in ("mv_linesearch_forward", "mv_fused_backward",
                         "mv_trajectory_cost"):
                model.entry(name)
    spans = [e.key for e in prof.key_averages() if e.key.startswith("mpc.")]
    counts = {e.key: e.count for e in prof.key_averages()}
    assert {k: counters()[k] - before[k] for k in keys} == {
        "traced_builds": 2, "traced_loads": 2}
    assert set(spans) == {"mpc.trace", "mpc.build"}
    assert counts["mpc.trace"] == 3 and counts["mpc.build"] == 2
    assert len(list((tmp_path / "_build").glob("libmv_traced_*.so"))) == 2


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_reference_runs_in_the_dtype_of_its_inputs(dtype):
    cfg = _cfg()
    x0, us, _ = _points(13, rows=4)
    xs = REF.rollout(x0.to(dtype), us.to(dtype), cfg)
    assert xs.dtype == dtype and REF.cost(xs, us.to(dtype), cfg).dtype == dtype
