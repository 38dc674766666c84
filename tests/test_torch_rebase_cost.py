"""The rounds' cost re-base (``ops/cuda/rollout.trajectory_cost``).

On the CPU (no marker): the solvers' re-base part (``_Parts.cost``) is the
plain masked cost, ``torch.where`` over the elementwise cost of every slot,
bit for bit, on every backend; the backends whose line search is K2 take
the kernel's wrapper, the others the plain cost; a streaming barrier solve
gives the bits it gives with that plain re-base in the loop, and launches
nothing.

On the card (marker ``cuda``; this file imports no JAX, so run it there
with ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_rebase_cost.py -q``): the kernel on every kind of device
model against K2's pre-roll cost of the same trajectory (bit for bit) and
the float32 twin (1e-5 relative to max(1, |ref|)), ``cost_in`` kept bit
for bit where the mask is false, and the launches a solve makes.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.func import vmap

import chip_smoke as cs
import mpc_verde_tpu_torch as mt
from chip_smoke import (_linear_case, _path_case, _same_bits, _term_cases,
                        _term_inputs)
from mpc_verde_tpu_torch.interop import bench_ocp, derived_ocps
from mpc_verde_tpu_torch.ops.cuda.rollout import (linesearch_forward,
                                                  trajectory_cost,
                                                  trajectory_cost_torch)
from mpc_verde_tpu_torch.solver import batched, streaming
from mpc_verde_tpu_torch.utils.profiling import counters

OPTS = dict(max_iters=20, tol_grad=1e-4, tol_cost=1e-6, n_alphas=4,
            alpha_decay=0.4)


def _parents_rebase(ocp, xs, us, ps, mask, cost_in):
    """The solver loop's re-base before the kernel: the elementwise cost of
    every slot under the OCP's callables, kept where the mask holds."""
    N = ocp.N
    c = vmap(vmap(ocp.stage_cost))(xs[:, :N], us, ps[:, :N]).sum(-1)
    if ocp.terminal_cost is not None:
        c = c + vmap(ocp.terminal_cost)(xs[:, N], ps[:, N])
    return torch.where(mask, c, cost_in)


def _cost_in(rng, B, dev):
    """Random costs with a NaN, +inf and -inf among them."""
    c = torch.as_tensor(rng.normal(size=B), dtype=torch.float32, device=dev)
    c[::5] = torch.nan
    c[1::7] = torch.inf
    c[2::11] = -torch.inf
    return c


def _mask(rng, kind, B, dev):
    if kind == "all":
        return torch.ones(B, dtype=torch.bool, device=dev)
    if kind == "none":
        return torch.zeros(B, dtype=torch.bool, device=dev)
    return torch.as_tensor(rng.uniform(size=B) < 0.04, device=dev)


def _barrier_trajectories(dev, B, N, rng, edge=True):
    """The barrier-derived bench OCP (mu 1e-2, float32) and trajectories of
    interior controls, rolled out by the OCP's own dynamics, with every
    seventh problem's control on the box's upper edge at one stage (its
    barrier +inf) when ``edge``."""
    ocp = derived_ocps(bench_ocp(N, dev))["barrier"]
    f = dict(dtype=torch.float32, device=dev)
    us = torch.as_tensor(rng.uniform(-0.6, 0.6, (B, N, 2)), **f)
    if edge:
        us[::7, N // 2, 0] = 1.0
    x = torch.as_tensor(rng.uniform(-2, 2, (B, 3)), **f)
    ps = torch.cat([torch.tensor([10.0, 10.0, 0.0], **f).expand(B, N + 1, 3),
                    torch.full((B, N + 1, 1), 1e-2, **f)], -1).contiguous()
    xs = [x]
    for k in range(N):
        xs.append(vmap(ocp.dynamics)(xs[-1], us[:, k], ps[:, k]))
    return ocp, torch.stack(xs, 1), us, ps


# ---- the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("backend",
                         ["torch", "cuda_bw", "cuda", "cuda_fused"])
def test_rebase_part_is_the_parents_masked_cost(backend):
    """``_Parts.cost`` on the CPU equals the plain masked cost bit for bit,
    +inf of a control on the box edge and the NaN and infinities of
    ``cost_in`` included."""
    rng = np.random.default_rng(5)
    B, N = 40, 8
    ocp, xs, us, ps = _barrier_trajectories("cpu", B, N, rng)
    parts = batched._make_parts(ocp, mt.ILQROptions(**OPTS), backend)
    for kind in ("all", "none", "4%"):
        mask, cost_in = _mask(rng, kind, B, "cpu"), _cost_in(rng, B, "cpu")
        got = parts.cost(xs, us, ps, mask, cost_in)
        assert _same_bits(got, _parents_rebase(ocp, xs, us, ps, mask, cost_in))
    assert torch.isinf(parts.cost(xs, us, ps, torch.ones(B, dtype=torch.bool),
                                  _cost_in(rng, B, "cpu"))[::7]).all()


@pytest.mark.parametrize("backend,kernel", [
    ("torch", False), ("cuda_bw", False), ("cuda", True),
    ("cuda_fused", True), ("scan", True)])
def test_rebase_prices_with_what_prices_the_line_search(backend, kernel,
                                                        monkeypatch):
    """The backends whose line search is K2 re-base through the kernel's
    wrapper (its CPU branch here), the others through the plain cost."""
    calls = []

    def spy(*args, **kw):
        calls.append(1)
        return trajectory_cost(*args, **kw)

    monkeypatch.setattr(batched, "trajectory_cost", spy)
    rng = np.random.default_rng(6)
    B, N = 12, 6
    ocp, xs, us, ps = _barrier_trajectories("cpu", B, N, rng, edge=False)
    if backend == "scan":   # the scan backward takes no control box
        ocp = dataclasses.replace(ocp, control_bounds=None)
    parts = batched._make_parts(ocp, mt.ILQROptions(**OPTS), backend)
    mask = torch.ones(B, dtype=torch.bool)
    got = parts.cost(xs, us, ps, mask, torch.zeros(B))
    assert bool(calls) == kernel
    assert _same_bits(got, trajectory_cost_torch(xs, us, ps, ocp=ocp))


@pytest.mark.parametrize("backend,dtype", [("torch", torch.float64),
                                           ("cuda", torch.float32)])
def test_streaming_barrier_solve_keeps_its_bits(backend, dtype, monkeypatch):
    """A streaming barrier solve (three rounds, each boundary re-based)
    returns the bits it returns with the plain re-base in the loop, and
    launches no re-base on the CPU."""
    N, M, W = 8, 12, 4
    g = torch.Generator().manual_seed(4)
    x0 = (4.0 * torch.rand((M, 3), generator=g, dtype=torch.float64)
          - 2.0).to(dtype)
    ps = torch.tensor([10.0, 10.0, 0.0], dtype=dtype).expand(M, N + 1, 3)
    ocp = bench_ocp(N, "cpu", dtype)

    def run():
        solve = mt.make_streaming_barrier_solver(
            ocp, mt.ILQROptions(**OPTS), backend=backend, batch_width=W,
            restarts=1)
        return solve(x0, ps)

    before = counters()
    got = run()
    after = counters()
    assert after["rebase"] == before["rebase"]
    assert after["iterations"] > before["iterations"]

    make_parts = streaming._make_parts

    def plain_parts(ocp_, opt, backend_):
        parts = make_parts(ocp_, opt, backend_)
        return dataclasses.replace(parts, cost=lambda *a: _parents_rebase(
            ocp_, *a))

    monkeypatch.setattr(streaming, "_make_parts", plain_parts)
    want = run()
    for name in ("xs", "us", "cost", "grad_norm", "iterations", "converged"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int(got.iterations.max()) > 0


# ---- the card --------------------------------------------------------------

N_CARD = 40


@pytest.fixture(scope="module")
def _libraries():
    """The kernels library and the traced (e4) obstacle program's library,
    built together."""
    if torch.cuda.is_available():
        from mpc_verde_tpu_torch.ops.cuda import build as build_mod
        from mpc_verde_tpu_torch.ops.cuda.trace import trace_ocp

        build_mod.build((), [trace_ocp(cs.obstacle_ocp("cpu", N=N_CARD))])


@pytest.fixture
def dev(_libraries):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _card_case(dev, label, B):
    """(OCP, x0, us, ps) float32 on the card for model ``label``."""
    rng = np.random.default_rng(17)
    f = dict(dtype=torch.float32, device=dev)
    if label == "ltv":
        ocp, _, (x0, _, us, _, _), ps = _linear_case(dev, B, "ltv", seed=41)
        return ocp, x0, us, ps
    if label == "frenet":
        ocp, _, (x0, _, us, _, _), ps = _path_case(dev, B, "frenet", seed=43)
        return ocp, x0, us, ps
    if label == "obstacle":
        ocp = cs.obstacle_ocp(dev, torch.float32, N_CARD)
        x0 = np.concatenate([rng.uniform(2.0, 8.0, (B, 2)),
                             rng.uniform(-1.0, 1.0, (B, 1))], -1)
        us = rng.uniform(-0.9, 0.9, (B, N_CARD, 2))
        ps = torch.tensor([10.0, 10.0, 0.0], **f).expand(B, N_CARD + 1, 3)
        return (ocp, torch.as_tensor(x0, **f), torch.as_tensor(us, **f),
                ps.contiguous())
    inputs = _term_inputs(dev, B, N_CARD)
    x0, us = inputs[0], inputs[2].clone()
    if label == "unicycle":
        return bench_ocp(N_CARD, dev), x0, us, inputs[3]
    if label == "barrier edge":
        us[::7, N_CARD // 2, 0] = 1.0
        label = "barrier mu=0.01"
    ocp, ps = next((o, p) for name, o, p in _term_cases(dev, N_CARD, inputs)
                   if name == label)
    return ocp, x0, us, ps


def _preroll(ocp, x0, us, ps):
    """K2's pre-roll (zero gains, one step length): the clipped rollout of
    ``us`` from ``x0`` and its cost."""
    B, N, nu = us.shape
    nx = x0.shape[-1]
    z = dict(dtype=torch.float32, device=x0.device)
    xs, us_c, cost, _ = linesearch_forward(
        x0, torch.zeros((B, N + 1, nx), **z), us, ps,
        torch.zeros((B, N, nu), **z), torch.zeros((B, N, nu, nx), **z),
        (1.0,), ocp=ocp)
    return xs, us_c, cost


CARD_CASES = ["unicycle", "barrier mu=0.01", "barrier mu=0", "barrier edge",
              "al", "ltv", "frenet", "obstacle"]


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", ["all", "none", "4%"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_rebase_kernel_is_k2s_cost_and_keeps_cost_in(dev, case, mask_kind):
    """On every kind of device model (the unicycle, its streaming barrier at
    mu 1e-2 and 0 and with a control on the box edge, its AL term, the
    linear rate-form and Frenet models, a traced OCP): the masked costs are
    K2's pre-roll costs of the same trajectories bit for bit and within
    1e-5 of the float32 twin, the others ``cost_in`` bit for bit; one
    launch.  B = 301 leaves a block ragged."""
    B = 301
    rng = np.random.default_rng(CARD_CASES.index(case))
    ocp, x0, us, ps = _card_case(dev, case, B)
    xs, us_c, c_k = _preroll(ocp, x0, us, ps)
    mask, cost_in = _mask(rng, mask_kind, B, dev), _cost_in(rng, B, dev)
    before = trajectory_cost.launches
    got = trajectory_cost(xs, us_c, ps, mask, cost_in, ocp=ocp)
    torch.cuda.synchronize()
    assert trajectory_cost.launches == before + 1
    assert _same_bits(got[~mask], cost_in[~mask])
    assert _same_bits(got[mask], c_k[mask])
    twin = trajectory_cost_torch(xs, us_c, ps, ocp=ocp)
    fin = mask & torch.isfinite(twin)
    if fin.any():
        rel = ((got - twin).abs() / twin.abs().clamp(min=1.0))[fin]
        assert float(rel.max()) <= 1e-5
    assert torch.equal(got[mask & ~fin], twin[mask & ~fin])
    if case == "barrier edge":
        assert torch.isinf(c_k[::7]).all() and torch.isfinite(twin).any()
        if mask_kind == "all":
            assert (got[::7] == torch.inf).all()


@pytest.mark.cuda
def test_rebase_at_mu_zero_is_the_base_cost(dev):
    """At mu = 0 the barrier-derived model's re-base is the base model's
    bit for bit."""
    B = 301
    inputs = _term_inputs(dev, B, N_CARD)
    ocp0, ps0 = next((o, p) for name, o, p in _term_cases(dev, N_CARD, inputs)
                     if name == "barrier mu=0")
    base = bench_ocp(N_CARD, dev)
    xs, us, _ = _preroll(base, inputs[0], inputs[2], inputs[3])
    mask = torch.ones(B, dtype=torch.bool, device=dev)
    cost_in = torch.zeros(B, device=dev)
    got = trajectory_cost(xs, us, ps0, mask, cost_in, ocp=ocp0)
    want = trajectory_cost(xs, us, inputs[3], mask, cost_in, ocp=base)
    assert _same_bits(got, want)


@pytest.mark.cuda
def test_rebase_wrapper_refuses_what_the_kernel_does_not_take(dev):
    rng = np.random.default_rng(9)
    ocp, x0, us, ps = _card_case(dev, "barrier mu=0.01", 16)
    xs, us, _ = _preroll(ocp, x0, us, ps)
    mask = torch.ones(16, dtype=torch.bool, device=dev)
    cost_in = _cost_in(rng, 16, dev)
    with pytest.raises(ValueError, match="mask"):
        trajectory_cost(xs, us, ps, mask.float(), cost_in, ocp=ocp)
    with pytest.raises(ValueError, match="mask"):
        trajectory_cost(xs, us, ps, mask[:8], cost_in, ocp=ocp)
    with pytest.raises(ValueError, match="contiguous"):
        trajectory_cost(xs.transpose(0, 1).contiguous().transpose(0, 1), us,
                        ps, mask, cost_in, ocp=ocp)
    with pytest.raises(ValueError, match="npar"):
        trajectory_cost(xs, us, ps[..., :3].contiguous(), mask, cost_in,
                        ocp=ocp)
    with pytest.raises(TypeError, match="float32"):
        trajectory_cost(xs, us, ps, mask, cost_in.double(), ocp=ocp)


@pytest.mark.cuda
def test_rebase_launches_once_an_iteration_of_a_loop_with_rounds(dev):
    """A streaming barrier solve launches the re-base once an iteration of
    its loop; a one-round streaming solve and the batched solver never."""
    N, M, W = 10, 48, 16
    g = torch.Generator().manual_seed(8)
    x0 = (4.0 * torch.rand((M, 3), generator=g) - 2.0).to(dev)
    ps = torch.tensor([10.0, 10.0, 0.0], device=dev).expand(M, N + 1, 3)
    ocp = bench_ocp(N, dev)
    opts = mt.ILQROptions(**OPTS)
    solvers = {
        "barrier": mt.make_streaming_barrier_solver(ocp, opts, batch_width=W,
                                                    restarts=1),
        "streaming": mt.make_streaming_solver(ocp, opts, batch_width=W,
                                              restarts=1),
        "batched": mt.make_batched_ilqr_solver(ocp, opts)}
    for name, solve in solvers.items():
        before = counters()
        res = solve(x0, ps)
        torch.cuda.synchronize()
        d = {k: v - before[k] for k, v in counters().items()}
        assert d["iterations"] > 0 and d["k2"] > 0, name
        assert d["rebase"] == (d["iterations"] if name == "barrier" else 0), \
            (name, d)
        assert bool(torch.isfinite(res.cost).all()), name
