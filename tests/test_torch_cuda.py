"""The hand-written CUDA kernels against their PyTorch twins, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
machine with the card has no JAX, so this file imports no JAX and needs
nothing from ``tests/conftest.py``; run it there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Tolerances are float32 kernel vs float32 twin, relative to max(1, |ref|):
the Riccati ones are those of the Pallas kernel's own test
(``tests/test_pallas_riccati.py``) and hold for the fused kernel as well,
the line-search ones those of ``chip_smoke.py`` phase 4.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mpc_verde_tpu_torch as mt
from chip_smoke import (_hold_optima, _k2_inputs, _k2_kernel_rule,
                        _random_riccati, _rel_err, _same_bits, _term_cases,
                        _term_inputs, quadrotor_cell_ocp)
from mpc_verde_tpu_torch.interop import BENCH_DT, bench_ocp, unicycle_ocp
from mpc_verde_tpu_torch.models import unicycle
from mpc_verde_tpu_torch.ops import euler_step, rk4_step
from mpc_verde_tpu_torch.ops.cuda.fused import (FUSED_VARIANTS,
                                                fused_backward,
                                                fused_backward_torch,
                                                fused_launch_plan,
                                                fused_phase_clocks)
from mpc_verde_tpu_torch.ops.cuda import build as build_mod
from mpc_verde_tpu_torch.ops.cuda.riccati import (CLOCK_PARTS, HELD_SIZES,
                                                  riccati_backward,
                                                  riccati_backward_torch,
                                                  riccati_launch_plan,
                                                  riccati_stage_clocks)
from mpc_verde_tpu_torch.ops.cuda.rollout import (LINESEARCH_VARIANTS,
                                                  linesearch_forward,
                                                  linesearch_forward_torch,
                                                  linesearch_launch_plan)
from mpc_verde_tpu_torch.scenarios import build_fleet
from mpc_verde_tpu_torch.utils.tune_launch_plans import _width_args

pytestmark = pytest.mark.cuda

K1_TOL = {"kff": 2e-4, "K": 2e-3, "dV1": 1e-3, "dV2": 1e-3, "gmax": 1e-4}
# K1's sizes built here: chip_smoke.py's and (8, 4), which stays out of the
# script's time limit
CARD_K1_SIZES = HELD_SIZES + ((8, 4),)


# csrc/traced_math.cuh's device functions, four a bank: each bank is an OCP
# (4, 1) whose step applies function i to x[i] (pow, fmod and remainder take
# u[0] as their second operand), so that one K2 launch at N = 1 evaluates
# each at every problem's point.  The domain each function's points are
# drawn from, and its tolerance against the float64 evaluator on the same
# float32 points, relative to max(1, |ref|): 0 for the exact ones.
MATH_BANKS = (("tanh", "sigmoid", "log1p", "exp2"),
              ("erfinv", "floor", "ceil", "round"),
              ("sign", "pow", "fmod", "remainder"))
MATH_DOMAIN = {"tanh": (-10.0, 10.0), "sigmoid": (-20.0, 20.0),
               "log1p": (-0.99, 10.0), "exp2": (-20.0, 20.0),
               "erfinv": (-0.999, 0.999), "floor": (-50.0, 50.0),
               "ceil": (-50.0, 50.0), "round": (-50.0, 50.0),
               "sign": (-2.0, 2.0), "pow": (0.05, 5.0), "fmod": (-10.0, 10.0),
               "remainder": (-10.0, 10.0)}
MATH_TOL = {"floor": 0.0, "ceil": 0.0, "round": 0.0, "sign": 0.0,
            "fmod": 0.0}


def _bank_ocp(bank, device, dtype=torch.float32):
    def F(x, u, p):
        out = []
        for i, name in enumerate(bank):
            fn = getattr(torch, name)
            out.append(fn(x[i], u[0]) if name in ("pow", "fmod", "remainder")
                       else fn(x[i]))
        return torch.stack(out)

    return mt.OCP(dynamics=F, stage_cost=lambda x, u, p: u[0] * u[0], N=1,
                  nx=4, nu=1, npar=0, device=torch.device(device),
                  dtype=dtype)


def _traced_programs():
    """The programs of the OCPs these tests run from their callables, traced
    on the CPU (the text, and so the library, is the card's)."""
    import chip_smoke as cs
    from chip_smoke import TERM_BOX
    from mpc_verde_tpu_torch.interop import derived_ocps
    from mpc_verde_tpu_torch.ops.cuda.trace import trace_ocp

    bare = lambda **kw: dataclasses.replace(bench_ocp(40, "cpu", **kw),
                                            device_model=None)
    rate = cs.traced_ocps("cpu")
    ocps = [bare(), bare(box=False),
            *(cs.user_ocp(name, "cpu") for name in cs.USER_OCPS),
            *derived_ocps(bare(x_lb=TERM_BOX[0], x_ub=TERM_BOX[1])).values(),
            *(rate[name] for name in ("lane_al", "rate_barrier", "obstacle",
                                      "ops")),
            *(_bank_ocp(bank, "cpu") for bank in MATH_BANKS),
            *cs.rate_form_ocps("cpu").values(),
            quadrotor_cell_ocp(40, "cpu")]
    return [trace_ocp(o) for o in ocps]


@pytest.fixture(scope="module")
def _libraries():
    """The kernels library, K1 at every size these tests launch and the
    traced programs' libraries, built once and together (one nvcc process a
    unit, all started at once)."""
    if torch.cuda.is_available():
        build_mod.build(CARD_K1_SIZES, _traced_programs())


@pytest.fixture
def dev(_libraries):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("variant", ["planned", "thread"])
@pytest.mark.parametrize("bounds", ["box", "none"])
@pytest.mark.parametrize("use_ddp", [True, False])
@pytest.mark.parametrize("nx,nu", sorted(HELD_SIZES))
def test_riccati_kernel_matches_twin(dev, nx, nu, use_ddp, bounds, variant):
    """B = 203 is not a multiple of either variant's block; half the
    problems have DDP off; with no bounds, dlb/dub are -inf/+inf and nothing
    may turn NaN.  The planned variant is "warps" up to nu = 3 and "thread"
    at nu = 4."""
    d, dlb, dub, gN, HN, reg, ddp = _random_riccati(
        np.random.default_rng(10 * nx + nu), 203, 6, nx, nu, dev)
    ddp[::2] = 0.0
    if bounds == "none":
        dlb, dub = torch.full_like(dlb, -torch.inf), torch.full_like(dub, torch.inf)
    args = (d, dlb, dub, gN, HN, reg, ddp)
    before = riccati_backward.launches
    by_variant = dict(riccati_backward.launches_by_variant)
    out = riccati_backward(*args, nx=nx, nu=nu, use_ddp=use_ddp,
                           variant=None if variant == "planned" else variant)
    torch.cuda.synchronize()
    assert riccati_backward.launches == before + 1
    expected = ("thread" if variant == "thread" or nu == 4 else "warps")
    assert riccati_launch_plan(6, nx, nu, use_ddp, 203).variant == (
        "thread" if nu == 4 else "warps")
    assert _launched(riccati_backward, by_variant) == {expected: 1}
    ref = riccati_backward_torch(*args, nx=nx, nu=nu, use_ddp=use_ddp)
    for (name, tol), o, r in zip(K1_TOL.items(), out, ref):
        assert bool(torch.isfinite(o).all()), name
        assert _rel_err(o, r) <= tol, (name, _rel_err(o, r))


@pytest.mark.parametrize("variant", ["planned", "warps"])
@pytest.mark.parametrize("bounds", ["box", "none"])
@pytest.mark.parametrize("use_ddp", [True, False])
def test_riccati_kernel_at_8x4_matches_float64_twin(dev, use_ddp, bounds,
                                                    variant):
    """K1 at (8, 4) (planned "thread", and "warps" forced), as the test
    above makes its inputs, held to the float64 twin as chip_smoke.py holds
    the linear cases (_hold_f64): within the larger of K1_TOL and
    F32_MARGIN times the float32 twin's own distance from float64.  At
    nx = 8 the float32 twin and the kernel part by more than K1_TOL where
    no bound is active (kff 4.0e-4 relative on this input with DDP, on an
    NVIDIA H100 80GB HBM3)."""
    from chip_smoke import _hold_f64

    d, dlb, dub, gN, HN, reg, ddp = _random_riccati(
        np.random.default_rng(84), 203, 6, 8, 4, dev)
    ddp[::2] = 0.0
    if bounds == "none":
        dlb, dub = torch.full_like(dlb, -torch.inf), torch.full_like(dub, torch.inf)
    args = (d, dlb, dub, gN, HN, reg, ddp)
    kw = dict(nx=8, nu=4, use_ddp=use_ddp)
    by_variant = dict(riccati_backward.launches_by_variant)
    out = riccati_backward(*args, variant=None if variant == "planned"
                           else variant, **kw)
    torch.cuda.synchronize()
    assert _launched(riccati_backward, by_variant) == {
        "thread" if variant == "planned" else "warps": 1}
    ref = riccati_backward_torch(*args, **kw)
    f64 = lambda t: t.double()
    ref64 = riccati_backward_torch({k: f64(v) for k, v in d.items()},
                                   *(f64(a) for a in args[1:]), **kw)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    _hold_f64(out, ref, ref64, "k1", f"(8, 4) DDP={use_ddp} {bounds} {variant}")


def _ocp_variant(variant, N, dev):
    """The bench OCP, or one of the other device models the kernel takes."""
    ocp = bench_ocp(N, dev, torch.float32)
    model = ocp.device_model
    if variant == "terminal":
        Qf = np.diag(np.array([2.0, 10.0, 0.2], np.float32))
        Qt = torch.as_tensor(Qf, device=dev)
        return dataclasses.replace(
            ocp, terminal_cost=lambda x, p: (x - p[:3]) @ Qt @ (x - p[:3]),
            device_model=dataclasses.replace(model, Qf=Qf))
    if variant == "euler":
        return dataclasses.replace(
            ocp, dynamics=euler_step(unicycle.f, BENCH_DT),
            device_model=dataclasses.replace(model, integrator="euler"))
    if variant == "rk4_m3":
        return dataclasses.replace(
            ocp, dynamics=rk4_step(unicycle.f, BENCH_DT, M=3),
            device_model=dataclasses.replace(model, substeps=3))
    return ocp


def _launched(fn, before):
    """The variants `fn` launched since the counts `before`."""
    return {v: n - before[v] for v, n in fn.launches_by_variant.items()
            if n > before[v]}


@pytest.mark.parametrize("variant", ["bench", "preroll", "terminal", "euler",
                                     "rk4_m3", "a5", "ties", "ragged_B",
                                     "fleet", "long_N_thread"])
def test_linesearch_kernel_matches_twin(dev, variant):
    """B = 300 leaves the last block ragged (8 problems a block), B = 301
    also the last warp; "a5" has an alpha count that is no power of two;
    on "ties" (zero gains) every cost ties and alpha 0 must win; the
    pre-roll (one alpha) takes the ring, which has no slots; "fleet" is
    the shape the closed-loop fleet gives the kernel, on the fleet's own OCP
    with the solver's default alphas (B = 1024, N = 10, A = 12: groups of 16
    lanes, 4 of them idle, 4 problems a block); N = 3700
    is past what shared memory holds for a whole horizon, so the plan takes
    the ring, whose shared memory does not grow with N (zero feedback there:
    3700 steps of a clipped feedback loop amplify float32 round-off past any
    tolerance)."""
    B, N, A = 300, 12, 8
    if variant == "ragged_B":
        B = 301
    elif variant == "long_N_thread":
        B, N = 20, 3700
    elif variant == "a5":
        A = 5
    ocp = _ocp_variant(variant, N, dev)
    alphas = tuple(0.4 ** i for i in range(A))
    if variant == "fleet":
        fleet, o = build_fleet(n_steps=1, device=dev), mt.ILQROptions()
        ocp, B, N = fleet["ocp"], fleet["spec"]["B"], fleet["spec"]["N"]
        alphas = tuple(float(o.alpha_decay) ** i for i in range(o.n_alphas))
        assert (B, N, len(alphas)) == (1024, 10, 12)
        assert linesearch_launch_plan(N, 12, 3)[:3] == ("lanes", 4, 64)
    x0, xs, us, ps, kffs, Ks = _k2_inputs(dev, B, N, seed=5)
    if variant in ("preroll", "ties"):
        kffs, Ks = torch.zeros_like(kffs), torch.zeros_like(Ks)
    if variant == "preroll":
        alphas = (1.0,)
    if variant == "long_N_thread":
        Ks = torch.zeros_like(Ks)
    args = (x0, xs, us, ps, kffs, Ks, alphas)
    before = linesearch_forward.launches
    by_variant = dict(linesearch_forward.launches_by_variant)
    xs_k, us_k, c_k, b_k = linesearch_forward(*args, ocp=ocp)
    torch.cuda.synchronize()
    assert linesearch_forward.launches == before + 1
    expected = {"long_N_thread": "lanes_ring",
                "preroll": "lanes_ring"}.get(variant, "lanes")
    assert linesearch_launch_plan(N, len(alphas), 3).variant == expected
    assert _launched(linesearch_forward, by_variant) == {expected: 1}
    xs_t, us_t, c_t, b_t = linesearch_forward_torch(*args, ocp=ocp)
    # the winner's cost is the minimum over alphas, so it agrees even where
    # a near-tie picks another alpha; trajectories are compared where the
    # chosen alpha is the same
    assert float(((c_k - c_t).abs() / c_t.abs()).max()) <= 1e-5
    same = b_k == b_t
    assert float(same.float().mean()) >= 0.99
    assert _rel_err(xs_k[same], xs_t[same]) <= 1e-4
    assert _rel_err(us_k[same], us_t[same]) <= 1e-4
    if variant in ("preroll", "ties"):
        assert int(b_k.abs().max()) == 0


# the ring's models and their (nx, nu, npar) as _ring_case builds them
RING_SIZES = {"unicycle": (3, 2, 3), "barrier": (3, 2, 4),
              "barrier_batched": (3, 2, 4), "al": (3, 2, 10),
              "quadrature": (3, 2, 3), "quadrotor": (6, 2, 6)}
RING_MODELS = tuple(RING_SIZES)


def _lanes_fit(model, N, A):
    """Whether a block of "lanes" holds one problem of ``model``."""
    nx, nu, npar = RING_SIZES[model]
    try:
        linesearch_launch_plan(N, A, npar, "lanes", nx=nx, nu=nu)
        return True
    except ValueError:
        return False


# where "lanes" holds a problem: past that (N = 600 at 12 or 32 alphas) the
# ring alone runs, held to the twin by test_linesearch_kernel_matches_twin
RING_CASES = [case for case in (
    [(m, 1000, N, A) for m in RING_MODELS for N in (10, 40, 600)
     for A in (1, 3, 8, 12, 32)]
    + [(m, 131071, N, A) for m in ("unicycle", "quadrotor")
       for N in (10, 40, 600) for A in (1, 8)]
    + [(m, 131071, 40, 8) for m in RING_MODELS[1:5]])
    if _lanes_fit(case[0], case[2], case[3])]


def _ring_case(dev, model, B, N, A):
    """(OCP, K2's inputs) of ``model``: the bench unicycle on its
    hand-written model, with the interior point's barrier (either rule, mu
    0.01), the state box's AL penalty, or the diff-drive's RK4 quadrature
    cost (4 substeps); or the benchmark's planar quadrotor on its traced
    model.  Random nominal trajectories and gains, no feedback past N =
    100 (a long clipped loop amplifies round-off past float32)."""
    from chip_smoke import TERM_BOX
    from mpc_verde_tpu_torch.interop import derived_ocps, derived_params
    from mpc_verde_tpu_torch.scenarios.diffdrive import diffdrive_ocp

    kind = "quadrotor" if model == "quadrotor" else "unicycle"
    x0, xs, us, ps, kff, K, _ = _width_args(dev, kind, B, N, A)
    if N > 100:
        K = torch.zeros_like(K)
    if model == "quadrotor":
        return quadrotor_cell_ocp(N, dev), (x0, xs, us, ps, kff, K)
    if model == "quadrature":
        ocp = diffdrive_ocp(N, dev, integrator="rk4", cost="quadrature", M=4)
    elif model == "unicycle":
        ocp = bench_ocp(N, dev)
    else:
        ocp = derived_ocps(bench_ocp(N, dev, torch.float32, x_lb=TERM_BOX[0],
                                     x_ub=TERM_BOX[1]))[model]
        g = torch.Generator(device=dev).manual_seed(14)
        lam = 2 * torch.rand((B, N + 1, 6), generator=g, device=dev)
        ps = derived_params(model, ps, mu=1e-2, lam=lam,
                            mu_al=torch.full((B,), 100.0, device=dev))
    return ocp, (x0, xs, us, ps.contiguous(), kff, K)


@pytest.mark.parametrize("model,B,N,A", RING_CASES)
def test_ring_matches_lanes_bit_for_bit(dev, model, B, N, A):
    """"lanes_ring" streams its rows through a ring and its winners roll
    again; it runs the same stage function and shuffle as "lanes", so its
    cost, alpha index, states and controls are those of "lanes" bit for
    bit, on ragged batches, horizons up to what a whole-horizon block holds,
    alpha counts that are no power of two and the pre-roll.  The barrier
    prices candidates +inf (streaming) or NaN (batched) outside its box:
    they lose alike (``test_linesearch_kernel_on_barrier_and_al_terms``
    holds both variants to that rule).  With zero gains every cost ties and
    alpha 0 wins."""
    ocp, data = _ring_case(dev, model, B, N, A)
    assert data[0].shape[-1:] + data[2].shape[-1:] + data[3].shape[-1:] == (
        RING_SIZES[model])
    alphas = tuple(0.4 ** i for i in range(A))
    zero = (*data[:4], torch.zeros_like(data[4]), torch.zeros_like(data[5]))
    for inputs in ((data, zero) if B == 1000 and A > 1 else (data,)):
        by_variant = dict(linesearch_forward.launches_by_variant)
        ring = linesearch_forward(*inputs, alphas, ocp=ocp,
                                  variant="lanes_ring")
        ref = linesearch_forward(*inputs, alphas, ocp=ocp, variant="lanes")
        torch.cuda.synchronize()
        assert _launched(linesearch_forward, by_variant) == {"lanes_ring": 1,
                                                             "lanes": 1}
        for name, a, b in zip(("xs", "us", "cost", "best"), ring, ref):
            assert _same_bits(a, b), name
        if inputs is zero:
            assert int(ring[3].abs().max()) == 0


@pytest.mark.parametrize("kernel", ["linesearch", "linesearch_reroll", "fused",
                                    "fused_gauss_newton", "riccati",
                                    "riccati_gauss_newton", "riccati_4x3",
                                    "riccati_5x4_forced_warps",
                                    "riccati_8x4_forced_warps"])
def test_forced_thread_variant_agrees_with_the_planned_one(dev, kernel):
    """Every variant runs the same device functions per candidate and per
    stage, so a forced variant gives the planned one's results (to float32
    round-off, should the compiler contract them differently).  K1 at
    (5, 4) and (8, 4) is planned "thread", so there "warps" is the forced
    one.  K2 has no "thread" variant: its line search (planned "lanes") is
    held against the ring, and its pre-roll (planned the ring) against
    "lanes"."""
    B, N = 301, 12
    if kernel.startswith("riccati"):
        nx, nu = {"riccati_4x3": (4, 3),
                  "riccati_5x4_forced_warps": (5, 4),
                  "riccati_8x4_forced_warps": (8, 4)}.get(kernel, (3, 2))
        kw = dict(nx=nx, nu=nu, use_ddp=kernel != "riccati_gauss_newton")
        args = _random_riccati(np.random.default_rng(4), B, N, nx, nu, dev)
        other = "warps" if nu == 4 else "thread"
        by_variant = dict(riccati_backward.launches_by_variant)
        planned = riccati_backward(*args, **kw)
        forced = riccati_backward(*args, variant=other, **kw)
        assert _launched(riccati_backward, by_variant) == {"warps": 1,
                                                           "thread": 1}
        if nu <= 2:   # the same compiled arithmetic: the same floats
            assert all(bool((o == r).all()) for o, r in zip(planned, forced))
    elif kernel.startswith("linesearch"):
        ocp = _ocp_variant("terminal", N, dev)
        preroll = kernel == "linesearch_reroll"
        x0, xs, us, ps, kff, K = _k2_inputs(dev, B, N, seed=5)
        if preroll:
            kff, K = torch.zeros_like(kff), torch.zeros_like(K)
        args = (x0, xs, us, ps, kff, K,
                (1.0,) if preroll else tuple(0.4 ** i for i in range(8)))
        other = "lanes" if preroll else "lanes_ring"
        by_variant = dict(linesearch_forward.launches_by_variant)
        planned = linesearch_forward(*args, ocp=ocp)
        forced = linesearch_forward(*args, ocp=ocp, variant=other)
        assert _launched(linesearch_forward, by_variant) == {"lanes": 1,
                                                             "lanes_ring": 1}
        assert float((planned[3] == forced[3]).float().mean()) >= 0.999
    else:
        ocp = _fused_ocp("terminal", N, dev)
        kw = dict(ocp=ocp, use_ddp=kernel == "fused")
        args = _fused_inputs(dev, B, N)
        by_variant = dict(fused_backward.launches_by_variant)
        planned = fused_backward(*args, **kw)
        forced = fused_backward(*args, variant="thread", **kw)
        assert _launched(fused_backward, by_variant) == {"staged": 1, "thread": 1}
    torch.cuda.synchronize()
    for o, r in zip(planned[:3] if kernel.startswith("linesearch") else planned,
                    forced):
        assert _rel_err(o, r) <= 1e-5


def test_riccati_stage_clocks_times_the_warps_kernel(dev):
    """The timing instantiation reports positive cycles for every block and
    part, and is not counted as a launch of the solvers' kernel."""
    B, N = 301, 12
    args = _random_riccati(np.random.default_rng(5), B, N, 3, 2, dev)
    before = riccati_backward.launches
    clocks = riccati_stage_clocks(*args)
    torch.cuda.synchronize()
    blocks = -(-B // riccati_launch_plan(N, 3, 2, True, B, "warps").problems)
    assert tuple(clocks.shape) == (blocks, len(CLOCK_PARTS))
    assert clocks.dtype == torch.int64 and int(clocks.min()) > 0
    assert riccati_backward.launches == before


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    d, dlb, dub, gN, HN, reg, ddp = _random_riccati(
        np.random.default_rng(0), 8, 4, 3, 2, dev)
    k1_before, k2_before = riccati_backward.launches, linesearch_forward.launches
    with pytest.raises(TypeError, match="float32"):
        riccati_backward({**d, "fx": d["fx"].double()}, dlb, dub, gN, HN, reg,
                         ddp, nx=3, nu=2)
    with pytest.raises(ValueError, match="contiguous"):
        riccati_backward({**d, "fx": d["fx"].transpose(-1, -2)}, dlb, dub, gN,
                         HN, reg, ddp, nx=3, nu=2)
    with pytest.raises(ValueError, match="on cpu"):
        riccati_backward(d, dlb.cpu(), dub, gN, HN, reg, ddp, nx=3, nu=2)
    with pytest.raises(NotImplementedError):
        riccati_backward(d, dlb, dub, gN, HN, reg, ddp, nx=3, nu=5)
    with pytest.raises(ValueError, match="shape"):
        riccati_backward(d, dlb, dub, gN, HN, reg, ddp, nx=4, nu=2)
    with pytest.raises(ValueError, match="unknown"):
        riccati_backward(d, dlb, dub, gN, HN, reg, ddp, nx=3, nu=2,
                         variant="lanes")
    ocp = bench_ocp(4, dev, torch.float32)
    z = lambda *s: torch.zeros(s, device=dev)
    with pytest.raises(ValueError, match="shape"):
        linesearch_forward(z(8, 3), z(8, 4, 3), z(8, 4, 2), z(8, 5, 3),
                           z(8, 4, 2), z(8, 4, 2, 3), (1.0,), ocp=ocp)
    # without a device model the callables are traced, and one outside the
    # lowering table raises before any launch
    atan2 = dataclasses.replace(ocp, device_model=None, stage_cost=lambda x, u,
                                p: torch.atan2(x[1], x[0]))
    with pytest.raises(NotImplementedError, match="stage_cost.*atan2"):
        linesearch_forward(z(8, 3), z(8, 5, 3), z(8, 4, 2), z(8, 5, 3),
                           z(8, 4, 2), z(8, 4, 2, 3), (1.0,), ocp=atan2)
    assert riccati_backward.launches == k1_before
    assert linesearch_forward.launches == k2_before


def test_streaming_cuda_matches_torch_float64(dev):
    """The "cuda" backend in float32 against the "torch" backend in float64
    on the card, over a small queue of the bench problem."""
    N, M, W = 20, 64, 16
    rng = np.random.default_rng(2)
    x0 = rng.uniform(-2.0, 2.0, (M, 3))
    target = np.array([10.0, 10.0, 0.0])
    opts = mt.ILQROptions(max_iters=60, tol_grad=1e-4, tol_cost=1e-6,
                          n_alphas=8, alpha_decay=0.4)
    solve = lambda backend, dtype: mt.make_streaming_solver(
        bench_ocp(N, dev, dtype), opts, backend=backend, batch_width=W,
        restarts=2)(x0, target)
    riccati_backward_torch.cuda_calls = 0
    linesearch_forward_torch.cuda_calls = 0
    k1, k2 = riccati_backward.launches, linesearch_forward.launches
    ck = solve("cuda", torch.float32)
    assert riccati_backward.launches > k1 and linesearch_forward.launches > k2
    assert riccati_backward_torch.cuda_calls == 0
    assert linesearch_forward_torch.cuda_calls == 0
    ct = solve("torch", torch.float64)
    assert float((ck.converged == ct.converged).float().mean()) >= 0.95
    both = ck.converged & ct.converged
    assert bool(both.any())
    rel = (ck.cost.double() - ct.cost).abs() / ct.cost.abs()
    assert float(rel[both].max()) <= 1e-3


def _fused_ocp(variant, N, dev):
    """The bench OCP, or with the terminal cost 2 e'Qe, or with no box."""
    if variant == "bench":
        return bench_ocp(N, dev, torch.float32)
    Q, R = np.diag([1.0, 5.0, 0.1]), np.diag([0.5, 0.05])
    if variant == "terminal":
        return unicycle_ocp(N, dev, dt=BENCH_DT, Q=Q, R=R, Qf=2.0 * Q,
                            lb=[-1.0, -np.pi / 4], ub=[1.0, np.pi / 4])
    return unicycle_ocp(N, dev, dt=BENCH_DT, Q=Q, R=R)


def _fused_inputs(dev, B, N, reg=1e-3, seed=6, spread=1.0):
    """Rolled-out trajectories of random controls (within 0.5 * spread) from
    random starts, each with a target within spread of its start, half the
    problems on Gauss-Newton."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    x0 = rng.uniform(-2, 2, (B, 3))
    target = x0 + spread * rng.uniform(-1, 1, (B, 3))
    ps = t(np.broadcast_to(target[:, None], (B, N + 1, 3)).copy())
    xs, us, _, _ = linesearch_forward_torch(
        t(x0), t(np.zeros((B, N + 1, 3))),
        t(spread * rng.uniform(-0.5, 0.5, (B, N, 2))), ps, t(np.zeros((B, N, 2))),
        t(np.zeros((B, N, 2, 3))), (1.0,), ocp=bench_ocp(N, dev))
    ddp = np.ones(B)
    ddp[::2] = 0.0
    return xs, us, ps, t(np.full(B, reg)), t(ddp)


@pytest.mark.parametrize("variant", ["bench", "terminal", "unbounded", "n10",
                                     "ragged_B", "long_N_thread",
                                     "wide_B_thread"])
@pytest.mark.parametrize("use_ddp", [True, False])
def test_fused_kernel_matches_twin(dev, variant, use_ddp):
    """B = 300 is not a multiple of the block (8 problems), B = 301 not of
    anything; N = 10 is the fleet's horizon; N = 640 with DDP and N = 1300
    without are past what shared memory holds, so the plan takes the one
    thread per problem kernel, as it does for B = 8200, whose blocks would
    take more than two waves.  With no box, dlb/dub are -inf/+inf and
    nothing may turn NaN.

    With DDP on, the curvature Vx . d2F/dv domega (about 0.02 |Vx|) makes Quu
    indefinite on these trajectories.  A box keeps the stage QP bounded; an
    unbounded Newton step on a near-singular Quu amplifies float32 round-off
    past any tolerance, so the unbounded case runs at reg = 10, a value the
    solver's x100 escalation reaches, which keeps Quu positive definite.
    Over a long horizon the value gradient Vx sums hundreds of stages, and
    float32 round-off in kff grows with it (9e-4 at N = 640 with targets
    within 1): the long cases keep targets and controls within 0.02 of the
    start and run at reg = 10 as well.
    """
    B, N = {"n10": (300, 10), "ragged_B": (301, 12), "wide_B_thread": (8200, 12),
            "long_N_thread": (4, 640 if use_ddp else 1300)}.get(variant, (300, 12))
    ocp = _fused_ocp(variant if variant in ("terminal", "unbounded")
                     else "bench", N, dev)
    args = _fused_inputs(
        dev, B, N, reg=10.0 if variant in ("unbounded", "long_N_thread") else 1e-3,
        spread=0.02 if variant == "long_N_thread" else 1.0)
    before = fused_backward.launches
    by_variant = dict(fused_backward.launches_by_variant)
    out = fused_backward(*args, ocp=ocp, use_ddp=use_ddp)
    torch.cuda.synchronize()
    assert fused_backward.launches == before + 1
    expected = "thread" if variant.endswith("_thread") else "staged"
    assert fused_launch_plan(N, use_ddp, None, B).variant == expected
    assert _launched(fused_backward, by_variant) == {expected: 1}
    ref = fused_backward_torch(*args, ocp=ocp, use_ddp=use_ddp)
    for (name, tol), o, r in zip(K1_TOL.items(), out, ref):
        assert bool(torch.isfinite(o).all()), name
        assert _rel_err(o, r) <= tol, (name, _rel_err(o, r))


def test_fused_phase_clocks_times_the_staged_kernel(dev):
    """The timing instantiation reports positive cycles for every block and
    phase, and is not counted as a launch of the solvers' kernel."""
    B, N = 301, 12
    args = _fused_inputs(dev, B, N)
    before = fused_backward.launches
    clocks = fused_phase_clocks(*args, ocp=bench_ocp(N, dev, torch.float32))
    torch.cuda.synchronize()
    blocks = -(-B // fused_launch_plan(N, True).problems)
    assert tuple(clocks.shape) == (blocks, 3) and clocks.dtype == torch.int64
    assert int(clocks.min()) > 0
    assert fused_backward.launches == before


def test_fused_wrapper_refuses_what_the_kernel_does_not_take(dev):
    ocp = bench_ocp(4, dev)
    xs, us, ps, reg, ddp = _fused_inputs(dev, 8, 4)
    before = fused_backward.launches
    with pytest.raises(TypeError, match="float32"):
        fused_backward(xs.double(), us, ps, reg, ddp, ocp=ocp)
    strided = torch.zeros((8, 5, 6), device=dev)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fused_backward(strided, us, ps, reg, ddp, ocp=ocp)
    with pytest.raises(ValueError, match="shape"):
        fused_backward(xs, us, ps, reg[:4], ddp, ocp=ocp)
    atan2 = dataclasses.replace(ocp, device_model=None, stage_cost=lambda x, u,
                                p: torch.atan2(x[1], x[0]))
    with pytest.raises(NotImplementedError, match="stage_cost.*atan2"):
        fused_backward(xs, us, ps, reg, ddp, ocp=atan2)
    assert fused_backward.launches == before


def test_batched_cuda_fused_matches_cuda(dev):
    """One batched solve on "cuda_fused" against "cuda": the two float32
    paths differ only in where the stage derivatives come from."""
    N, B = 20, 64
    x0 = np.random.default_rng(3).uniform(-2.0, 2.0, (B, 3))
    target = np.array([10.0, 10.0, 0.0])
    opts = mt.ILQROptions(max_iters=60, tol_grad=1e-4, tol_cost=1e-6,
                          n_alphas=8, alpha_decay=0.4)
    ocp = bench_ocp(N, dev, torch.float32)
    fused_backward_torch.cuda_calls = 0
    riccati_backward_torch.cuda_calls = 0
    linesearch_forward_torch.cuda_calls = 0
    k1, k2, k3 = (riccati_backward.launches, linesearch_forward.launches,
                  fused_backward.launches)
    rf = mt.make_batched_ilqr_solver(ocp, opts, backend="cuda_fused")(x0, target)
    assert fused_backward.launches > k3 and linesearch_forward.launches > k2
    assert riccati_backward.launches == k1
    assert fused_backward_torch.cuda_calls == 0
    assert riccati_backward_torch.cuda_calls == 0
    assert linesearch_forward_torch.cuda_calls == 0
    rc = mt.make_batched_ilqr_solver(ocp, opts, backend="cuda")(x0, target)
    assert float((rf.converged == rc.converged).float().mean()) >= 0.95
    both = rf.converged & rc.converged
    assert float(both.float().mean()) >= 0.9
    rel = (rf.cost - rc.cost).abs() / rc.cost.abs()
    assert float(rel[both].max()) <= 1e-3


# chip_smoke.py phase 10's cases: the streaming barrier (npar 4) at three mu,
# the batched barrier without a clip box, AL (npar 10), barrier + AL (11)
TERM_CASES = ["barrier mu=0.01", "barrier mu=0.0001", "barrier mu=0",
              "barrier_batched mu=0.01", "al", "barrier_al mu=0.01"]


def _term_case(dev, label, B=300, N=12):
    inputs = _term_inputs(dev, B, N)
    for name, ocp, ps in _term_cases(dev, N, inputs):
        if name == label:
            return inputs, ocp, ps
    raise KeyError(label)


@pytest.mark.parametrize("variant", LINESEARCH_VARIANTS)
@pytest.mark.parametrize("case", TERM_CASES)
def test_linesearch_kernel_on_barrier_and_al_terms(dev, case, variant):
    """Each variant against the twin's candidates under the kernel's winner
    rule (a +inf or NaN candidate loses to every finite one), at the
    tolerances of chip_smoke.py phase 4; B = 300 leaves a block ragged."""
    inputs, ocp, ps = _term_case(dev, case)
    data = (*inputs[:3], ps, *inputs[4:6])
    alphas = tuple(0.4 ** i for i in range(8))
    best, xs_r, us_r, c_r, nonfinite = _k2_kernel_rule(data, alphas, ocp)
    by_variant = dict(linesearch_forward.launches_by_variant)
    xs_k, us_k, c_k, b_k = linesearch_forward(*data, alphas, ocp=ocp,
                                              variant=variant)
    torch.cuda.synchronize()
    assert _launched(linesearch_forward, by_variant) == {variant: 1}
    if case.startswith("barrier") and case != "barrier mu=0":
        assert nonfinite > 0   # some candidate leaves or touches the box
    same = b_k == best
    assert float(same.float().mean()) >= 0.99
    fin = same & torch.isfinite(c_r)
    assert float(((c_k - c_r).abs() / c_r.abs())[fin].max()) <= 1e-5
    assert not torch.isfinite(c_k[same & ~torch.isfinite(c_r)]).any()
    assert _rel_err(xs_k[same], xs_r[same]) <= 1e-4
    assert _rel_err(us_k[same], us_r[same]) <= 1e-4


@pytest.mark.parametrize("variant", FUSED_VARIANTS)
@pytest.mark.parametrize("case,use_ddp", [
    (case, use_ddp) for case in TERM_CASES for use_ddp in (True, False)
    if not (case.startswith("barrier_batched") and use_ddp)])
def test_fused_kernel_on_barrier_and_al_terms(dev, case, use_ddp, variant):
    """Each variant against the twin at the Riccati tolerances, finite
    everywhere; on the AL cases the terminal penalty is active.  The batched
    barrier (no clip box) runs Gauss-Newton only, as chip_smoke.py phase 10
    says why: with DDP its Quu is indefinite on these trajectories."""
    inputs, ocp, ps = _term_case(dev, case)
    xs, us = inputs[1], inputs[2]
    B = xs.shape[0]
    args = (xs, us, ps, torch.full((B,), 1e-6, device=dev),
            torch.ones((B,), device=dev))
    if case.startswith(("al", "barrier_al")):
        gN, _ = ocp.device_model.terminal_grad_hess(xs[:, -1], ps[:, -1])
        assert bool((gN != 0).any())
    by_variant = dict(fused_backward.launches_by_variant)
    out = fused_backward(*args, ocp=ocp, use_ddp=use_ddp, variant=variant)
    torch.cuda.synchronize()
    assert _launched(fused_backward, by_variant) == {variant: 1}
    ref = fused_backward_torch(*args, ocp=ocp, use_ddp=use_ddp)
    for (name, tol), o, r in zip(K1_TOL.items(), out, ref):
        assert bool(torch.isfinite(o).all()), name
        assert _rel_err(o, r) <= tol, (name, _rel_err(o, r))


def test_wrappers_refuse_params_the_model_reads_past(dev):
    """A derived model reads columns past the base params: the wrappers
    refuse params without them rather than read out of bounds."""
    inputs, ocp, ps = _term_case(dev, "barrier_al mu=0.01", B=8)
    short = ps[..., :10].contiguous()
    with pytest.raises(ValueError, match="npar>=11"):
        linesearch_forward(*inputs[:3], short, *inputs[4:6], (1.0, 0.5),
                           ocp=ocp)
    with pytest.raises(ValueError, match="npar>=11"):
        fused_backward(inputs[1], inputs[2], short,
                       torch.ones((8,), device=dev), ocp=ocp)


@pytest.mark.parametrize("path", ["ipm", "al"])
def test_ipm_and_al_cuda_fused_match_torch_float64(dev, path):
    """The streaming barrier solver and the streaming AL solver on
    "cuda_fused" in float32 against "torch" in float64 on the card."""
    N, M, W = 20, 48, 16
    x0 = np.random.default_rng(4).uniform(-2.0, 2.0, (M, 3))
    target = np.array([10.0, 10.0, 0.0])
    opts = mt.ILQROptions(max_iters=60, tol_grad=1e-4, tol_cost=1e-6,
                          n_alphas=8, alpha_decay=0.4, al_iters=5)
    box = dict(x_ub=[np.inf, 3.0, np.inf]) if path == "al" else {}
    make = (mt.make_streaming_barrier_solver if path == "ipm"
            else mt.make_streaming_solver)
    solve = lambda backend, dtype: make(
        bench_ocp(N, dev, dtype, **box), opts, backend=backend,
        batch_width=W, restarts=2)(x0, target)
    fused_backward_torch.cuda_calls = 0
    linesearch_forward_torch.cuda_calls = 0
    k2, k3 = linesearch_forward.launches, fused_backward.launches
    rk = solve("cuda_fused", torch.float32)
    assert fused_backward.launches > k3 and linesearch_forward.launches > k2
    assert fused_backward_torch.cuda_calls == 0
    assert linesearch_forward_torch.cuda_calls == 0
    rt = solve("torch", torch.float64)
    assert float((rk.converged == rt.converged).float().mean()) >= 0.95
    both = rk.converged & rt.converged
    assert float(both.float().mean()) >= 0.9
    rel = (rk.cost.double() - rt.cost).abs() / rt.cost.abs()
    assert float(rel[both].max()) <= 1e-3
    if path == "al":   # five rounds: with three the float64 solve leaves 0.13
        assert float(rk.max_violation.max()) < 1e-2


# chip_smoke.py phase 10's cases of the circular-track and diff-drive
# families: the control reference (npar 5), the circular track's derived AL
# OCP (npar 12), the quadrature cost at M = 1 and 4 under RK4 and Euler
NEW_TERM_CASES = ["u_ref", "circular_al", "quadrature M=1 rk4",
                  "quadrature M=4 rk4", "quadrature M=1 euler",
                  "quadrature M=4 euler"]


@pytest.mark.parametrize("B", [1, 8, 301])
@pytest.mark.parametrize("case", NEW_TERM_CASES)
def test_linesearch_kernel_on_new_terms(dev, case, B):
    """The planned variant against the twin at chip_smoke.py phase 4's
    tolerances; B = 1 is one problem in a block of eight, B = 301 leaves the
    last block ragged."""
    inputs, ocp, ps = _term_case(dev, case, B=B)
    data = (*inputs[:3], ps, *inputs[4:6])
    alphas = tuple(0.4 ** i for i in range(8))
    best, xs_r, us_r, c_r, _ = _k2_kernel_rule(data, alphas, ocp)
    by_variant = dict(linesearch_forward.launches_by_variant)
    xs_k, us_k, c_k, b_k = linesearch_forward(*data, alphas, ocp=ocp)
    torch.cuda.synchronize()
    assert _launched(linesearch_forward, by_variant) == {"lanes": 1}
    # the winner's cost is the minimum over alphas, so it agrees even where
    # a near-tie picks another alpha; trajectories where the alpha is the same
    assert float(((c_k - c_r).abs() / c_r.abs()).max()) <= 1e-5
    same = b_k == best
    if B > 8:
        assert float(same.float().mean()) >= 0.99
    if bool(same.any()):
        assert _rel_err(xs_k[same], xs_r[same]) <= 1e-4
        assert _rel_err(us_k[same], us_r[same]) <= 1e-4


@pytest.mark.parametrize("use_ddp", [True, False])
@pytest.mark.parametrize("B", [1, 8, 301])
@pytest.mark.parametrize("case", NEW_TERM_CASES)
def test_fused_kernel_on_new_terms(dev, case, B, use_ddp):
    """The planned variant ("staged", also at B = 1) against the twin at the
    Riccati tolerances, finite everywhere."""
    inputs, ocp, ps = _term_case(dev, case, B=B)
    xs, us = inputs[1], inputs[2]
    args = (xs, us, ps, torch.full((B,), 1e-6, device=dev),
            torch.ones((B,), device=dev))
    by_variant = dict(fused_backward.launches_by_variant)
    out = fused_backward(*args, ocp=ocp, use_ddp=use_ddp)
    torch.cuda.synchronize()
    assert _launched(fused_backward, by_variant) == {"staged": 1}
    ref = fused_backward_torch(*args, ocp=ocp, use_ddp=use_ddp)
    for (name, tol), o, r in zip(K1_TOL.items(), out, ref):
        assert bool(torch.isfinite(o).all()), name
        assert _rel_err(o, r) <= tol, (name, _rel_err(o, r))


@pytest.mark.parametrize("backend", [None, "cuda"])
def test_ilqr_solver_at_b1_matches_twin(dev, backend):
    """make_ilqr_solver on the card: the default backend is "cuda_fused"
    (K3 and K2), "cuda" runs K1 and K2, each at B = 1; against the plain
    "torch" twin on the same float32 OCP."""
    N = 20
    ocp = bench_ocp(N, dev, torch.float32)
    opts = mt.ILQROptions(max_iters=60, tol_grad=1e-4, tol_cost=1e-6,
                          n_alphas=8, alpha_decay=0.4)
    x0, target = np.array([0.5, -1.0, 0.3]), np.array([10.0, 10.0, 0.0])
    counts = {f: f.launches for f in (riccati_backward, linesearch_forward,
                                      fused_backward)}
    for twin in (riccati_backward_torch, linesearch_forward_torch,
                 fused_backward_torch):
        twin.cuda_calls = 0
    rk = mt.make_ilqr_solver(ocp, opts, backend=backend)(x0, target)
    torch.cuda.synchronize()
    ran = {f.__name__ for f, n in counts.items() if f.launches > n}
    assert ran == ({"riccati_backward", "linesearch_forward"} if backend
                   else {"fused_backward", "linesearch_forward"})
    assert riccati_backward_torch.cuda_calls == 0
    assert fused_backward_torch.cuda_calls == 0
    assert linesearch_forward_torch.cuda_calls == 0
    rt = mt.make_ilqr_solver(ocp, opts, backend="torch")(x0, target)
    assert rk.xs.shape == (N + 1, 3) and bool(rk.converged) and bool(rt.converged)
    assert float((rk.cost - rt.cost).abs() / rt.cost.abs()) <= 1e-3


@pytest.mark.parametrize("scenario", ["circular", "diffdrive"])
def test_scenario_20_steps_on_the_card(dev, scenario):
    """20 closed-loop steps at B = 1 on the default device and backend
    ("cuda_fused"), against the float64 "torch" run on the CPU within
    chip_smoke.py's CIRC_STATE_TOL."""
    from chip_smoke import CIRC_STATE_TOL
    from mpc_verde_tpu_torch import scenarios as sc

    build, run = {"circular": (sc.build_circular_tracking,
                               sc.run_circular_tracking),
                  "diffdrive": (sc.build_diffdrive, sc.run_diffdrive)}[scenario]
    k2, k3 = linesearch_forward.launches, fused_backward.launches
    m = run(build(n_steps=20))
    assert fused_backward.launches > k3 and linesearch_forward.launches > k2
    assert m["result"].xs.is_cuda
    m64 = run(build(n_steps=20, device="cpu", dtype=torch.float64))
    dx = (m["result"].xs.double().cpu() - m64["result"].xs).abs().max()
    assert float(dx) <= CIRC_STATE_TOL


# ---- the linear rate-form families: phase 10's linear cases -----------------
# Held against the float64 twin within chip_smoke.py's bounds (_hold_k2_f64,
# _hold_f64: the larger of the unicycle's tolerance and F32_MARGIN times the
# float32 twin's own distance from float64; the pendulum's unstable plant
# over N = 50 grows float32 round-off past the unicycle's bounds).

def _linear(dev, label, B):
    from chip_smoke import _linear_case

    return _linear_case(dev, B, label, seed=37 + B)


LINEAR_LABELS = ["lti N=20 Ntu=3", "ltv", "dynamic", "pendulum",
                 "pendulum padded"]


@pytest.mark.parametrize("B", [1, 8, 301])
@pytest.mark.parametrize("label", LINEAR_LABELS)
def test_linesearch_kernel_on_the_linear_model(dev, label, B):
    """K2 on the linear rate-form families' traced models, every variant: the
    pick is a first minimum of the float64 twin's candidates, its cost and
    trajectory are that candidate's, the box follows the rolled u_prev, and
    the move-blocked stages' rates come out exactly 0 where u_prev lies
    inside the control box."""
    from chip_smoke import _hold_k2_f64, _k2_candidates, _to64

    ocp, ocp64, (x0, xs, us, kff, K), ps = _linear(dev, label, B)
    alphas = tuple(0.4 ** i for i in range(8))
    data = (x0, xs, us, ps, kff, K)
    cand32 = _k2_candidates(data, alphas, ocp)
    cand64 = _k2_candidates(_to64(*data), alphas, ocp64)
    for variant in LINESEARCH_VARIANTS:
        by_variant = dict(linesearch_forward.launches_by_variant)
        out = linesearch_forward(*data, alphas, ocp=ocp, variant=variant)
        torch.cuda.synchronize()
        assert _launched(linesearch_forward, by_variant) == {variant: 1}
        _hold_k2_f64(f"{label} B={B} {variant}", out, cand32, cand64, ocp)


@pytest.mark.parametrize("use_ddp", [True, False])
@pytest.mark.parametrize("B", [1, 8, 301])
@pytest.mark.parametrize("label", LINEAR_LABELS)
def test_fused_kernel_on_the_linear_model(dev, label, B, use_ddp):
    """K3 on the linear rate-form families' traced models, both variants,
    and K1 at the model's (nx, nu) on the twin's derivatives of the same
    trajectories (lo == hi on the blocked stages), each against the float64
    twin."""
    from chip_smoke import _hold_f64, _to64
    from mpc_verde_tpu_torch.ops.linearize import trajectory_derivatives

    ocp, ocp64, (_, xs, us, _, _), ps = _linear(dev, label, B)
    args = (xs, us, ps, torch.full((B,), 1e-6, device=dev),
            torch.ones((B,), device=dev))
    ref = fused_backward_torch(*args, ocp=ocp, use_ddp=use_ddp)
    ref64 = fused_backward_torch(*_to64(*args), ocp=ocp64, use_ddp=use_ddp)
    for variant in FUSED_VARIANTS:
        by_variant = dict(fused_backward.launches_by_variant)
        out = fused_backward(*args, ocp=ocp, use_ddp=use_ddp, variant=variant)
        torch.cuda.synchronize()
        assert _launched(fused_backward, by_variant) == {variant: 1}
        assert all(bool(torch.isfinite(o).all()) for o in out)
        _hold_f64(out, ref, ref64, "k3", f"{label} B={B} {variant}")
    kw = dict(nx=ocp.nx, nu=ocp.nu, use_ddp=use_ddp)
    d, gN, HN, dlb, dub = trajectory_derivatives(ocp, xs, us, ps, use_ddp)
    d64, gN64, HN64, dlb64, dub64 = trajectory_derivatives(
        ocp64, *_to64(xs, us, ps), use_ddp)
    rargs = (d, dlb.contiguous(), dub.contiguous(), gN, HN, *args[3:])
    ref1 = riccati_backward_torch(*rargs, **kw)
    ref1_64 = riccati_backward_torch(d64, dlb64, dub64, gN64, HN64,
                                     *_to64(*args[3:]), **kw)
    for variant in ("warps", "thread"):
        out = riccati_backward(*rargs, variant=variant, **kw)
        _hold_f64(out, ref1, ref1_64, "k1", f"{label} B={B} {variant}")


@pytest.mark.parametrize("backend", [None, "cuda"])
def test_move_blocking_pins_exactly_on_the_card(dev, backend):
    """The lane change's v1 plan (N 20, Ntu 3) at B = 1 and over 301
    problems: the rates after Ntu are exactly 0, the head moves; the plan
    agrees with the float32 twin's."""
    from mpc_verde_tpu_torch.scenarios import build_lane_change_lti

    built = build_lane_change_lti(N=20, Ntu=3, n_steps=300, backend=backend)
    ocp = built["ocp"]
    z0 = torch.zeros(4, device=dev)
    res = built["solve"](z0, built["params_seq"][150],
                         torch.zeros((ocp.N, ocp.nu), device=dev))
    assert float(res.us[3:].abs().max()) == 0.0
    assert float(res.us[:3].abs().max()) > 0.0
    twin = mt.make_ilqr_solver(ocp, mt.ILQROptions(max_iters=30),
                               backend="torch")(z0, built["params_seq"][150])
    assert float((res.us - twin.us).abs().max()) <= 1e-3
    solve_b = mt.make_batched_ilqr_solver(ocp, mt.ILQROptions(max_iters=30),
                                          backend=backend)
    rng = np.random.default_rng(42)
    z0s = torch.zeros((301, 4), device=dev)
    z0s[:, :3] = torch.as_tensor(rng.uniform(-0.5, 0.5, (301, 3)), device=dev)
    res_b = solve_b(z0s, built["params_seq"][rng.integers(0, 300, 301)], None)
    assert float(res_b.us[:, 3:].abs().max()) == 0.0
    assert bool(torch.isfinite(res_b.cost).all())


@pytest.mark.parametrize("family", ["lti", "pendulum"])
def test_linear_family_20_steps_on_the_card(dev, family):
    """20 closed-loop steps at B = 1 on the default device and backend
    ("cuda_fused"), against the float64 "torch" run on the CPU: the lane
    change from sample 110 of its course within chip_smoke.py's LC_STATE_TOL
    (absolute), the pendulum within PEND_STATE_TOL (relative to max(1,
    |x|))."""
    from chip_smoke import LC_START, LC_STATE_TOL, PEND_STATE_TOL
    from mpc_verde_tpu_torch import scenarios as sc
    from mpc_verde_tpu_torch.refgen import synthetic_lane_change

    if family == "lti":
        path = {k: np.asarray(v)[LC_START:]
                for k, v in synthetic_lane_change().items()}
        go = lambda **kw: sc.run_lane_change_lti(sc.build_lane_change_lti(
            path=path, n_steps=20, **kw))
    else:
        go = lambda **kw: sc.run_pendulum(sc.build_pendulum(n_steps=20, **kw))
    k2, k3 = linesearch_forward.launches, fused_backward.launches
    m = go()
    assert fused_backward.launches > k3 and linesearch_forward.launches > k2
    assert m["result"].xs.is_cuda
    m64 = go(device="cpu", dtype=torch.float64)
    x, x64 = m["result"].xs.double().cpu(), m64["result"].xs
    if family == "lti":
        assert float((x - x64).abs().max()) <= LC_STATE_TOL
    else:
        assert float(((x - x64).abs() / x64.abs().clamp(min=1.0)).max()) <= (
            PEND_STATE_TOL)


# The Frenet and curvature families' traced models (chip_smoke.py phase
# 10's path cases at B = 1 and 301), held to the float64 twin as the linear
# families are.
PATH_LABELS = ["frenet", "curvature"]


@pytest.mark.parametrize("B", [1, 301])
@pytest.mark.parametrize("label", PATH_LABELS)
def test_linesearch_kernel_on_the_path_models(dev, label, B):
    """K2 on the Frenet OCP and the curvature cost, every variant: the pick
    is a first minimum of the float64 twin's candidates, and its cost and
    trajectory are that candidate's."""
    from chip_smoke import _hold_k2_f64, _k2_candidates, _path_case, _to64

    ocp, ocp64, (x0, xs, us, kff, K), ps = _path_case(dev, B, label,
                                                      seed=53 + B)
    alphas = tuple(0.4 ** i for i in range(8))
    data = (x0, xs, us, ps, kff, K)
    cand32 = _k2_candidates(data, alphas, ocp)
    cand64 = _k2_candidates(_to64(*data), alphas, ocp64)
    for variant in LINESEARCH_VARIANTS:
        by_variant = dict(linesearch_forward.launches_by_variant)
        out = linesearch_forward(*data, alphas, ocp=ocp, variant=variant)
        torch.cuda.synchronize()
        assert _launched(linesearch_forward, by_variant) == {variant: 1}
        _hold_k2_f64(f"{label} B={B} {variant}", out, cand32, cand64, ocp)


@pytest.mark.parametrize("use_ddp", [True, False])
@pytest.mark.parametrize("B", [1, 301])
@pytest.mark.parametrize("label", PATH_LABELS)
def test_fused_kernel_on_the_path_models(dev, label, B, use_ddp):
    """K3 on the Frenet OCP and on the curvature cost, both variants, and
    K1 at the model's (nx, nu), (5, 2) and (4, 1), on the twin's derivatives
    of the same trajectories, each against the float64 twin."""
    from chip_smoke import _hold_f64, _path_case, _to64
    from mpc_verde_tpu_torch.ops.linearize import trajectory_derivatives

    ocp, ocp64, (_, xs, us, _, _), ps = _path_case(dev, B, label, seed=57 + B)
    args = (xs, us, ps, torch.full((B,), 1e-6, device=dev),
            torch.ones((B,), device=dev))
    ref = fused_backward_torch(*args, ocp=ocp, use_ddp=use_ddp)
    ref64 = fused_backward_torch(*_to64(*args), ocp=ocp64, use_ddp=use_ddp)
    for variant in FUSED_VARIANTS:
        by_variant = dict(fused_backward.launches_by_variant)
        out = fused_backward(*args, ocp=ocp, use_ddp=use_ddp, variant=variant)
        torch.cuda.synchronize()
        assert _launched(fused_backward, by_variant) == {variant: 1}
        assert all(bool(torch.isfinite(o).all()) for o in out)
        _hold_f64(out, ref, ref64, "k3", f"{label} B={B} {variant}")
    kw = dict(nx=ocp.nx, nu=ocp.nu, use_ddp=use_ddp)
    d, gN, HN, dlb, dub = trajectory_derivatives(ocp, xs, us, ps, use_ddp)
    d64, gN64, HN64, dlb64, dub64 = trajectory_derivatives(
        ocp64, *_to64(xs, us, ps), use_ddp)
    rargs = (d, dlb.contiguous(), dub.contiguous(), gN, HN, *args[3:])
    ref1 = riccati_backward_torch(*rargs, **kw)
    ref1_64 = riccati_backward_torch(d64, dlb64, dub64, gN64, HN64,
                                     *_to64(*args[3:]), **kw)
    for variant in ("warps", "thread"):
        out = riccati_backward(*rargs, variant=variant, **kw)
        _hold_f64(out, ref1, ref1_64, "k1", f"{label} B={B} {variant}")


@pytest.mark.parametrize("family", PATH_LABELS)
def test_path_family_20_steps_on_the_card(dev, family):
    """20 closed-loop steps at B = 1 on the default device and backend
    ("cuda_fused") from sample 110 of the lane change's course, against the
    float64 "torch" run on the CPU within chip_smoke.py's LC_STATE_TOL
    (absolute)."""
    from chip_smoke import LC_START, LC_STATE_TOL
    from mpc_verde_tpu_torch import scenarios as sc
    from mpc_verde_tpu_torch.refgen import synthetic_lane_change

    path = {k: np.asarray(v)[LC_START:]
            for k, v in synthetic_lane_change().items()}
    build, run = ((sc.build_frenet, sc.run_frenet) if family == "frenet"
                  else (sc.build_curvature_ltv, sc.run_curvature_ltv))
    go = lambda **kw: run(build(path=path, n_steps=20, **kw))
    k2, k3 = linesearch_forward.launches, fused_backward.launches
    m = go()
    assert fused_backward.launches > k3 and linesearch_forward.launches > k2
    assert m["result"].xs.is_cuda
    m64 = go(device="cpu", dtype=torch.float64)
    x, x64 = m["result"].xs.double().cpu(), m64["result"].xs
    assert float((x - x64).abs().max()) <= LC_STATE_TOL


def _kernels_ran(run):
    """Run ``run`` and return (its result, the kernels it launched); every
    twin's count of CUDA calls must stay 0."""
    counts = {f: f.launches for f in (riccati_backward, linesearch_forward,
                                      fused_backward)}
    for twin in (riccati_backward_torch, linesearch_forward_torch,
                 fused_backward_torch):
        twin.cuda_calls = 0
    out = run()
    torch.cuda.synchronize()
    assert max(t.cuda_calls for t in (riccati_backward_torch,
                                      linesearch_forward_torch,
                                      fused_backward_torch)) == 0
    return out, {f.__name__ for f, n in counts.items() if f.launches > n}


def test_scan_backend_runs_k2_and_matches_torch_float64(dev):
    """backend="scan" on the card: the associative-scan backward in plain
    PyTorch and K2's line search (no K1, no K3), on the bench OCP without
    its box, against the float64 "torch" solve on the CPU: converged alike,
    costs to 1e-3 relative (chip_smoke.py's float32 tolerance between
    paths)."""
    N, B = 16, 8
    opts = mt.ILQROptions(max_iters=60, tol_grad=1e-4, tol_cost=1e-6,
                          n_alphas=8, alpha_decay=0.4, use_ddp=False)
    rng = np.random.default_rng(18)
    x0 = rng.uniform(-1, 1, (B, 3))
    ps = np.broadcast_to(np.array([3.0, 3.0, 0.0]), (B, N + 1, 3)).copy()
    rs, ran = _kernels_ran(lambda: mt.make_batched_ilqr_solver(
        bench_ocp(N, dev, box=False), opts, backend="scan")(x0, ps))
    assert ran == {"linesearch_forward"}
    rt = mt.make_batched_ilqr_solver(
        bench_ocp(N, "cpu", torch.float64, box=False), opts,
        backend="torch")(x0, ps)
    assert bool(rs.converged.all()) and bool(rt.converged.all())
    assert float(((rs.cost.double().cpu() - rt.cost).abs()
                  / rt.cost.abs()).max()) <= 1e-3


def test_scan_backend_needs_a_device_model_on_the_card(dev):
    """"scan" on the card runs K2 on a device model: for an OCP given by its
    callables the one traced from them (the traced K2 alone launches, as
    the hand-written model's does), and a callable outside the lowering
    table raises NotImplementedError before any solve."""
    N, B = 16, 8
    opts = mt.ILQROptions(max_iters=60, tol_grad=1e-4, tol_cost=1e-6,
                          n_alphas=8, alpha_decay=0.4, use_ddp=False)
    ocp = bench_ocp(N, dev, box=False)
    bare = dataclasses.replace(ocp, device_model=None)
    rng = np.random.default_rng(18)
    x0 = rng.uniform(-1, 1, (B, 3))
    ps = np.broadcast_to(np.array([3.0, 3.0, 0.0]), (B, N + 1, 3)).copy()
    rs, ran = _kernels_ran(lambda: mt.make_batched_ilqr_solver(
        bare, opts, backend="scan")(x0, ps))
    assert ran == {"linesearch_forward"}
    rh = mt.make_batched_ilqr_solver(ocp, opts, backend="scan")(x0, ps)
    # the two models round alike but for the compiler's contractions:
    # costs to 1e-3 relative, as the test above holds "scan" to float64
    assert bool(rs.converged.all()) and bool(rh.converged.all())
    assert float(((rs.cost - rh.cost).abs() / rh.cost.abs()).max()) <= 1e-3
    atan2 = dataclasses.replace(bare, stage_cost=lambda x, u, p: torch.atan2(
        x[1], x[0]))
    with pytest.raises(NotImplementedError, match="stage_cost.*atan2"):
        mt.make_batched_ilqr_solver(atan2, opts, backend="scan")


def test_lqr_warm_start_runs_k1_and_k2(dev):
    """make_lqr_warm_start on the card: one K1 launch (infinite bounds, no
    DDP, gN = HN = 0) and one K2 launch (alpha 1, x_nom = xref, u_nom =
    uref); controls inside the box and within 1e-3 of the float64 twins on
    the CPU (chip_smoke.py phase 19's tolerance)."""
    from mpc_verde_tpu_torch.solver import make_lqr_warm_start

    N, B = 40, 301
    rng = np.random.default_rng(19)
    x0 = rng.uniform(-2, 2, (B, 3))
    ps = np.broadcast_to(np.array([10.0, 10.0, 0.0]), (B, N + 1, 3)).copy()
    k1, k2 = riccati_backward.launches, linesearch_forward.launches
    us, ran = _kernels_ran(lambda: make_lqr_warm_start(
        bench_ocp(N, dev), xref_fn=lambda p: p[:3])(x0, ps))
    assert ran == {"riccati_backward", "linesearch_forward"}
    assert (riccati_backward.launches - k1, linesearch_forward.launches - k2) \
        == (1, 1)
    box = torch.tensor([1.0, np.pi / 4], device=dev)
    assert bool((us.abs() <= box * (1 + 1e-6)).all())
    u64 = make_lqr_warm_start(bench_ocp(N, "cpu", torch.float64),
                              xref_fn=lambda p: p[:3])(x0, ps)
    assert float((us.double().cpu() - u64).abs().max()) <= 1e-3


@pytest.mark.parametrize("B", [5, 1000])
@pytest.mark.parametrize("N", [3, 20])
def test_kernels_on_the_sweep_weight_term(dev, N, B):
    """K2 (every variant) and K3 (DDP on and off, both variants) on the
    sweep's OCP, whose Q[0, 0] is p[4] (``q_param``), against the float64
    twin (chip_smoke.py phase 21 (a) at these shapes)."""
    from chip_smoke import (_hold_f64, _hold_k2_f64, _k2_candidates,
                            _sweep_case, _to64)

    ocp, ocp64, (x0, xs, us, kff, K), ps = _sweep_case(dev, B, N, seed=53 + N)
    assert ocp.device_model is None and ps.shape[-1] == 5
    alphas = tuple(0.4 ** i for i in range(8))
    data = (x0, xs, us, ps, kff, K)
    cand32 = _k2_candidates(data, alphas, ocp)
    cand64 = _k2_candidates(_to64(*data), alphas, ocp64)
    for variant in LINESEARCH_VARIANTS:
        by_variant = dict(linesearch_forward.launches_by_variant)
        out = linesearch_forward(*data, alphas, ocp=ocp, variant=variant)
        torch.cuda.synchronize()
        assert _launched(linesearch_forward, by_variant) == {variant: 1}
        _hold_k2_f64(f"sweep N={N} B={B} {variant}", out, cand32, cand64,
                     ocp)
    args = (xs, us, ps, torch.full((B,), 1e-6, device=dev),
            torch.ones((B,), device=dev))
    for use_ddp in (True, False):
        ref = fused_backward_torch(*args, ocp=ocp, use_ddp=use_ddp)
        ref64 = fused_backward_torch(*_to64(*args), ocp=ocp64, use_ddp=use_ddp)
        for variant in FUSED_VARIANTS:
            by_variant = dict(fused_backward.launches_by_variant)
            out = fused_backward(*args, ocp=ocp, use_ddp=use_ddp,
                                 variant=variant)
            torch.cuda.synchronize()
            assert _launched(fused_backward, by_variant) == {variant: 1}
            _hold_f64(out, ref, ref64, "k3",
                      f"sweep N={N} B={B} DDP={use_ddp} {variant}")


@pytest.mark.parametrize("backend", ["cuda_fused", "cuda"])
def test_sharded_solver_over_nccl_at_world_size_one(dev, tmp_path, backend):
    """make_sharded_solver at world size 1 over NCCL: the unsharded solve's
    results to the bit, the statistics its local reductions."""
    import torch.distributed as dist

    from mpc_verde_tpu_torch.parallel import (distributed_init, gather_result,
                                              make_sharded_solver)

    B, N = 256, 20
    rng = np.random.default_rng(29)
    x0 = torch.as_tensor(rng.uniform(-2, 2, (B, 3)), dtype=torch.float32,
                         device=dev)
    ps = torch.tensor([10.0, 10.0, 0.0], device=dev).expand(B, N + 1, 3)
    us = torch.zeros((B, N, 2), device=dev)
    solve = mt.make_batched_ilqr_solver(bench_ocp(N, dev), backend=backend)
    ref = solve(x0, ps, us)
    distributed_init(store=dist.FileStore(str(tmp_path / "store"), 1),
                     world_size=1, rank=0, backend="nccl")
    try:
        assert dist.get_backend() == "nccl"
        res, stats = make_sharded_solver(solve, batched=True)(x0, ps, us)
        full = gather_result(res)
    finally:
        dist.destroy_process_group()
    for f in ("xs", "us", "cost", "iterations", "converged", "grad_norm"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
        assert torch.equal(getattr(full, f), getattr(ref, f)), f
    assert int(stats.n_total) == B
    assert int(stats.n_converged) == int(ref.converged.sum())
    assert float(stats.mean_cost) == float(ref.cost.sum() / B)
    assert float(stats.max_grad_norm) == float(ref.grad_norm.max())
    assert int(stats.max_iterations) == int(ref.iterations.max())


def _bw_ran(run):
    """Run ``run`` on "cuda_bw": (its result, the kernels it launched); no
    twin of K1 or K3 may run on CUDA tensors (the line search's twin is the
    backend's own)."""
    counts = {f: f.launches for f in (riccati_backward, linesearch_forward,
                                      fused_backward)}
    riccati_backward_torch.cuda_calls = 0
    fused_backward_torch.cuda_calls = 0
    linesearch_forward_torch.cuda_calls = 0
    out = run()
    torch.cuda.synchronize()
    assert riccati_backward_torch.cuda_calls == 0
    assert fused_backward_torch.cuda_calls == 0
    assert linesearch_forward_torch.cuda_calls > 0
    return out, {f.__name__ for f, n in counts.items() if f.launches > n}


def _default_ran(run):
    """Run ``run`` on the default path: (its result, the kernels it
    launched); no twin runs on CUDA tensors, the plain line search
    included."""
    counts = {f: f.launches for f in (riccati_backward, linesearch_forward,
                                      fused_backward)}
    riccati_backward_torch.cuda_calls = 0
    fused_backward_torch.cuda_calls = 0
    linesearch_forward_torch.cuda_calls = 0
    out = run()
    torch.cuda.synchronize()
    assert riccati_backward_torch.cuda_calls == 0
    assert fused_backward_torch.cuda_calls == 0
    assert linesearch_forward_torch.cuda_calls == 0
    return out, {f.__name__ for f, n in counts.items() if f.launches > n}


def test_cuda_bw_on_the_bench_ocp_without_a_device_model(dev):
    """The bench OCP built from its callables: backend=None resolves to
    "cuda_fused" on the model traced from them and runs K3 and K2 and no
    plain line search; "cuda_bw", named, runs K1 and neither K2 nor K3.
    Each converges as "cuda" does on the same queue: converged agree >=
    0.99; where both converged, costs within 1e-3 relative on >= 0.99 of
    the starts, and both answers of every other start float64 optima
    (chip_smoke.py's _hold_optima: the two line searches can part at a near
    tie and end in two local optima of the bench OCP)."""
    from mpc_verde_tpu_torch.solver.batched import resolve_backend

    N, M, W = 40, 512, 256
    ocp = bench_ocp(N, dev, torch.float32)
    bare = dataclasses.replace(ocp, device_model=None)
    assert resolve_backend(bare, None) == "cuda_fused"
    rng = np.random.default_rng(22)
    x0 = rng.uniform(-2.0, 2.0, (M, 3))
    target = np.array([10.0, 10.0, 0.0])
    opts = mt.ILQROptions(max_iters=60, tol_grad=1e-4, tol_cost=1e-6,
                          n_alphas=8, alpha_decay=0.4)
    make = lambda o, b: mt.make_streaming_solver(o, opts, backend=b,
                                                 batch_width=W, restarts=2)
    rb, ran = _bw_ran(lambda: make(bare, "cuda_bw")(x0, target))
    assert ran == {"riccati_backward"}
    rd, ran = _default_ran(lambda: make(bare, None)(x0, target))
    assert ran == {"fused_backward", "linesearch_forward"}
    rc = make(ocp, "cuda")(x0, target)
    ps = torch.as_tensor(np.broadcast_to(target, (M, N + 1, 3)).copy(),
                         dtype=torch.float32, device=dev)
    for tag, res in (("cuda_bw", rb), ("default", rd)):
        assert float(res.converged.float().mean()) >= 0.99
        _hold_optima(f"{tag} vs cuda", res, rc,
                     bench_ocp(N, dev, torch.float64),
                     torch.as_tensor(x0, dtype=torch.float32, device=dev), ps,
                     1e-3)


def test_cuda_bw_float64_runs_k1_on_float32_copies(dev):
    """A float64 OCP on the card resolves to "cuda_bw": K1 on float32
    copies, everything else in float64; its results are float64 and, held
    by chip_smoke.py's _hold_optima as phase 22 (c) holds them, within 1e-4
    relative cost of the float64 "torch" solve on the card on >= 0.99 of
    the starts where both converged, every other start's answers float64
    optima."""
    from mpc_verde_tpu_torch.solver.batched import resolve_backend

    N, B = 40, 128
    ocp = bench_ocp(N, dev, torch.float64)
    assert resolve_backend(ocp, None) == "cuda_bw"
    rng = np.random.default_rng(23)
    x0 = rng.uniform(-2.0, 2.0, (B, 3))
    target = np.array([10.0, 10.0, 0.0])
    opts = mt.ILQROptions(max_iters=60, tol_grad=1e-4, tol_cost=1e-6,
                          n_alphas=8, alpha_decay=0.4)
    rb, ran = _bw_ran(lambda: mt.make_batched_ilqr_solver(ocp, opts)(x0,
                                                                      target))
    assert ran == {"riccati_backward"}
    assert rb.cost.dtype == rb.xs.dtype == torch.float64
    rt = mt.make_batched_ilqr_solver(ocp, opts, backend="torch")(x0, target)
    assert float(rb.converged.float().mean()) >= 0.99
    ps = torch.as_tensor(np.broadcast_to(target, (B, N + 1, 3)).copy(),
                         device=dev)
    _hold_optima("cuda_bw float64 vs torch", rb, rt, ocp,
                 torch.as_tensor(x0, device=dev), ps, 1e-4)


@pytest.mark.parametrize("name", ["double_integrator", "quadrotor",
                                  "point_mass"])
def test_cuda_bw_on_user_ocps(dev, name):
    """chip_smoke.py's user OCPs at (2, 1), (6, 2), (6, 3), from callables:
    "cuda_bw", named, K1 alone, converged_frac >= 0.99 (JAX float32's band,
    1.0, less 0.01) and within 1e-3 relative cost of the float64 "torch"
    solve on the CPU where both converged."""
    import chip_smoke as cs

    B = 256
    x0, ps, us0 = cs.user_queue(name, B)
    opts = mt.ILQROptions(max_iters=60, tol_grad=1e-4, tol_cost=1e-6,
                          n_alphas=8, alpha_decay=0.4)
    rb, ran = _bw_ran(lambda: mt.make_batched_ilqr_solver(
        cs.user_ocp(name, dev), opts, backend="cuda_bw")(x0, ps, us0))
    assert ran == {"riccati_backward"}
    rt = mt.make_batched_ilqr_solver(cs.user_ocp(name, "cpu", torch.float64),
                                     opts, backend="torch")(x0, ps, us0)
    assert float(rb.converged.float().mean()) >= 0.99
    both = rb.converged.cpu() & rt.converged
    rel = (rb.cost.double().cpu() - rt.cost).abs() / rt.cost.abs()
    assert float(rel[both].max()) <= 1e-3


def test_cuda_bw_warm_start_runs_k1_alone(dev):
    """make_lqr_warm_start on "cuda_bw", named, on the bench OCP without its
    device model: one K1 launch and the rollout's twin; the controls of the
    "cuda" warm start (K2 in place of the twin, both float32) within 1e-4.
    backend=None there runs one K1 and one K2 launch (on the traced model)
    and no twin, to the same controls."""
    from mpc_verde_tpu_torch.solver import make_lqr_warm_start

    N, B = 40, 301
    rng = np.random.default_rng(24)
    x0 = rng.uniform(-2, 2, (B, 3))
    ps = np.broadcast_to(np.array([10.0, 10.0, 0.0]), (B, N + 1, 3)).copy()
    ocp = bench_ocp(N, dev)
    k1 = riccati_backward.launches
    bare = dataclasses.replace(ocp, device_model=None)
    us, ran = _bw_ran(lambda: make_lqr_warm_start(
        bare, xref_fn=lambda p: p[:3], backend="cuda_bw")(x0, ps))
    assert ran == {"riccati_backward"} and riccati_backward.launches == k1 + 1
    ref = make_lqr_warm_start(ocp, xref_fn=lambda p: p[:3],
                              backend="cuda")(x0, ps)
    assert float((us - ref).abs().max()) <= 1e-4
    k1, k2 = riccati_backward.launches, linesearch_forward.launches
    us, ran = _default_ran(lambda: make_lqr_warm_start(
        bare, xref_fn=lambda p: p[:3])(x0, ps))
    assert ran == {"riccati_backward", "linesearch_forward"}
    assert (riccati_backward.launches, linesearch_forward.launches) == (
        k1 + 1, k2 + 1)
    assert float((us - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("case", ["lane_al", "rate_barrier"])
def test_default_path_on_the_rate_form_derived_ocps(dev, case):
    """backend=None on the rate-form models' derived OCPs, which have no
    device model (chip_smoke.py phase 23 (e2) and (e3) at B = 256): the
    lane change with a box on y through make_streaming_solver (its
    AL-derived OCP), the double integrator's rate form through
    make_streaming_barrier_solver (its barrier-derived OCP).  Each resolves
    to "cuda_fused" on the traced model, launches K3 and K2 and neither K1
    nor any twin (the plain line search included), converges on >= 0.99,
    keeps max_violation < 1e-2 and lands within 1e-3 relative cost of the
    float64 "torch" solve on the CPU on its first 32 problems where both
    converged."""
    import chip_smoke as cs
    from mpc_verde_tpu_torch.ops.cuda.rollout import (TracedDeviceModel,
                                                      kernel_model)
    from mpc_verde_tpu_torch.solver.batched import (_augment_ocp_al,
                                                    resolve_backend)
    from mpc_verde_tpu_torch.solver.ipm import _barrier_ocp

    N, B, H = 40, 256, 32
    if case == "lane_al":
        make = lambda o: mt.make_streaming_solver(
            o, cs._opts(al_iters=cs.AL_ITERS), batch_width=B, restarts=2)
        ocp, ocp64 = (cs.lane_box_ocp(d, t, N) for d, t in (
            (dev, torch.float32), ("cpu", torch.float64)))
        derived = _augment_ocp_al(ocp)
        queue = cs.lane_box_queue(B, N)
    else:
        make = lambda o: mt.make_streaming_barrier_solver(
            o, cs._opts(), batch_width=B, restarts=2)
        ocp, ocp64 = (cs.rate_di_ocp(N, d, t) for d, t in (
            (dev, torch.float32), ("cpu", torch.float64)))
        derived = _barrier_ocp(ocp, "streaming")
        queue = cs.rate_di_queue(B, N)
    assert derived.device_model is None
    assert resolve_backend(derived, None) == "cuda_fused"
    assert isinstance(kernel_model(derived), TracedDeviceModel)
    solve = make(ocp)
    res, ran = _default_ran(lambda: solve(*queue, max_iters=60,
                                          restarts_n=2))
    assert ran == {"fused_backward", "linesearch_forward"}
    assert float(res.converged.float().mean()) >= 0.99
    assert float(res.max_violation.max()) < 1e-2
    ref = make(ocp64)(*(a[:H] for a in queue), max_iters=60, restarts_n=2)
    both = res.converged[:H].cpu() & ref.converged
    rel = (res.cost[:H].double().cpu() - ref.cost).abs() / ref.cost.abs()
    assert float(both.float().mean()) >= 0.99
    assert float(rel[both].max()) <= 1e-3


def test_failed_k1_build_raises_with_its_log(dev, tmp_path, monkeypatch):
    """A K1 size whose nvcc fails raises with nvcc's log; the wrapper does
    not fall back to its twin and counts no launch."""
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build_mod, "_RICCATI", {})
    monkeypatch.setattr(build_mod, "_RICCATI_UNIT",
                        build_mod._RICCATI_UNIT + "#error forced failure\n")
    args = _random_riccati(np.random.default_rng(3), 8, 4, 2, 1, dev)
    before = riccati_backward.launches
    riccati_backward_torch.cuda_calls = 0
    with pytest.raises(RuntimeError, match="forced failure"):
        riccati_backward(*args, nx=2, nu=1)
    assert riccati_backward.launches == before
    assert riccati_backward_torch.cuda_calls == 0
    assert not list(tmp_path.glob("*.so"))


# ---- K2 and K3 on the device model traced from an OCP's callables ----------

@pytest.mark.parametrize("variant", [None, "lanes_ring"])
def test_traced_linesearch_matches_the_unicycle_model(dev, variant):
    """K2 on the bench OCP built from its callables (the model traced from
    them) against K2 on the hand-written unicycle model, on chip_smoke.py
    phase 4's inputs: costs, picks and trajectories within phase 4's
    tolerances (1e-5 cost, 1e-4 trajectory, same alpha >= 0.999)."""
    N, B, A = 40, 301, 8
    ocp = bench_ocp(N, dev)
    bare = dataclasses.replace(ocp, device_model=None)
    data = _k2_inputs(dev, B, N)
    alphas = tuple(0.4 ** i for i in range(A))
    by_variant = dict(linesearch_forward.launches_by_variant)
    out = linesearch_forward(*data, alphas, ocp=bare, variant=variant)
    torch.cuda.synchronize()
    planned = linesearch_launch_plan(N, A, 3).variant
    assert _launched(linesearch_forward, by_variant) == {variant or planned: 1}
    ref = linesearch_forward(*data, alphas, ocp=ocp, variant=variant)
    same = out[3] == ref[3]
    assert float(same.float().mean()) >= 0.999
    assert float(((out[2] - ref[2]).abs() / ref[2].abs()).max()) <= 1e-5
    assert _rel_err(out[0][same], ref[0][same]) <= 1e-4
    assert _rel_err(out[1][same], ref[1][same]) <= 1e-4


@pytest.mark.parametrize("variant", [None, "thread"])
@pytest.mark.parametrize("use_ddp", [True, False])
def test_traced_fused_kernel_matches_the_unicycle_model(dev, use_ddp, variant):
    """K3 on the traced bench model against K3 on the hand-written one, on
    pre-rolled trajectories, at K1_TOL (the Riccati kernel's tolerances)."""
    from chip_smoke import _bench_trajectories

    N, B = 40, 203
    ocp = bench_ocp(N, dev)
    bare = dataclasses.replace(ocp, device_model=None)
    f = dict(dtype=torch.float32, device=dev)
    args = (*_bench_trajectories(ocp, B, dev), torch.full((B,), 1e-6, **f),
            torch.ones((B,), **f))
    by_variant = dict(fused_backward.launches_by_variant)
    out = fused_backward(*args, ocp=bare, use_ddp=use_ddp, variant=variant)
    torch.cuda.synchronize()
    assert _launched(fused_backward, by_variant) == {variant or "staged": 1}
    ref = fused_backward(*args, ocp=ocp, use_ddp=use_ddp, variant=variant)
    for (name, tol), o, r in zip(K1_TOL.items(), out, ref):
        assert bool(torch.isfinite(o).all()), name
        assert _rel_err(o, r) <= tol, (name, _rel_err(o, r))


@pytest.mark.parametrize("name", ["double_integrator", "quadrotor",
                                  "point_mass"])
def test_traced_kernels_on_user_ocps(dev, name):
    """chip_smoke.py's user OCPs from callables: K2 (every variant) against
    the float64 twin's candidates and K3 (DDP on and off, both variants)
    against the float64 twin, as phase 23 (c) holds them, on random
    trajectories and gains."""
    import chip_smoke as cs

    B, N = 301, cs.USER_N
    ocp, ocp64 = cs.user_ocp(name, dev), cs.user_ocp(name, dev, torch.float64)
    rng = np.random.default_rng(71)
    f = dict(dtype=torch.float32, device=dev)
    t = lambda a: torch.as_tensor(a, **f).contiguous()
    x0, ps, us0 = cs.user_queue(name, B)
    res = mt.make_batched_ilqr_solver(ocp, mt.ILQROptions(max_iters=5),
                                      backend="cuda_fused")(x0, ps, us0)
    err = {"linesearch_forward": 0.0, "fused_backward": 0.0}
    cs._traced_user_kernels(name, ocp, ocp64, res, t(x0), t(ps),
                            tuple(0.4 ** i for i in range(8)), err)
    assert all(np.isfinite(e) for e in err.values())


def test_cuda_fused_on_a_bare_ocp_runs_the_traced_kernels(dev):
    """make_batched_ilqr_solver on the bench OCP from its callables:
    "cuda_fused" launches K3 and K2 and no K1, "cuda" K1 and K2 and no K3,
    no twin on CUDA tensors; both answers within 1e-3 relative cost of
    "cuda_fused" on the hand-written model where both converged."""
    N, B = 40, 128
    ocp = bench_ocp(N, dev)
    bare = dataclasses.replace(ocp, device_model=None)
    rng = np.random.default_rng(72)
    x0 = rng.uniform(-2.0, 2.0, (B, 3))
    target = np.array([10.0, 10.0, 0.0])
    opts = mt.ILQROptions(max_iters=60, tol_grad=1e-4, tol_cost=1e-6,
                          n_alphas=8, alpha_decay=0.4)
    ref = mt.make_batched_ilqr_solver(ocp, opts, backend="cuda_fused")(
        x0, target)
    for backend, kernels in (("cuda_fused", {"fused_backward",
                                             "linesearch_forward"}),
                             ("cuda", {"riccati_backward",
                                       "linesearch_forward"})):
        res, ran = _kernels_ran(lambda: mt.make_batched_ilqr_solver(
            bare, opts, backend=backend)(x0, target))
        assert ran == kernels, backend
        assert float(res.converged.float().mean()) >= 0.99
        both = res.converged & ref.converged
        rel = (res.cost.double() - ref.cost.double()).abs() / ref.cost.abs()
        assert float((rel[both] <= 1e-3).float().mean()) >= 0.99, backend


def test_traced_kernels_follow_weights_changed_in_place(dev):
    """The double integrator from its callables: after a launch, its weights
    (Q, R and the reference controls the stage cost closes over) change in
    place; K2 and K3 then give exactly what they give on a second OCP traced
    after the same change (one program text, one library), and not what
    they gave before."""
    import chip_smoke as cs

    name, B = "double_integrator", 64
    rng = np.random.default_rng(73)
    s = cs.USER_OCPS[name]
    N, nx, nu = cs.USER_N, s["nx"], s["nu"]
    f = dict(dtype=torch.float32, device=dev)
    t = lambda a: torch.as_tensor(a, **f).contiguous()
    x0, ps, us0 = cs.user_queue(name, B)
    xs = t(0.5 * rng.standard_normal((B, N + 1, nx)))
    us, ps = t(us0), t(ps)
    data = (t(x0), xs, us, ps, t(0.1 * rng.standard_normal((B, N, nu))),
            t(0.05 * rng.standard_normal((B, N, nu, nx))))
    args = (xs, us, ps, torch.full((B,), 1e-6, **f), torch.ones((B,), **f))
    alphas = tuple(0.4 ** i for i in range(8))

    def scale(ocp):
        for cell in ocp.stage_cost.__closure__:
            v = cell.cell_contents
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                v.mul_(1.5)

    def run(ocp):
        out = (*linesearch_forward(*data, alphas, ocp=ocp),
               *fused_backward(*args, ocp=ocp))
        torch.cuda.synchronize()
        return out

    ocp, ref_ocp = cs.user_ocp(name, dev), cs.user_ocp(name, dev)
    before = run(ocp)
    scale(ref_ocp)
    ref = run(ref_ocp)
    scale(ocp)
    after = run(ocp)
    assert all(torch.equal(a, r) for a, r in zip(after, ref))
    assert not all(torch.equal(b, r) for b, r in zip(before, ref))


def test_traced_kernels_on_the_barrier_and_al_ocps(dev):
    """The barrier- and AL-derived OCPs of the bench OCP from its callables
    (traced themselves, as JAX traces the augmented callables): K2 against
    the float64 twin's candidates one alpha at a time (chip_smoke.py's
    _hold_k2_f64: a first minimum among the finite ones), where a +inf or
    NaN candidate never wins, K3 against the twin at K1_TOL, on
    chip_smoke.py phase 10's inputs and parameters (npar 4, 10 and 11)."""
    from chip_smoke import TERM_BOX
    from mpc_verde_tpu_torch.interop import derived_ocps, derived_params

    from chip_smoke import _hold_k2_f64, _k2_candidates, _to64

    N, B = 40, 301
    x0, xs, us, ps, kff, K, lam, mu_al = _term_inputs(dev, B, N)
    derived = lambda dtype: derived_ocps(dataclasses.replace(
        bench_ocp(N, dev, dtype, x_lb=TERM_BOX[0], x_ub=TERM_BOX[1]),
        device_model=None))
    ocps, ocps64 = derived(torch.float32), derived(torch.float64)
    alphas = tuple(0.4 ** i for i in range(8))
    f = dict(dtype=torch.float32, device=dev)
    args_of = lambda p: (xs, us, p, torch.full((B,), 1e-6, **f),
                         torch.ones((B,), **f))
    for name, kw in (("barrier", dict(mu=1e-2)), ("barrier", dict(mu=0.0)),
                     ("barrier_batched", dict(mu=1e-2)),
                     ("al", dict(lam=lam, mu_al=mu_al)),
                     ("barrier_al", dict(mu=1e-2, lam=lam, mu_al=mu_al))):
        ocp = ocps[name]
        assert ocp.device_model is None
        p = derived_params(name, ps, **kw)
        data = (x0, xs, us, p, kff, K)
        out = linesearch_forward(*data, alphas, ocp=ocp)
        # the pick a first minimum of the finite float64 candidates within
        # the float32 bound, its cost and trajectory within it (a near tie
        # may part the kernel's float32 pick from the twin's)
        _hold_k2_f64(f"traced {name} {sorted(kw)}", out,
                     _k2_candidates(data, alphas, ocp),
                     _k2_candidates(_to64(*data), alphas, ocps64[name]), None)
        best, _, _, c_r, _ = _k2_kernel_rule(data, alphas, ocp)
        same = out[3] == best   # a +inf or NaN candidate never wins
        assert not bool(torch.isfinite(out[2][same & ~torch.isfinite(c_r)]).any())
        for use_ddp in ((True, False) if ocp.control_bounds is not None
                        else (False,)):
            out = fused_backward(*args_of(p), ocp=ocp, use_ddp=use_ddp)
            ref = fused_backward_torch(*args_of(p), ocp=ocp, use_ddp=use_ddp)
            for (key, tol), o, r in zip(K1_TOL.items(), out, ref):
                assert _rel_err(o, r) <= tol, (name, kw, use_ddp, key)


@pytest.mark.parametrize("bank", range(len(MATH_BANKS)))
def test_traced_math_functions_match_the_float64_evaluator(dev, bank):
    """Each device function of csrc/traced_math.cuh in float32 (K2 at N = 1
    on a bank OCP, one launch) against the float64 evaluator on the same
    float32 points, 10^5 points a function over its domain (for floor, ceil
    and round 1 in 8 a half-integer, for sign 1 in 8 a zero; pow's exponent
    and fmod's and remainder's divisor +-U(0.25, 3)): MATH_TOL, else 1e-6 of
    max(1, |ref|)."""
    from mpc_verde_tpu_torch.ops.cuda.rollout import traced_device_model

    names, B = MATH_BANKS[bank], 100_000
    rng = np.random.default_rng(81 + bank)
    x = np.stack([rng.uniform(*MATH_DOMAIN[n], B) for n in names], -1)
    for i, name in enumerate(names):
        if name in ("floor", "ceil", "round"):
            x[::8, i] = np.round(x[::8, i]) + 0.5
        if name == "sign":
            x[::8, i] = 0.0
    u = rng.choice([-1.0, 1.0], (B, 1)) * rng.uniform(0.25, 3.0, (B, 1))
    f = dict(dtype=torch.float32, device=dev)
    ocp = _bank_ocp(names, dev)
    x0, u0 = torch.as_tensor(x, **f), torch.as_tensor(u, **f)
    xs = torch.zeros((B, 2, 4), **f)
    ps = torch.zeros((B, 2, 1), **f)
    zero = lambda *shape: torch.zeros(shape, **f)
    before = linesearch_forward.launches
    xs_k, us_k, _, best = linesearch_forward(
        x0, xs, u0[:, None].contiguous(), ps, zero(B, 1, 1), zero(B, 1, 1, 4),
        (1.0,), ocp=ocp)
    torch.cuda.synchronize()
    assert linesearch_forward.launches == before + 1
    assert bool((best == 0).all()) and torch.equal(us_k[:, 0], u0)
    model = traced_device_model(ocp)
    ref = model.step(x0.double(), u0.double(), ps[:, 0].double())
    for i, name in enumerate(names):
        got, r = xs_k[:, 1, i].double(), ref[:, i]
        assert bool(torch.isfinite(r).all()), name
        err = float(((got - r).abs() / r.abs().clamp(min=1.0)).max())
        assert err <= MATH_TOL.get(name, 1e-6), (name, err)


@pytest.mark.parametrize("name", ["ops", "obstacle"])
def test_traced_kernels_on_the_new_ops(dev, name):
    """chip_smoke.py phase 23 (f) and (e4): K2 (every variant) against the
    float64 twin's candidates and K3 (DDP on and off, both variants) against
    the float64 twin, on random trajectories and gains (the ops OCP's params
    from op_params, at least 0.05 from a jump of its rounding ops; its
    twins on its program's evaluator, as torch.func cannot differentiate
    torch's huber_loss twice)."""
    import chip_smoke as cs

    B, N = 301, 40
    make = cs.ops_ocp if name == "ops" else cs.obstacle_ocp
    ocp, ocp64 = make(dev, torch.float32, N), make(dev, torch.float64, N)
    rng = np.random.default_rng(83)
    f = dict(dtype=torch.float32, device=dev)
    t = lambda a: torch.as_tensor(a, **f).contiguous()
    if name == "ops":
        ps = cs.op_params(B)
        xs = rng.uniform(-1.5, 1.5, (B, N + 1, 3))
    else:
        ps = np.broadcast_to([10.0, 10.0, 0.0], (B, 3))
        xs = np.concatenate([rng.uniform(2.0, 8.0, (B, N + 1, 2)),
                             rng.uniform(-1.0, 1.0, (B, N + 1, 1))], -1)
    ps = t(np.broadcast_to(np.asarray(ps)[:, None], (B, N + 1, ocp.npar)))
    xs, us = t(xs), t(rng.uniform(-0.9, 0.9, (B, N, 2)))
    err = {"linesearch_forward": 0.0, "fused_backward": 0.0}
    twins = (tuple(cs.evaluator_ocp(o) for o in (ocp, ocp64))
             if name == "ops" else None)
    cs._traced_user_kernels(name, ocp, ocp64, SimpleNamespace(xs=xs, us=us),
                            xs[:, 0].contiguous(), ps,
                            tuple(0.4 ** i for i in range(8)), err,
                            twins=twins)
    assert all(np.isfinite(e) for e in err.values())


def test_default_path_on_the_obstacle_ocp(dev):
    """chip_smoke.py phase 23 (e4) at B = 256: backend=None on the obstacle
    OCP (tanh and softplus in its callables) resolves to "cuda_fused" on the
    traced model, launches K3 and K2 and neither K1 nor any twin, converges
    on >= 0.99, and its first 32 answers are float64 optima
    (chip_smoke._hold_optima against the float64 "torch" solve on the card,
    by optimality: a start may pass the obstacle on either side)."""
    import chip_smoke as cs
    from mpc_verde_tpu_torch.solver.batched import resolve_backend

    N, B, H = 40, 256, 32
    ocp, ocp64 = (cs.obstacle_ocp(dev, dt, N) for dt in (torch.float32,
                                                          torch.float64))
    assert resolve_backend(ocp, None) == "cuda_fused"
    queue = cs._queue(B, N)
    make = lambda o, b: mt.make_streaming_solver(o, cs._opts(), backend=b,
                                                 batch_width=B, restarts=2)
    res, ran = _default_ran(lambda: make(ocp, None)(*queue, max_iters=60,
                                                    restarts_n=2))
    assert ran == {"fused_backward", "linesearch_forward"}
    assert float(res.converged.float().mean()) >= 0.99
    ref = make(ocp64, "torch")(*(a[:H] for a in queue), max_iters=60,
                               restarts_n=2)
    t = lambda a: torch.as_tensor(a[:H], device=dev)
    _hold_optima("obstacle vs float64", SimpleNamespace(
        converged=res.converged[:H], cost=res.cost[:H], us=res.us[:H]), ref,
        ocp64, t(queue[0]), t(queue[1]), 1e-3, share_gate=0.0)


def test_failed_traced_build_raises_with_its_log(dev, tmp_path, monkeypatch):
    """A traced program whose nvcc fails raises with nvcc's log; the wrapper
    does not fall back to its twin and counts no launch."""
    from mpc_verde_tpu_torch.ops.cuda import codegen

    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build_mod, "_TRACED", {})
    monkeypatch.setattr(codegen, "_K2_ENTRY",
                        codegen._K2_ENTRY + "#error forced failure\n")
    monkeypatch.setattr(build_mod, "traced_units", codegen.units)
    ocp = dataclasses.replace(bench_ocp(4, dev), device_model=None)
    data = _k2_inputs(dev, 8, 4)
    before = linesearch_forward.launches
    linesearch_forward_torch.cuda_calls = 0
    with pytest.raises(RuntimeError, match="forced failure"):
        linesearch_forward(*data, (1.0,), ocp=ocp)
    assert linesearch_forward.launches == before
    assert linesearch_forward_torch.cuda_calls == 0
