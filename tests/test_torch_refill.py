"""The streaming refill (``ops/cuda/refill.py``).

On the CPU (no marker): the plain refill ``refill_slots_torch`` against a
per-slot spec of what a turn does (each finished slot's result row out to
its problem's row, the next queued problem in with a fresh solver state, in
slot order, a finished slot with no problem left idle at ``prob = M``), bit
for bit, at the unicycle's, the AL-augmented and the quadrotor's widths, in
float32 and float64, with no slot finished, every slot finished, the queue
running out inside the turn, the drain tail and slots in mid-round; a
streaming solve, an AL solve and a streaming barrier solve give the same
bits with the spec in the loop; the counters a solve adds.

On the card (marker ``cuda``; this file imports no JAX, so run it there
with ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_refill.py -q``): the kernel against the twin bit for bit on
the same cases, untouched slots and rows (the dummy row ``M`` among them)
byte for byte as they were, the slot tensors updated in place, what the
wrapper refuses, one call a turn, and a streaming solve at M = 65,536 over
8,192 slots that gives the same bits with the kernel and with the twin.
"""
import math

import numpy as np
import pytest
import torch

import mpc_verde_tpu_torch as mt
from mpc_verde_tpu_torch.interop import bench_ocp
from mpc_verde_tpu_torch.ops.cuda.refill import (SLOT_STATE, refill_slots,
                                                 refill_slots_torch)
from mpc_verde_tpu_torch.solver import streaming
from mpc_verde_tpu_torch.utils.profiling import counters

OPTS = dict(max_iters=20, tol_grad=1e-4, tol_cost=1e-6, n_alphas=4,
            alpha_decay=0.4)
REG_INIT = 1e-3
# (nx, nu, npar of the slots): the unicycle, its AL-augmented params
# (npar + 2 nx + 1), the planar quadrotor
WIDTHS = {"unicycle": (3, 2, 3), "al": (3, 2, 10), "quadrotor": (6, 2, 6)}
CASES = ("none_finished", "all_finished", "queue_runs_out", "drain_tail",
         "mid_round")
DTYPES = (torch.float32, torch.float64)


def _slots(case, width, dtype, dev, B=24, M=60, N=5, seed=0):
    """(state, nq, out, qpk) of a turn: random slot tensors whose problems
    are distinct rows below nq, some slots idle (prob = M), costs and
    gradients with NaN and infinities among them."""
    rng = np.random.default_rng([seed, CASES.index(case),
                                 list(WIDTHS).index(width)])
    nx, nu, npar = WIDTHS[width]
    f = dict(dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    t = lambda a, **kw: torch.as_tensor(a, **(kw or f)).contiguous()

    def floats(*shape):
        a = rng.normal(size=shape)
        a.reshape(-1)[::7] = np.nan
        a.reshape(-1)[3::11] = np.inf
        a.reshape(-1)[5::13] = -np.inf
        return a

    nq = {"queue_runs_out": M - 3, "drain_tail": M}.get(case, B + 6)
    prob = rng.choice(nq, size=B, replace=False)
    idle = rng.uniform(size=B) < (0.0 if case == "all_finished" else 0.2)
    prob[idle] = M
    done = {"none_finished": idle, "all_finished": np.ones(B, bool)}.get(
        case, (rng.uniform(size=B) < 0.5) | idle)
    small = lambda lo, hi: (t(rng.integers(lo, hi, B), **i32)
                            if case == "mid_round"
                            else torch.zeros(B, **i32))
    state = dict(
        xs=t(floats(B, N + 1, nx)), us=t(floats(B, N, nu)), cost=t(floats(B)),
        reg=t(rng.uniform(1e-6, 1e3, B)),
        it=t(rng.integers(-1, 40, B), **i32), done=t(done, **{"device": dev}),
        gnorm=t(floats(B)), stall=t(rng.integers(0, 4, B), **i32),
        fail=t(rng.uniform(size=B) < 0.3, device=dev),
        ddp_on=t(rng.uniform(size=B) < 0.5, device=dev),
        x0s=t(floats(B, nx)), ps=t(floats(B, N + 1, npar)),
        capped=t(rng.uniform(size=B) < 0.3, device=dev),
        rst=small(0, 3), iacc=small(1, 90), alr=small(1, 3),
        prob=t(prob, **i32))
    sx, su, sp = (N + 1) * nx, N * nu, (N + 1) * npar
    out = t(floats(M + 1, sx + su + 4))
    qpk = t(floats(M, nx + sp + su + sx + 1))
    return (tuple(state[k] for k in SLOT_STATE), torch.tensor(nq, **i32),
            out, qpk)


def _spec(state, nq, out, qpk, *, reg_init, use_ddp):
    """The refill slot by slot: what a turn does, written as a loop."""
    s = {k: v.clone() for k, v in zip(SLOT_STATE, state)}
    B, N1, nx = s["xs"].shape
    sp, su, sx = s["ps"][0].numel(), s["us"][0].numel(), N1 * nx
    M, q0, dt = qpk.shape[0], int(nq), out.dtype
    loaded = 0
    for b in range(B):
        p = int(s["prob"][b])
        if not (bool(s["done"][b]) and p < M):
            continue
        c = s["cost"][b]
        conv = (not bool(s["fail"][b]) and math.isfinite(float(c))
                and not bool(s["capped"][b]))
        tail = torch.tensor([float(c), float(s["gnorm"][b]),
                             int(s["iacc"][b]) + max(int(s["it"][b]), 0),
                             1.0 if conv else 0.0], dtype=torch.float64)
        out[p] = torch.cat([s["xs"][b].reshape(-1), s["us"][b].reshape(-1),
                            tail.to(dt)])
        cand = q0 + loaded
        loaded += 1
        if cand >= M:
            s["prob"][b] = M
            continue
        row = qpk[cand]
        s["x0s"][b] = row[:nx]
        s["ps"][b] = row[nx:nx + sp].reshape(s["ps"][b].shape)
        s["us"][b] = row[nx + sp:nx + sp + su].reshape(s["us"][b].shape)
        s["xs"][b] = row[nx + sp + su:nx + sp + su + sx].reshape(N1, nx)
        s["cost"][b] = row[-1]
        for k, v in (("reg", reg_init), ("it", 0), ("gnorm", math.inf),
                     ("stall", 0), ("fail", False), ("ddp_on", use_ddp),
                     ("capped", False), ("done", False), ("prob", cand),
                     ("rst", 0), ("iacc", 0), ("alr", 0)):
            s[k][b] = v
    nq_new = torch.tensor(q0 + min(loaded, M - q0), dtype=torch.int32,
                          device=nq.device)
    return tuple(s[k] for k in SLOT_STATE), nq_new


def _same(a, b):
    """Whether two tensors hold the same bits (NaNs included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {torch.float32: torch.int32, torch.float64: torch.int64}
        return torch.equal(a.contiguous().view(ints[a.dtype]),
                           b.contiguous().view(ints[b.dtype]))
    return torch.equal(a, b)


def _assert_same(got, want, M):
    (gs, gnq, gout), (ws, wnq, wout) = got, want
    for name, g, w in zip(SLOT_STATE, gs, ws):
        assert _same(g, w), name
    assert _same(gnq, wnq), (gnq, wnq)
    assert _same(gout[:M], wout[:M]), "out"


def _run(fn, slots, use_ddp=True):
    state, nq, out, qpk = slots
    state = tuple(t.clone() for t in state)
    out = out.clone()
    new, nq_new = fn(state, nq.clone(), out, qpk, reg_init=REG_INIT,
                     use_ddp=use_ddp)
    return new, nq_new, out


# ---- the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_plain_refill_is_the_per_slot_spec(width, dtype, case):
    slots = _slots(case, width, dtype, "cpu")
    M = slots[3].shape[0]
    got = _run(refill_slots_torch, slots)
    _assert_same(got, _run(_spec, slots), M)
    # the CPU wrapper is the twin
    _assert_same(_run(refill_slots, slots), got, M)
    fin = slots[0][5] & (slots[0][16] < M)
    n_fin = int(fin.sum())
    assert int(got[1]) == min(int(slots[1]) + n_fin, M)
    if case == "none_finished":
        assert n_fin == 0
    if case == "all_finished":
        assert n_fin == len(fin) and not bool(got[0][5].any())
    if case in ("queue_runs_out", "drain_tail"):
        left = M - int(slots[1])
        assert n_fin > left
        assert int((got[0][16][fin] == M).sum()) == n_fin - left
    if case == "mid_round":
        assert bool((slots[0][15][fin] != 0).any())
        assert bool((got[0][15][fin & (got[0][16] < M)] == 0).all())


def _solver(kind, dtype, W=5):
    N = 8
    opts = mt.ILQROptions(**OPTS, al_iters=3)
    if kind == "barrier":
        return mt.make_streaming_barrier_solver(
            bench_ocp(N, "cpu", dtype), opts, batch_width=W, restarts=1), N
    if kind == "al":
        big = 1e9
        ocp = bench_ocp(N, "cpu", dtype, x_lb=torch.tensor([-big, -big, -big]),
                        x_ub=torch.tensor([big, 5.0, big]))
        return mt.make_streaming_solver(ocp, opts, batch_width=W,
                                        restarts=1), N
    return mt.make_streaming_solver(bench_ocp(N, "cpu", dtype), opts,
                                    batch_width=W, restarts=1), N


def _queue(M, N, dtype, seed=4):
    g = torch.Generator().manual_seed(seed)
    x0 = (4.0 * torch.rand((M, 3), generator=g, dtype=torch.float64)
          - 2.0).to(dtype)
    return x0, torch.tensor([10.0, 10.0, 0.0], dtype=dtype).expand(
        M, N + 1, 3)


@pytest.mark.parametrize("kind,dtype", [
    ("streaming", torch.float64), ("streaming", torch.float32),
    ("al", torch.float64), ("barrier", torch.float64)])
def test_solve_keeps_its_bits_with_the_spec_refill(kind, dtype, monkeypatch):
    """A solve on the CPU returns the same bits with the per-slot spec as
    its refill; its counters: every problem's row out, every problem past
    the first load in, and no kernel call."""
    M = 23
    solve, N = _solver(kind, dtype)
    x0, ps = _queue(M, N, dtype)
    before = counters()
    got = solve(x0, ps)
    d = {k: v - before[k] for k, v in counters().items()}
    assert d["refill_rows"] == 2 * M - 5 and d["refill"] == 0
    assert d["turns"] > 0
    monkeypatch.setattr(streaming, "refill_slots", _spec)
    want = solve(x0, ps)
    for name in ("xs", "us", "cost", "grad_norm", "iterations", "converged",
                 "max_violation"):
        assert _same(getattr(got, name), getattr(want, name)), name
    assert int(got.iterations.max()) > 0


def test_refill_rows_of_a_queue_within_the_slots():
    """A queue no longer than the slots is loaded whole before the loop:
    the refill moves each row out and none in."""
    M = 4
    solve, N = _solver("streaming", torch.float64, W=6)
    x0, ps = _queue(M, N, torch.float64)
    before = counters()["refill_rows"]
    solve(x0, ps)
    assert counters()["refill_rows"] - before == M


# ---- the card --------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_refill_kernel_is_the_twin(dev, width, dtype, case):
    """The kernel's slots, queue pointer and rows below M are the twin's
    bit for bit; it updates the slot tensors in place, and the slots that
    did not finish and every row of ``out`` that no finished slot owns (the
    dummy row M among them) keep their bytes."""
    # 300 slots: 16-slot groups read by vector loads and a ragged last
    # group; 1,024: vector loads alone
    for (B, M), use_ddp in zip(((300, 700), (1024, 2500)), (True, False)):
        slots = _slots(case, width, dtype, dev, B=B, M=M, N=40)
        state, nq, out, qpk = slots
        want = _run(refill_slots_torch, slots, use_ddp)
        mine = tuple(t.clone() for t in state)
        out_k, nq_k = out.clone(), nq.clone()
        new, nq_new = refill_slots(mine, nq_k, out_k, qpk, reg_init=REG_INIT,
                                   use_ddp=use_ddp)
        torch.cuda.synchronize()
        assert all(a is b for a, b in zip(new, mine)) and nq_new is nq_k
        _assert_same((new, nq_new, out_k), want, M)
        fin = state[5] & (state[16] < M)
        for name, a, b in zip(SLOT_STATE, new, state):
            assert _same(a[~fin], b[~fin]), name
        owned = torch.zeros(M + 1, dtype=torch.bool, device=dev)
        owned[state[16][fin].long()] = True
        assert _same(out_k[~owned], out[~owned])
        assert not bool(owned[M])


@pytest.mark.cuda
def test_refill_wrapper_refuses_what_the_kernel_does_not_take(dev):
    state, nq, out, qpk = _slots("mid_round", "unicycle", torch.float32, dev)
    call = lambda st=state, n=nq, o=out, q=qpk: refill_slots(
        st, n, o, q, reg_init=REG_INIT, use_ddp=True)
    swap = lambda i, t: state[:i] + (t,) + state[i + 1:]
    with pytest.raises(TypeError, match="float32 or float64"):
        call(tuple(t.half() if t.is_floating_point() else t for t in state),
             o=out.half(), q=qpk.half())
    with pytest.raises(TypeError, match="cost"):
        call(swap(2, state[2].double()))
    with pytest.raises(TypeError, match="it"):
        call(swap(4, state[4].long()))
    with pytest.raises(TypeError, match="done"):
        call(swap(5, state[5].to(torch.uint8)))
    with pytest.raises(ValueError, match="contiguous"):
        call(swap(0, state[0].transpose(0, 1).contiguous().transpose(0, 1)))
    with pytest.raises(ValueError, match="out"):
        call(o=out[:-1])
    with pytest.raises(ValueError, match="qpk"):
        call(q=qpk[:, :-1].contiguous())
    with pytest.raises(ValueError, match="nq"):
        call(n=nq.cpu())
    with pytest.raises(ValueError, match="prob"):
        call(swap(16, state[16][:-1].contiguous()))


@pytest.mark.cuda
def test_refill_calls_once_a_turn_and_only_in_the_streaming_loop(dev):
    N, M, W = 10, 48, 16
    x0, ps = _queue(M, N, torch.float32, seed=8)
    ocp = bench_ocp(N, dev)
    opts = mt.ILQROptions(**OPTS)
    solvers = {
        "streaming": mt.make_streaming_solver(ocp, opts, batch_width=W,
                                              restarts=1),
        "barrier": mt.make_streaming_barrier_solver(ocp, opts, batch_width=W,
                                                    restarts=1),
        "batched": mt.make_batched_ilqr_solver(ocp, opts)}
    for name, solve in solvers.items():
        before = counters()
        res = solve(x0.to(dev), ps.to(dev))
        torch.cuda.synchronize()
        d = {k: v - before[k] for k, v in counters().items()}
        assert d["iterations"] > 0, name
        streams = name != "batched"
        assert d["refill"] == (d["turns"] if streams else 0), (name, d)
        assert d["refill_rows"] == (2 * M - W if streams else 0), (name, d)
        assert bool(torch.isfinite(res.cost).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["streaming", "barrier"])
def test_solve_gives_the_same_bits_with_the_kernel_and_the_twin(dev, kind,
                                                                monkeypatch):
    """The cells' path (float32, ``backend=None``: K3 and K2) at M =
    65,536 over 8,192 slots (the barrier solve at a quarter of that)."""
    N = 40
    M, W = (65536, 8192) if kind == "streaming" else (16384, 2048)
    g = torch.Generator().manual_seed(12)
    x0 = (4.0 * torch.rand((M, 3), generator=g) - 2.0).to(dev)
    ps = torch.tensor([10.0, 10.0, 0.0], device=dev).expand(M, N + 1, 3)
    opts = mt.ILQROptions(max_iters=60, tol_grad=1e-4, tol_cost=1e-6,
                          n_alphas=8, alpha_decay=0.4)
    make = (mt.make_streaming_solver if kind == "streaming"
            else mt.make_streaming_barrier_solver)
    solve = make(bench_ocp(N, dev), opts, batch_width=W, restarts=2)
    before = counters()["refill"]
    got = solve(x0, ps)
    torch.cuda.synchronize()
    assert counters()["refill"] > before
    monkeypatch.setattr(streaming, "refill_slots", refill_slots_torch)
    want = solve(x0, ps)
    torch.cuda.synchronize()
    for name in ("xs", "us", "cost", "grad_norm", "iterations", "converged"):
        assert _same(getattr(got, name), getattr(want, name)), name
    assert float(got.converged.float().mean()) > 0.9
