"""The kernels' launch plans, and the tie rule every line-search variant keeps.

``riccati_launch_plan``, ``linesearch_launch_plan`` and ``fused_launch_plan``
choose a kernel variant, its block and its shared memory from the shape alone; they are plain Python
and are held here against an independent count of the bytes each variant
keeps in shared memory.  The plain PyTorch line search is held against the
JAX materialising line search on inputs where every alpha ties and on an
alpha count that is not a power of two: the first minimum wins, which is
what the kernel's shuffle reduction must reproduce on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import bench
import mpc_verde_tpu as mv
from mpc_verde_tpu.solver.batched import _make_parts as j_make_parts
from mpc_verde_tpu_torch.interop import bench_ocp
from mpc_verde_tpu_torch.ops.cuda import rollout
from mpc_verde_tpu_torch.ops.cuda.build import SMEM_MAX_BYTES
from mpc_verde_tpu_torch.ops.cuda.fused import fused_launch_plan
from mpc_verde_tpu_torch.ops.cuda.riccati import HELD_SIZES, riccati_launch_plan
from mpc_verde_tpu_torch.ops.cuda.rollout import (linesearch_forward_torch,
                                                  linesearch_launch_plan)

NPAR = 3


def test_shared_memory_limit_is_hoppers():
    assert SMEM_MAX_BYTES == 232_448        # 227 KB a block on sm_90


def _riccati_entries(nx, nu, use_ddp):
    """Floats a stage of the twelve inputs: fx fu lx lu lxx luu lux, the
    second-order fxx fux fuu, dlb dub."""
    first = [nx * nx, nx * nu, nx, nu, nx * nx, nu * nu, nu * nx]
    second = [nx ** 3, nx * nu * nx, nx * nu * nu] if use_ddp else [0, 0, 0]
    return first + second + [nu, nu]


@pytest.mark.parametrize("B", [1, 1024, 16384])
@pytest.mark.parametrize("N", [1, 10, 40, 600, 5000])
@pytest.mark.parametrize("use_ddp", [True, False])
@pytest.mark.parametrize("nx,nu", sorted(HELD_SIZES))
def test_riccati_launch_plan(nx, nu, use_ddp, N, B):
    plan = riccati_launch_plan(N, nx, nu, use_ddp, B)
    entries = _riccati_entries(nx, nu, use_ddp)
    cand_warps = 3 if nu == 1 else 9
    # floats one problem keeps in shared memory: its slabs, its kff and K,
    # its rows of the two exchange areas; padding adds at most 31 floats a
    # slab and one to each staging stride
    kept = (N * (sum(entries) + nu + nu * nx) + nu + nu * nu
            + cand_warps * (2 + nu))
    slack = 31 * 12 + 2
    assert plan.smem_bytes <= SMEM_MAX_BYTES and 1 <= plan.threads <= 1024
    forced_thread = riccati_launch_plan(N, nx, nu, use_ddp, B, "thread")
    assert forced_thread[:4] == ("thread", 64, 64, 0)
    if 4 * kept > SMEM_MAX_BYTES:     # not one problem fits
        assert plan == forced_thread
        with pytest.raises(ValueError, match="shared memory"):
            riccati_launch_plan(N, nx, nu, use_ddp, B, "warps")
        return
    # (no case here sits within the padding of the limit)
    assert 4 * (kept + slack) <= SMEM_MAX_BYTES
    forced = riccati_launch_plan(N, nx, nu, use_ddp, B, "warps")
    pb = forced.problems
    assert forced.variant == "warps" and forced.threads == 32 * (cand_warps + 1)
    assert 4 * pb * kept <= forced.smem_bytes <= 4 * pb * (kept + slack)
    # as many problems as fit, up to 8
    assert pb == 8 or 4 * (pb + 1) * (kept + slack) > SMEM_MAX_BYTES
    # "warps" unless the batch makes more than three blocks an SM or a
    # candidate warp would have more than three patterns (nu = 4)
    expected = "warps" if -(-B // pb) <= 3 * 132 and nu <= 3 else "thread"
    assert plan == (forced if expected == "warps" else forced_thread)
    # the layout the kernel is given: twelve slabs of pb chunks at strides
    # that hold a chunk, 16-byte aligned and 4 modulo 32 floats; the staging
    # areas at odd strides; the exchange areas; nothing overlaps
    lay = forced.layout
    offsets, strides = lay[:12], lay[12:24]
    okff, oK, skff, sK, xu, xc, total = lay[24:]
    end = 0
    for off, stride, e in zip(offsets, strides, entries):
        assert off % 4 == 0 and off >= end
        if e:
            assert stride >= N * e and stride % 32 == 4
        end = off + pb * stride
    assert okff >= end and skff >= N * nu and skff % 2 == 1
    assert oK >= okff + pb * skff and sK >= N * nu * nx and sK % 2 == 1
    assert xu >= oK + pb * sK
    assert xc >= xu + pb * (nu + nu * nu)
    assert total >= xc + pb * cand_warps * (2 + nu)
    assert 4 * total == forced.smem_bytes


def test_riccati_launch_plan_at_the_bench_and_fleet_shapes():
    assert riccati_launch_plan(40, 3, 2, True, 1024)[:4] == (
        "warps", 8, 320, 146_304)
    assert riccati_launch_plan(40, 3, 2, False, 1024)[:3] == ("warps", 8, 320)
    assert riccati_launch_plan(10, 3, 2, True, 1024)[:4] == (
        "warps", 8, 320, 41_344)
    assert riccati_launch_plan(40, 3, 2, True)[:2] == ("warps", 8)
    assert riccati_launch_plan(40, 3, 1, True, 1024)[:3] == ("warps", 8, 128)
    assert riccati_launch_plan(40, 4, 3, True, 1024)[:3] == ("warps", 5, 320)
    # 81 patterns in nine rounds a warp lose to one thread a problem
    assert riccati_launch_plan(40, 5, 4, True, 1024).variant == "thread"
    assert riccati_launch_plan(40, 5, 4, True, 1024, "warps")[:2] == ("warps", 3)
    # three problems a block still win at N = 160, one a block would not
    assert riccati_launch_plan(160, 3, 2, True, 1024)[:2] == ("warps", 3)
    assert riccati_launch_plan(300, 3, 2, True, 1024).variant == "thread"


@pytest.mark.parametrize("N,B,expected", [
    (40, 1000, "warps"), (40, 1024, "warps"), (40, 2048, "warps"),
    (40, 3168, "warps"), (40, 3169, "thread"), (40, 4096, "thread"),
    (40, 16384, "thread"), (10, 2048, "warps"), (10, 4096, "thread"),
    (160, 1024, "warps"), (160, 2048, "thread")])
def test_riccati_launch_plan_takes_the_batch(N, B, expected):
    """More than three "warps" blocks an SM go to the "thread" kernel, as
    measured on the card; the width the solvers run (1024) stays "warps",
    and a forced variant ignores the batch."""
    assert riccati_launch_plan(N, 3, 2, True, B).variant == expected
    assert (riccati_launch_plan(N, 3, 2, True, B, "warps")
            == riccati_launch_plan(N, 3, 2, True))
    assert riccati_launch_plan(N, 3, 2, True, B, "thread").variant == "thread"


def test_riccati_launch_plan_refuses():
    with pytest.raises(ValueError, match="unknown"):
        riccati_launch_plan(40, 3, 2, True, 1024, "staged")
    with pytest.raises(NotImplementedError, match="nu <= 4"):
        riccati_launch_plan(40, 4, 5, True)
    with pytest.raises(ValueError, match="shared memory"):
        riccati_launch_plan(5000, 3, 2, True, 1024, "warps")


def _linesearch_floats(N, A_pad):
    """Floats one problem keeps in shared memory: (nominal slabs, slots)."""
    nominal = (N + 1) * 3 + N * 2 + N * 2 + N * 6 + (N + 1) * NPAR
    return nominal, A_pad * ((N + 1) * 3 + N * 2)


def _ring_layout_holds(plan, nx=3, nu=2, npar=NPAR):
    """The ring's layout: each stage xs, us, kff, K and ps, an odd problem
    stride that holds a chunk's 8 stages, the ring's two slots, then the
    winners' indices; the bytes are the total's."""
    row, pstride, sstride, best, total = plan.layout
    assert row == nx + 2 * nu + nu * nx + npar
    assert pstride % 2 == 1 and 8 * row <= pstride <= 8 * row + 1
    assert sstride == plan.problems * pstride and best == 2 * sstride
    assert total == best + plan.problems and 4 * total == plan.smem_bytes


@pytest.mark.parametrize("A", [1, 5, 8, 32])
@pytest.mark.parametrize("N", [1, 10, 40, 600, 5000])
def test_linesearch_launch_plan(N, A):
    plan = linesearch_launch_plan(N, A, NPAR)
    A_pad = {1: 1, 5: 8, 8: 8, 32: 32}[A]
    nominal, slots = _linesearch_floats(N, A_pad)
    assert plan.smem_bytes <= SMEM_MAX_BYTES and 1 <= plan.threads <= 1024
    # one wave (no batch given): "lanes" where there is a choice of alpha
    # and at least a warp of lanes fits a block with its slots (a few
    # floats of alignment and padding aside, which no case here sits
    # within), else the ring, whose bytes do not grow with N
    warp = max(1, 32 // A_pad)     # the problems of one warp of lanes
    if A > 1 and 4 * warp * (nominal + slots) < SMEM_MAX_BYTES - 64 * warp:
        expected = "lanes"
    else:
        expected = "lanes_ring"
    assert plan.variant == expected
    assert plan.threads == plan.problems * A_pad
    ring = linesearch_launch_plan(N, A, NPAR, "lanes_ring")
    # 128 threads, or for one alpha as many problems as let two blocks fit
    # an SM's 228 KB (1 KB of them reserved a block)
    assert ring.variant == "lanes_ring"
    assert ring.threads == (64 if A == 1 else 128) == ring.problems * A_pad
    assert 2 * (ring.smem_bytes + 1024) <= 233_472
    _ring_layout_holds(ring)
    # the same bytes at every horizon and every batch
    assert ring == linesearch_launch_plan(1, A, NPAR, "lanes_ring")
    assert ring == linesearch_launch_plan(N, A, NPAR, "lanes_ring", B=10**6)
    # a forced variant is the same plan, or another that fits, or an error
    assert linesearch_launch_plan(N, A, NPAR, plan.variant) == plan
    if plan.variant == "lanes_ring":
        assert plan == ring
        return
    kept = nominal + slots
    assert plan.smem_bytes >= 4 * plan.problems * kept
    assert plan.smem_bytes <= 4 * plan.problems * (kept + A_pad + 1) + 5 * 16
    # the layout the kernel is given: five slabs that hold the block's
    # problems at 16-byte offsets, then the slots (odd stride) and indices
    *slabs, cand, best, slot, total = plan.layout
    sizes = [plan.problems * n for n in
             ((N + 1) * 3, N * 2, N * 2, N * 6, (N + 1) * NPAR)]
    for start, size, end in zip(slabs, sizes, slabs[1:] + [cand]):
        assert start % 4 == 0 and start + size <= end
    assert 4 * total == plan.smem_bytes
    assert slot % 2 == 1 and slot >= (N + 1) * 3 + N * 2
    assert cand + plan.threads * slot == best
    assert best + plan.problems == total


def test_linesearch_launch_plan_at_the_bench_and_fleet_shapes():
    assert linesearch_launch_plan(40, 8, 3)[:4] == ("lanes", 8, 64, 72_672)
    assert linesearch_launch_plan(10, 12, 3)[:4] == ("lanes", 4, 64, 16_240)
    assert linesearch_launch_plan(10, 8, 3).variant == "lanes"
    # the pre-rolls of the streaming queue and of the fleet: no slots, the
    # ring's 64 problems a block at either horizon
    assert linesearch_launch_plan(40, 1, 3)[:4] == ("lanes_ring", 64, 64,
                                                    66_304)
    assert linesearch_launch_plan(10, 1, 3)[:4] == ("lanes_ring", 64, 64,
                                                    66_304)
    assert linesearch_launch_plan(40, 1, 3, "lanes").variant == "lanes"
    # fewer lanes than a warp would fit with their slots: the ring
    assert linesearch_launch_plan(600, 8, 3)[:3] == ("lanes_ring", 16, 128)
    assert linesearch_launch_plan(600, 8, 3, "lanes")[:3] == ("lanes", 1, 8)


# the traced planar quadrotor of the benchmark's cell: (6, 2), npar 6
QUADROTOR = dict(nx=6, nu=2)


@pytest.mark.parametrize("N,A,npar,kw,B,expected", [
    # the quadrotor cell: 131,072 slots, the pre-roll over a call's rows
    (40, 8, 6, QUADROTOR, 131072, "lanes_ring"),
    (40, 1, 6, QUADROTOR, 131072, "lanes_ring"),
    (40, 1, 6, QUADROTOR, 1048576, "lanes_ring"),
    (40, 8, 6, QUADROTOR, 16384, "lanes_ring"),
    (40, 8, 6, QUADROTOR, 4096, "lanes_ring"),
    (40, 8, 6, QUADROTOR, 2048, "lanes"),
    (40, 8, 6, QUADROTOR, 1024, "lanes"),
    (40, 1, 6, QUADROTOR, 1024, "lanes_ring"),
    # the unicycle's queue cells (npar 3, the barrier's 4) and the batch
    (40, 8, 3, {}, 131072, "lanes_ring"),
    (40, 8, 4, {}, 131072, "lanes_ring"),
    (40, 8, 3, {}, 65536, "lanes_ring"),
    (40, 8, 3, {}, 8192, "lanes_ring"),
    (40, 1, 3, {}, 1048576, "lanes_ring"),
    (40, 8, 3, {}, 4096, "lanes"),
    (40, 8, 3, {}, 1024, "lanes"),
    (40, 1, 3, {}, 1024, "lanes_ring"),
    # the fleet: N = 10, 12 alphas, 524,288 robots
    (10, 12, 3, {}, 524288, "lanes"),
    (10, 1, 3, {}, 524288, "lanes_ring"),
    (10, 12, 3, {}, 1024, "lanes")])
def test_linesearch_launch_plan_takes_the_batch(N, A, npar, kw, B, expected):
    """Where its grid runs in up to two waves "lanes" keeps the width the
    solvers' tests run (1,024), and the fleet's 13 blocks (26 warps) an SM
    keep it at any width; where the batch runs many waves of few warps an
    SM the plan takes the ring, as measured on the card at the cells'
    widths: the quadrotor's and the unicycle's queues.  One alpha takes
    the ring.  A forced variant ignores the batch."""
    plan = linesearch_launch_plan(N, A, npar, B=B, **kw)
    assert plan.variant == expected
    assert plan == linesearch_launch_plan(N, A, npar, expected, B=B, **kw)
    assert plan == linesearch_launch_plan(N, A, npar, expected, **kw)
    if expected == "lanes_ring":
        _ring_layout_holds(plan, kw.get("nx", 3), kw.get("nu", 2), npar)


def test_linesearch_launch_plan_refuses():
    with pytest.raises(ValueError, match="alphas"):
        linesearch_launch_plan(40, rollout.MAX_ALPHAS + 1, 3)
    with pytest.raises(ValueError, match="unknown"):
        linesearch_launch_plan(40, 8, 3, "warp")
    with pytest.raises(ValueError, match="unknown"):
        linesearch_launch_plan(40, 8, 3, "thread")
    with pytest.raises(ValueError, match="shared memory"):
        linesearch_launch_plan(5000, 8, 3, "lanes")
    # a stage row of 8,013 floats: one problem's ring of two 8-stage chunks
    # takes 512,844 bytes, forced or planned
    with pytest.raises(ValueError, match="'lanes_ring' needs 512844 bytes"):
        linesearch_launch_plan(40, 8, 8000, "lanes_ring")
    with pytest.raises(ValueError, match="'lanes_ring' needs 512844 bytes"):
        linesearch_launch_plan(40, 8, 8000, B=131072)


@pytest.mark.parametrize("use_ddp", [True, False])
@pytest.mark.parametrize("N", [1, 10, 40, 600, 5000])
def test_fused_launch_plan(N, use_ddp):
    plan = fused_launch_plan(N, use_ddp)
    # a stage record: per dynamics component 5 gradient (+ 15 Hessian
    # triangle) floats, the cost's 5 + 15, lo and hi; 8 floats of kff and K
    record = 3 * (5 + (15 if use_ddp else 0)) + 20 + 4
    kept = N * (record + 8)
    assert plan.smem_bytes <= SMEM_MAX_BYTES and 1 <= plan.threads <= 1024
    # "staged" where at least 4 problems fit a block
    expected = "staged" if 16 * (kept + N + 3) <= SMEM_MAX_BYTES else "thread"
    assert plan.variant == expected
    if plan.variant == "thread":
        assert (plan.problems, plan.threads, plan.smem_bytes) == (64, 64, 0)
        return
    assert plan.smem_bytes >= 4 * plan.problems * kept
    assert plan.smem_bytes <= 4 * plan.problems * (kept + N + 3)
    assert plan.problems <= plan.threads <= 256 and plan.threads % 32 == 0
    # the per-problem strides the kernel is given: odd (no bank conflicts)
    rec, kff, K = plan.layout
    assert (rec >= N * record and kff >= N * 2 and K >= N * 6
            and rec % 2 == kff % 2 == K % 2 == 1)
    assert 4 * plan.problems * (rec + kff + K) == plan.smem_bytes
    turns = -(-plan.problems * N // plan.threads)
    assert plan.threads * turns >= plan.problems * N       # every stage taken
    assert plan.threads * (turns - 1) < plan.problems * N  # no idle turn
    assert plan.problems >= 4
    assert fused_launch_plan(N, use_ddp, "staged") == plan
    assert fused_launch_plan(N, use_ddp, "thread").variant == "thread"


def test_fused_launch_plan_at_the_bench_and_fleet_shapes():
    assert fused_launch_plan(40, True)[:4] == ("staged", 8, 160, 119_136)
    assert fused_launch_plan(10, True)[:4] == ("staged", 8, 96, 29_856)
    assert fused_launch_plan(156, True)[:2] == ("staged", 4)
    assert fused_launch_plan(157, True).variant == "thread"
    # forced, "staged" runs as long as one problem fits
    assert fused_launch_plan(624, True, "staged")[:2] == ("staged", 1)


@pytest.mark.parametrize("N,B,expected", [
    (40, 1000, "staged"), (40, 1024, "staged"), (40, 2048, "staged"),
    (40, 4096, "thread"), (40, 16384, "thread"),
    (10, 1024, "staged"), (10, 4096, "staged"), (10, 8192, "thread")])
def test_fused_launch_plan_takes_the_batch(N, B, expected):
    """A batch whose "staged" blocks would run in more than two waves goes
    to the "thread" kernel, as measured on the card; the widths the solvers
    run (1024) stay "staged", and a forced variant ignores the batch."""
    assert fused_launch_plan(N, True, None, B).variant == expected
    assert fused_launch_plan(N, True, "staged", B) == fused_launch_plan(N, True)
    assert fused_launch_plan(N, True, "thread", B).variant == "thread"


def test_fused_launch_plan_refuses():
    with pytest.raises(ValueError, match="unknown"):
        fused_launch_plan(40, True, "lanes")
    with pytest.raises(ValueError, match="shared memory"):
        fused_launch_plan(5000, True, "staged")


@pytest.mark.parametrize("case", ["ties", "a5"])
def test_twin_tie_rule_matches_jax_materialize(case):
    """With zero gains every alpha rolls the nominal controls, so all costs
    tie and the first alpha (index 0) must win; with A = 5 the alpha count
    is not a power of two.  Both against the JAX materialising line search
    (float64, inputs from a numpy seed)."""
    N, B = 12, 16
    A = 8 if case == "ties" else 5
    rng = np.random.default_rng(11)
    kffs = 0.3 * rng.normal(size=(B, N, 2))
    Ks = 0.2 * rng.normal(size=(B, N, 2, 3))
    if case == "ties":
        kffs, Ks = np.zeros_like(kffs), np.zeros_like(Ks)
    data = (rng.uniform(-2, 2, (B, 3)), rng.uniform(-2, 2, (B, N + 1, 3)),
            rng.uniform(-0.8, 0.8, (B, N, 2)),
            np.broadcast_to(np.array([10.0, 10.0, 0.0]), (B, N + 1, 3)).copy(),
            kffs, Ks)
    xs_j, us_j, c_j = j_make_parts(
        bench.build_ocp(N), mv.ILQROptions(n_alphas=A, alpha_decay=0.4), "xla",
        "materialize").linesearch(*data)
    xs_t, us_t, c_t, best = linesearch_forward_torch(
        *(torch.as_tensor(a) for a in data), tuple(0.4 ** i for i in range(A)),
        ocp=bench_ocp(N, "cpu", torch.float64))
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0, atol=1e-10)
    if case == "ties":
        assert best.tolist() == [0] * B
    else:
        assert len(set(best.tolist())) > 1 and max(best.tolist()) < A


# The linear rate-form families' shapes: (N, npar, nx) of the lane change
# (N 5, npar 4; v1 N 20), LTV (npar 16), the dynamic bicycle (N 10, npar 25,
# nx 5) and the pendulum (N 50, npar 0, or 1 as the closed-loop runner pads
# it), nu = 1, at the solvers' 12 alphas, phase 10's 8 and the pre-roll's 1.
LINEAR_SHAPES = [(5, 4, 4), (20, 4, 4), (5, 16, 4), (10, 25, 5), (50, 0, 5),
                 (50, 1, 5)]


@pytest.mark.parametrize("A", [1, 8, 12])
@pytest.mark.parametrize("N,npar,nx", LINEAR_SHAPES)
def test_linesearch_launch_plan_at_the_linear_shapes(N, npar, nx, A):
    plan = linesearch_launch_plan(N, A, npar, nx=nx, nu=1)
    A_pad = 1 << (A - 1).bit_length()
    if A == 1:
        assert plan.variant == "lanes_ring"
        assert plan.problems == plan.threads <= 128
        assert 2 * (plan.smem_bytes + 1024) <= 233_472
        _ring_layout_holds(plan, nx, 1, npar)
        return
    assert plan.variant == "lanes"
    assert plan.problems == 64 // A_pad and plan.threads == 64
    *slabs, cand, best, slot, total = plan.layout
    sizes = [plan.problems * n for n in
             ((N + 1) * nx, N, N, N * nx, (N + 1) * npar)]
    for start, size, end in zip(slabs, sizes, slabs[1:] + [cand]):
        assert start % 4 == 0 and start + size <= end
    assert 4 * total == plan.smem_bytes <= SMEM_MAX_BYTES
    assert slot % 2 == 1 and slot >= (N + 1) * nx + N
    assert cand + plan.threads * slot == best
    # the unicycle's sizes are the default
    assert (linesearch_launch_plan(N, A, npar)
            == linesearch_launch_plan(N, A, npar, nx=3, nu=2))


def test_linesearch_launch_plan_at_the_family_shapes():
    assert linesearch_launch_plan(5, 12, 4, nx=4, nu=1)[:4] == (
        "lanes", 4, 64, 8_688)
    assert linesearch_launch_plan(10, 12, 25, nx=5, nu=1)[:4] == (
        "lanes", 4, 64, 23_056)
    assert linesearch_launch_plan(50, 12, 1, nx=5, nu=1)[:4] == (
        "lanes", 4, 64, 88_592)
    assert linesearch_launch_plan(50, 1, 1, nx=5, nu=1)[:4] == (
        "lanes_ring", 128, 128, 108_032)


@pytest.mark.parametrize("use_ddp", [True, False])
@pytest.mark.parametrize("N,nx", [(5, 4), (20, 4), (10, 5), (50, 5), (600, 5)])
def test_fused_launch_plan_at_the_linear_shapes(N, nx, use_ddp):
    nz = nx + 1
    tri = nz * (nz + 1) // 2
    record = nx * (nz + (tri if use_ddp else 0)) + nz + tri + 2
    for B in (1, 301, 1024):
        plan = fused_launch_plan(N, use_ddp, None, B, nx=nx, nu=1)
        if plan.variant == "thread":
            assert 16 * N * (record + 1 + nx) > SMEM_MAX_BYTES
            continue
        rec, kff, K = plan.layout
        assert (rec >= N * record and kff >= N and K >= N * nx
                and rec % 2 == kff % 2 == K % 2 == 1)
        assert 4 * plan.problems * (rec + kff + K) == plan.smem_bytes
        assert plan.smem_bytes <= SMEM_MAX_BYTES and plan.problems >= 4
        assert plan.threads * -(-plan.problems * N // plan.threads) >= (
            plan.problems * N)
    assert fused_launch_plan(N, use_ddp) == fused_launch_plan(
        N, use_ddp, nx=3, nu=2)


def test_fused_launch_plan_at_the_family_shapes():
    """At B = 1 and B = 1024 alike (one wave): the lane change, the dynamic
    bicycle, and the pendulum's 50 stages, 4 problems a block with DDP."""
    for B in (1, 1024):
        assert fused_launch_plan(5, True, None, B, nx=4, nu=1)[:4] == (
            "staged", 8, 64, 17_312)
        assert fused_launch_plan(10, True, None, B, nx=5, nu=1)[:4] == (
            "staged", 8, 96, 54_816)
        assert fused_launch_plan(50, True, None, B, nx=5, nu=1)[:4] == (
            "staged", 4, 224, 136_848)
        assert fused_launch_plan(50, False, None, B, nx=5, nu=1)[:4] == (
            "staged", 8, 224, 104_096)


def test_riccati_launch_plan_at_the_linear_sizes():
    for B in (1, 1024):
        assert riccati_launch_plan(5, 4, 1, True, B)[:4] == (
            "warps", 8, 128, 30_368)
        assert riccati_launch_plan(10, 5, 1, True, B)[:4] == (
            "warps", 8, 128, 80_672)
        assert riccati_launch_plan(50, 5, 1, True, B)[:4] == (
            "warps", 4, 128, 186_512)
    assert {(4, 1), (5, 1)} <= set(HELD_SIZES)
