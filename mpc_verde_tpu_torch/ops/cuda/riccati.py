"""Batched box-constrained Riccati backward pass: CUDA kernel K1 and its PyTorch twin.

``riccati_backward`` replaces the Pallas TPU kernel ``riccati_backward_pallas``
(``mpc_verde_tpu/ops/pallas/riccati.py``).  Like it, it takes any nx >= 1
and 1 <= nu <= 4; nu > 4 raises ``NotImplementedError``.  The 3^nu stage
box-QP patterns are unrolled at compile time per (nx, nu), so each size is
a library of its own, built the first time that size is launched
(``build.riccati_entry``).  ``HELD_SIZES`` are the sizes the tests and
``chip_smoke.py`` hold against the twin on the card: the unicycle (3, 2),
the rate-form linear families (4, 1) and (5, 1), the Frenet family's rate
form (5, 2), the JAX kernel's test sizes, and three user models' sizes, the
double integrator (2, 1), the planar quadrotor (6, 2) and the 3-D point mass
(6, 3).
What bounds the function on the H100 is neither bytes nor operations but the
recursion's chain: N stage QPs that each wait for the next stage's
(Vx, Vxx), with too few problems to hide one chain behind another.

Its kernels are ``csrc/riccati_warps.cuh`` and ``csrc/riccati.cuh``.
``riccati_launch_plan`` picks the variant from the shape alone:
``"warps"``: a block copies its problems' derivative slabs to shared memory
(coalesced 16-byte ``cp.async``, each problem's chunk at a padded stride so
that the problems' reads fall into different banks) and deals each stage
over its warps: one warp keeps the value function, expands Qu and Quu and
hands them to a warp per share of the active-set patterns, which solve the
candidates while it expands Qx, Qxx, Qux; it then merges the first minimum,
solves the gain and updates the value function; kff and K leave
through a staging area as coalesced slabs.  ``"thread"``: one thread per
problem walks the stages over device memory, with uncoalesced loads; it
needs no shared memory and its small blocks all run at once, so it takes
the horizons at which too few problems' slabs fit a block and the batches
whose ``"warps"`` blocks would run in many waves.  Both run the same stage
functions and give the same floats.  The plan also computes the
``"warps"`` kernel's shared-memory layout, which the C entry point takes as
it is.

``riccati_backward_torch`` is the plain PyTorch version: the batched form
of the JAX ``"xla"`` backward (``mpc_verde_tpu/solver/batched.py``), on any
device and dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...solver.ilqr import _stage_boxqp_with_gain
from .build import (SMEM_MAX_BYTES, LaunchPlan, check_args, check_launch,
                    check_riccati_size, riccati_entry)

HELD_SIZES = ((3, 1), (3, 2), (4, 1), (4, 3), (5, 1), (5, 2), (5, 4),
              (2, 1), (6, 2), (6, 3))
RICCATI_VARIANTS = ("thread", "warps")  # the C entry's ids

_STAGE_KEYS = ("fx", "fu", "lx", "lu", "lxx", "luu", "lux")
_DDP_KEYS = ("fxx", "fux", "fuu")
CLOCK_PARTS = ("load", "expand_u", "expand_x", "wait_candidates", "merge",
               "gain", "finish", "write_out", "candidates")   # kClockSlots of csrc/riccati_warps.cuh

# The plan's constants follow measurements on the H100
# (utils/tune_launch_plans.py, nx = 3, nu = 2, DDP, B = 1024 unless said).
# Problems a block: at N = 40, 1 / 2 / 4 / 8 / 12 take 0.197 / 0.102 / 0.0533
# / 0.0507 / 0.0533 ms ("thread": 0.141); at N = 10, 4 / 8 / 16 take 0.0192 /
# 0.0187 / 0.0204 ms.
_BLOCK_PROBLEMS = 8
# Chunk strides padded to 4 modulo 32 floats: 0.0507 ms against 0.0567 ms for
# contiguous chunks (fx 8 modulo 32 floats apart, a 4-way bank conflict) at
# N = 40; no difference at N = 10.
_PAD_BANKS = True
# Blocks: a "warps" block's chain leaves no room to hide a second block's
# behind it, whether the SM holds one block (N = 40) or five (N = 10), so a
# batch of more blocks than about three an SM is faster on the small
# "thread" blocks, which all run at once.  B = 1024 / 2048 / 4096 / 16384:
# at N = 40 "warps" 0.0513 / 0.101 / 0.202 / 0.801 ms against "thread" 0.141
# / 0.155 / 0.160 / 0.291; at N = 10 0.0193 / 0.0209 / 0.0393 / 0.152
# against 0.0287 / 0.0292 / 0.0292 / 0.0608; at N = 160, 3 problems a block,
# 0.523 / 1.04 against 0.816 / 0.821 (342 and 683 blocks on 132 SMs).
_MAX_BLOCKS_PER_SM = 3
_SMS = 132
# Patterns a candidate warp: (nx, nu) = (3, 1), 1 pattern a warp, 0.0319 ms
# against 0.0767 for "thread"; (4, 3), 3 a warp, 5 problems a block, 0.850
# against 1.12; (5, 4), 9 a warp, 3 problems a block, 7.94 against 5.57: the
# 81 patterns' code in every warp loses to one thread a problem.
_MAX_WARP_PATTERNS = 3


def _slab_entries(nx: int, nu: int, use_ddp: bool):
    """Floats a stage of the twelve input arrays (slab_entries of
    ``csrc/riccati_warps.cuh``); 0 for the second-order ones without DDP."""
    second = (nx * nx * nx, nx * nu * nx, nx * nu * nu)
    return (nx * nx, nx * nu, nx, nu, nx * nx, nu * nu, nu * nx,
            *(second if use_ddp else (0, 0, 0)), nu, nu)


def riccati_launch_plan(N: int, nx: int, nu: int, use_ddp: bool,
                        B: Optional[int] = None,
                        variant: Optional[str] = None) -> LaunchPlan:
    """How ``riccati_backward`` launches its kernel for horizon ``N``, sizes
    ``(nx, nu)`` and batch ``B`` (one wave of blocks if not given): a rule
    on the shape.

    A block takes 8 problems, or as many fewer as their slabs, the kff/K
    staging and the exchange areas leave room for in its shared memory:
    ``"warps"`` if one fits, the batch makes at most three blocks an SM
    and a candidate warp has at most three patterns (nu <= 3), else
    ``"thread"`` (the limits are measurements, stated at the constants
    above).  A block has one warp per share of the 3^nu active-set patterns
    (3 for nu = 1, else 9) and one more for the rest of the stage.
    ``variant`` forces one (for a comparison on the card); a forced
    ``"warps"`` that does not fit raises ``ValueError``.  The plan's
    ``layout`` is WarpsLayout of ``csrc/riccati_warps.cuh`` from ``in`` on,
    in floats, computed here and nowhere else: per input array the offset of
    problem 0's chunk and the stride between problems' chunks (multiples of
    4 floats, for the 16-byte copies; the stride 4 modulo 32, so that 8
    problems read 8 different banks), the offsets and odd per-problem
    strides of the kff and K staging areas, the offsets of the two exchange
    areas, and the total.
    """
    check_riccati_size(nx, nu)
    if variant is not None and variant not in RICCATI_VARIANTS:
        raise ValueError(f"unknown Riccati variant {variant!r}")
    cand_warps = 3 if nu == 1 else 9       # kCandWarps of riccati_warps.cuh
    threads = 32 * (cand_warps + 1)

    def layout(pb):
        pad = lambda n: n + (4 - n) % 32 if _PAD_BANKS else (n + 3) // 4 * 4
        strides = [pad(N * e) if e else 0
                   for e in _slab_entries(nx, nu, use_ddp)]
        offsets = [0]
        for s in strides:
            offsets.append(offsets[-1] + pb * s)
        skff, sK = (N * nu) | 1, (N * nu * nx) | 1
        okff = offsets.pop()
        oK = okff + pb * skff
        xu = oK + pb * sK
        xc = xu + pb * (nu + nu * nu)
        total = xc + pb * cand_warps * (2 + nu)
        return (*offsets, *strides, okff, oK, skff, sK, xu, xc, total)

    smem = lambda pb: 4 * layout(pb)[-1]
    if variant != "thread":
        pb = _BLOCK_PROBLEMS
        while pb > 1 and smem(pb) > SMEM_MAX_BYTES:
            pb -= 1
        blocks = -(-(B or 1) // pb)
        if smem(pb) <= SMEM_MAX_BYTES and (variant or (
                blocks <= _MAX_BLOCKS_PER_SM * _SMS
                and 3 ** nu <= _MAX_WARP_PATTERNS * cand_warps)):
            return LaunchPlan("warps", pb, threads, smem(pb), layout(pb))
        if variant is not None:
            raise ValueError(f'variant "warps" needs {smem(1)} bytes of shared '
                             f"memory for one problem at N={N}, (nx, nu)="
                             f"({nx}, {nu}), use_ddp={use_ddp}; a block has "
                             f"{SMEM_MAX_BYTES}")
    return LaunchPlan("thread", 64, 64, 0)   # kThreads of the C entry


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def riccati_backward_torch(derivs, dlb, dub, gN, HN, reg, ddp_scale=None, *,
                           nx: int, nu: int, use_ddp: bool = True,
                           tol: float = 1e-8):
    """Plain PyTorch batched Riccati backward (same contract as the kernel).

    Args:
      derivs: dict of (B, N, ...) stage derivatives (fx, fu, lx, lu, lxx,
        luu, lux [, fxx, fux, fuu]).
      dlb, dub: (B, N, nu) delta-control bounds; +-inf allowed.
      gN, HN: (B, nx), (B, nx, nx) terminal value gradient / Hessian.
      reg: (B,) Levenberg regularization added to Quu.
      ddp_scale: (B,) 0/1 scale of the second-order terms (default 1).

    Returns (kff (B, N, nu), K (B, N, nu, nx), dV1 (B,), dV2 (B,), gmax (B,)).
    """
    if derivs["fx"].is_cuda:
        riccati_backward_torch.cuda_calls += 1
    B, N = derivs["fx"].shape[:2]
    dt, dev = gN.dtype, gN.device
    if ddp_scale is None:
        ddp_scale = torch.ones((B,), dtype=dt, device=dev)
    eye = torch.eye(nu, dtype=dt, device=dev)
    rg = reg[:, None, None] * eye
    ds = ddp_scale[:, None, None]
    Vx, Vxx = gN, HN
    dV1 = torch.zeros((B,), dtype=dt, device=dev)
    dV2 = torch.zeros((B,), dtype=dt, device=dev)
    gmax = torch.zeros((B,), dtype=dt, device=dev)
    kffs = torch.empty((B, N, nu), dtype=dt, device=dev)
    Ks = torch.empty((B, N, nu, nx), dtype=dt, device=dev)
    for k in reversed(range(N)):
        fx, fu, lx, lu, lxx, luu, lux = (derivs[n][:, k] for n in _STAGE_KEYS)
        lo, hi = dlb[:, k], dub[:, k]
        fxT, fuT = fx.transpose(-1, -2), fu.transpose(-1, -2)
        Qx = lx + _mv(fxT, Vx)
        Qu = lu + _mv(fuT, Vx)
        Qxx = lxx + fxT @ Vxx @ fx
        Quu = luu + fuT @ Vxx @ fu + rg
        Qux = lux + fuT @ Vxx @ fx
        if use_ddp:
            fxx, fux, fuu = (derivs[n][:, k] for n in _DDP_KEYS)
            Qxx = Qxx + ds * torch.einsum("bi,bijk->bjk", Vx, fxx)
            Qux = Qux + ds * torch.einsum("bi,bijk->bjk", Vx, fux)
            Quu = Quu + ds * torch.einsum("bi,bijk->bjk", Vx, fuu)
        kff, K, _ = _stage_boxqp_with_gain(Quu, Qu, Qux, lo, hi, tol)
        pg = -torch.clamp(-Qu, lo, hi)
        dV1 = dV1 + (kff * Qu).sum(-1)
        dV2 = dV2 + 0.5 * (_mv(Quu.transpose(-1, -2), kff) * kff).sum(-1)
        KT, QuxT = K.transpose(-1, -2), Qux.transpose(-1, -2)
        Vx_n = Qx + _mv(KT @ Quu, kff) + _mv(KT, Qu) + _mv(QuxT, kff)
        Vxx_n = Qxx + KT @ Quu @ K + KT @ Qux + QuxT @ K
        gmax = torch.maximum(gmax, pg.abs().amax(-1))
        Vx, Vxx = Vx_n, 0.5 * (Vxx_n + Vxx_n.transpose(-1, -2))
        kffs[:, k] = kff
        Ks[:, k] = K
    return kffs, Ks, dV1, dV2, gmax


riccati_backward_torch.cuda_calls = 0


def _launch(derivs, dlb, dub, gN, HN, reg, ddp_scale, nx, nu, use_ddp, tol,
            variant, timed=False):
    """Check the arguments, plan and launch K1's C entry at (nx, nu); returns
    the outputs and the plan.  With ``timed`` the launch is of the ``"warps"``
    kernel's timing instantiation and the block cycles are appended to the
    outputs."""
    fx = derivs["fx"]
    if not fx.is_cuda:
        raise ValueError(f"riccati_backward: unsupported device {fx.device}")
    B, N = fx.shape[:2]
    if ddp_scale is None:
        ddp_scale = torch.ones((B,), dtype=torch.float32, device=fx.device)
    shapes = {
        "fx": (B, N, nx, nx), "fu": (B, N, nx, nu), "lx": (B, N, nx),
        "lu": (B, N, nu), "lxx": (B, N, nx, nx), "luu": (B, N, nu, nu),
        "lux": (B, N, nu, nx), "fxx": (B, N, nx, nx, nx),
        "fux": (B, N, nx, nu, nx), "fuu": (B, N, nx, nu, nu),
    }
    keys = _STAGE_KEYS + (_DDP_KEYS if use_ddp else ())
    named = [(k, derivs[k], shapes[k]) for k in keys] + [
        ("dlb", dlb, (B, N, nu)), ("dub", dub, (B, N, nu)),
        ("gN", gN, (B, nx)), ("HN", HN, (B, nx, nx)), ("reg", reg, (B,)),
        ("ddp_scale", ddp_scale, (B,))]
    check_args("riccati_backward", fx.device, named)
    plan = riccati_launch_plan(N, nx, nu, use_ddp, B, variant)

    entry = riccati_entry(nx, nu)
    opts = dict(dtype=torch.float32, device=fx.device)
    kff = torch.empty((B, N, nu), **opts)
    K = torch.empty((B, N, nu, nx), **opts)
    dV1, dV2, gmax = (torch.empty((B,), **opts) for _ in range(3))
    out = (kff, K, dV1, dV2, gmax)
    clocks = None
    if timed:
        clocks = torch.zeros((-(-B // plan.problems), len(CLOCK_PARTS)),
                             dtype=torch.int64, device=fx.device)
        out += (clocks,)
    ptr = lambda name: derivs[name].data_ptr() if name in keys else None
    with torch.cuda.device(fx.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry(
            nx, nu, int(use_ddp), B, N, float(tol),
            *(ptr(k) for k in _STAGE_KEYS + _DDP_KEYS),
            dlb.data_ptr(), dub.data_ptr(), gN.data_ptr(), HN.data_ptr(),
            reg.data_ptr(), ddp_scale.data_ptr(),
            kff.data_ptr(), K.data_ptr(), dV1.data_ptr(), dV2.data_ptr(),
            gmax.data_ptr(), RICCATI_VARIANTS.index(plan.variant),
            plan.problems, plan.c_layout(),
            None if clocks is None else clocks.data_ptr(), stream)
    check_launch(rc, f"mv_riccati_backward_{nx}x{nu}")
    return out, plan


def riccati_backward(derivs, dlb, dub, gN, HN, reg, ddp_scale=None, *,
                     nx: int, nu: int, use_ddp: bool = True,
                     tol: float = 1e-8, variant: Optional[str] = None):
    """Batched Riccati backward: the CUDA kernel for CUDA tensors.

    Same arguments and results as ``riccati_backward_torch``, which is what
    runs when the tensors lie on the CPU.  CUDA tensors must be contiguous
    float32; anything else raises.  The kernel's variant is
    ``riccati_launch_plan``'s choice for the shape; ``variant`` forces
    another for a comparison on the card (the solvers never pass it).
    ``launches`` counts every launch and ``launches_by_variant`` the
    launches of each variant.  Any nx >= 1 and 1 <= nu <= 4, on either
    device: nu > 4 raises ``NotImplementedError``, as the JAX kernel does.
    """
    check_riccati_size(nx, nu)
    if derivs["fx"].device.type == "cpu":
        return riccati_backward_torch(derivs, dlb, dub, gN, HN, reg,
                                      ddp_scale, nx=nx, nu=nu,
                                      use_ddp=use_ddp, tol=tol)
    out, plan = _launch(derivs, dlb, dub, gN, HN, reg, ddp_scale, nx, nu,
                        use_ddp, tol, variant)
    riccati_backward.launches += 1
    riccati_backward.launches_by_variant[plan.variant] += 1
    return out


riccati_backward.launches = 0
riccati_backward.launches_by_variant = dict.fromkeys(RICCATI_VARIANTS, 0)


def riccati_backward_cast(derivs, dlb, dub, gN, HN, reg, ddp_scale=None, *,
                          nx: int, nu: int, use_ddp: bool = True,
                          tol: float = 1e-8):
    """``riccati_backward`` on inputs of any float dtype, as
    ``riccati_backward_pallas`` takes them: CUDA tensors of another dtype
    than float32 go to the kernel as float32 copies, and kff, K, dV1, dV2
    and gmax come back in the inputs' dtype.  CPU tensors run the twin in
    their own dtype, as ``riccati_backward`` does."""
    dt = derivs["fx"].dtype
    kw = dict(nx=nx, nu=nu, use_ddp=use_ddp, tol=tol)
    if derivs["fx"].device.type == "cpu" or dt == torch.float32:
        return riccati_backward(derivs, dlb, dub, gN, HN, reg, ddp_scale, **kw)
    f32 = lambda t: None if t is None else t.to(torch.float32).contiguous()
    out = riccati_backward({k: f32(v) for k, v in derivs.items()}, f32(dlb),
                           f32(dub), f32(gN), f32(HN), f32(reg),
                           f32(ddp_scale), **kw)
    return tuple(o.to(dt) for o in out)


def riccati_stage_clocks(derivs, dlb, dub, gN, HN, reg, ddp_scale=None, *,
                         tol: float = 1e-8):
    """A measurement aid: one launch of the ``"warps"`` kernel's timing
    instantiation (nx = 3, nu = 2, DDP; the same body with ``clock64()``
    reads, which the solvers' kernel does not carry) on
    ``riccati_backward``'s arguments.  Returns an int64 tensor
    (blocks, 9), blocks = ceil(B / plan.problems) of the forced ``"warps"``
    plan: each block's clock cycles in ``CLOCK_PARTS`` order: the load of
    the slabs; summed over the N stages, the stage warp's expand_u, expand_x
    (with the first barrier), its wait for the candidate warps (to the first
    of their results read), its merge of their results, the gain and the
    rest of the stage; the write-out; and candidate warp 0's cycles from
    the Qu it reads to its result.
    Not counted in ``riccati_backward.launches``."""
    out, _ = _launch(derivs, dlb, dub, gN, HN, reg, ddp_scale, 3, 2, True,
                     tol, "warps", timed=True)
    return out[-1]
