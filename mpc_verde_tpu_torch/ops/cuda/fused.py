"""Fused stage derivatives + Riccati backward pass: CUDA kernel K3 and its PyTorch twin.

``fused_backward`` replaces the Pallas TPU kernel ``make_fused_backward``
(``mpc_verde_tpu/ops/pallas/fused.py``).  From the trajectory alone (xs, us,
ps) it computes every stage derivative, the terminal value and the control
box, and runs the box-constrained Riccati backward pass: the outputs of
``riccati_backward`` without the derivative tensors ever reaching device
memory.

Its kernel is ``csrc/fused.cu``, two phases in one launch.  In phase 1 a
block's threads take its problems' stages one (problem, stage) at a time:
each evaluates the OCP's device model (``UnicycleDeviceModel``,
``csrc/unicycle.cuh``, or for an OCP without one the ``TracedDeviceModel``
generated from its callables, ``codegen.py``: the models K2 evaluates; the
kernels, templates on the model, are in ``csrc/fused.cuh``) on second-order
forward-mode dual numbers (``csrc/dual.cuh``) over z = [x; u] and stores
the stage's derivatives as one record in shared memory.  In phase 2 one
thread per problem walks the stages N-1..0 with K1's stage recursion
(``backward_stage`` in ``csrc/riccati.cuh``) on those records, and the gains
leave through a shared-memory staging area as coalesced slabs.  ``fused_launch_plan`` picks
the variant from the shape alone: ``"staged"`` as described, and
``"thread"`` (one thread per problem, each stage's derivatives computed in
registers just before its stage QP) for horizons at which fewer than 4
problems' records fit a block's shared memory and for batches whose
``"staged"`` blocks would take more than two waves.

``fused_backward_torch`` is the plain PyTorch version: the port's
``derivs`` -> ``backward`` on the OCP's own callables
(``ops.linearize.trajectory_derivatives``, then ``riccati_backward_torch``).
``dual_chain`` is the PyTorch twin of the dual numbers' chain rule.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..linearize import trajectory_derivatives
from .build import SMEM_MAX_BYTES, LaunchPlan, check_args, check_launch
from .riccati import riccati_backward_torch
from .rollout import kernel_model, model_entry

FUSED_VARIANTS = ("thread", "staged")  # the C entry's ids
# The plan's constants follow measurements on the H100
# (utils/tune_launch_plans.py, DDP, B = 1024 unless said).
# Problems a block: at N = 40, 8 take 0.074 ms, 4 and 2 take 0.137 ms (their
# blocks no longer run in one wave) and more do not fit; at N = 10, 2 to 16
# are equal.  With fewer than 4 a block "thread" is the faster: 1.03 ms
# against 0.83 ms at N = 160, where "staged" still won at N = 150 with 4.
_BLOCK_PROBLEMS = 8
_MIN_PROBLEMS = 4
# Waves: a "staged" block is large, so an SM holds one (N = 40) or two
# (N = 10) and a wide batch takes them in turn, while the small "thread"
# blocks all run at once.  At N = 40, B = 1024 / 2048 / 4096 / 16384 take
# 0.075 / 0.146 / 0.287 / 1.141 ms against 0.210 / 0.225 / 0.226 / 0.259 ms,
# and at N = 10 "staged" wins up to B = 4096: two waves are the most.  What
# an SM holds at once is set by its shared memory (each block takes 1 KB
# besides its own) and its registers (250 a thread, allotted as 256).
_MAX_WAVES = 2
_SMS, _SM_SMEM_BYTES, _SM_REGISTERS, _THREAD_REGISTERS = 132, 233_472, 65_536, 256
_MAX_THREADS = 256    # kMaxThreads in csrc/fused.cu: 255 registers a thread


# (f, f', f'') at a of the scalar functions of csrc/dual.cuh, as its mv_*
# functions hand them to chain(): the twins of its formulas
CHAIN_COEFFS = {
    "sin": lambda a: (torch.sin(a), torch.cos(a), -torch.sin(a)),
    "cos": lambda a: (torch.cos(a), -torch.sin(a), -torch.cos(a)),
    "tan": lambda a: (torch.tan(a), 1.0 + torch.tan(a) ** 2,
                      2.0 * torch.tan(a) * (1.0 + torch.tan(a) ** 2)),
    "log": lambda a: (torch.log(a), 1.0 / a, -(1.0 / a) ** 2),
    "recip": lambda a: (1.0 / a, -(1.0 / a) ** 2, 2.0 * (1.0 / a) ** 3),
    "exp": lambda a: (torch.exp(a), torch.exp(a), torch.exp(a)),
    "sqrt": lambda a: (torch.sqrt(a), 0.5 / torch.sqrt(a),
                       -0.25 / torch.sqrt(a) ** 3),
    "abs": lambda a: (torch.abs(a), torch.sign(a), torch.zeros_like(a)),
}


def dual_chain(name: str, v, g, H):
    """``f(a)`` on a second-order dual number as ``chain`` in
    ``csrc/dual.cuh`` computes it, f one of ``CHAIN_COEFFS``: from a's value
    ``v`` (...), gradient ``g`` (..., nz) and Hessian ``H`` (..., nz, nz), the
    value f(v), the gradient f'(v) g and the Hessian f'(v) H + f''(v) g g'."""
    f0, f1, f2 = CHAIN_COEFFS[name](v)
    return (f0, f1[..., None] * g,
            f1[..., None, None] * H
            + f2[..., None, None] * (g[..., :, None] * g[..., None, :]))


def fused_launch_plan(N: int, use_ddp: bool, variant: Optional[str] = None,
                      B: Optional[int] = None, *, nx: int = 3,
                      nu: int = 2) -> LaunchPlan:
    """How ``fused_backward`` launches its kernel for horizon ``N``, batch
    ``B`` (one wave of blocks if not given) and the model's sizes ``(nx,
    nu)`` (the unicycle's by default): a rule on the shape.

    A block takes 8 problems, halved until their N stage records and kff/K
    staging fit its shared memory: ``"staged"`` if at least 4 fit and the
    batch's blocks run in at most two waves, else ``"thread"`` (both limits
    are measurements, stated at the constants above).  A block's threads
    share the problems x N stages of phase 1 in equal turns of at most 256
    threads (a multiple of 32).
    ``variant`` forces one (for a comparison on the card); a forced
    ``"staged"`` that does not fit raises ``ValueError``.  The plan's
    ``layout`` holds the per-problem strides of the records and of the kff
    and K staging areas (StagedLayout of ``csrc/fused.cu``), computed here
    and nowhere else: the C entry point takes them as they are.
    """
    if variant is not None and variant not in FUSED_VARIANTS:
        raise ValueError(f"unknown fused-backward variant {variant!r}")
    nz = nx + nu
    tri = nz * (nz + 1) // 2
    # SharedStage's record (csrc/riccati.cuh, kStride): the dynamics'
    # gradients (and Hessian triangles with DDP), the cost's gradient and
    # triangle, lo and hi.  Every stride is odd, so that neither phase's
    # lanes meet in a shared-memory bank.
    record = (nx * (nz + (tri if use_ddp else 0)) + nz + tri + 2 * nu) | 1
    strides = ((N * record) | 1, (N * nu) | 1, (N * nu * nx) | 1)
    smem = lambda pb: 4 * pb * sum(strides)
    if variant != "thread":
        pb = _BLOCK_PROBLEMS
        while pb > 1 and smem(pb) > SMEM_MAX_BYTES:
            pb //= 2
        turns = -(-pb * N // _MAX_THREADS)
        threads = max(32, (-(-pb * N // turns) + 31) // 32 * 32)
        resident = max(1, min(_SM_SMEM_BYTES // (smem(pb) + 1024),
                              _SM_REGISTERS // (threads * _THREAD_REGISTERS)))
        waves = -(-(-(-(B or 1) // pb)) // (_SMS * resident))
        if smem(pb) <= SMEM_MAX_BYTES and (variant or (
                pb >= _MIN_PROBLEMS and waves <= _MAX_WAVES)):
            return LaunchPlan("staged", pb, threads, smem(pb), strides)
        if variant is not None:
            raise ValueError(f'variant "staged" needs {smem(1)} bytes of shared '
                             f"memory for one problem at N={N}, "
                             f"use_ddp={use_ddp}, (nx, nu)=({nx}, {nu}); a "
                             f"block has {SMEM_MAX_BYTES}")
    return LaunchPlan("thread", 64, 64, 0)   # kThreads of the C entry


def fused_backward_torch(xs, us, ps, reg, ddp_scale=None, *, ocp,
                         use_ddp: bool = True, tol: float = 1e-8):
    """Plain PyTorch derivs + backward on ``ocp`` (same contract as the kernel).

    Args:
      xs: (B, N+1, nx) states; us: (B, N, nu) controls; ps: (B, N+1, npar).
      reg: (B,) Levenberg regularization added to Quu.
      ddp_scale: (B,) 0/1 scale of the second-order terms (default 1).

    Returns (kff (B, N, nu), K (B, N, nu, nx), dV1 (B,), dV2 (B,), gmax (B,)).
    """
    if xs.is_cuda:
        fused_backward_torch.cuda_calls += 1
    d, gN, HN, dlb, dub = trajectory_derivatives(ocp, xs, us, ps,
                                                 second_order=use_ddp)
    return riccati_backward_torch(d, dlb, dub, gN, HN, reg, ddp_scale,
                                  nx=ocp.nx, nu=ocp.nu, use_ddp=use_ddp,
                                  tol=tol)


fused_backward_torch.cuda_calls = 0


def _launch(xs, us, ps, reg, ddp_scale, ocp, use_ddp, tol, variant,
            timed=False):
    """Check the arguments, plan and launch ``mv_fused_backward``; returns
    the outputs and the plan.  With ``timed`` the launch is of the kernel's
    timing instantiation and the block cycles are appended to the outputs."""
    if not xs.is_cuda:
        raise ValueError(f"fused_backward: unsupported device {xs.device}")
    model = kernel_model(ocp)
    B, N, nu = us.shape
    nx, npar = xs.shape[-1], ps.shape[-1]
    if (nx, nu) != (model.nx, model.nu) or npar < model.min_npar:
        raise ValueError(f"the {type(model).__name__} needs nx={model.nx}, "
                         f"nu={model.nu}, npar>={model.min_npar}")
    if ddp_scale is None:
        ddp_scale = torch.ones((B,), dtype=torch.float32, device=xs.device)
    named = [("xs", xs, (B, N + 1, nx)), ("us", us, (B, N, nu)),
             ("ps", ps, (B, N + 1, npar)), ("reg", reg, (B,)),
             ("ddp_scale", ddp_scale, (B,))]
    check_args("fused_backward", xs.device, named)
    plan = fused_launch_plan(N, use_ddp, variant, B, nx=nx, nu=nu)

    launch = model_entry(model, "mv_fused_backward")
    opts = dict(dtype=torch.float32, device=xs.device)
    kff = torch.empty((B, N, nu), **opts)
    K = torch.empty((B, N, nu, nx), **opts)
    dV1, dV2, gmax = (torch.empty((B,), **opts) for _ in range(3))
    out = (kff, K, dV1, dV2, gmax)
    clocks = None
    if timed:
        clocks = torch.zeros((-(-B // plan.problems), 3), dtype=torch.int64,
                             device=xs.device)
        out += (clocks,)
    c_model, c_ints, c_tables = model.kernel_args(xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            int(use_ddp), B, N, npar, float(tol), xs.data_ptr(),
            us.data_ptr(), ps.data_ptr(), reg.data_ptr(), ddp_scale.data_ptr(),
            c_model, c_ints, c_tables, kff.data_ptr(),
            K.data_ptr(), dV1.data_ptr(), dV2.data_ptr(), gmax.data_ptr(),
            FUSED_VARIANTS.index(plan.variant), plan.problems, plan.threads,
            plan.c_layout(), None if clocks is None else clocks.data_ptr(),
            stream)
    check_launch(rc, "mv_fused_backward")
    return out, plan


def fused_backward(xs, us, ps, reg, ddp_scale=None, *, ocp,
                   use_ddp: bool = True, tol: float = 1e-8,
                   variant: Optional[str] = None):
    """Fused derivs + backward: the CUDA kernel for CUDA tensors.

    Same arguments and results as ``fused_backward_torch``, which is what
    runs when the tensors lie on the CPU.  On the card the kernel evaluates
    ``ocp.device_model`` (its dynamics, stage cost, terminal weight and
    control box), or for an OCP without one the model traced from its
    callables (``rollout.traced_device_model``, whose library builds at its
    first launch); a callable that does not lower raises
    ``NotImplementedError``, a failed build ``RuntimeError``.  CUDA tensors
    must be contiguous float32.  The kernel's variant is
    ``fused_launch_plan``'s choice for the shape; ``variant`` forces another
    for a comparison on the card (the solvers never pass it).  ``launches``
    counts every launch and ``launches_by_variant`` the launches of each
    variant.
    """
    if xs.device.type == "cpu":
        return fused_backward_torch(xs, us, ps, reg, ddp_scale, ocp=ocp,
                                    use_ddp=use_ddp, tol=tol)
    out, plan = _launch(xs, us, ps, reg, ddp_scale, ocp, use_ddp, tol, variant)
    fused_backward.launches += 1
    fused_backward.launches_by_variant[plan.variant] += 1
    return out


fused_backward.launches = 0
fused_backward.launches_by_variant = dict.fromkeys(FUSED_VARIANTS, 0)


def fused_phase_clocks(xs, us, ps, reg, ddp_scale=None, *, ocp,
                       tol: float = 1e-8):
    """A measurement aid: one launch of the ``"staged"`` DDP kernel's timing
    instantiation (the same body with four ``clock64()`` reads, which the
    solvers' kernel does not carry) on ``fused_backward``'s arguments.
    Returns an int64 tensor (blocks, 3), blocks = ceil(B / plan.problems)
    of ``fused_launch_plan(N, True, "staged")``:
    each block's clock cycles in phase 1, phase 2 and the write-out.  Not
    counted in ``fused_backward.launches``."""
    out, _ = _launch(xs, us, ps, reg, ddp_scale, ocp, True, tol, "staged",
                     timed=True)
    return out[-1]
