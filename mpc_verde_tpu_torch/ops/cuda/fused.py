"""Fused stage derivatives + Riccati backward pass: CUDA kernel K3 and its PyTorch twin.

``fused_backward`` replaces the Pallas TPU kernel ``make_fused_backward``
(``mpc_verde_tpu/ops/pallas/fused.py``).  From the trajectory alone (xs, us,
ps) it computes every stage derivative, the terminal value and the control
box, and runs the box-constrained Riccati backward pass: the outputs of
``riccati_backward`` without the derivative tensors ever reaching device
memory.

Its kernel is ``csrc/fused.cu``: one thread per problem walks the stages
N-1..0, evaluates the OCP's ``UnicycleDeviceModel`` (``csrc/unicycle.cuh``,
the model K2 evaluates) on second-order forward-mode dual numbers
(``csrc/dual.cuh``) over z = [x; u], and hands the derivatives in registers
to K1's stage recursion (``backward_stage`` in ``csrc/riccati.cuh``).  At
the bench shapes (B = 1024, N = 40) the card is latency bound on that
per-thread chain (1024 threads on 16 of 132 SMs, 250 registers each).

``fused_backward_torch`` is the plain PyTorch version: the port's
``derivs`` -> ``backward`` on the OCP's own callables
(``ops.linearize.trajectory_derivatives``, then ``riccati_backward_torch``).
"""
from __future__ import annotations

import torch

from ..linearize import trajectory_derivatives
from .build import check_args, check_launch, load_library
from .riccati import riccati_backward_torch


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


def fused_backward(xs, us, ps, reg, ddp_scale=None, *, ocp,
                   use_ddp: bool = True, tol: float = 1e-8):
    """Fused derivs + backward: the CUDA kernel for CUDA tensors.

    Same arguments and results as ``fused_backward_torch``, which is what
    runs when the tensors lie on the CPU.  On the card the kernel evaluates
    ``ocp.device_model`` (its dynamics, stage cost, terminal weight and
    control box); an OCP without one raises ``NotImplementedError``.  CUDA
    tensors must be contiguous float32.
    """
    if xs.device.type == "cpu":
        return fused_backward_torch(xs, us, ps, reg, ddp_scale, ocp=ocp,
                                    use_ddp=use_ddp, tol=tol)
    if not xs.is_cuda:
        raise ValueError(f"fused_backward: unsupported device {xs.device}")
    model = ocp.device_model
    if model is None:
        raise NotImplementedError(
            "fused_backward on CUDA needs ocp.device_model (the kernel "
            "cannot differentiate Python callables)")
    B, N, nu = us.shape
    nx, npar = xs.shape[-1], ps.shape[-1]
    if (nx, nu) != (3, 2) or npar < 3:
        raise ValueError("the unicycle device model needs nx=3, nu=2, npar>=3")
    if ddp_scale is None:
        ddp_scale = torch.ones((B,), dtype=torch.float32, device=xs.device)
    named = [("xs", xs, (B, N + 1, nx)), ("us", us, (B, N, nu)),
             ("ps", ps, (B, N + 1, npar)), ("reg", reg, (B,)),
             ("ddp_scale", ddp_scale, (B,))]
    check_args("fused_backward", xs.device, named)

    lib = load_library()
    opts = dict(dtype=torch.float32, device=xs.device)
    kff = torch.empty((B, N, nu), **opts)
    K = torch.empty((B, N, nu, nx), **opts)
    dV1, dV2, gmax = (torch.empty((B,), **opts) for _ in range(3))
    c_model, substeps, euler, has_terminal = model.kernel_args()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mv_fused_backward(
            int(use_ddp), B, N, npar, float(tol), xs.data_ptr(),
            us.data_ptr(), ps.data_ptr(), reg.data_ptr(), ddp_scale.data_ptr(),
            c_model, substeps, euler, has_terminal, kff.data_ptr(),
            K.data_ptr(), dV1.data_ptr(), dV2.data_ptr(), gmax.data_ptr(),
            stream)
    check_launch(rc, "mv_fused_backward")
    fused_backward.launches += 1
    return kff, K, dV1, dV2, gmax


fused_backward.launches = 0
