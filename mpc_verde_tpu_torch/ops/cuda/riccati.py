"""Batched box-constrained Riccati backward pass: CUDA kernel K1 and its PyTorch twin.

``riccati_backward`` replaces the Pallas TPU kernel ``riccati_backward_pallas``
(``mpc_verde_tpu/ops/pallas/riccati.py``).  Its kernel is
``csrc/riccati.cu``: one thread per problem walks the stages N-1..0 with
(Vx, Vxx) in registers, and the 3^nu stage box-QP patterns are unrolled at
compile time for (nx, nu) in {(3, 1), (3, 2), (4, 3), (5, 4)}.  At the bench
shapes (B = 1024, N = 40) the card is latency bound on that per-thread
stage chain; the derivative loads keep the JAX (B, N, ...) layout and do not
coalesce.  A problem-fastest (SoA) layout is left for a later change.

``riccati_backward_torch`` is the plain PyTorch version: the batched form
of the JAX ``"xla"`` backward (``mpc_verde_tpu/solver/batched.py``), on any
device and dtype.
"""
from __future__ import annotations

import torch

from ...solver.ilqr import _stage_boxqp_with_gain
from .build import check_args, check_launch, load_library

SUPPORTED = {(3, 1), (3, 2), (4, 3), (5, 4)}

_STAGE_KEYS = ("fx", "fu", "lx", "lu", "lxx", "luu", "lux")
_DDP_KEYS = ("fxx", "fux", "fuu")


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


def riccati_backward(derivs, dlb, dub, gN, HN, reg, ddp_scale=None, *,
                     nx: int, nu: int, use_ddp: bool = True,
                     tol: float = 1e-8):
    """Batched Riccati backward: the CUDA kernel for CUDA tensors.

    Same arguments and results as ``riccati_backward_torch``, which is what
    runs when the tensors lie on the CPU.  CUDA tensors must be contiguous
    float32; anything else raises.
    """
    fx = derivs["fx"]
    if fx.device.type == "cpu":
        return riccati_backward_torch(derivs, dlb, dub, gN, HN, reg,
                                      ddp_scale, nx=nx, nu=nu,
                                      use_ddp=use_ddp, tol=tol)
    if not fx.is_cuda:
        raise ValueError(f"riccati_backward: unsupported device {fx.device}")
    if (nx, nu) not in SUPPORTED:
        raise NotImplementedError(
            f"riccati_backward kernel is built for (nx, nu) in "
            f"{sorted(SUPPORTED)}, not ({nx}, {nu})")
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

    lib = load_library()
    opts = dict(dtype=torch.float32, device=fx.device)
    kff = torch.empty((B, N, nu), **opts)
    K = torch.empty((B, N, nu, nx), **opts)
    dV1, dV2, gmax = (torch.empty((B,), **opts) for _ in range(3))
    ptr = lambda name: derivs[name].data_ptr() if name in keys else None
    with torch.cuda.device(fx.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mv_riccati_backward(
            nx, nu, int(use_ddp), B, N, float(tol),
            *(ptr(k) for k in _STAGE_KEYS + _DDP_KEYS),
            dlb.data_ptr(), dub.data_ptr(), gN.data_ptr(), HN.data_ptr(),
            reg.data_ptr(), ddp_scale.data_ptr(),
            kff.data_ptr(), K.data_ptr(), dV1.data_ptr(), dV2.data_ptr(),
            gmax.data_ptr(), stream)
    check_launch(rc, "mv_riccati_backward")
    riccati_backward.launches += 1
    return kff, K, dV1, dV2, gmax


riccati_backward.launches = 0
