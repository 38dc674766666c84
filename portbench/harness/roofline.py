"""The card's peaks and the least time of a kernel's work.

Frozen from ``chip_smoke.py`` (``_bound``, ``K2_STEP_FLOPS``,
``K3_STAGE_FLOPS``, ``TERM_FLOPS``), so that the yardstick stays where
later changes to the program cannot move it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W power
limit): 3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the tensor
cores.  A run states the card's name and power limit beside them, as
``nvidia-smi`` reads them.

Operations per unit of work, counted from the kernels' arithmetic with a
full-precision sinf, cosf or logf taken as 16: one clipped closed-loop RK4
step of the unicycle with its stage cost (K2, the line search and the
pre-roll); one stage of the Riccati recursion with the stage's
dual-number derivatives, nx = 3, nu = 2 (K3).  The barrier term adds its
four logs per step (K2) and, on second-order duals over z = [x; u], 400
per stage (K3).
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
PEAKS = {"hbm_bytes_s": HBM_BYTES_S, "fp32_flop_s": FP32_FLOP_S,
         "part": "NVIDIA H100 SXM, 700 W"}

K2_STEP_FLOPS, K3_STAGE_FLOPS = 250, 4000
TERM_FLOPS = {"barrier": (80, 400)}   # (K2 step, K3 stage)
FLOAT_BYTES = 4


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: each input byte read once and
    each output byte written once at the memory rate, or the operations at
    the float32 peak, whichever is larger."""
    return max(n_bytes / HBM_BYTES_S, flops / FP32_FLOP_S)


def k3_least_s(rows: int, N: int, nx: int, nu: int, npar: int,
               terms=()) -> float:
    """One launch of K3 (stage derivatives and the backward pass) over
    ``rows`` problems of N stages: reads xs, us, ps, reg and the DDP
    switch; writes kff, K, dV1, dV2 and gmax."""
    n_in = (N + 1) * nx + N * nu + (N + 1) * npar + 2
    n_out = N * nu + N * nu * nx + 3
    flops = rows * N * (K3_STAGE_FLOPS + sum(TERM_FLOPS[t][1] for t in terms))
    return bound_s(FLOAT_BYTES * rows * (n_in + n_out), flops)


def k2_least_s(rows: int, N: int, A: int, nx: int, nu: int, npar: int,
               terms=()) -> float:
    """One launch of K2 over ``rows`` problems, N stages and A step
    lengths (A = 1 with zero gains is the pre-roll): reads x0, xs, us, ps,
    kff and K; writes the winners' xs and us, their cost and index."""
    n_in = nx + (N + 1) * nx + N * nu + (N + 1) * npar + N * nu + N * nu * nx
    n_out = (N + 1) * nx + N * nu + 2
    flops = rows * A * N * (K2_STEP_FLOPS
                            + sum(TERM_FLOPS[t][0] for t in terms))
    return bound_s(FLOAT_BYTES * rows * (n_in + n_out), flops)
