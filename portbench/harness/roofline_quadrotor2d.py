"""The least time of K2's and K3's work on the planar quadrotor's traced
program (``programs/quadrotor2d.py``, nx 6, nu 2, npar 6).

Operations frozen from the generated program (276 instructions, hash
4ba165c1f48a2345; its step and stage cost reach 257 of them), with a
full-precision sinf or cosf taken as 16 as ``roofline.py`` takes them.
One K2 step, on floats: every instruction 1, a sin or cos 16, 313 for the
RK4 step and the stage cost, plus the feedback law and the clip,
2 nu nx + 3 nu = 30: 343.  One K3 stage: the step and the stage cost on
the second-order duals of ``csrc/dual.cuh`` over z = [x; u] (nz = 8
numbers, nh = 36 Hessian entries), each instruction at that header's cost
for its operands, a value that depends on neither x nor u staying a float
(``codegen.py``'s S): a sum or difference of two duals 1 + nz + nh (76, 1 where
one side is a float: 12), a product of two duals 1 + 3 nz + 7 nh (16), of
a dual by a float or a quotient by a float 1 + nz + nh (77), a negation
1 + nz + nh (4), a sin or cos of a dual its sinf and cosf and the chain
rule, 32 + nz + 4 nh (8): 12,981; plus the stage of the Riccati recursion,
``chip_smoke._k1_flops`` at (6, 2), 6,400: 19,381.  K3's terminal value,
one evaluation a problem and not a stage, is left out.

The bytes are counted as ``roofline.k2_least_s`` and ``k3_least_s`` count
them, each input read once and each output written once, and the peaks
are ``roofline``'s.
"""
from __future__ import annotations

from harness.roofline import FLOAT_BYTES, bound_s

K2_STEP_FLOPS, K3_STAGE_FLOPS = 343, 19381
# the struct that codegen.py names every generated device model; a
# kernel's symbol holds it where the kernel runs a traced program
MODEL = "TracedModel"


def times(trace, names) -> list:
    """Seconds of each kernel of the traced block whose name holds one of
    ``names`` and ``MODEL``; [] without a trace."""
    if not trace:
        return []
    return [s for n, s in trace["kernels"]
            if MODEL in n and any(k in n for k in names)]


def k3_least_s(rows: int, N: int, nx: int, nu: int, npar: int) -> float:
    """One launch of K3 over ``rows`` problems of N stages: reads xs, us,
    ps, reg and the DDP switch; writes kff, K, dV1, dV2 and gmax."""
    n_in = (N + 1) * nx + N * nu + (N + 1) * npar + 2
    n_out = N * nu + N * nu * nx + 3
    return bound_s(FLOAT_BYTES * rows * (n_in + n_out),
                   rows * N * K3_STAGE_FLOPS)


def k2_least_s(rows: int, N: int, A: int, nx: int, nu: int,
               npar: int) -> float:
    """One launch of K2 over ``rows`` problems, N stages and A step
    lengths (A = 1 with zero gains is the pre-roll): reads x0, xs, us, ps,
    kff and K; writes the winners' xs and us, their cost and index."""
    n_in = nx + (N + 1) * nx + N * nu + (N + 1) * npar + N * nu + N * nu * nx
    n_out = (N + 1) * nx + N * nu + 2
    return bound_s(FLOAT_BYTES * rows * (n_in + n_out),
                   rows * A * N * K2_STEP_FLOPS)
