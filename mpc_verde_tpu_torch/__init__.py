"""mpc_verde_tpu_torch — the PyTorch / CUDA port of ``mpc_verde_tpu``.

Module paths mirror the JAX package; the JAX package stays the reference
the port is tested against.  This package imports torch and numpy, never
jax.  Its main path is the streaming box-DDP solver: torch.func stage
derivatives, and two hand-written CUDA kernels for the H100 (``ops/cuda``:
the Riccati backward pass and the fused line search / pre-roll).  The
``"cuda_fused"`` backend replaces the derivatives and the backward pass with
a third kernel that computes both; the closed-loop driver (``runtime``) and
the fleet scenario (``scenarios.fleet``) run on it.  State bounds run the
augmented-Lagrangian rounds, and the interior-point solvers
(``solver.ipm``) the barrier continuation; the kernels evaluate both terms.
"""

__version__ = "0.1.0"

from .ocp import OCP, box_bounds, to_rate_form
from .solver import (ILQROptions, ILQRResult, make_barrier_solver,
                     make_batched_ilqr_solver, make_ilqr_solver,
                     make_streaming_barrier_solver, make_streaming_solver)
