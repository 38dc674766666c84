"""mpc_verde_tpu_torch — the PyTorch / CUDA port of ``mpc_verde_tpu``.

Module paths mirror the JAX package; the JAX package stays the reference
the port is tested against.  This package imports torch and numpy, never
jax.  Its main path is the streaming box-DDP solver: torch.func stage
derivatives, and two hand-written CUDA kernels for the H100 (``ops/cuda``:
the Riccati backward pass and the fused line search / pre-roll).
"""

__version__ = "0.1.0"

from .ocp import OCP, box_bounds
from .solver import (ILQROptions, ILQRResult, make_batched_ilqr_solver,
                     make_streaming_solver)
