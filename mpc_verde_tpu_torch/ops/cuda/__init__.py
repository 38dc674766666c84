"""Hand-written Hopper kernels, each beside its plain PyTorch twin.

The wrappers launch the kernel for CUDA tensors and run the twin for CPU
tensors; the kernels are built on first use (``build.py``).
"""
from .fused import fused_backward, fused_backward_torch
from .refill import refill_slots, refill_slots_torch
from .riccati import riccati_backward, riccati_backward_torch
from .rollout import (UnicycleDeviceModel, linesearch_forward,
                      linesearch_forward_torch, trajectory_cost,
                      trajectory_cost_torch)
