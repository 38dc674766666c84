"""What the GPU host offers: card, power limit and toolchain."""
from __future__ import annotations

import subprocess

import torch

from ..ops.cuda.build import _nvcc


def gpu_info() -> dict:
    """Card name and power limit (``nvidia-smi``), CUDA runtime and ``nvcc``.

    Raises when ``nvidia-smi`` or ``nvcc`` is missing or fails: there is no
    device fallback.
    """
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    return {"nvidia_smi": smi, "torch_cuda": torch.version.cuda,
            "nvcc": nvcc.splitlines()[-1]}
