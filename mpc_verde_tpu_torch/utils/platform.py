"""What the GPU host offers: card, power limit and toolchain; where the
scenarios run."""
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


def scenario_device(device, entry: str) -> torch.device:
    """The device a scenario entry point runs on: ``device`` when given,
    else the CUDA device.  Without one it raises and names ``device="cpu"``:
    a scenario runs on the CPU only when asked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{entry} runs on the CUDA device by default and none is "
                'available; pass device="cpu" to run it on the CPU')
        device = "cuda"
    return torch.device(device)
