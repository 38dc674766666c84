"""The card a run measures: its presence, name and power limit, and the
clock steps are timed with.

A run needs as many CUDA devices as its cell asks for and fails without
them: nothing falls back to the CPU.  The CPU path of ``Clock`` exists for
the harness's own tests, which drive a cell on the CPU at a tiny size and
publish no time.
"""
from __future__ import annotations

import subprocess
import time

import torch


class NoCard(RuntimeError):
    """The run found fewer CUDA devices than its cell asks for."""


def require_cards(count: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark "
                     "measures the port on an NVIDIA card and runs nowhere "
                     "else")
    found = torch.cuda.device_count()
    if found < count:
        raise NoCard(f"the cell asks for {count} CUDA devices and "
                     f"torch.cuda.device_count() is {found}")


def card_info() -> dict:
    """Name and power limit of card 0 as ``nvidia-smi`` reads them, beside
    the name PyTorch gives.  Raises when ``nvidia-smi`` finds no card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, limit = (s.strip() for s in out.strip().splitlines()[0].split(","))
    return {"kind": torch.cuda.get_device_name(0), "smi_name": name,
            "power_limit_w": float(limit)}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Marks at the boundaries of consecutive steps.  On the card each mark
    is a CUDA event recorded on the current stream, so a step's time is
    read from the device's clock (to about a microsecond) and takes in
    whatever kept the device waiting between steps; on the CPU a mark is
    the host's clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        """Milliseconds between consecutive marks (synchronizes first)."""
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                      self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]
