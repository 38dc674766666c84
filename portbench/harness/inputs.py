"""The inputs of every cell, made on the run's device from ``--seed``.

Frozen copies of the program's generators, drawn with a ``torch.Generator``
on the device instead of NumPy on the host:

* ``queue_starts``: starts uniform in [-b, b]^nx, as ``chip_smoke._queue``
  (and the JAX ``bench.py``) draws them;
* ``fleet_starts``: positions uniform in [-b, b]^2 and headings uniform in
  [-pi/2, pi/2], as ``scenarios/fleet.py`` draws the fleet's starts.

Each call or episode draws from a generator of its own, seeded from the
run's seed, the stream's name and its index, so the same seed gives the
same inputs whatever else the run does, and any whole number (also one
beyond 64 bits) is a seed.
"""
from __future__ import annotations

import hashlib
import math

import torch


def substream_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for the ``index``-th draw of ``stream`` in a run."""
    h = hashlib.blake2b(f"{int(seed)}:{stream}:{int(index)}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def generator(device: torch.device, seed: int, stream: str,
              index: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(substream_seed(seed, stream, index))
    return g


def queue_starts(rows: int, nx: int, box: float, g: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """(rows, nx) float32 starts uniform in [-box, box]^nx."""
    u = torch.rand((rows, nx), generator=g, device=device, dtype=torch.float32)
    return (2.0 * box) * u - box


def fleet_starts(rows: int, box: float, g: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """(rows, 3) float32 poses: (x, y) uniform in [-box, box]^2, heading
    uniform in [-pi/2, pi/2]."""
    u = torch.rand((rows, 3), generator=g, device=device, dtype=torch.float32)
    scale = torch.tensor([2.0 * box, 2.0 * box, math.pi], device=device)
    shift = torch.tensor([box, box, math.pi / 2], device=device)
    return u * scale - shift


def sample_rows(rows: int, take: int, g: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """``take`` row indices drawn uniformly from ``rows`` (with repeats)."""
    return torch.randint(rows, (take,), generator=g, device=device)
