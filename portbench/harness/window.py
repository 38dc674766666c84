"""What the drivers share: the run's context, what a driver returns, the
fault test of one returned answer and the port's launch counters.

An operation is one solve that the program returned.  ``failed`` counts
the operations whose returned result is a fault: a returned control, state
or cost that is not finite, a control outside the configuration's box by
more than float32 rounding, or every operation of a call that raised.  A
solve that did not converge is not a fault: the tally counts it apart, for
the solver's per-layer metrics.
"""
from __future__ import annotations

import math
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Optional

import torch

# a control may exceed its bound by float32 rounding of the bound itself
BOX_SLACK = 4 * 2.0 ** -24


@dataclass
class RunCtx:
    device: torch.device
    seed: int
    seconds: float
    trace: bool
    cell: object          # spec.Cell
    program: object       # programs/<model>.py
    t_start: float        # time.perf_counter() at the process's start
    stamps: list = field(default_factory=list)   # [(label, perf_counter)]

    def stamp(self, label: str) -> None:
        """Mark the end of a part of the set-up."""
        self.stamps.append((label, time.perf_counter()))

    def setup_parts(self, t_first: float) -> dict:
        """Seconds of each part of the set-up, from the process's start
        to the window's first operation."""
        marks = [("start", self.t_start)] + self.stamps + [("inputs",
                                                             t_first)]
        return {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}


@dataclass
class DriverOutput:
    kind: str             # "queue" or "fleet": which numbers check the sample
    metrics: dict         # end-to-end readings by metric name
    attempted: int
    failed: int
    counts: dict          # the window's counts, for the per-layer readers
    sample: dict          # answers for the reference, drawn from the seed
    gates: dict = field(default_factory=dict)   # further compared numbers
    tail_ms: list = field(default_factory=list)  # every call's or step's time
    trace: Optional[dict] = None   # the traced block's reading and shapes
    memory_peak_bytes: Optional[int] = None
    setup_parts: dict = field(default_factory=dict)


class Box:
    """The configuration's control box, for the fault test."""

    def __init__(self, cfg: dict, device: torch.device):
        lb = torch.tensor(cfg["u_lb"], dtype=torch.float64)
        ub = torch.tensor(cfg["u_ub"], dtype=torch.float64)
        slack = lambda b: BOX_SLACK * b.abs().clamp(min=1.0)
        self.lo = (lb - slack(lb)).float().to(device)
        self.hi = (ub + slack(ub)).float().to(device)

    def faults(self, us, *values) -> torch.Tensor:
        """(rows,) bool: the row's controls ``us`` (rows, ..., nu) leave
        the box or any of ``us`` and ``values`` (each (rows, ...)) is not
        finite."""
        rows = us.shape[0]
        ok = ((us >= self.lo) & (us <= self.hi)).reshape(rows, -1).all(1)
        for v in (us,) + values:
            ok &= torch.isfinite(v).reshape(rows, -1).all(1)
        return ~ok


def kernel_launches() -> dict:
    """The port's launch counters of K3 and K2 (program counters)."""
    from mpc_verde_tpu_torch.ops.cuda.fused import fused_backward
    from mpc_verde_tpu_torch.ops.cuda.rollout import linesearch_forward

    return {"k3": fused_backward.launches, "k2": linesearch_forward.launches}


def report_raise(what: str) -> None:
    print(f"portbench: {what} raised; every operation of it counts as "
          "failed", file=sys.stderr)
    traceback.print_exc(file=sys.stderr)


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of ``values``, linear between ranks."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
