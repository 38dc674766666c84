"""Profiling: device traces and per-phase wall timing (port of
``mpc_verde_tpu.utils.profiling``).

The reference's observability is per-iteration ``time()`` prints
(``Casadi/single_shooting_v1.py:206-212``).  ``device_trace`` records a
``torch.profiler`` trace of a block, the card's kernels included, and writes
it as a Chrome trace (open it in Perfetto or ``chrome://tracing``);
``SolvePhaseTimer`` is the phase ``Timer`` with the solver's phase names.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from collections import Counter
from pathlib import Path
from typing import Optional

import torch

from .timing import Timer

# trace event categories of work that ran on the card
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceTrace:
    """What ``device_trace`` yields: ``logdir``, and once the block has
    ended, ``path`` (the Chrome trace written there) and ``kernels`` (the
    launches in it by kernel symbol)."""

    logdir: str
    cuda: bool
    path: Optional[str] = None
    kernels: dict = dataclasses.field(default_factory=dict)


def kernel_counts(events) -> dict:
    """{kernel symbol: launches} of the device kernels among a Chrome
    trace's events."""
    return dict(Counter(e["name"] for e in events
                        if e.get("cat") == "kernel" and "name" in e))


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """Record a ``torch.profiler`` trace of the enclosed block and export it
    as a Chrome trace into ``logdir`` (default: ``mpc_verde_trace`` under the
    temp dir); yields a ``DeviceTrace``.

    The trace records the host's activity, and the card's as well when a
    CUDA device is present: there the block must launch device work, and a
    trace that recorded none (the profiler saw no kernel, copy or memset)
    raises instead of passing a host-only trace off as the device's.
    """
    logdir = logdir or os.path.join(tempfile.gettempdir(), "mpc_verde_trace")
    Path(logdir).mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    trace = DeviceTrace(logdir=str(logdir), cuda=cuda)
    with torch.profiler.profile(activities=activities) as prof:
        yield trace
        if cuda:
            torch.cuda.synchronize()
    path = Path(logdir) / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    trace.path = str(path)
    trace.kernels = kernel_counts(events)
    if cuda and not any(e.get("cat") in _DEVICE_CATS for e in events):
        raise RuntimeError(
            f"device_trace: the trace {path} recorded no CUDA activity; the "
            "profiler did not see the card")


class SolvePhaseTimer(Timer):
    """Timer with phase names standardized across the solver pipeline
    (rollout / linearize / backward / line_search / plant)."""

    PHASES = ("rollout", "linearize", "backward", "line_search", "plant")

    def report(self) -> str:
        rows = [f"{k:>12s}: total {v['total_s']:.3f}s  mean {v['mean_ms']:.2f}ms"
                f"  n={v['count']}"
                for k, v in self.summary().items()]
        return "\n".join(rows)
