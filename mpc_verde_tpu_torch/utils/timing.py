"""Timing helpers (port of ``mpc_verde_tpu.utils.timing``): the wall-clock
``Timer`` and ``timed`` of the JAX package, and the device time of a call by
CUDA events.

The reference instruments every closed-loop script with per-iteration wall
timers and an end-of-run mean (``Casadi/single_shooting_v1.py:167,206-212,
221-225``); ``Timer`` and ``timed`` are that as a reusable utility.  They
read the host's clock: a block that queues CUDA work is timed to its last
launch unless it synchronizes (``device_time_ms`` times the device).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

_SPIN_CYCLES = 40_000_000   # about 20 ms at the H100's clock


@dataclass
class Timer:
    """Accumulates named phase timings; ``summary()`` mirrors the reference's
    end-of-run table (total time / avg iteration ms)."""

    samples: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples.setdefault(name, []).append(time.perf_counter() - t0)

    def mean_ms(self, name: str) -> float:
        xs = self.samples.get(name, [])
        return 1e3 * sum(xs) / max(len(xs), 1)

    def total_s(self, name: str) -> float:
        return sum(self.samples.get(name, []))

    def summary(self) -> dict:
        return {
            name: {"total_s": self.total_s(name), "mean_ms": self.mean_ms(name),
                   "count": len(xs)}
            for name, xs in self.samples.items()
        }


@contextlib.contextmanager
def timed(label: str = ""):
    """Yield a dict that holds ``seconds`` and ``label`` once the block ends."""
    t0 = time.perf_counter()
    out = {}
    try:
        yield out
    finally:
        out["seconds"] = time.perf_counter() - t0
        out["label"] = label


def device_time_ms(fn, reps: int, warmup: int = 2, queued: bool = True) -> float:
    """Mean device time in ms of one ``fn()``, by CUDA events around ``reps`` calls.

    With ``queued`` the device first spins for about 20 ms, so that the host
    has queued every call by the time the first one starts: a kernel shorter
    than its wrapper's host time is then timed back to back, not at the
    host's pace.  Should the host still be queueing when the device has run
    dry (the end event is complete as soon as it is recorded), the time
    would be the host's, and the call raises instead of returning it.
    Without ``queued`` the calls are timed at whatever pace the host sets:
    the honest time of a function that is many launches, as an eager PyTorch
    version is.
    """
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(_SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if queued and end.query():
        raise RuntimeError(
            f"device_time_ms: the device finished {reps} calls before the "
            "host had queued them, so the events would time the host; use "
            "fewer reps or a longer spin")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
