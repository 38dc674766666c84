"""A ``torch.profiler`` trace of a block of the window, and what the
per-layer metrics read from it.

``Traced`` records the host's and the card's activity over a block of
whole calls (or steps) inside the window, marked by a
``portbench.traced`` range, exports it as a Chrome trace into a
directory made under ``TMPDIR``, reads it back and deletes it.  From the
events inside the range it keeps the device's busy time (the union of the
kernels, copies and sets), the kernels one by one, the device operations
that took most time, and the idle gaps of the device by what the host was
doing in them: the innermost host operation running at the middle of the
gap, or ``python`` where none was.
"""
from __future__ import annotations

import bisect
import json
import shutil
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

RANGE = "portbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10


class Traced:
    """Profile what runs between ``start()`` and ``stop()``, with the
    launch counters of the port's kernels read at both ends; ``read()``,
    called once the window has closed, returns the block's reading
    (``read_trace``) with the counters' increments under ``launches``."""

    def __init__(self, device: torch.device, counters):
        self.device = device
        self.counters = counters
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.range = None
        self.launches = None
        self.calls = 0      # whole calls or steps inside the block

    def running(self) -> bool:
        return self.range is not None and self.launches is None

    def start(self) -> None:
        self.before = self.counters()
        self.prof.start()
        self.range = torch.autograd.profiler.record_function(RANGE)
        self.range.__enter__()

    def stop(self) -> None:
        """End the block; a second call, or one before ``start()``, does
        nothing."""
        if self.range is None or self.launches is not None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.range.__exit__(None, None, None)
        self.prof.stop()
        after = self.counters()
        self.launches = {k: after[k] - self.before[k] for k in after}

    def read(self) -> dict:
        tmp = Path(tempfile.mkdtemp(prefix="portbench_trace_"))
        try:
            path = tmp / "trace.json"
            self.prof.export_chrome_trace(str(path))
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return dict(read_trace(events), launches=self.launches)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(host, starts, t, max_walk=4096):
    """Name of the host event with the latest start that covers t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - max_walk, -1), -1):
        ts, end, name = host[j]
        if end >= t:
            return name
    return "python"


def short_name(name: str, width: int = 80) -> str:
    return name if len(name) <= width else name[:width]


def read_trace(events: list) -> dict:
    """The block's reading from Chrome trace events (times in seconds):
    ``window_s``, ``busy_s``, ``kernels`` [(name, seconds)] in order,
    ``device_ops`` and ``idle_gaps`` [(name, seconds)], most first."""
    marks = [e for e in events if e.get("name") == RANGE
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError(f"the trace holds no {RANGE!r} range")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev, kernels, host = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS and ts >= w0 and ts + dur <= w1:
            dev.append((ts, ts + dur, e["name"]))
            if cat == "kernel":
                kernels.append((ts, e["name"], 1e-6 * dur))
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, e["name"]))
    busy = _union([(a, b) for a, b, _ in dev])
    by_op = defaultdict(float)
    for a, b, name in dev:
        by_op[short_name(name)] += 1e-6 * (b - a)
    host.sort()
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[short_name(_innermost(host, starts, 0.5 * (a + b)))] += \
                1e-6 * (b - a)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": 1e-6 * (w1 - w0),
            "busy_s": 1e-6 * sum(b - a for a, b in busy),
            "kernels": [(n, s) for _, n, s in sorted(kernels)],
            "device_ops": [list(kv) for kv in top(by_op)],
            "idle_gaps": [list(kv) for kv in top(gaps)]}
