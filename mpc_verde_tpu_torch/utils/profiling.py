"""Profiling: device traces, the solvers' spans and counters, and
per-phase wall timing (port of ``mpc_verde_tpu.utils.profiling``).

The reference's observability is per-iteration ``time()`` prints
(``Casadi/single_shooting_v1.py:206-212``).  ``device_trace`` records a
``torch.profiler`` trace of a block, the card's kernels included, and writes
it as a Chrome trace (open it in Perfetto or ``chrome://tracing``);
``SolvePhaseTimer`` is the phase ``Timer`` with the solver's phase names.

Spans: the solver loops (``solver/batched.py``, ``solver/streaming.py``,
``solver/ipm.py``) and the closed-loop drivers (``runtime/receding.py``)
mark their work with ``span(name)``: a ``torch.profiler.record_function``
range while a profiler records, else one shared no-op context, so that no
``record_function`` is built without a profiler.  Any ``torch.profiler``
trace (``device_trace``'s, or one of the caller's own) then shows which
part of the loop launched each kernel and what the host was doing while
the card waited.  The names, each the innermost span of the work beside
it:

  ``mpc.solve``       one call of a solver's ``solve``
  ``mpc.preroll``     the initial rollout of the batch or queue, the queue's
                      packing and the slots' first load
  ``mpc.turn``        one host loop turn: a batched iteration, or a
                      streaming refill and ``refill_every`` iterations
  ``mpc.refill``      the streaming refill: finished rows out, queued in
  ``mpc.direction``   the search direction (K3, or derivatives then K1)
  ``mpc.linesearch``  the line search (K2)
  ``mpc.accept``      acceptance and update, with the streaming budget and
                      restart bookkeeping
  ``mpc.rebase``      the rounds' advance: params, re-based cost
  ``mpc.flag``        the device-to-host reads that decide whether the loop
                      goes on (both reads under a quorum), one before each
                      turn and one after the last
  ``mpc.unpack``      the results after the loop, the state-bounds cost
  ``mpc.step``        one closed-loop step
  ``mpc.plant``       the step's plant call and warm-start shift
  ``mpc.trace``       the trace of an OCP's callables into the program of
                      its traced device model (``ops/cuda/trace.py``), once
                      per OCP
  ``mpc.build``       the build or load of a traced program's library
                      (``ops/cuda/build.traced_entry``), once per program
                      per process

Counters (``counters()``): host integers kept where the loops already are
on the host, always on, with no kernel and no synchronisation of their
own; the difference of two snapshots counts the work in between, and
``device_trace`` takes it over its block.  ``read_spans`` reads the spans
of a Chrome trace: where the card's idle time and kernel time went.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import json
import os
import tempfile
import time
from collections import Counter, defaultdict
from pathlib import Path
from typing import Optional

import torch

from .timing import Timer

# trace event categories of work that ran on the card
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# what counters() counts, besides the kernels' launches:
#   turns            host loop turns (mpc.turn)
#   flag_reads       device-to-host reads of the loops' go-on flag: one
#                    before each turn and one after the last, per loop run
#                    (two a test under a quorum while the batch runs)
#   iterations       solver iterations run by the loops
#   slot_iterations  each iteration's width: the batch, or the streaming
#                    slots, finished ones included; with the iterations the
#                    solves return, the share of the slot-work spent on
#                    problems still being solved
#   refill_rows      rows the streaming refill moved: each problem's result
#                    row out, and each problem it loaded (all but the first
#                    batch_width of a queue); beside slot_iterations, how
#                    much of the slots' state the refill changes
# and of the traced device models (ops/cuda/rollout.TracedDeviceModel), on
# their path alone, none a launch:
#   traced_traces       OCPs traced into a program (trace_ocp)
#   traced_builds       traced programs' libraries compiled by nvcc
#   traced_loads        traced programs' libraries opened
#   traced_table_fills  refills of a traced model's table buffer: its first
#                       fill on a device and one a change of a hoisted weight
COUNTER_NAMES = ("turns", "flag_reads", "iterations", "slot_iterations",
                 "refill_rows", "traced_traces", "traced_builds",
                 "traced_loads", "traced_table_fills")
_COUNTS = dict.fromkeys(COUNTER_NAMES, 0)
_NO_SPAN = contextlib.nullcontext()
# the range device_trace opens around its block
BLOCK = "device_trace"
SPAN_PREFIX = "mpc."
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records, else the shared no-op context (the check costs about
    0.2 us)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def spanned(name: str):
    """Decorator: run the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(**increments: int) -> None:
    """Add to the process's counters (names of ``COUNTER_NAMES``)."""
    for name, n in increments.items():
        _COUNTS[name] += n


def counters() -> dict:
    """A snapshot of the process's counters: ``COUNTER_NAMES`` and the
    launches of K1, K2 and K3 (``k1``, ``k2``, ``k3``), of the rounds' cost
    re-base (``rebase``, one an iteration of a loop with rounds on a kernel
    backend) and of the streaming refill (``refill``, one a turn on the
    card), read from the kernel wrappers' own ``launches``."""
    from ..ops.cuda.fused import fused_backward
    from ..ops.cuda.refill import refill_slots
    from ..ops.cuda.riccati import riccati_backward
    from ..ops.cuda.rollout import linesearch_forward, trajectory_cost

    return dict(_COUNTS, k1=riccati_backward.launches,
                k2=linesearch_forward.launches, k3=fused_backward.launches,
                rebase=trajectory_cost.launches,
                refill=refill_slots.launches)


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _segments(spans) -> list:
    """[(start, end, name)] in time order: the innermost of the properly
    nested ``spans`` [(start, end, name)] at each covered time."""
    segs, stack, t = [], [], None
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, inner = stack.pop()
            if end > t:
                segs.append((t, end, inner))
                t = end
        if stack and s > t:
            segs.append((t, s, stack[-1][1]))
        t = s
        stack.append((min(e, stack[-1][0]) if stack else e, name))
    while stack:
        end, inner = stack.pop()
        if end > t:
            segs.append((t, end, inner))
            t = end
    return segs


def _split(intervals, segs) -> dict:
    """Seconds of the sorted, disjoint ``intervals`` [(a, b)] (in us)
    under each segment's name, the rest ``outside``."""
    out = defaultdict(float)
    j = 0
    for a, b in intervals:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2]] += 1e-6 * (hi - lo)
                covered += hi - lo
            k += 1
        if b - a > covered:
            out["outside"] += 1e-6 * (b - a - covered)
    return dict(out)


def read_spans(events: list, block: str = BLOCK) -> dict:
    """The ``mpc.*`` spans of a Chrome trace's ``events`` inside the first
    host range named ``block``, in seconds:

    - ``spans``: for each name its count, its total (nested spans of one
      name counted once) and its self time (where it is the innermost);
    - ``idle_by_span``: the block's idle time of the card (no kernel, copy
      or memset running) split by the innermost span over each part; what
      no span covers is ``outside``, the caller's own code;
    - ``device_by_span``: each kernel's time under the innermost span open
      at its launch, the runtime or driver call that the trace ties to it
      by ``correlation``; a launch outside every span is ``outside``, a
      kernel whose launch is not in the trace ``unmatched``.

    The buckets of each sum to the block's idle and kernel time.
    """
    marks = [e for e in events if e.get("name") == block
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError(f"the trace holds no {block!r} range")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    spans, dev, kernels, launch_ts = [], [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        cat = e.get("cat")
        if cat in _DEVICE_CATS and ts >= w0 and ts + dur <= w1:
            dev.append((ts, ts + dur))
            if cat == "kernel":
                kernels.append((dur, e.get("args", {}).get("correlation")))
        elif cat in _LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = ts
        elif (cat == "user_annotation"
              and e.get("name", "").startswith(SPAN_PREFIX)):
            a, b = max(ts, w0), min(ts + dur, w1)
            if b > a:
                spans.append((a, b, e["name"]))
    segs = _segments(spans)

    by_name = defaultdict(list)
    for a, b, name in spans:
        by_name[name].append((a, b))
    self_s = defaultdict(float)
    for a, b, name in segs:
        self_s[name] += 1e-6 * (b - a)
    table = {name: {"count": len(iv),
                    "total_s": 1e-6 * sum(b - a for a, b in _union(iv)),
                    "self_s": self_s[name]}
             for name, iv in sorted(by_name.items())}

    edges = [w0] + [t for iv in _union(dev) for t in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    starts = [s[0] for s in segs]
    device = defaultdict(float)
    for dur, corr in kernels:
        t = launch_ts.get(corr)
        if t is None:
            name = "unmatched"
        else:
            i = bisect.bisect_right(starts, t) - 1
            name = segs[i][2] if i >= 0 and segs[i][1] > t else "outside"
        device[name] += 1e-6 * dur
    return {"spans": table, "idle_by_span": _split(idle, segs),
            "device_by_span": dict(device)}


@dataclasses.dataclass
class DeviceTrace:
    """What ``device_trace`` yields: ``logdir``, and once the block has
    ended, ``path`` (the Chrome trace written there), ``kernels`` (the
    launches in it by kernel symbol), ``counters`` (what ``counters()``
    counted over the block) and ``read_spans``'s ``spans``,
    ``idle_by_span`` and ``device_by_span`` of the block."""

    logdir: str
    cuda: bool
    path: Optional[str] = None
    kernels: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)
    idle_by_span: dict = dataclasses.field(default_factory=dict)
    device_by_span: dict = dataclasses.field(default_factory=dict)


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
    CUDA device is present, with the block as a ``device_trace`` range and
    the solvers' spans (the ``mpc.*`` ranges of this module's docstring)
    among the host's events, on the same clock as the kernels they
    launched.  There the block must launch device work, and a
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
    before = counters()
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(BLOCK):
            yield trace
            if cuda:
                torch.cuda.synchronize()
    after = counters()
    trace.counters = {k: after[k] - before[k] for k in after}
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
    for key, value in read_spans(events).items():
        setattr(trace, key, value)


class SolvePhaseTimer(Timer):
    """Timer with phase names standardized across the solver pipeline
    (rollout / linearize / backward / line_search / plant)."""

    PHASES = ("rollout", "linearize", "backward", "line_search", "plant")

    def report(self) -> str:
        rows = [f"{k:>12s}: total {v['total_s']:.3f}s  mean {v['mean_ms']:.2f}ms"
                f"  n={v['count']}"
                for k, v in self.summary().items()]
        return "\n".join(rows)
