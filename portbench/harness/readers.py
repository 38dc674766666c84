"""What the per-layer metric readers (``metrics/<name>.py``) share.

Each reader takes ``ctx``: ``counts`` (the window's counts of operations,
converged solves and solver iterations, kept by the driver from what the
program returned), ``trace`` (the profiled block's reading, with the
shapes of its calls, or None in a run without a trace), ``config`` and
``traffic``.  A reader with nothing to read returns None, never 0.
"""
from __future__ import annotations

from harness import roofline

K3_KERNELS = ("fused_staged_kernel", "fused_thread_kernel")
K2_KERNELS = ("linesearch_lanes_kernel", "linesearch_thread_kernel")


def times(trace: dict, names) -> list:
    """Seconds of each traced kernel whose name holds one of ``names``."""
    return [s for n, s in trace["kernels"] if any(k in n for k in names)]


def k3_roofline(ctx: dict, names=K3_KERNELS):
    """Share (%) of the least time of the traced block's K3 launches, each
    the stage derivatives and backward of width x N stages, in their device
    time."""
    tr = ctx["trace"]
    t = times(tr, names) if tr else []
    if not t:
        return None
    least = len(t) * roofline.k3_least_s(tr["width"], tr["N"], tr["nx"],
                                         tr["nu"], tr["npar"], tr["terms"])
    return 100.0 * least / sum(t)


def k2_roofline(ctx: dict, names=K2_KERNELS):
    """Share (%) of the least time of the traced block's K2 launches in
    their device time: one pre-roll (A = 1 over the rows of a call) a call
    or step, the rest line searches of width x N x A candidates."""
    tr = ctx["trace"]
    t = times(tr, names) if tr else []
    n_search = len(t) - tr["calls"] if t else 0
    if n_search <= 0:
        return None
    least = (n_search * roofline.k2_least_s(
        tr["width"], tr["N"], tr["A"], tr["nx"], tr["nu"], tr["npar"],
        tr["terms"])
        + tr["calls"] * roofline.k2_least_s(
            tr["rows_per_call"], tr["N"], 1, tr["nx"], tr["nu"], tr["npar"],
            tr["terms"]))
    return 100.0 * least / sum(t)


def launches_per_iter(ctx: dict):
    """Device kernels of the traced block per K3 launch (one an
    iteration)."""
    tr = ctx["trace"]
    if not tr or not tr["launches"]["k3"]:
        return None
    return len(tr["kernels"]) / tr["launches"]["k3"]


def glue_device_pct(ctx: dict):
    """Share (%) of the traced block's kernel time outside K2 and K3."""
    tr = ctx["trace"]
    total = sum(s for _, s in tr["kernels"]) if tr else 0.0
    if total <= 0.0:
        return None
    kernels = sum(times(tr, K3_KERNELS + K2_KERNELS))
    return 100.0 * (total - kernels) / total


def idle_pct(ctx: dict):
    """Share (%) of the traced block in which no operation ran on the
    device."""
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def per_op(ctx: dict, num: str, den: str):
    """counts[num] / counts[den], or None without operations."""
    c = ctx["counts"]
    return c[num] / c[den] if c.get(den) else None


def unconverged_pct(ctx: dict, den: str):
    """Share (%) of the window's operations (counts[den]) whose solve did
    not converge."""
    c = ctx["counts"]
    return 100.0 * (c[den] - c["converged"]) / c[den] if c.get(den) else None
