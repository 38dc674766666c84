"""Run one cell and build the line that reports it.

``run_cell`` drives the cell's traffic through the port (``drivers/``),
then, once the window has closed, the peak memory read and the program's
state dropped, holds the sample of its answers against the plain reference
and reads the cell's metrics: with ``trace`` off its end-to-end metrics,
with ``trace`` on its per-layer metrics (``metrics/<name>.py``).
``result_line`` orders the keys as the benchmark's contract asks, the
compared numbers last.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Optional

import torch

from harness import check, roofline, spec
from harness.window import DriverOutput, RunCtx


@dataclass
class CellRun:
    out: DriverOutput
    readings: dict          # every number read from the answers
    checks: dict            # the numbers compared, each beside its limit
    correct: bool
    metrics: dict           # {name: {"value", "unit"}}
    control: Optional[dict] = None   # readings and checks of the control


def _numbers(out: DriverOutput, cfg: dict, ref, sample: dict) -> dict:
    readings = dict(out.gates, failed=out.failed)
    if sample:
        readings.update(check.NUMBERS[out.kind](sample, cfg, ref))
    return readings


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, control: bool = False,
             stamps=()) -> CellRun:
    """``stamps``: the parts of the set-up already done, [(label,
    perf_counter at its end)]."""
    cfg = cell.config
    ctx = RunCtx(device=device, seed=seed, seconds=seconds, trace=trace,
                 cell=cell, program=spec.load_program(cfg["model"],
                                                      cell.bench_dir),
                 t_start=t_start, stamps=list(stamps))
    out = spec.load_driver(cell.traffic["driver"], cell.bench_dir).run(ctx)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = spec.load_reference(cfg["model"], cell.bench_dir)
    t0 = time.perf_counter()
    readings = _numbers(out, cfg, ref, out.sample)
    print(f"portbench: the reference took {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    checks = check.judge(readings, cell.limits)
    run = CellRun(out=out, readings=readings, checks=checks,
                  correct=all(c["ok"] for c in checks.values()),
                  metrics=_metrics(cell, out, trace))
    if control and out.sample:
        low = check.control_answers(out.kind, out.sample, cfg, ref)
        c_readings = _numbers(out, cfg, ref, low)
        c_checks = check.judge(c_readings, cell.limits)
        run.control = {"readings": c_readings, "checks": c_checks,
                       "correct": all(c["ok"] for c in c_checks.values())}
    return run


def _metrics(cell: spec.Cell, out: DriverOutput, trace: bool) -> dict:
    if not trace:
        return {m["name"]: {"value": out.metrics[m["name"]], "unit": m["unit"]}
                for m in cell.end_to_end}
    ctx = {"counts": out.counts, "trace": out.trace, "config": cell.config,
           "traffic": cell.traffic}
    metrics = {}
    for m in cell.per_layer:
        value = spec.load_reader(m["name"], cell.bench_dir)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def result_line(run: CellRun, device: dict) -> dict:
    """The result's keys in the contract's order, the compared numbers
    (``checks``: value, comparison and limit) last."""
    dev = dict(device, memory_peak_bytes=run.out.memory_peak_bytes)
    line = {"correct": run.correct, "attempted": run.out.attempted,
            "failed": run.out.failed, "metrics": run.metrics, "device": dev}
    if run.out.trace is not None:
        dev.update(busy_s=run.out.trace["busy_s"],
                   window_s=run.out.trace["window_s"])
        line["breakdown"] = {"device_ops": run.out.trace["device_ops"],
                             "idle_gaps": run.out.trace["idle_gaps"]}
    line["setup_parts_s"] = run.out.setup_parts
    line["peaks"] = dict(roofline.PEAKS)
    line["readings"] = {k: v for k, v in run.readings.items()
                        if k not in run.checks}
    line["checks"] = {k: {"value": c["value"], "op": c["op"],
                          "limit": c["limit"]} for k, c in run.checks.items()}
    return line


def check_lines(checks: dict) -> list:
    """One line per compared number: name, value, comparison, limit."""
    return [f"check {k} = {c['value']!r} {c['op']} {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAILS'}" for k, c in checks.items()]
