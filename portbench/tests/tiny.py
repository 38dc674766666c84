"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
harness's tests: the same files, drivers and reference, with the traffic
and the horizon shrunk and the harness's look for a card skipped."""
from __future__ import annotations

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from harness import cell as cellmod  # noqa: E402
from harness import spec  # noqa: E402

QUEUE = "pointstab_n40.batch-m65536"
STREAM = "pointstab_n40.stream-w131072"
IPM = "pointstab_n40.ipm-w131072"
FLEET = "fleet_n10.mc-b524288"

SIZES = {
    "stream-w131072": dict(width=8, rows_per_call=24, check_rows_per_call=12,
                           trace={"skip": 0, "take": 1}),
    "batch-m65536": dict(rows_per_call=12, check_rows_per_call=12,
                         trace={"skip": 0, "take": 1}),
    "ipm-w131072": dict(width=8, rows_per_call=16, check_rows_per_call=8,
                        trace={"skip": 0, "take": 1}),
    "mc-b524288": dict(robots=8, check_robots_per_step=8, warm_steps=1,
                       trace={"skip": 0, "take": 1}),
}
# the closed loop's gates on the final error need whole episodes of the
# configuration's length; the tiny episodes keep the reference's numbers
EPISODE_GATES = ("final_err_max", "final_err_p99", "final_err_mean")


def tiny_cell(name: str, N: int = 10, n_sim: int = 1) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.traffic = dict(cell.traffic, **SIZES[name.split(".", 1)[1]])
    cell.config = dict(cell.config, N=N)
    if "Nsim" in cell.config:
        cell.config["Nsim"] = n_sim
        cell.limits = {k: v for k, v in cell.limits.items()
                       if k not in EPISODE_GATES}
    return cell


def run_tiny(cell: spec.Cell, seed: int = 2**33 + 7, seconds: float = 0.0,
             trace: bool = False, control: bool = False):
    """One run of the cell on the CPU: one call (or step) unless
    ``seconds`` asks for more."""
    return cellmod.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), control=control)
