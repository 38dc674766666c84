"""Find what a cell is made of by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each lives in a file of its own under the benchmark's folder:

* ``configs/<config>.json``: the configuration as it is run; its ``model``
  names the program's builder (``programs/<model>.py``) and the plain
  reference (``reference/<model>.py``);
* ``traffic/<traffic>.json``: the traffic mix; its ``driver`` names the
  general generator that reads it (``drivers/<driver>.py``);
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct``;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a
  function ``read(ctx)`` that returns a number or None.

A later cell, configuration, mix or metric is new files and entries: no
file here needs an edit.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what its names point at."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list    # the end-to-end metric entries this cell reports
    per_layer: list     # the per-layer metric entries this cell reports
    bench_dir: Path


def _load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def reports(metric: dict, cell: str) -> bool:
    """Whether ``metric`` (an entry of ``end_to_end`` or ``per_layer``) is
    reported in ``cell``: every cell without a ``workloads`` key."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files read from
    ``bench_dir``.  Raises KeyError for a cell the file does not name."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; "
                       f"the cells are {sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_load_json(bench_dir / "configs" / f"{w['config']}.json"),
        traffic=_load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
        bench_dir=bench_dir)


def _load_file(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_{label}_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    return _load_file(bench_dir / "metrics" / f"{metric}.py", "metric").read


def load_driver(name: str, bench_dir: Path = BENCH_DIR):
    """The module ``drivers/<name>.py``: ``run(run_ctx) -> DriverOutput``."""
    return _load_file(bench_dir / "drivers" / f"{name}.py", "driver")


def load_program(model: str, bench_dir: Path = BENCH_DIR):
    """The module ``programs/<model>.py``, which builds the port's OCP."""
    return _load_file(bench_dir / "programs" / f"{model}.py", "program")


def load_reference(model: str, bench_dir: Path = BENCH_DIR):
    """The module ``reference/<model>.py``, the plain reference."""
    return _load_file(bench_dir / "reference" / f"{model}.py", "reference")
