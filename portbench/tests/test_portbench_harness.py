"""The harness's accounting on the CPU: what ``failed`` counts, that the
rate and ``attempted`` count the same operations over the whole window,
that tails are taken over every call or step, that a cell's files are found
by name, and that nothing the benchmark runs loads JAX or the JAX package.
"""
from __future__ import annotations

import ast
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tiny import BENCH, FLEET, QUEUE, run_tiny, tiny_cell

import mpc_verde_tpu_torch
from harness import cell as cellmod
from harness import spec, window
from mpc_verde_tpu_torch.solver.ilqr import ILQRResult

BANNED = ("jax", "jaxlib", "flax", "mpc_verde_tpu")


def fake_factory(delays, bad_rows=True):
    """A stand-in for make_batched_ilqr_solver: each call sleeps the next of
    ``delays`` and returns finite in-box answers, with row 0's controls not
    finite, row 1's outside the box and rows 2 and 3 unconverged."""
    calls = []

    def factory(ocp, options=None, backend=None):
        def solve(x0s, params=None, us_init=None):
            M = x0s.shape[0]
            time.sleep(delays[min(len(calls), len(delays) - 1)])
            calls.append(M)
            us = torch.zeros((M, ocp.N, ocp.nu))
            conv = torch.ones(M, dtype=torch.bool)
            if bad_rows:
                us[0, 3, 1] = float("nan")
                us[1, 0, 0] = 1.5
                conv[2:4] = False
            return ILQRResult(
                xs=torch.zeros((M, ocp.N + 1, ocp.nx)), us=us,
                cost=torch.ones(M), grad_norm=torch.zeros(M),
                iterations=torch.full((M,), 7, dtype=torch.int32),
                converged=conv, max_violation=torch.zeros(M))
        return solve

    return factory, calls


def test_box_faults_count_non_finite_and_out_of_box_not_unconverged():
    cfg = tiny_cell(QUEUE).config
    box = window.Box(cfg, torch.device("cpu"))
    us = torch.zeros((4, 10, 2))
    us[0, 2, 0] = float("inf")
    us[1, 0, 1] = math.pi / 4 + 1e-3           # outside the box
    us[2, 0, 1] = float(np.float32(math.pi / 4))  # on the float32 bound
    us[3, 0, 0] = -1.0
    cost = torch.tensor([1.0, 1.0, 1.0, float("nan")])
    assert box.faults(us, cost).tolist() == [True, True, False, True]
    assert box.faults(us[:3], cost[:3]).tolist() == [True, True, False]


def test_failed_counts_faults_and_rate_counts_converged(monkeypatch):
    factory, calls = fake_factory([0.02])
    monkeypatch.setattr(mpc_verde_tpu_torch, "make_batched_ilqr_solver",
                        factory)
    cell = tiny_cell(QUEUE)
    run = run_tiny(cell, seconds=0.3, trace=True)
    out, M = run.out, cell.traffic["rows_per_call"]
    n = len(calls) - 1                          # the first call is set-up
    assert n >= 5 and out.counts["calls"] == n
    # every operation of the window, and only those, is attempted
    assert out.attempted == out.counts["solves"] == n * M
    # the non-finite and the out-of-box rows fail; unconverged rows do not
    assert out.failed == 2 * n
    assert out.counts["converged"] == n * (M - 2)
    assert run.metrics["queue.unconverged_pct"]["value"] == \
        pytest.approx(100 * 2 / M)
    assert run.metrics["queue.iters_per_solve"]["value"] == 7
    assert not run.correct and not run.checks["failed"]["ok"]
    # the rate: converged solves over the wall of all the window's calls
    rate = out.metrics["solves_per_s"]
    wall = sum(out.tail_ms) / 1e3
    assert n * (M - 2) / wall * 0.8 < rate <= n * (M - 2) / wall


def test_tails_are_taken_over_every_call(monkeypatch):
    factory, calls = fake_factory([0.01, 0.01, 0.01, 0.01, 0.12, 0.01], False)
    monkeypatch.setattr(mpc_verde_tpu_torch, "make_batched_ilqr_solver",
                        factory)
    out = run_tiny(tiny_cell(QUEUE), seconds=0.2).out
    assert len(out.tail_ms) == out.counts["calls"] == len(calls) - 1
    assert max(out.tail_ms) > 100.0             # the slow call is in the tail
    assert out.metrics["batch_ms_p90"] == pytest.approx(
        np.percentile(out.tail_ms, 90))


def test_fleet_counts_robot_steps_and_times_every_step():
    cell = tiny_cell(FLEET)
    run = run_tiny(cell, seconds=1.0)
    out, B = run.out, cell.traffic["robots"]
    steps = out.counts["steps"]
    assert steps >= 1 and out.counts["robot_steps"] == B * steps
    assert out.attempted == B * steps and out.failed == 0
    assert len(out.tail_ms) == steps
    assert out.metrics["step_ms_p95"] == pytest.approx(
        np.percentile(out.tail_ms, 95))
    assert out.gates["episodes"] == steps      # one step an episode here
    assert run.correct, cellmod.check_lines(run.checks)


def test_percentile_matches_numpy_linear():
    v = list(np.random.default_rng(3).exponential(size=37))
    for q in (50, 90, 95, 99):
        assert window.percentile(v, q) == pytest.approx(np.percentile(v, q))


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, limits and a metric added as files
    of their own are found by the names in BENCHMARK.json."""
    bench = tmp_path / "bench"
    for d in ("configs", "traffic", "limits", "metrics"):
        (bench / d).mkdir(parents=True)
    cfg = json.loads((BENCH / "configs" / "pointstab_n40.json").read_text())
    (bench / "configs" / "other_n20.json").write_text(
        json.dumps(dict(cfg, N=20)))
    (bench / "traffic" / "tiny-b4.json").write_text(json.dumps(
        {"driver": "queue", "solver": "batched", "rows_per_call": 4,
         "start_box": 1.0, "check_rows_per_call": 4,
         "trace": {"skip": 0, "take": 1}}))
    (bench / "limits" / "other_n20.tiny-b4.json").write_text(
        json.dumps({"failed": {"max": 0}}))
    (bench / "metrics" / "queue.solves_seen.py").write_text(
        "def read(ctx):\n    return ctx['counts']['solves']\n")
    for d in ("drivers", "programs", "reference"):
        (bench / d).symlink_to(BENCH / d)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "other_n20.tiny-b4", "config": "other_n20",
                       "traffic": "tiny-b4", "chips": 1}],
        "end_to_end": [{"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "queue.solves_seen", "unit": "solves"}]}))
    cell = spec.load_cell("other_n20.tiny-b4", root=tmp_path, bench_dir=bench)
    assert cell.config["N"] == 20 and cell.traffic["rows_per_call"] == 4
    assert cell.limits == {"failed": {"max": 0}}
    assert spec.load_reader("queue.solves_seen", bench)(
        {"counts": {"solves": 12}}) == 12
    run = run_tiny(cell, trace=True)
    assert run.metrics == {"queue.solves_seen": {"value": 4,
                                                 "unit": "solves"}}
    with pytest.raises(KeyError):
        spec.load_cell("absent.cell", root=tmp_path, bench_dir=bench)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in BANNED, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("torch", "numpy", "math",
                                          "__future__"), (path, name)


def test_a_run_loads_no_jax_module():
    """Every cell's path at a tiny size, in a fresh process: afterwards no
    loaded module's top-level name, compared whole, is banned."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from tiny import FLEET, QUEUE, STREAM, run_tiny, tiny_cell\n"
        "import run as runmod\n"
        "for name in (QUEUE, STREAM, FLEET):\n"
        "    run_tiny(tiny_cell(name), trace=True)\n"
        "print(runmod.banned_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'mpc_verde_tpu_torch', 'torch'}))\n") % str(Path(__file__).parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert lines[-1] == "['mpc_verde_tpu_torch', 'torch']"
