"""The planar quadrotor's cell on the CPU: it loads by name, its readers
return None where they have nothing to read, its control fails the cell's
limits, and a tiny run of the cell comes out correct."""
from __future__ import annotations

import pytest
import torch

from tiny import BENCH, run_tiny

from harness import check, spec

QUAD = "quadrotor2d_n40.hover-w131072"
READERS = ("k3_roofline.quadrotor2d", "k2_roofline.quadrotor2d",
           "traced.table_fills.queue")
QUEUE_METRICS = {"queue.iters_per_solve", "queue.unconverged_pct",
                 "glue.launches_per_iter.queue", "glue.device_pct.queue",
                 "device.idle_pct.queue"}


def test_new_cell_loads_by_name():
    quad = spec.load_cell(QUAD)
    assert quad.config["model"] == "quadrotor2d" and quad.chips == 1
    assert quad.traffic["width"] == 131072 and quad.traffic["start_box"] == 1.0
    assert {m["name"] for m in quad.end_to_end} == {"solves_per_s", "setup_s"}
    assert set(quad.limits) == {"failed", "x_gap", "cost_gap", "grad_p90"}
    # the unicycle's rooflines count the unicycle's operations: not here
    assert {m["name"] for m in quad.per_layer} == QUEUE_METRICS | set(READERS)
    assert spec.load_program("quadrotor2d", BENCH).build_ocp
    assert spec.load_reference("quadrotor2d", BENCH).projected_gradient


def _trace(kernels):
    return {"kernels": kernels, "calls": 1, "rows_per_call": 64, "width": 16,
            "N": 40, "A": 8, "nx": 6, "nu": 2, "npar": 6, "terms": [],
            "busy_s": 1.0, "window_s": 1.0}


def _ctx(trace):
    return {"counts": {}, "trace": trace, "config": {}, "traffic": {}}


HAND = [("void fused_thread_kernel<UnicycleModel, false>(FusedArgs)", 1e-3),
        ("void linesearch_lanes_kernel<UnicycleModel>(RolloutArgs)", 1e-3),
        ("void linesearch_lanes_kernel<UnicycleModel>(RolloutArgs)", 1e-3)]
TRACED = [(n.replace("UnicycleModel", "(anonymous namespace)::TracedModel"),
           s) for n, s in HAND]


@pytest.mark.parametrize("name", READERS[:2])
def test_roofline_readers_need_traced_kernels(name):
    read = spec.load_reader(name, BENCH)
    assert read(_ctx(None)) is None
    assert read(_ctx(_trace(HAND))) is None
    assert read(_ctx(_trace([("elementwise_kernel", 1e-3)]))) is None
    assert 0.0 < read(_ctx(_trace(TRACED))) < 100.0


def test_table_fills_reader_needs_the_counter(monkeypatch):
    from mpc_verde_tpu_torch.utils import profiling

    read = spec.load_reader("traced.table_fills.queue", BENCH)
    before = profiling.counters()["traced_table_fills"]
    assert read(_ctx(None)) == before   # read with or without a trace
    plain = profiling.counters()
    plain.pop("traced_table_fills")
    monkeypatch.setattr(profiling, "counters", lambda: dict(plain))
    assert read(_ctx(_trace(TRACED))) is None


def _sample(cfg, ref, rows=64, seed=3):
    """Hover-like answers of the reference in float64 at the cell's N,
    kept in float32 as the program returns them."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g, dtype=torch.float64)
    x0 = 2.0 * r(rows, 6) - 1.0
    us = torch.tensor(cfg["u_ref"], dtype=torch.float64) * (
        1.0 + 0.2 * (2.0 * r(rows, cfg["N"], 2) - 1.0))
    xs = ref.rollout(x0, us, cfg)
    return {"x0": x0.float(), "xs": xs.float(), "us": us.float(),
            "cost": ref.cost(xs, us, cfg).float()}


def test_bfloat16_control_fails_where_float32_answers_pass():
    cell = spec.load_cell(QUAD)
    ref = spec.load_reference("quadrotor2d", BENCH)
    sample = _sample(cell.config, ref)
    ours = check.queue_numbers(sample, cell.config, ref)
    low = check.control_answers("queue", sample, cell.config, ref)
    theirs = check.queue_numbers(low, cell.config, ref)
    lim = {k: v["max"] for k, v in cell.limits.items()}
    assert ours["x_gap"] < lim["x_gap"] and ours["cost_gap"] < lim["cost_gap"]
    assert theirs["x_gap"] > lim["x_gap"]
    assert theirs["cost_gap"] > lim["cost_gap"]


def test_tiny_quadrotor_run_is_correct():
    cell = spec.load_cell(QUAD)
    cell.traffic = dict(cell.traffic, width=8, rows_per_call=16,
                        check_rows_per_call=8)
    cell.config = dict(cell.config, N=8)
    run = run_tiny(cell)
    assert run.correct and run.out.failed == 0
    assert run.out.counts["solves"] == 16
    assert run.out.counts["converged"] >= 15
