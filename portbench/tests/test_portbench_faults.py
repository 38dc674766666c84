"""The comparison that decides ``correct`` fails what it must: a whole run
of a cell, cut to a CPU size, with the timed path broken underneath, comes
out not correct for each fault the cell can have, and so does the control
(the reference in the program's place in bfloat16); the same run with
nothing broken comes out correct.  One chip, so no exchange between chips
to leave out.
"""
from __future__ import annotations

import pytest
import torch

from tiny import FLEET, IPM, QUEUE, STREAM, run_tiny, tiny_cell

import mpc_verde_tpu_torch
import mpc_verde_tpu_torch.runtime as runtime
import mpc_verde_tpu_torch.solver.batched as batched
from harness import cell as cellmod

CELLS = (QUEUE, STREAM, IPM, FLEET)


def _unchanged(monkeypatch):
    """Every solver iteration returns its state unchanged: the line search
    steps with zero gains."""
    orig = batched.linesearch_forward_torch

    def ls(x0s, xs, us, ps, kffs, Ks, alphas, ocp):
        return orig(x0s, xs, us, ps, torch.zeros_like(kffs),
                    torch.zeros_like(Ks), (1.0,), ocp=ocp)

    monkeypatch.setattr(batched, "linesearch_forward_torch", ls)


def _wrap_results(monkeypatch, alter):
    """Every solver factory's answers pass through ``alter(x0s, result)``."""
    import dataclasses

    def wrap(factory):
        def make(ocp, *a, **kw):
            solve = factory(ocp, *a, **kw)

            def run(x0s, *args, **kwargs):
                return dataclasses.replace(
                    solve(x0s, *args, **kwargs),
                    **alter(x0s, solve, args, kwargs))
            return run
        return make

    for name in ("make_batched_ilqr_solver", "make_streaming_solver",
                 "make_streaming_barrier_solver"):
        monkeypatch.setattr(mpc_verde_tpu_torch, name,
                            wrap(getattr(mpc_verde_tpu_torch, name)))


def _half_left_out(monkeypatch):
    """Only the first half of each batch is solved; the second half gets
    copies of the first half's answers."""
    def alter(x0s, solve, args, kwargs):
        h = (x0s.shape[0] + 1) // 2
        sub = lambda a: a[:h] if torch.is_tensor(a) and a.shape[:1] == \
            x0s.shape[:1] else a
        r = solve(x0s[:h], *(sub(a) for a in args),
                  **{k: sub(v) for k, v in kwargs.items()})
        n = x0s.shape[0]
        dup = lambda a: torch.cat([a, a])[:n]
        return {f: dup(getattr(r, f)) for f in
                ("xs", "us", "cost", "grad_norm", "iterations", "converged",
                 "max_violation")}
    _wrap_results(monkeypatch, alter)


def _answer_altered(monkeypatch):
    """Each solve's first control is moved by 0.3 toward the middle of the
    box where it is produced; states and cost are left as computed."""
    def alter(x0s, solve, args, kwargs):
        r = solve(x0s, *args, **kwargs)
        us = r.us.clone()
        us[:, 0, 0] -= 0.3 * torch.sign(us[:, 0, 0] + 1e-9)
        return {"us": us}
    _wrap_results(monkeypatch, alter)


def _plant_unchanged(monkeypatch):
    """The closed loop's plant returns the state it was given."""
    orig = runtime.make_batched_receding_horizon

    def make(ocp, solve, plant, n_steps, **kw):
        return orig(ocp, solve, lambda x, u, p: x + 0.0 * u.sum(), n_steps,
                    **kw)

    monkeypatch.setattr(runtime, "make_batched_receding_horizon", make)


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_control_is_not(name):
    run = run_tiny(tiny_cell(name), control=True)
    assert run.correct, cellmod.check_lines(run.checks)
    assert not run.control["correct"], run.control["readings"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_run_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    run = run_tiny(tiny_cell(name))
    assert not run.correct, cellmod.check_lines(run.checks)


def test_fleet_plant_unchanged_is_not_correct(monkeypatch):
    _plant_unchanged(monkeypatch)
    run = run_tiny(tiny_cell(FLEET))
    assert not run.checks["plant_gap"]["ok"]
    assert not run.correct
