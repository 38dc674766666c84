"""The plain reference agrees with the port's ``"torch"`` backend at tiny
sizes in float64: the same rollout, cost and plant step, and the port's
float64 answers are first-order optimal by the reference's gradient."""
from __future__ import annotations

import pytest
import torch
from torch.func import vmap

from tiny import BENCH, FLEET, QUEUE, tiny_cell

from harness import check, spec
from mpc_verde_tpu_torch import ILQROptions, make_batched_ilqr_solver

F64 = torch.float64


def _port(cfg):
    program = spec.load_program(cfg["model"], BENCH)
    cfg = dict(cfg, dtype="float64")
    return program, program.build_ocp(cfg, torch.device("cpu"))


@pytest.mark.parametrize("name", (QUEUE, FLEET))
def test_rollout_and_cost_match_the_port(name):
    cfg = tiny_cell(name).config
    ref = spec.load_reference(cfg["model"], BENCH)
    _, ocp = _port(cfg)
    g = torch.Generator().manual_seed(5)
    B, N = 6, cfg["N"]
    x0 = 4.0 * torch.rand((B, 3), generator=g, dtype=F64) - 2.0
    us = torch.rand((B, N, 2), generator=g, dtype=F64) - 0.5
    ps = torch.tensor(cfg["target"], dtype=F64).expand(B, 3)
    xs = [x0]
    for k in range(N):
        xs.append(vmap(ocp.dynamics)(xs[-1], us[:, k], ps))
    xs = torch.stack(xs, 1)
    costs = sum(vmap(ocp.stage_cost)(xs[:, k], us[:, k], ps) for k in range(N))
    assert torch.allclose(ref.rollout(x0, us, cfg), xs, rtol=1e-12, atol=1e-12)
    assert torch.allclose(ref.cost(xs, us, cfg), costs, rtol=1e-6)


def test_plant_step_matches_the_port():
    cfg = tiny_cell(FLEET).config
    ref = spec.load_reference(cfg["model"], BENCH)
    program, _ = _port(cfg)
    plant = program.plant(cfg)
    x = torch.tensor([[0.5, -1.0, 0.3], [1.0, 2.0, -1.2]], dtype=F64)
    u = torch.tensor([[0.7, -0.2], [-1.0, 0.785]], dtype=F64)
    want = torch.stack([plant(xi, ui, None) for xi, ui in zip(x, u)])
    assert torch.allclose(ref.plant_step(x, u, cfg), want, atol=1e-14)


def test_port_answers_pass_the_reference_numbers():
    cfg = tiny_cell(QUEUE).config
    ref = spec.load_reference(cfg["model"], BENCH)
    _, ocp = _port(cfg)
    g = torch.Generator().manual_seed(9)
    x0 = 4.0 * torch.rand((8, 3), generator=g, dtype=F64) - 2.0
    opts = ILQROptions(**dict(cfg["solver"], tol_grad=1e-9, tol_cost=1e-13))
    r = make_batched_ilqr_solver(ocp, opts)(
        x0, torch.tensor(cfg["target"], dtype=F64))
    assert bool(r.converged.all())
    nums = check.queue_numbers({"x0": x0, "xs": r.xs, "us": r.us,
                                "cost": r.cost}, cfg, ref)
    assert nums["x_gap"] < 1e-12 and nums["cost_gap"] < 1e-9
    assert nums["grad_max"] < 1e-3
