"""Whether what the timed path returned is correct, judged by the plain
reference.

The drivers keep a sample, drawn from the seed, of the answers that the
timed window produced at the timed sizes.  Once the window has closed the
reference (``reference/<model>.py``) works out again, in float64, what the
program derived from the harness's inputs, and these numbers compare it:

* a queue's solve (``queue_numbers``): ``x_gap``, the largest gap between
  the returned states and the reference's rollout of the returned controls
  from the start, each relative to max(1, |x|); ``cost_gap``, the largest
  gap between the returned cost and the reference's cost of that rollout,
  relative to max(1, |cost|); ``grad_p90``, the 90th percentile over the
  sampled solves of the largest component of the projected gradient of the
  cost with respect to the controls (``reference.projected_gradient``).
  Its largest value, ``grad_max``, is printed beside it and not compared:
  the solver's own test stops a solve whose cost moves by less than
  ``tol_cost`` of itself, which leaves gradients up to about 2 on costs of
  about 10^4, so the largest swings with the seed;
* a closed-loop step (``fleet_numbers``): ``plant_gap``, the largest gap
  between the state the program's plant produced and the reference's plant
  step from the program's state under the applied control; the plan's
  ``cost_gap`` and ``grad_p90`` from the program's state, as above.

The control (``control_answers``) puts the reference in the program's
place, computed in bfloat16, the precision below the configuration's
float32: the program's controls rounded to it, the states and costs worked
out in it.  Its numbers are read by ``control.py`` and never by a
benchmark run.
"""
from __future__ import annotations

import torch

BLOCK = 32768


def _rel_gap(a, b):
    """(rows,) largest |a - b| / max(1, |b|) over every other axis."""
    g = (a - b).abs() / b.abs().clamp(min=1.0)
    return g.reshape(g.shape[0], -1).amax(dim=1)


def _blocks(sample: dict):
    rows = next(iter(sample.values())).shape[0]
    for s in range(0, rows, BLOCK):
        yield {k: v[s:s + BLOCK].double() for k, v in sample.items()}


def _finish(gaps: dict, grads: list) -> dict:
    out = {k: float(torch.cat(v).max()) for k, v in gaps.items()}
    g = torch.cat(grads)
    out["grad_p90"] = float(torch.quantile(g, 0.9))
    out["grad_max"] = float(g.max())
    return out


def queue_numbers(sample: dict, cfg: dict, ref) -> dict:
    """Numbers of the sampled solves: ``sample`` holds x0 (k, nx), xs (k,
    N+1, nx), us (k, N, nu) and cost (k,)."""
    gaps, grads = {"x_gap": [], "cost_gap": []}, []
    for b in _blocks(sample):
        xr = ref.rollout(b["x0"], b["us"], cfg)
        gaps["x_gap"].append(_rel_gap(b["xs"], xr))
        gaps["cost_gap"].append(_rel_gap(b["cost"][:, None],
                                         ref.cost(xr, b["us"], cfg)[:, None]))
        grads.append(ref.projected_gradient(b["x0"], b["us"], cfg))
    return _finish(gaps, grads)


def fleet_numbers(sample: dict, cfg: dict, ref) -> dict:
    """Numbers of the sampled closed-loop steps: ``sample`` holds x (k, nx)
    the program's state, plan (k, N, nu) the solve's controls (the first
    one applied), cost (k,) and x_next (k, nx) the program's next state."""
    gaps, grads = {"plant_gap": [], "cost_gap": []}, []
    for b in _blocks(sample):
        gaps["plant_gap"].append(_rel_gap(
            b["x_next"], ref.plant_step(b["x"], b["plan"][:, 0], cfg)))
        xr = ref.rollout(b["x"], b["plan"], cfg)
        gaps["cost_gap"].append(_rel_gap(b["cost"][:, None],
                                         ref.cost(xr, b["plan"], cfg)[:, None]))
        grads.append(ref.projected_gradient(b["x"], b["plan"], cfg))
    return _finish(gaps, grads)


NUMBERS = {"queue": queue_numbers, "fleet": fleet_numbers}


def control_answers(kind: str, sample: dict, cfg: dict, ref,
                    dtype=torch.bfloat16) -> dict:
    """The sample's answers as the reference computes them in ``dtype``
    from the program's controls rounded to it (float32 tensors)."""
    low = {k: v.to(dtype) for k, v in sample.items()}
    if kind == "queue":
        xs = ref.rollout(low["x0"], low["us"], cfg)
        out = dict(sample, xs=xs, us=low["us"], cost=ref.cost(xs, low["us"], cfg))
    else:
        xs = ref.rollout(low["x"], low["plan"], cfg)
        out = dict(sample, plan=low["plan"],
                   cost=ref.cost(xs, low["plan"], cfg),
                   x_next=ref.plant_step(low["x"], low["plan"][:, 0], cfg))
    return {k: v.float() for k, v in out.items()}


def judge(readings: dict, limits: dict) -> dict:
    """{name: {"value", "op", "limit", "ok"}} for every limit in
    ``limits`` ({name: {"max": v} or {"min": v}}); a number the run did not
    produce is not ok."""
    out = {}
    for name, lim in limits.items():
        (op, bound), = lim.items()
        v = readings.get(name)
        ok = v is not None and v == v and (v <= bound if op == "max"
                                           else v >= bound)
        out[name] = {"value": v, "op": "<=" if op == "max" else ">=",
                     "limit": bound, "ok": bool(ok)}
    return out
