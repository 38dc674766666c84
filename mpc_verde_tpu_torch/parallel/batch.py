"""Sharded batched solves: each rank solves its shard of the batch, and the
solve statistics are reduced across ranks (port of
``mpc_verde_tpu.parallel.batch``).

Replaces the reference's serial sweep loops (``Phiref.py:24-28`` runs horizon/
weight configs one IPOPT instance at a time) with a data-parallel program: the
batch of MPC problems is split over the ranks of a process group, each rank
solves its shard on its own device, and the only cross-rank traffic is the
all-reduce of scalar solve statistics — no per-problem data crosses ranks
unless ``gather_result`` is asked for it.  The JAX package writes the same
with ``shard_map`` and ``psum`` / ``pmax``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from ..solver.ilqr import ILQRResult


@dataclasses.dataclass
class BatchStats:
    """Global (cross-rank) statistics of a batched solve — the batched
    analogue of IPOPT's per-step status string
    (``Trajectory_tracking.py:110``): one failing batch member must be
    visible without poisoning the batch."""

    n_total: torch.Tensor
    n_converged: torch.Tensor
    mean_cost: torch.Tensor
    max_grad_norm: torch.Tensor
    max_iterations: torch.Tensor


def _check_transport(group, device: torch.device):
    """Tensors on CUDA go over NCCL, CPU tensors over gloo: a group of the
    other kind would stage every reduction through the host (or fail)."""
    backend = dist.get_backend(group)
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(
            f"make_sharded_solver: results on {device} need a {want} group, "
            f"this one is {backend}")


def _stack_results(rows):
    return ILQRResult(**{f.name: torch.stack([getattr(r, f.name) for r in rows])
                         for f in dataclasses.fields(ILQRResult)})


def make_sharded_solver(solve: Callable, group=None, batched: bool = False):
    """Wrap a solver into a batched solve sharded over the ranks of
    ``group`` (default: the whole world).

    ``solve`` is a single-problem ``solve(x0, params, us_init)``
    (``make_ilqr_solver``), which each rank runs problem by problem in a
    loop over its shard and stacks (the JAX package ``vmap``s it), or, with
    ``batched=True``, a batch-major solver (``make_batched_ilqr_solver``,
    ``make_streaming_solver``) applied to the rank's shard in one call.

    Returns ``solve_batch(x0s, params, us_inits) -> (ILQRResult,
    BatchStats)``.  Every rank passes the whole batch (the JAX package's
    global arrays), whose size must be divisible by the group's size; rank
    r solves rows ``[r B / W, (r + 1) B / W)`` and returns its own rows'
    result with the global statistics: ``all_reduce`` SUM of the converged
    count, the problem count and the cost sum, MAX of the gradient norm and
    the iterations.  ``gather_result`` collects the whole batch's result.
    """

    def solve_batch(x0s, params, us_inits):
        g = group or dist.group.WORLD
        W, r = dist.get_world_size(g), dist.get_rank(g)
        B = len(x0s)
        if B % W:
            raise ValueError(f"batch {B} is not divisible by the group's "
                             f"{W} ranks")
        lo, hi = r * (B // W), (r + 1) * (B // W)
        shard = (x0s[lo:hi], params[lo:hi], us_inits[lo:hi])
        if batched:
            res = solve(*shard)
        else:
            res = _stack_results([solve(*(a[i] for a in shard))
                                  for i in range(hi - lo)])
        dev = res.cost.device
        _check_transport(g, dev)
        counts = torch.stack([res.converged.sum(), torch.tensor(
            hi - lo, device=dev)]).to(torch.int64)
        cost_sum = res.cost.sum()
        gmax, imax = res.grad_norm.max(), res.iterations.max()
        for t, op in ((counts, dist.ReduceOp.SUM), (cost_sum, dist.ReduceOp.SUM),
                      (gmax, dist.ReduceOp.MAX), (imax, dist.ReduceOp.MAX)):
            dist.all_reduce(t, op=op, group=g)
        stats = BatchStats(
            n_total=counts[1], n_converged=counts[0],
            mean_cost=cost_sum / counts[1].to(cost_sum.dtype),
            max_grad_norm=gmax, max_iterations=imax)
        return res, stats

    return solve_batch


def gather_result(res: ILQRResult, group=None) -> ILQRResult:
    """The whole batch's result on every rank: ``all_gather`` of each
    field of every rank's shard, in rank order."""
    g = group or dist.group.WORLD
    W = dist.get_world_size(g)
    out = {}
    for f in dataclasses.fields(res):
        t = getattr(res, f.name).contiguous()
        parts = [torch.empty_like(t) for _ in range(W)]
        dist.all_gather(parts, t, group=g)
        out[f.name] = torch.cat(parts)
    return type(res)(**out)
