"""Checkpoint/resume for long closed-loop simulations (port of
``mpc_verde_tpu.runtime.checkpoint``).

The reference has no in-process checkpointing (SURVEY.md §5.4): closed-loop
results are dumped to xlsx/csv only at the end, and a crash loses the run.
Here the receding-horizon loop runs in segments with its full resumable
state — current plant state, warm-start plan, step index, and accumulated
history — persisted between segments as npz files on local disk.  The files
are those of the JAX package, key for key, so either package's
``SegmentedRun`` resumes a run the other checkpointed.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from .receding import ClosedLoopResult
from ..utils.tree import to_numpy


def save_checkpoint(path: str, state: dict) -> str:
    """Persist a resumable-state dict of arrays (atomic rename)."""
    p = Path(path)
    tmp = p.with_suffix(".tmp.npz")
    np.savez(tmp, **{k: to_numpy(v) for k, v in state.items()})
    tmp.replace(p)
    return str(p)


def load_checkpoint(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@dataclasses.dataclass
class SegmentedRun:
    """Run a closed loop in checkpointed segments.

    ``make_runner(n_steps)`` must return a receding-horizon runner for a
    segment of that length (``runtime.make_receding_horizon``); the runner
    for a full segment is built once and reused for every full segment.
    Each runner takes the state and warm start as they come from the last
    segment or the checkpoint (numpy arrays on resume) and casts them to
    its OCP's device and dtype.
    """

    make_runner: Callable[[int], Callable]
    segment_steps: int
    checkpoint_path: Optional[str] = None

    def _seg_path(self, idx: int) -> Path:
        return Path(f"{self.checkpoint_path}.seg{idx:05d}.npz")

    def run(self, x0, params_seq, plant_params=None, us_init=None,
            resume: bool = True):
        """Run ``len(params_seq)`` steps from ``x0``, from the checkpoint
        where ``resume`` and the checkpoint is of this run (same step count
        and initial state); returns {"xs", "us", "converged"} as numpy
        arrays over the whole run."""
        n_total = len(params_seq)
        start = 0
        seg_idx = 0
        hist_xs, hist_us, hist_conv = [], [], []
        x0 = to_numpy(x0)
        x = x0
        warm = us_init

        if resume and self.checkpoint_path and Path(self.checkpoint_path).is_file():
            ck = load_checkpoint(self.checkpoint_path)
            # a stale checkpoint from a *different* run (other initial state
            # or run length) must not be silently resumed
            same_run = (int(ck.get("n_total", -1)) == n_total
                        and ck["x0"].shape == x0.shape
                        and np.allclose(ck["x0"], x0))
            if same_run:
                start = int(ck["step"])
                seg_idx = int(ck["segments"])
                x = ck["x"]
                warm = ck["warm"]
                for i in range(seg_idx):
                    seg = load_checkpoint(self._seg_path(i))
                    hist_xs.append(seg["xs"])
                    hist_us.append(seg["us"])
                    hist_conv.append(seg["converged"])

        runner = self.make_runner(self.segment_steps)
        while start < n_total:
            n = min(self.segment_steps, n_total - start)
            r = runner if n == self.segment_steps else self.make_runner(n)
            seg_params = params_seq[start:start + n]
            seg_plant = (None if plant_params is None
                         else plant_params[start:start + n])
            res: ClosedLoopResult = r(x, seg_params, seg_plant, warm)
            seg_hist = {"xs": to_numpy(res.xs[:-1]), "us": to_numpy(res.us),
                        "converged": to_numpy(res.converged)}
            hist_xs.append(seg_hist["xs"])
            hist_us.append(seg_hist["us"])
            hist_conv.append(seg_hist["converged"])
            x = res.xs[-1]
            warm = res.final_warm
            start += n
            if self.checkpoint_path:
                # per-segment history files + a small head state: I/O stays
                # linear in run length instead of re-serializing everything
                save_checkpoint(str(self._seg_path(seg_idx)), seg_hist)
                seg_idx += 1
                save_checkpoint(self.checkpoint_path, {
                    "step": start, "segments": seg_idx, "x": x, "warm": warm,
                    "n_total": n_total, "x0": x0,
                })

        xs = np.concatenate(hist_xs + [to_numpy(x)[None]])
        us = np.concatenate(hist_us)
        conv = np.concatenate(hist_conv)
        return {"xs": xs, "us": us, "converged": conv}
