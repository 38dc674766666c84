"""Run the ported scenario families end to end and print their metrics.

Usage:
    python -m mpc_verde_tpu_torch.scenarios.run_all [--quick] [--family NAME] [--cpu]

Families: diffdrive, circular, lti, ltv, dynamic, pendulum, frenet,
curvature, fleet (default: all).  They run on the CUDA device in float32 by
default; ``--cpu`` runs them on the CPU in float64.  One JSON line a family;
the exit code is 1 if any family raised.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

NOT_PORTED = ()   # the JAX package's families without a port: none


def families(quick: bool, **kw) -> dict:
    """Name -> a call that builds and runs the family's closed loop with
    ``kw`` (device, dtype), short where ``quick``."""
    from mpc_verde_tpu_torch import scenarios as sc

    n = 120 if quick else None
    # lane-change families: the synthetic maneuver spans samples 125-375 of
    # the 500-sample course, so the quick window must cover it
    nlc = 400 if quick else None
    return {
        "diffdrive": lambda: sc.run_diffdrive(sc.build_diffdrive(
            n_steps=min(n or 100, 100), **kw)),
        "circular": lambda: sc.run_circular_tracking(
            sc.build_circular_tracking(n_steps=n, **kw)),
        "lti": lambda: sc.run_lane_change_lti(
            sc.build_lane_change_lti(n_steps=nlc, **kw)),
        "ltv": lambda: sc.run_lane_change_ltv(
            sc.build_lane_change_ltv(n_steps=nlc, **kw)),
        "dynamic": lambda: sc.run_dynamic_bicycle(
            sc.build_dynamic_bicycle(n_steps=nlc, **kw)),
        "pendulum": lambda: sc.run_pendulum(sc.build_pendulum(
            n_steps=min(n or 1000, 1000), **kw)),
        "frenet": lambda: sc.run_frenet(sc.build_frenet(n_steps=n, **kw)),
        "curvature": lambda: sc.run_curvature_ltv(sc.build_curvature_ltv(
            n_steps=300 if quick else None, **kw)),
        "fleet": lambda: sc.run_fleet(sc.build_fleet(
            B=64 if quick else 1024, n_steps=n, **kw)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="short closed loops")
    ap.add_argument("--family", default="all")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in float64")
    args = ap.parse_args(argv)

    kw = (dict(device="cpu", dtype=torch.float64) if args.cpu
          else dict(device=None, dtype=torch.float32))
    fams = families(args.quick, **kw)
    names = list(fams) if args.family == "all" else [args.family]

    failures = 0
    for name in names:
        t0 = time.time()
        try:
            m = fams[name]()
            metrics = {k: v for k, v in m.items()
                       if isinstance(v, (int, float, bool))}
            metrics["wall_s"] = round(time.time() - t0, 1)
            print(json.dumps({"family": name, **metrics}), flush=True)
        except Exception as e:  # one family's failure does not stop the rest
            failures += 1
            print(json.dumps({"family": name, "error": repr(e)}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
