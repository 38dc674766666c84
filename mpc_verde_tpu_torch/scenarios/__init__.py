"""Scenario suite (port of ``mpc_verde_tpu.scenarios``): the diff-drive and
circular-track families, the method comparison and the fleet.

Each ``build_*`` function returns a dict with the configured OCP, the
closed-loop runner, the problem tensors and the spec; ``run_*`` runs the
closed loop and returns the JAX package's metrics under the same keys.
Every entry point runs on the CUDA device unless given ``device="cpu"``.
"""
from .diffdrive import build_diffdrive, run_diffdrive
from .circular import build_circular_tracking, run_circular_tracking
from .fleet import SPEC, build_fleet, run_fleet
from .compare import compare_diffdrive_methods
