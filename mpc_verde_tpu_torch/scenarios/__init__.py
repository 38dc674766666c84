"""Scenario suite (port of ``mpc_verde_tpu.scenarios``): so far the fleet.

Each ``build_*`` function returns a dict with the configured OCP, the
closed-loop runner, the problem tensors and the spec; ``run_*`` runs the
closed loop and returns the JAX package's metrics under the same keys.
"""
from .fleet import SPEC, build_fleet, run_fleet
