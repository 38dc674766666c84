"""Scenario suite (port of ``mpc_verde_tpu.scenarios``): the diff-drive and
circular-track families, the method comparison, the fleet, the linear
rate-form families (LTI and LTV lane change, leitura, the dynamic bicycle,
the cart pendulum), the nonlinear Frenet family and the curvature-cost LTV
family: every family of the JAX package.

Each ``build_*`` function returns a dict with the configured OCP, the
closed-loop runner, the problem tensors and the spec; ``run_*`` runs the
closed loop and returns the JAX package's metrics under the same keys.
Every entry point runs on the CUDA device unless given ``device="cpu"``.
"""
from .diffdrive import build_diffdrive, run_diffdrive
from .circular import build_circular_tracking, run_circular_tracking
from .fleet import SPEC, build_fleet, run_fleet
from .compare import compare_diffdrive_methods
from .lane_change import build_lane_change_lti, run_lane_change_lti
from .ltv import build_lane_change_ltv, build_leitura, run_lane_change_ltv
from .dynamic_bicycle import build_dynamic_bicycle, run_dynamic_bicycle
from .pendulum import build_pendulum, run_pendulum
from .frenet import build_frenet, run_frenet
from .curvature import build_curvature_ltv, run_curvature_ltv
