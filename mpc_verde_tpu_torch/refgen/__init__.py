"""Reference generators (port of ``mpc_verde_tpu.refgen``): so far the
trajectory generators."""
from .trajectories import (circular_reference_params,
                           double_lane_change_course,
                           extend_lane_change_course, synthetic_lane_change)
