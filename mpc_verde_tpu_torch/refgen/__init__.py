"""Reference generators (port of ``mpc_verde_tpu.refgen``): the trajectory
generators, the lateral-error reference synthesis and the CSV loader."""
from .trajectories import (circular_reference_params,
                           double_lane_change_course,
                           extend_lane_change_course, synthetic_lane_change)
from .synthesis import lateral_error_references, path_heading, stage_param_tensor
from .io import load_path_csv, reference_data_dir
