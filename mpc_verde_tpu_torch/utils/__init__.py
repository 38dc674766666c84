from .tree import to_numpy, tree_where
from .timing import Timer, device_time_ms, timed
from .platform import gpu_info, scenario_device
from .profiling import SolvePhaseTimer, device_trace
