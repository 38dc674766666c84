from .platform import gpu_info, scenario_device
from .timing import device_time_ms
