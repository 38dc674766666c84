from .platform import gpu_info
from .timing import device_time_ms
