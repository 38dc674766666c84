from .platform import gpu_info
