from .logging import Color
from .memory import cache_size_mb, device_memory_stats, print_device_stats
from .profiling import profile_trace, step_timer

__all__ = [
    "Color",
    "cache_size_mb",
    "device_memory_stats",
    "print_device_stats",
    "profile_trace",
    "step_timer",
]
