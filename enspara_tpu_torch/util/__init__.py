"""Device selection, trajectory loading and timing helpers."""
from .log import timed, trace_region, device_memory_stats, setup_logging
