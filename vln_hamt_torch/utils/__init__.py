from .logging import MetricsLogger, RunningMeter, Timer, write_record
from .misc import set_seed, length_mask

__all__ = [
    "MetricsLogger",
    "RunningMeter",
    "Timer",
    "write_record",
    "set_seed",
    "length_mask",
]
