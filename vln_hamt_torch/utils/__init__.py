from .logging import MetricsLogger, SpanRecorder, Timer, count, span, write_record
from .misc import set_seed, length_mask

__all__ = [
    "MetricsLogger",
    "SpanRecorder",
    "Timer",
    "count",
    "span",
    "write_record",
    "set_seed",
    "length_mask",
]
