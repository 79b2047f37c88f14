"""Observability: metrics logging, timers, running meters (torch port of
``vln_hamt_tpu/utils/logging.py``; its JAX profiler scope is not part of
the port, see ROADMAP item A17).

Parity targets: the reference's record files + TB scalars
(``finetune_src/utils/logger.py``, ``pretrain_src/utils/logger.py``:
``TensorboardLogger`` singleton, ``RunningMeter`` EMA, append-only
``train.txt``/``valid.txt``). Here the primary sink is an append-only
JSONL metrics file (machine-readable; one line per event) with optional
tensorboardX mirroring when available, plus wall-clock timers for the
per-phase profiling the reference lacks (SURVEY §5: env-step / H2D /
model / eval timing as a first-class concern). Across ranks only rank 0
writes (the reference's ``is_default_gpu`` gating).
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Any, Dict

from ..parallel.mesh import is_default_process


class Timer:
    """Accumulating wall-clock timer (finetune_src/utils/logger.py:28-57)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0
        self.last = 0.0  # most recent interval (throughput/MFU logging)
        self._start = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self):
        assert self._start is not None
        self.last = time.perf_counter() - self._start
        self.total += self.last
        self.count += 1
        self._start = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


def write_record(path: str, text: str) -> None:
    """Append-only record file (utils/logger.py:8-13); rank 0 writes."""
    if not is_default_process():
        return
    with open(path, "a") as f:
        f.write(text.rstrip() + "\n")


class MetricsLogger:
    """JSONL metrics sink with per-phase timers; rank 0 writes."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        self.timers: Dict[str, Timer] = defaultdict(Timer)
        self.path = os.path.join(log_dir, filename)
        os.makedirs(log_dir, exist_ok=True)

    def timer(self, name: str) -> Timer:
        return self.timers[name]

    def log(self, step: int, scalars: Dict[str, Any], prefix: str = "") -> None:
        rec = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            rec[f"{prefix}{k}"] = float(v) if isinstance(v, (int, float)) else v  # None stays null
        if not is_default_process():
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_timers(self, step: int) -> None:
        self.log(step, {f"time/{k}": t.mean for k, t in self.timers.items()})
