"""Observability: metrics logging, timers, running meters and the
profiler scope (torch port of ``vln_hamt_tpu/utils/logging.py``;
:class:`profile_trace` runs ``torch.profiler`` where the JAX package runs
``jax.profiler``, and ``utils/xprof.py`` reads what it writes).

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
from typing import Any, Dict, Optional

import torch

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


class RunningMeter:
    """EMA-smoothed scalar (pretrain_src/utils/logger.py RunningMeter)."""

    def __init__(self, name: str, smooth: float = 0.99):
        self.name = name
        self.smooth = smooth
        self.val: Optional[float] = None

    def update(self, v: float):
        self.val = v if self.val is None else (
            self.val * self.smooth + v * (1 - self.smooth)
        )


def write_record(path: str, text: str) -> None:
    """Append-only record file (utils/logger.py:8-13); rank 0 writes."""
    if not is_default_process():
        return
    with open(path, "a") as f:
        f.write(text.rstrip() + "\n")


class profile_trace:
    """``torch.profiler`` scope over CPU and (where present) CUDA activity
    that writes one Chrome trace, ``{worker}.{ns}.pt.trace.json``, into
    ``log_dir`` on exit (TensorBoard's profile plugin reads it; so does
    ``python -m vln_hamt_torch.utils.xprof log_dir``). Usage:
    ``with profile_trace("runs/trace"): step()``.

    The tracer starts in a warm-up window whose events are dropped, and
    on a card that window runs :data:`LEAD_IN` short spin kernels and
    waits for them before the recorded window opens: on the H100 a trace
    opened cold lost the first device events of the block (0 to about
    100 of a remat IL update's 24,600 kernels, torch 2.11). So every
    device event of the block is in the trace, and none of the lead-in's.
    """

    #: spin kernels of the warm-up window
    LEAD_IN = 1000

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

        os.makedirs(self.log_dir, exist_ok=True)
        acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                if a in torch.profiler.supported_activities()]
        self._prof = profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                             on_trace_ready=tensorboard_trace_handler(self.log_dir))
        self._prof.__enter__()  # the warm-up window: traced, not kept
        if torch.cuda.is_available():
            for _ in range(self.LEAD_IN):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        self._prof.step()  # the recorded window opens
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the queued kernels land in the trace
        self._prof.__exit__(*exc)


class MetricsLogger:
    """JSONL metrics sink with per-phase timers and, where tensorboardX
    imports, a TensorBoard mirror of its numeric scalars in
    ``log_dir/tb``; rank 0 writes."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        self.timers: Dict[str, Timer] = defaultdict(Timer)
        self.path = os.path.join(log_dir, filename)
        self._tb = None
        os.makedirs(log_dir, exist_ok=True)
        if is_default_process():
            try:  # optional mirror
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))

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
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self._tb.add_scalar(k, v, step)

    def log_timers(self, step: int) -> None:
        self.log(step, {f"time/{k}": t.mean for k, t in self.timers.items()})

    def close(self) -> None:
        """Flush and close the TensorBoard mirror, if any."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None
