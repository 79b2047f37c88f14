"""Observability: metrics logging, timers, the program's spans and
counters, and the profiler scope (torch port of
``vln_hamt_tpu/utils/logging.py``; :class:`profile_trace` runs
``torch.profiler`` where the JAX package runs ``jax.profiler``, and
``utils/xprof.py`` reads what it writes).

Parity targets: the reference's record files + TB scalars
(``finetune_src/utils/logger.py``, ``pretrain_src/utils/logger.py``:
``TensorboardLogger`` singleton, append-only ``train.txt``/``valid.txt``).
Here the primary sink is an append-only JSONL metrics file
(machine-readable; one line per event) with optional tensorboardX
mirroring when available, plus wall-clock timers for the per-phase
profiling the reference lacks (SURVEY §5: env-step / H2D / model / eval
timing as a first-class concern). Across ranks only rank 0 writes (the
reference's ``is_default_gpu`` gating).

Spans and counters (:func:`span`, :func:`count`, :class:`SpanRecorder`)
mark the phases of the training update and the device-rollout evaluation
(``agents/agent.py``). They cost nothing while no recorder is open: no
clock, no allocation, no call into torch.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

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


# ---------------------------------------------------------------- spans
#: the open recorder, if any: one per process
_recorder: Optional["SpanRecorder"] = None


class SpanRecord(NamedTuple):
    """One span a ``keep=True`` recorder kept: ``parent`` and ``root``
    index the recorder's ``records`` (``parent`` is -1 for a root, whose
    ``root`` is its own index); times by ``time.perf_counter_ns()``."""

    name: str
    parent: int
    root: int
    start_ns: int
    end_ns: int


class _NoSpan:
    """What :func:`span` returns while no recorder is open."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "name", "index", "parent", "root", "root_name", "start", "children",
                 "annotation")

    def __init__(self, rec: "SpanRecorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        parent = rec._stack[-1] if rec._stack else None
        self.parent, self.index, self.children, self.annotation = parent, rec._next, 0, None
        rec._next += 1
        if parent is None:
            self.root, self.root_name = self.index, self.name
            rec.roots[self.name] += 1
        else:
            self.root, self.root_name = parent.root, parent.root_name
        if rec.keep:
            rec.records.append(None)  # filled in when the span closes
        if torch.autograd.profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        rec._stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rec._stack.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.rec._close(self, end)
        return False


def span(name: str):
    """A context manager that records the block as the span ``name``,
    nested in the span under way, while a :class:`SpanRecorder` is open;
    else the shared no-op :data:`NO_SPAN`. Under an active
    ``torch.profiler`` the span also opens a ``record_function`` of its
    name, so the profiler's traces show the program's phases."""
    rec = _recorder
    if rec is None:
        return NO_SPAN
    return _Span(rec, name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` of the open recorder, if any."""
    rec = _recorder
    if rec is not None:
        rec._count(name, n)


def sync_span():
    """The span of a point where the host waits for the device (a copy to
    it from pageable memory, a read back, an event's wait): ``sync``, each
    counted under ``syncs``."""
    rec = _recorder
    if rec is None:
        return NO_SPAN
    rec._count("syncs", 1)
    return _Span(rec, "sync")


def allocator_counts(device: torch.device):
    """Over the block, on a card and while a recorder is open, counts the
    caching allocator's cudaMalloc and cudaFree calls (``allocator_calls``:
    its ``num_device_alloc`` and ``num_device_free``) and its retries after
    a failed allocation (``alloc_retries``), from ``torch.cuda.memory_stats``."""
    if _recorder is None or device.type != "cuda":
        return NO_SPAN
    return _AllocatorCounts(device)


class _AllocatorCounts:
    def __init__(self, device: torch.device):
        self.device = device

    def _read(self) -> Tuple[int, int]:
        st = torch.cuda.memory_stats(self.device)
        return st["num_device_alloc"] + st["num_device_free"], st["num_alloc_retries"]

    def __enter__(self):
        self.before = self._read()
        return self

    def __exit__(self, *exc):
        calls, retries = self._read()
        count("allocator_calls", calls - self.before[0])
        count("alloc_retries", retries - self.before[1])
        return False


class SpanRecorder:
    """Opens span recording for the process: ``with SpanRecorder() as rec:``.

    A span's root is the outermost span under way when it opened (an
    update's ``train_iteration``, an evaluation's ``eval_split_device``).
    The recorder sums, per (root name, span name), the spans' count, total
    time and self time (the time less what the span's children cover), in
    ns, into ``stats``; the counters per (root name, counter) into
    ``counters`` (root ``""`` outside every span); the roots' calls per
    name into ``roots``. With ``keep`` it also keeps every span, in the
    order they opened, as a :class:`SpanRecord` in ``records``, and each
    root's counters in ``root_counters``: open such a recorder over a
    bounded window.

    It reads one pair of clocks as it opens, so :meth:`to_profiler_ns`
    puts a span's times on the clock of ``torch.profiler``'s events,
    ``time.time_ns()``'s (torch 2.13's host events on the CPU; on an H100
    under torch 2.11 a span around a kernel and the wait for it holds the
    kernel's device interval, ``tests/test_torch_gpu.py``). One recorder
    at a time; spans are opened from one thread.
    """

    def __init__(self, keep: bool = False):
        self.keep = keep
        self.wall0 = self.perf0 = 0
        self.reset()

    def reset(self) -> None:
        """Drops what was recorded."""
        self.stats: Dict[Tuple[str, str], List[int]] = {}
        self.counters: Dict[Tuple[str, str], int] = defaultdict(int)
        self.roots: Dict[str, int] = defaultdict(int)
        self.records: List[Optional[SpanRecord]] = []
        self.root_counters: Dict[int, Dict[str, int]] = {}
        self._stack: List[_Span] = []
        self._next = 0

    def __enter__(self):
        global _recorder
        if _recorder is not None:
            raise RuntimeError("a span recorder is already open")
        self.wall0, self.perf0 = time.time_ns(), time.perf_counter_ns()
        _recorder = self
        return self

    def __exit__(self, *exc):
        global _recorder
        _recorder = None
        return False

    def to_profiler_ns(self, t: int) -> int:
        """A ``time.perf_counter_ns()`` reading on the profiler's clock."""
        return self.wall0 + (t - self.perf0)

    def per_root(self, root: str) -> Tuple[int, Dict[str, List[int]], Dict[str, int]]:
        """(calls of the roots named ``root``, their spans' [count, total
        ns, self ns] by span name, their counters by name)."""
        return (self.roots.get(root, 0),
                {n: v for (r, n), v in self.stats.items() if r == root},
                {n: v for (r, n), v in self.counters.items() if r == root})

    def _close(self, s: _Span, end: int) -> None:
        dur = end - s.start
        if s.parent is not None:
            s.parent.children += dur
        st = self.stats.get((s.root_name, s.name))
        if st is None:
            st = self.stats[(s.root_name, s.name)] = [0, 0, 0]
        st[0] += 1
        st[1] += dur
        st[2] += dur - s.children
        if self.keep:
            self.records[s.index] = SpanRecord(
                s.name, -1 if s.parent is None else s.parent.index, s.root, s.start, end)

    def _count(self, name: str, n: int) -> None:
        top = self._stack[-1] if self._stack else None
        self.counters[(top.root_name if top is not None else "", name)] += n
        if self.keep and top is not None:
            mine = self.root_counters.setdefault(top.root, {})
            mine[name] = mine.get(name, 0) + n


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

    def log_timers(self, step: int, spans: Optional[SpanRecorder] = None) -> None:
        """Each timer's mean (``time/<name>``); with ``spans``, also each
        span's mean self time per update (``span/<name>_ms``) and each
        counter per update (``count/<name>``) over the ``train_iteration``
        spans recorded since the last call, and clears ``spans``."""
        scalars = {f"time/{k}": t.mean for k, t in self.timers.items()}
        if spans is not None:
            n, stats, counters = spans.per_root("train_iteration")
            if n:
                scalars.update({f"span/{k}_ms": v[2] / 1e6 / n for k, v in stats.items()})
                scalars.update({f"count/{k}": v / n for k, v in counters.items()})
            spans.reset()
        self.log(step, scalars)

    def close(self) -> None:
        """Flush and close the TensorBoard mirror, if any."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None
