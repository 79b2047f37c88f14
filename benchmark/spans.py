"""The program's spans (``vln_hamt_torch/utils/logging.py``) against a
traced window: what the host was doing while the device idled.

A ``SpanRecorder(keep=True)`` open over a window gives its spans in the
order they opened, each with its parent and root. :func:`window_stats`
turns the units (root spans) of a window into per-unit figures: the host's
work (a root's time less the ``sync`` spans under it, where the host
waited for the device), each span's count, total and self time, and each
counter. :func:`idle_by_span` charges every nanosecond of a device-only
window's idle stretches (its gaps between device events, and the
stretches from the window's start to its first event and from its last
event to its end) to the innermost span under way at that instant, or to
``outside`` where none was; the spans' times go to the profiler's clock
through the recorder's ``to_profiler_ns``. :func:`idle_parts` sums those
charges by the spans' categories over the window's wall time, so the
parts add up to the window's ``device_idle``.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

#: span names by category: the host's env work, the enqueue of device
#: work (model, autograd, optimizer), and waits for the device
ENV = ("teacher_episode", "rollout_inputs", "decode")
LAUNCH = ("forward", "backward", "optimizer", "rollout")
SYNC = ("sync",)
#: idle under no span
OUTSIDE = "outside"


def category(name: str) -> str:
    """``env``, ``launch``, ``sync``, ``outside``, or ``root`` for the own
    time of a root span (an update, an evaluation call) between its
    phases."""
    for cat, names in (("env", ENV), ("launch", LAUNCH), ("sync", SYNC)):
        if name in names:
            return cat
    return OUTSIDE if name == OUTSIDE else "root"


def timeline(records: Sequence, to_ns: Callable[[int], int] = lambda t: t
             ) -> List[Tuple[int, int, str]]:
    """(start, end, name) stretches, in time order and apart, each under
    the innermost of ``records`` (spans that nest, as one thread opens
    them) under way in it; stretches under no span are left out."""
    spans = sorted((to_ns(r.start_ns), -to_ns(r.end_ns), r.name) for r in records)
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []  # (end, name) of the spans under way
    at = None

    def emit(t0, t1, name):
        if t1 > t0:
            out.append((t0, t1, name))

    for start, neg_end, name in spans:
        while stack and stack[-1][0] <= start:
            end, inner = stack.pop()
            emit(at, end, inner)
            at = end
        if stack:
            emit(at, start, stack[-1][1])
        stack.append((-neg_end, name))
        at = start
    while stack:
        end, inner = stack.pop()
        emit(at, end, inner)
        at = end
    return out


def idle_by_span(idle: Iterable[Tuple[int, int]], records: Sequence,
                 to_ns: Callable[[int], int] = lambda t: t) -> Dict[str, float]:
    """Seconds of the idle stretches ``idle`` ((start, end) on the
    profiler's clock) under each innermost span name, and ``outside``."""
    line = timeline(records, to_ns)
    starts = [s for s, _, _ in line]
    out: Dict[str, float] = {}
    for g0, g1 in idle:
        if g1 <= g0:
            continue
        covered = 0
        k = max(bisect.bisect_right(starts, g0) - 1, 0)
        while k < len(line) and line[k][0] < g1:
            s, e, name = line[k]
            part = min(e, g1) - max(s, g0)
            if part > 0:
                out[name] = out.get(name, 0.0) + part / 1e9
                covered += part
            k += 1
        if g1 - g0 > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (g1 - g0 - covered) / 1e9
    return out


def idle_stretches(window: Tuple[int, int], device: Sequence[Tuple[int, int]]
                   ) -> List[Tuple[int, int]]:
    """The device's idle stretches in ``window`` (start, end): the gaps
    between its events' union, and the window's ends before the first
    event and after the last."""
    w0, w1 = window
    spans = sorted((max(s, w0), min(e, w1)) for s, e in device if e > w0 and s < w1)
    if not spans:
        return [window]
    out, at = [], w0
    for s, e in spans:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if w1 > at:
        out.append((at, w1))
    return out


def idle_parts(by_span: Dict[str, float], window_s: float) -> Dict[str, float]:
    """The idle seconds of :func:`idle_by_span` by category, as % of the
    window's wall time."""
    parts = {c: 0.0 for c in ("env", "launch", "sync", "root", OUTSIDE)}
    for name, sec in by_span.items():
        parts[category(name)] += 100.0 * sec / window_s
    return parts


def window_stats(records: Sequence, root_counters: Dict[int, Dict[str, int]], root: str,
                 start_ns: int, end_ns: int) -> dict:
    """Per unit, over the roots named ``root`` that opened in [start_ns,
    end_ns) (the recorder's clock): ``host_work_ms`` (a root's time less
    its ``sync`` spans), and each span's ``count``, ``total_ms`` and
    ``self_ms`` and each counter, by name; ``units`` counts the roots."""
    roots = {i for i, r in enumerate(records)
             if r.parent < 0 and r.name == root and start_ns <= r.start_ns < end_ns}
    n = len(roots)
    if not n:
        return {"units": 0, "host_work_ms": None, "spans": {}, "counters": {}}
    child_ns: Dict[int, int] = {}
    for r in records:
        if r.root in roots and r.parent >= 0:
            child_ns[r.parent] = child_ns.get(r.parent, 0) + r.end_ns - r.start_ns
    spans: Dict[str, Dict[str, float]] = {}
    work_ns = 0
    for i, r in enumerate(records):
        if r.root not in roots:
            continue
        dur = r.end_ns - r.start_ns
        st = spans.setdefault(r.name, {"count": 0.0, "total_ms": 0.0, "self_ms": 0.0})
        st["count"] += 1 / n
        st["total_ms"] += dur / 1e6 / n
        st["self_ms"] += (dur - child_ns.get(i, 0)) / 1e6 / n
        work_ns += dur if r.parent < 0 else -dur if r.name in SYNC else 0
    counters: Dict[str, float] = {}
    for i in roots:
        for name, v in root_counters.get(i, {}).items():
            counters[name] = counters.get(name, 0.0) + v / n
    return {"units": n, "host_work_ms": work_ns / 1e6 / n, "spans": spans,
            "counters": counters}
