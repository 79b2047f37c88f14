"""The traced window: ``torch.profiler`` over a few units of work, read in
memory into the summary that the per-layer metrics read.

The numbers come from a window in which only the device is traced,
since tracing the host slows it and the device then idles for the
tracer: the window's wall time by the host's clock (``window_s``), the
device's busy time in it (the union of the device events' intervals,
``busy_s``), the device time and launches by kernel name, and the
attention kernels' time as the table ``attention_kernels.json`` names
them. The host's time to issue each unit comes from as many units run
untraced just before. A third window, with the host traced too, names
the longest idle gaps of the result's ``breakdown`` by the harness's
span and the innermost host operation under way when each began; the
device operations of the breakdown come from the first traced window.
The device's copies of host spans are no device work and are left out.

A trace without device events raises: the readers never see zeros.
"""

from __future__ import annotations

import bisect
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

KERNEL_TABLE = Path(__file__).resolve().parent / "attention_kernels.json"
WINDOW = "bench_window"


def attention_kind(name: str, table: Dict[str, List[str]]) -> str:
    """``bwd``, ``fwd`` or ``""``: which attention pass a kernel serves."""
    low = name.lower()
    for kind in ("bwd", "fwd"):
        if any(p in low for p in table[kind]):
            return kind
    return ""


def _union(spans: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """(busy ns, idle gaps) of sorted intervals."""
    busy, gaps = 0, []
    start, end = spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy += end - start
            gaps.append((end, s))
            start, end = s, e
        else:
            end = max(end, e)
    return busy + end - start, gaps


def _events(prof):
    """(device events, host events) of a profile as (start ns, end ns,
    name); the device's copies of host spans are no device work."""
    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type())
        if "CUDA" in kind and not e.is_user_annotation():
            dev.append((e.start_ns(), e.end_ns(), e.name()))
        elif "CPU" in kind:
            cpu.append((e.start_ns(), e.end_ns(), e.name()))
    return dev, cpu


def profile(fn: Callable[[], object], units: int, label: str, device) -> dict:
    """Run ``fn`` ``units`` times untraced, timing each call on the host;
    then ``units`` times with the device alone traced, which gives every
    number; then ``units`` times with the host traced too, which names the
    idle gaps of the breakdown (tracing the host slows it, so those gaps
    run long)."""
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    if device.type != "cuda":
        raise RuntimeError("the traced window reads device events: it needs the card")
    x = torch.ones(1 << 20, device=device)
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(200):
            x.mul_(1.0)
        torch.cuda.synchronize()
    del x
    host_ms = []
    for _ in range(units):
        th = time.perf_counter()
        fn()
        host_ms.append((time.perf_counter() - th) * 1e3)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev_ev, _ = _events(prof)
    if not dev_ev:
        raise RuntimeError("the profiler recorded no device event: no per-layer metric")
    spans = sorted((s, e) for s, e, _ in dev_ev)
    busy_ns, _ = _union(spans)
    table = json.loads(KERNEL_TABLE.read_text())
    kernels: Dict[str, List[float]] = {}
    attn = {"fwd": 0.0, "bwd": 0.0}
    for s, e, name in dev_ev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) / 1e9
        k[1] += 1
        kind = attention_kind(name, table)
        if kind:
            attn[kind] += (e - s) / 1e9
    top_ops = sorted(([n, v[0]] for n, v in kernels.items()), key=lambda r: -r[1])[:10]
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(units):
                with record_function(label):
                    fn()
            torch.cuda.synchronize()
    named_dev, cpu_ev = _events(prof)
    win = next((s, e) for s, e, n in cpu_ev if n == WINDOW)
    nspans = sorted((max(s, win[0]), min(e, win[1])) for s, e, _ in named_dev
                    if e > win[0] and s < win[1])
    _, gaps = _union(nspans)
    gaps = [(win[0], nspans[0][0])] + gaps + [(nspans[-1][1], win[1])]
    return {"window_s": window_s, "busy_s": busy_ns / 1e9, "kernels": kernels,
            "launches": len(dev_ev), "attn_fwd_s": attn["fwd"], "attn_bwd_s": attn["bwd"],
            "host_ms": host_ms,
            "breakdown": {"device_ops": top_ops, "idle_gaps": _name_gaps(gaps, cpu_ev, label)}}


def _name_gaps(gaps, cpu_ev, label: str) -> List[list]:
    """The ten longest gaps, each named by the innermost host operation
    that was under way when it began."""
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    cpu = sorted(cpu_ev)
    starts = [c[0] for c in cpu]
    out = []
    for s, e in longest:
        under = [c for c in cpu[:bisect.bisect_right(starts, s)] if c[1] >= s
                 and c[2] not in (WINDOW, label)]
        inner = min(under, key=lambda c: c[1] - c[0])[2] if under else "host between units"
        outer = label if any(c[2] == label and c[0] <= s <= c[1] for c in cpu) else "harness"
        out.append([f"{outer}/{inner}", (e - s) / 1e9])
    return out
