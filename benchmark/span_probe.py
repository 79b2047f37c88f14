"""The program's spans and counters in a cell's windows, on the card:

    python3 -m benchmark.span_probe --workload <cell> --seed <n> [--cost_seconds 15 --cost_pairs 4]

sets the cell up as ``benchmark.run`` does, then runs ``trace.profile``'s
first two windows (the untraced units, then the same number with the
device alone traced) with a ``SpanRecorder(keep=True)`` of
``vln_hamt_torch.utils.logging`` open, and prints one JSON line: the
per-unit figures of each window (``spans.window_stats``), the device-only
window's idle by innermost span (``spans.idle_by_span``) and by category
(``spans.idle_parts``, which add up to its ``device_idle``), and the span
metrics a traced run would read. With ``--cost_pairs`` it then times the
cell's window ``2 x cost_pairs`` times, with no recorder open and with a
``keep=True`` one, in turns, and prints a second line: the recorder's
cost on the cell's rate. The cell's check is not run.

The numbers are read here until ``trace.profile`` reads them itself
(ROADMAP E8).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import statistics
import sys
import time
import types

from . import run, spans, trace

#: the root span of each entry's unit
ROOTS = {"finetune": "train_iteration", "eval_greedy": "eval_split_device"}


def _unit(entry_name: str, state):
    if entry_name == "finetune":
        def update():
            state.agent.train_iteration(sync=False)
            state.updates += 1
        return update
    entry = importlib.import_module(f"benchmark.entries.{entry_name}")
    return lambda: entry._call(state)


def probe(fn, units: int, root: str) -> dict:
    """``trace.profile``'s untraced and device-only windows of ``units``
    calls of ``fn``, under an open ``keep=True`` recorder."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from vln_hamt_torch.utils.logging import SpanRecorder

    x = torch.ones(1 << 20, device="cuda")
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(200):
            x.mul_(1.0)
        torch.cuda.synchronize()
    del x
    with SpanRecorder(keep=True) as rec:
        u0 = time.perf_counter_ns()
        host_ms = []
        for _ in range(units):
            th = time.perf_counter()
            fn()
            host_ms.append((time.perf_counter() - th) * 1e3)
        u1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter_ns()
            for _ in range(units):
                fn()
            torch.cuda.synchronize()
            w1 = time.perf_counter_ns()
    dev, _ = trace._events(prof)
    if not dev:
        raise RuntimeError("the profiler recorded no device event")
    window_s = (w1 - w0) / 1e9
    busy_ns, _ = trace._union(sorted((s, e) for s, e, _ in dev))
    idle = spans.idle_stretches((rec.to_profiler_ns(w0), rec.to_profiler_ns(w1)),
                                [(s, e) for s, e, _ in dev])
    by_span = spans.idle_by_span(idle, rec.records, rec.to_profiler_ns)
    return {"window_s": window_s, "busy_s": busy_ns / 1e9,
            "device_idle": 100.0 * (1.0 - busy_ns / 1e9 / window_s), "host_ms": host_ms,
            "untraced": spans.window_stats(rec.records, rec.root_counters, root, u0, u1),
            "traced": spans.window_stats(rec.records, rec.root_counters, root, w0, w1),
            "idle_by_span": by_span, "idle_parts": spans.idle_parts(by_span, window_s)}


def metrics(kind: str, p: dict) -> dict:
    """The span metrics of ROADMAP E8 from a :func:`probe` result."""
    parts, u = p["idle_parts"], p["untraced"]
    if kind == "eval":
        return {"idle_env.eval": parts["env"], "idle_launch.eval": parts["launch"]}
    return {"host_work_ms_per_update.train": u["host_work_ms"],
            "syncs_per_update.train": u["counters"].get("syncs", 0.0),
            "idle_env.train": parts["env"], "idle_launch.train": parts["launch"],
            "allocator_calls_per_update.train": u["counters"].get("allocator_calls")}


def cost(entry, state, seconds: float, pairs: int) -> dict:
    """The cell's window with no recorder open and with a ``keep=True``
    one, in turns (closed first in even pairs, open first in odd)."""
    from vln_hamt_torch.utils.logging import SpanRecorder

    rates = {"closed": [], "open": []}
    for k in range(pairs):
        for kept in ((False, True) if k % 2 == 0 else (True, False)):
            if kept:
                with SpanRecorder(keep=True):
                    v = entry.window(state, seconds)
            else:
                v = entry.window(state, seconds)
            rates["open" if kept else "closed"].append(next(iter(v.values())))
    return {**rates, **{f"{k}_median": statistics.median(v) for k, v in rates.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="The program's spans in a cell's windows.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--cost_seconds", type=float, default=15.0)
    p.add_argument("--cost_pairs", type=int, default=0)
    args = p.parse_args(argv)
    run._cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("span_probe: needs a CUDA device", file=sys.stderr)
        return 2
    cell, config = run.load_cell(args.workload)
    entry = importlib.import_module(f"benchmark.entries.{cell['entry']}")
    ctx = types.SimpleNamespace(name=args.workload, cell=cell, config=config, seed=args.seed,
                                device=torch.device("cuda"), trace=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = entry.setup(ctx)
    torch.cuda.synchronize()
    kind = "eval" if cell["entry"] == "eval_greedy" else "train"
    units = entry.TRACED
    got = probe(_unit(cell["entry"], state), units, ROOTS[cell["entry"]])
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(), "power_limit_w": run.power_limit(),
                      "metrics": metrics(kind, got), "probe": got}), flush=True)
    if args.cost_pairs:
        print(json.dumps({"workload": args.workload, "seed": args.seed,
                          "cost": cost(entry, state, args.cost_seconds, args.cost_pairs)}),
              flush=True)
    del state
    gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
