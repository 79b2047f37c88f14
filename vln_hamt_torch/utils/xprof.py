"""Per-category device-time breakdown of a ``torch.profiler`` trace, the
port's counterpart of ``vln_hamt_tpu/utils/xprof.py``.

``utils/logging.py:profile_trace`` writes a Chrome trace
(``*.pt.trace.json``, or ``*.json.gz``) into its directory; this tool
reads every such file under a directory and, from the device events
(``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``), reports:

- device time and launches by category (:func:`kernel_group`, the groups
  ``run/profile_eval.py:kernel_table`` sums by): the attention forward
  kernel, the attention backward kernel (with its block-sum and dm
  passes), the key-blocked forward, the key-blocked backward (its
  statistics, key-block, dq-sum and dm passes), matrix products, other;
- the idle gaps between them: the span from the first event's start to
  the last one's end on each device, the busy time (the union of the
  events' intervals), the idle time and share, the number of gaps and the
  longest;
- the top kernels by device time;

and prints one trailing JSON line for scripts::

    python -m vln_hamt_torch.utils.xprof <trace_dir> [--top 25]

A trace without device events raises (a CPU-only trace has none): it
never reports zeros. The JAX tool's ``--hlo`` option has no counterpart:
it recovers what an XLA fusion computes from the compiled module, while
a CUDA kernel's name already carries its category.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
from collections import defaultdict
from typing import Dict, List, Tuple

#: the trace's device-event categories
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GROUPS = ("attention_fwd_kernel", "attention_bwd_kernel", "attention_fwd_blocked_kernel",
          "attention_bwd_blocked_kernel", "matmul", "other")


def kernel_group(name: str) -> str:
    """The group of a device kernel by its name (:data:`GROUPS`)."""
    low = name.lower()
    if "attention_fwd_blocked" in low:
        return "attention_fwd_blocked_kernel"
    if "attention_bwd_blocked" in low:  # the key-blocked backward's passes
        return "attention_bwd_blocked_kernel"
    if "attention_fwd_kernel" in low:
        return "attention_fwd_kernel"
    if "attention_bwd" in low:  # the backward kernel, its block-sum and dm passes
        return "attention_bwd_kernel"
    # cuBLAS's Hopper bf16 products are named nvjet_* or *xmma*
    if any(s in low for s in ("gemm", "gemv", "cutlass", "cublas", "matmul", "nvjet",
                              "xmma")):
        return "matmul"
    return "other"


def find_trace_files(logdir: str) -> List[str]:
    """Every ``*.json`` and ``*.json.gz`` under ``logdir``."""
    return sorted(p for pat in ("*.json", "*.json.gz")
                  for p in glob.glob(os.path.join(logdir, "**", pat), recursive=True))


def load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def device_events(trace: dict) -> List[Tuple[str, object, float, float]]:
    """(name, device, start us, duration us) of each complete device event."""
    return [(e["name"], e.get("pid"), float(e["ts"]), float(e["dur"]))
            for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def timeline(events: List[Tuple[str, object, float, float]]) -> Dict[str, float]:
    """Span, busy time (the union of the intervals), idle time, the
    number of gaps and the longest, in us, over one device's events."""
    spans = sorted((ts, ts + dur) for _, _, ts, dur in events)
    busy = gaps = 0
    longest = 0.0
    start, end = spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy += end - start
            gaps += 1
            longest = max(longest, s - end)
            start, end = s, e
        else:
            end = max(end, e)
    busy += end - start
    span = max(e for _, e in spans) - spans[0][0]
    return {"span_us": span, "busy_us": busy, "idle_us": span - busy, "gaps": gaps,
            "max_gap_us": longest}


def analyze(logdir: str, top: int = 25) -> dict:
    """The breakdown of every trace under ``logdir`` (module docstring).
    Raises when there is no trace, or no device event in them."""
    files = find_trace_files(logdir)
    if not files:
        raise FileNotFoundError(f"no *.json or *.json.gz trace under {logdir}")
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    line = {"span_us": 0.0, "busy_us": 0.0, "idle_us": 0.0, "gaps": 0, "max_gap_us": 0.0}
    for path in files:
        trace = load_trace(path)
        if not isinstance(trace, dict):  # a JSON file that is no trace
            continue
        by_device = defaultdict(list)
        for ev in device_events(trace):
            by_device[ev[1]].append(ev)
            kernels[ev[0]][0] += ev[3]
            kernels[ev[0]][1] += 1
        for evs in by_device.values():
            t = timeline(evs)
            for k in ("span_us", "busy_us", "idle_us", "gaps"):
                line[k] += t[k]
            line["max_gap_us"] = max(line["max_gap_us"], t["max_gap_us"])
    if not kernels:
        raise RuntimeError(f"no device kernels in the traces under {logdir}")
    # every group, the key-blocked kernels' only where the trace holds them
    # (no preset's shape reaches them)
    cats = {g: {"category": g, "us": 0.0, "launches": 0} for g in GROUPS
            if "blocked" not in g}
    for name, (us, n) in kernels.items():
        g = kernel_group(name)
        c = cats.setdefault(g, {"category": g, "us": 0.0, "launches": 0})
        c["us"] += us
        c["launches"] += n
    total = sum(c["us"] for c in cats.values())
    rows = sorted(({**c, "share": c["us"] / total} for c in cats.values()),
                  key=lambda r: -r["us"])
    top_kernels = sorted(({"name": k, "us": us, "launches": n, "category": kernel_group(k)}
                          for k, (us, n) in kernels.items()), key=lambda r: -r["us"])[:top]
    return {"files": files, "categories": rows, "top": top_kernels, "device_us": total,
            **line, "idle_share": line["idle_us"] / line["span_us"] if line["span_us"] else 0.0}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("logdir")
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args(argv)
    res = analyze(args.logdir, args.top)
    print(f"device busy {res['busy_us'] / 1e3:.3f} ms over a {res['span_us'] / 1e3:.3f} ms "
          f"span ({100 * res['idle_share']:.1f} % idle in {res['gaps']} gaps, longest "
          f"{res['max_gap_us'] / 1e3:.3f} ms)")
    print(f"{'category':<22} {'time_ms':>10} {'share':>7} {'launches':>9}")
    for c in res["categories"]:
        print(f"{c['category']:<22} {c['us'] / 1e3:>10.3f} {100 * c['share']:>6.1f}% "
              f"{c['launches']:>9}")
    print()
    print(f"{'kernel':<60} {'category':<22} {'time_ms':>9} {'#':>7}")
    for k in res["top"]:
        print(f"{k['name'][:60]:<60} {k['category']:<22} {k['us'] / 1e3:>9.3f} "
              f"{k['launches']:>7}")
    print(json.dumps({
        "metric": "xprof_device_busy_ms", "value": res["busy_us"] / 1e3,
        "span_ms": res["span_us"] / 1e3, "idle_share": res["idle_share"], "gaps": res["gaps"],
        "categories": {c["category"]: {"ms": c["us"] / 1e3, "launches": c["launches"],
                                       "share": c["share"]} for c in res["categories"]}}))
    return res


if __name__ == "__main__":
    main()
