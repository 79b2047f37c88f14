"""The benchmark of ``vln_hamt_torch`` on one H100.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout. The cell
names its file under ``benchmark/cells/``, which names its configuration
under ``benchmark/configs/`` and the entry under ``benchmark/entries/``
that sets the program up, times its window and checks what it produced
against the plain reference of ``benchmark/reference/``. With
``--trace 0`` the last line of standard output is the cell's end-to-end
metrics; with ``--trace 1`` a short traced window gives its per-layer
metrics, each read by its own reader under ``benchmark/metrics/``.

The run exits non-zero, printing no result, where the card is missing,
where the program cannot be imported, and where JAX or the JAX package
is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: whole top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "vln_hamt_tpu")


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own nvcc builds go to ``vln_hamt_torch/build/``)."""
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


#: the keys of every cell file; its entry's ``CELL_KEYS`` add their own
CELL_KEYS = ("config", "entry", "chips", "batch", "world", "why", "limits")


def load_cell(name: str, bench: Path = BENCH) -> Tuple[dict, dict]:
    """The cell file and its configuration file, found by name. A cell
    file holds exactly the keys its entry reads: one that nothing reads
    would misstate what the cell runs."""
    cell = load_json(bench / "cells" / f"{name}.json")
    entry = importlib.import_module(f"benchmark.entries.{cell['entry']}")
    known = set(CELL_KEYS) | set(entry.CELL_KEYS)
    if set(cell) != known:
        raise ValueError(f"cell {name}: unknown keys {sorted(set(cell) - known)}, "
                         f"missing keys {sorted(known - set(cell))}")
    return cell, load_json(bench / "configs" / f"{cell['config']}.json")


def load_reader(name: str, bench: Path = BENCH) -> types.ModuleType:
    """The per-layer metric ``name``'s reader, ``benchmark/metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest_metrics(manifest: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """The cell's end-to-end and per-layer metrics."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]
    return ([m for m in manifest["end_to_end"] if mine(m)],
            [m for m in manifest["per_layer"] if mine(m)])


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             bench: Path = BENCH, manifest: Optional[dict] = None
             ) -> Tuple[dict, List[Tuple[str, float, float]]]:
    """Set up, time (or trace) and check one cell. Returns the result's
    object (without the compared numbers) and the compared numbers as
    (name, value, limit)."""
    import torch

    cell, config = load_cell(name, bench)
    manifest = manifest if manifest is not None else load_json(ROOT / "BENCHMARK.json")
    e2e, per_layer = manifest_metrics(manifest, name)
    entry = importlib.import_module(f"benchmark.entries.{cell['entry']}")
    ctx = types.SimpleNamespace(name=name, cell=cell, config=config, seed=int(seed),
                                device=torch.device(device), trace=trace)
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    state = entry.setup(ctx)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    metrics: Dict[str, dict] = {}
    dev: Dict[str, object] = {"platform": "gpu" if cuda else "cpu",
                              "kind": torch.cuda.get_device_name() if cuda else "cpu",
                              "count": 1}
    breakdown = None
    if not trace:
        values = entry.window(state, seconds)
        values["setup_s"] = setup_s
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        summary = entry.traced(state)
        for m in per_layer:
            value = load_reader(m["name"], bench).read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        breakdown = summary["breakdown"]
    if cuda:
        torch.cuda.synchronize()
        dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        dev["power_limit_w"] = power_limit()
    attempted, failed = state.attempted, state.failed
    limits = entry.check(state)
    result = {"correct": all(v <= lim for _, v, lim in limits), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, limits


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="One cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    import torch

    cell, _ = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, limits = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    result["limits"] = {n: {"value": v, "limit": lim} for n, v, lim in limits}
    for n, v, lim in limits:
        print(f"{n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
