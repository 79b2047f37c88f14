"""Shared set-up of the benchmark's CPU tests: a tiny cell run in this
process on the CPU through the harness's own path."""

from __future__ import annotations

import importlib
import types
from pathlib import Path

import torch

from benchmark import run

DATA = Path(__file__).resolve().parent / "data"
MANIFEST = {"end_to_end": [{"name": "train_episodes_per_s", "unit": "episodes/s"},
                           {"name": "eval_episodes_per_s", "unit": "episodes/s"},
                           {"name": "setup_s", "unit": "s"}], "per_layer": []}


def manifest_for(cell: str) -> dict:
    kind = "eval" if "eval" in cell else "train"
    return {"end_to_end": [m for m in MANIFEST["end_to_end"]
                           if m["name"] == "setup_s" or m["name"].startswith(kind)],
            "per_layer": []}


def run_tiny(cell: str, seed: int = 2147483650, bench: Path = DATA):
    """(result, {name: (value, limit)}) of one CPU run of a tiny cell."""
    res, limits = run.run_cell(cell, seed, 0.5, False, device="cpu", bench=bench,
                               manifest=manifest_for(cell))
    return res, {n: (v, lim) for n, v, lim in limits}


def tiny_state(cell: str, seed: int = 2147483651):
    c, config = run.load_cell(cell, DATA)
    entry = importlib.import_module(f"benchmark.entries.{c['entry']}")
    ctx = types.SimpleNamespace(name=cell, cell=c, config=config, seed=seed,
                                device=torch.device("cpu"), trace=False)
    return entry, entry.setup(ctx)
