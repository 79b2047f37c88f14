"""On the card: the comparison's control fails and the program passes,
at the published widths over a small world (a size a test run holds).
The control is the float32 reference computed with TF32 products, in the
program's place. Run with
``python -m pytest benchmark/tests/test_bench_gpu.py -q -p no:cacheprovider``."""

from __future__ import annotations

import importlib
import json
import types
from pathlib import Path

import pytest

from benchmark import harness

pytestmark = pytest.mark.gpu
BENCH = Path(__file__).resolve().parents[1]


def _calibrate(cell_name, device, seed, **small):
    cell = json.loads((BENCH / "cells" / f"{cell_name}.json").read_text())
    config = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    cell.update(small)
    entry = importlib.import_module(f"benchmark.entries.{cell['entry']}")
    ctx = types.SimpleNamespace(name=cell_name, cell=cell, config=config, seed=seed,
                                device=device, trace=False)
    prog, ctl = entry.calibrate(entry.setup(ctx))
    harness.free()
    return cell["limits"], prog, ctl


SMALL = {"scans": 4, "panoramas": 468, "items": 400}


@pytest.mark.parametrize("cell", ["r2r.finetune_sample", "rxr.finetune_sample"])
def test_training_control_fails_and_program_passes(cuda, cell):
    limits, prog, ctl = _calibrate(cell, cuda, 2147483660, batch=4, world=SMALL)
    assert all(prog[k] <= v for k, v in limits.items()), prog
    assert any(ctl[k] > v for k, v in limits.items()), ctl


def test_eval_control_fails_and_program_passes(cuda):
    # the control flips a greedy decision only at a near-tie: it needs the
    # cell's hundreds of decisions (256 episodes), not a smaller sample
    limits, prog, ctl = _calibrate("r2r.eval_greedy", cuda, 2147483661, world=SMALL)
    assert all(prog[k] <= v for k, v in limits.items()), prog
    assert any(ctl[k] > v for k, v in limits.items()), ctl
