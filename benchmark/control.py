"""The comparison's control and the program's readings, on the card.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up as a benchmark run
makes it (for evaluation, a short window of shard calls at the cell's
load), then the numbers the check compares, read twice against the
float32 reference: once for the program, once for the control, the
reference itself computed with TF32 products in the program's place.
One JSON line per seed. The benchmark's own runs never run this; the
limits of ``benchmark/cells/<cell>.json`` are set from its readings.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import types

from . import harness
from .run import _cache_dirs, load_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    _cache_dirs()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell, config = load_cell(args.workload)
    entry = importlib.import_module(f"benchmark.entries.{cell['entry']}")
    for seed in args.seeds:
        ctx = types.SimpleNamespace(name=args.workload, cell=cell, config=config, seed=seed,
                                    device=torch.device(args.device), trace=False)
        state = entry.setup(ctx)
        prog, ctl = entry.calibrate(state)
        del state
        harness.free()
        print(json.dumps({"workload": args.workload, "seed": seed, "program": prog,
                          "control": ctl, "limits": cell["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
