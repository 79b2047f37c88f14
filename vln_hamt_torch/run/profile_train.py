"""Where the time of one full-width R2R training update goes on the card.

    python -m vln_hamt_torch.run.profile_train [--feedback teacher|sample]
        [--no_merged_sample] [--batch_size 8] [--out DIR]

Builds the training that ``chip_smoke.py`` drives (``r2r`` preset, fp32,
production dropout, adamw lr 1e-5, clip 40, seeded random weights, the
synthetic world of ``run/profile_eval.py:slice_config``) with IL
(``teacher``, the default) or IL + A2C (``sample``: the merged update,
or the fused one with ``--no_merged_sample``), warms it up with three
updates, times 20 unprofiled updates (as many as ``chip_smoke.py``'s
``train`` and ``sample`` phases: the host's pace varies, and the idle
share rests on this wall time), then traces one ``train_iteration``
with ``torch.profiler``. Prints one JSON line: wall time per update
without and with the profiler, summed kernel time (one stream: the
device is busy that long), the idle share against both wall times, and
kernel time by group (the attention forward and backward kernels,
matrix products, the rest); writes the per-kernel table to
``DIR/profile_train_{teacher|merged|fused}.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..agents.agent import HAMTAgent, resolve_device
from .profile_eval import kernel_table, slice_config, slice_env


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--feedback", default="teacher", choices=("teacher", "sample"))
    p.add_argument("--no_merged_sample", action="store_true",
                   help="profile the fused sample update instead of the merged one")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/profile_train")
    args = p.parse_args(argv)
    device = resolve_device()  # the card; raises without one

    cfg, world = slice_config(args.batch_size, args.seed)
    cfg = cfg.replace(train={"feedback": args.feedback})
    agent = HAMTAgent(cfg, slice_env(cfg, world, args.seed), seed=args.seed, device=device)
    agent.merged_sample_update = not args.no_merged_sample
    agent.enable_feature_table()
    update = ("teacher" if args.feedback == "teacher"
              else "fused" if args.no_merged_sample else "merged")
    for _ in range(3):  # warm-up
        agent.train_iteration(sync=False)
    torch.cuda.synchronize()
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        agent.train_iteration(sync=False)
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3 / n

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = agent.train_iteration()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    kernels, groups = kernel_table(prof)
    busy_ms = sum(ms for _, ms, _ in kernels)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_train_{update}.txt"), "w") as f:
        f.write(f"{'device ms':>10} {'launches':>9}  kernel\n")
        for name, ms, k in kernels:
            f.write(f"{ms:10.3f} {k:9d}  {name}\n")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "update": update,
        "batch": args.batch_size, "t_max": cfg.env.max_action_len, "losses": out,
        "unprofiled_wall_ms_per_update": unprofiled_ms, "wall_ms": wall_ms,
        "kernel_ms": busy_ms,
        "idle_share_traced": 1.0 - busy_ms / wall_ms,
        "idle_share_unprofiled": 1.0 - busy_ms / unprofiled_ms,
        "kernel_launches": sum(k for *_, k in kernels),
        "groups": groups, "top": kernels[:10],
    }))


if __name__ == "__main__":
    main()
