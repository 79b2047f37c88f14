"""Where the time of one full-width training update goes on the card.

    python -m vln_hamt_torch.run.profile_train
        [--task r2r|r2r_last|r4r|rxr|r2r_back|cvdn|reverie]
        [--feedback teacher|sample] [--no_merged_sample | --replay [--no_feat_table]]
        [--packed_il] [--bf16] [--batch_size B] [--out DIR]

Builds the training that ``chip_smoke.py`` drives (the task's preset,
``r2r`` by default, fp32 or with ``--bf16`` bfloat16, production
dropout, adamw lr 1e-5, clip 40,
the preset's batch unless ``--batch_size``, seeded random weights, the
synthetic world of ``run/profile_eval.py:slice_config``) with IL
(``teacher``, the default; packed with ``--packed_il``) or IL + A2C
(``sample``: the merged update, the fused one with
``--no_merged_sample``, or rollout-then-replay with ``--replay``: a
sampling device rollout, or with ``--no_feat_table`` a host-loop one
over features shipped per step, then the IL episode and the replay),
warms it up with three
updates, times 20 unprofiled updates (as many as ``chip_smoke.py``'s
``train`` and ``sample`` phases: the host's pace varies, and the idle
share rests on this wall time), then traces one ``train_iteration``
with ``torch.profiler``. Prints one JSON line: wall time per update
without and with the profiler, episodes per update and per second,
summed kernel time (one stream: the
device is busy that long), the idle share against both wall times, and
kernel time by group (the attention forward and backward kernels,
matrix products, the rest); writes the per-kernel table to
``DIR/profile_train_{task}_{teacher|packed|merged|fused|replay|replay_host}[_bf16].txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..agents.agent import resolve_device
from ..configs import get_preset
from .profile_eval import TASKS, kernel_table, slice_agent, slice_config


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--task", default="r2r", choices=TASKS)
    p.add_argument("--feedback", default="teacher", choices=("teacher", "sample"))
    p.add_argument("--no_merged_sample", action="store_true",
                   help="profile the fused sample update instead of the merged one")
    p.add_argument("--replay", action="store_true",
                   help="profile the rollout-then-replay sample update (merged and fused off)")
    p.add_argument("--no_feat_table", action="store_true",
                   help="features on the host, shipped per step (with --replay: the "
                        "host-loop rollout)")
    p.add_argument("--packed_il", action="store_true",
                   help="profile the packed IL update (teacher feedback)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--batch_size", type=int, default=None, help="the preset's by default")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/profile_train")
    args = p.parse_args(argv)
    device = resolve_device()  # the card; raises without one

    cfg, world = slice_config(args.batch_size or get_preset(args.task).train.batch_size,
                              args.seed, args.task)
    if args.replay and args.feedback != "sample":
        raise ValueError("--replay profiles the sample update")
    if args.no_feat_table and not args.replay:
        raise ValueError("--no_feat_table profiles the replay update's host-loop rollout")
    if args.packed_il and args.feedback != "teacher":
        raise ValueError("--packed_il profiles the teacher update")
    cfg = cfg.replace(train={"feedback": args.feedback},
                      model={"dtype": "bfloat16" if args.bf16 else "float32"})
    agent = slice_agent(cfg, world, args.seed, device)
    agent.merged_sample_update = not (args.no_merged_sample or args.replay)
    agent.fused_sample_update = not args.replay
    if not args.no_feat_table:
        agent.enable_feature_table()
    if args.packed_il:
        agent.enable_packed_il()
    update = ("packed" if args.packed_il else "teacher" if args.feedback == "teacher"
              else ("replay_host" if args.no_feat_table else "replay") if args.replay
              else "fused" if args.no_merged_sample else "merged")
    for _ in range(3):  # warm-up
        agent.train_iteration(sync=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 20
    t0 = time.perf_counter()
    episodes = sum(agent.train_iteration(sync=False).get("episodes", cfg.train.batch_size)
                   for _ in range(n))
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3 / n
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = agent.train_iteration()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    kernels, groups = kernel_table(prof)
    busy_ms = sum(ms for _, ms, _ in kernels)
    os.makedirs(args.out, exist_ok=True)
    stem = f"profile_train_{args.task}_{update}" + ("_bf16" if args.bf16 else "")
    with open(os.path.join(args.out, stem + ".txt"), "w") as f:
        f.write(f"{'device ms':>10} {'launches':>9}  kernel\n")
        for name, ms, k in kernels:
            f.write(f"{ms:10.3f} {k:9d}  {name}\n")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "task": args.task, "update": update,
        "dtype": cfg.model.dtype, "batch": cfg.train.batch_size, "peak_mem_gb": peak_gb,
        "t_max": cfg.env.max_action_len, "losses": out,
        "episodes_per_update": episodes / n,
        "episodes_per_s": episodes / (unprofiled_ms * n / 1e3),
        "unprofiled_wall_ms_per_update": unprofiled_ms, "wall_ms": wall_ms,
        "kernel_ms": busy_ms,
        "idle_share_traced": 1.0 - busy_ms / wall_ms,
        "idle_share_unprofiled": 1.0 - busy_ms / unprofiled_ms,
        "kernel_launches": sum(k for *_, k in kernels),
        "groups": groups, "top": kernels[:10],
    }))


if __name__ == "__main__":
    main()
