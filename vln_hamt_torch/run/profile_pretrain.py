"""Where the time of full-width pretraining goes on the card.

    python -m vln_hamt_torch.run.profile_pretrain [--preset r2r|rxr] [--updates 30]
        [--per_task 5] [--bf16] [--out DIR]

Builds the pretraining that ``run/pretrain.py --synthetic`` runs and
``chip_smoke.py`` drives (the preset's model at full width, every stack
trained, fp32 or with ``--bf16`` bfloat16, production dropout, batch 16, the JAX CLI's adamw with
warmup-linear and grad-norm 5, index-mode batches over the resident
feature table, seeded random weights), warms it up with one update per
task, times ``--per_task`` unprofiled updates of each task on host
batches built beforehand and traces one more with ``torch.profiler``,
then times ``--updates`` steps of the preset's task mix as the CLI
trains them (``train_step``: the scheduler's draw, the host batch built
in the prefetch thread while the device trains on the one before).
Prints one JSON line per task and one for the mix: examples/s, wall ms
per update, summed kernel time (one stream: the device is busy that
long), the idle share against the unprofiled and the traced wall time,
kernel time by group (matrix products, the attention forward and
backward kernels, the rest), peak memory; writes each task's per-kernel
table to ``DIR/profile_pretrain_{preset}_{task}[_bf16].txt``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time
from typing import Dict, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from ..agents.agent import resolve_device
from ..pretrain.trainer import PretrainTrainer
from . import pretrain
from .profile_attention import pretrain_launch_mix
from .profile_eval import kernel_table

NUM_OB = 37  # 36 views + STOP


def _slice_args(preset: str, batch_size: int, seed: int, extra=()):
    return pretrain.parse_args(["--synthetic", "--preset", preset, "--batch_size",
                                str(batch_size), "--seed", str(seed), *extra])


def slice_mixes(preset: str = "r2r", batch_size: int = 16, extra=()):
    """Per task of the preset's mix, its attention launches per update by
    (lanes, Lq, Lk), forward and backward (``pretrain_launch_mix``), and
    the task's share of the mix."""
    args = _slice_args(preset, batch_size, 0, extra)
    mcfg = pretrain.resolve(args)
    width = NUM_OB + (args.ob_cand_extra if args.ob_cand_pano_view else 0)
    mixes = {task: pretrain_launch_mix(mcfg, task, batch_size, args.max_txt_len,
                                       args.max_hist_len, width) for task in args.tasks}
    total = sum(args.mix_ratio)
    return mixes, {t: r / total for t, r in zip(args.tasks, args.mix_ratio)}


def slice_trainer(preset: str = "r2r", batch_size: int = 16, seed: int = 0, device=None,
                  extra=()) -> Tuple[PretrainTrainer, Dict[str, object]]:
    """The measured configuration (also ``chip_smoke.py``'s): the CLI's
    ``--synthetic`` pretraining of ``preset`` with its defaults."""
    return pretrain.build(_slice_args(preset, batch_size, seed, extra), resolve_device(device))


def timed_updates(trainer: PretrainTrainer, batches) -> float:
    """Wall seconds of unsynchronized updates over host ``batches``
    [(task, batch)], the last one waited for."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for task, batch in batches:
        loss, _ = trainer.update(task, batch)
    float(loss)
    return time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="r2r", choices=("r2r", "rxr"))
    p.add_argument("--updates", type=int, default=30)
    p.add_argument("--per_task", type=int, default=5)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/profile_pretrain")
    args = p.parse_args(argv)
    # the card; raises without one
    trainer, _ = slice_trainer(args.preset, seed=args.seed,
                               extra=("--bf16",) if args.bf16 else ())
    suffix = "_bf16" if args.bf16 else ""
    tasks = trainer.scheduler.tasks
    bs = trainer.batch_size
    for task in tasks:  # warm-up: allocator, cuBLAS handles
        trainer.update(task, trainer.batcher.batch(task, bs))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    os.makedirs(args.out, exist_ok=True)
    rows = {}
    for task in tasks:
        batches = [(task, trainer.batcher.batch(task, bs)) for _ in range(args.per_task)]
        seconds = timed_updates(trainer, batches)
        wall_ms = seconds / args.per_task * 1e3
        batch = trainer.batcher.batch(task, bs)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            float(trainer.update(task, batch)[0])
            torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
        kernels, groups = kernel_table(prof)
        busy_ms = sum(ms for _, ms, _ in kernels)
        with open(os.path.join(args.out, f"profile_pretrain_{args.preset}_{task}{suffix}.txt"),
                  "w") as f:
            f.write(f"{'device ms':>10} {'launches':>9}  kernel\n")
            for name, ms, n in kernels:
                f.write(f"{ms:10.3f} {n:9d}  {name}\n")
        rows[task] = {"examples_per_s": bs * args.per_task / seconds, "wall_ms": wall_ms,
                      "traced_wall_ms": traced_ms, "kernel_ms": busy_ms,
                      "idle_share_unprofiled": 1.0 - busy_ms / wall_ms,
                      "idle_share_traced": 1.0 - busy_ms / traced_ms,
                      "kernel_launches": sum(n for *_, n in kernels), "groups": groups}
        print(json.dumps({"device": torch.cuda.get_device_name(0), "preset": args.preset,
                          "dtype": trainer.cfg.dtype, "task": task, "batch": bs,
                          **rows[task]}), flush=True)

    # the mix as the CLI trains it: batch building and its prefetch are
    # inside the clock; one step first, so that a batch is in preparation
    float(trainer.train_step()[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draw = []
    for _ in range(args.updates):
        task, loss, _ = trainer.train_step()
        draw.append(task)
    float(loss)
    seconds = time.perf_counter() - t0
    counts = collections.Counter(draw)
    kernel_ms = sum(rows[t]["kernel_ms"] * n for t, n in counts.items()) / args.updates
    wall_ms = seconds / args.updates * 1e3
    groups = {g: sum(rows[t]["groups"].get(g, {"ms": 0.0})["ms"] * n
                     for t, n in counts.items()) / args.updates
              for g in ("matmul", "attention_fwd_kernel", "attention_bwd_kernel", "other")}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "preset": args.preset,
        "dtype": trainer.cfg.dtype, "task": "mix",
        "batch": bs, "updates": args.updates, "draw": dict(counts),
        "examples_per_s": bs * args.updates / seconds, "wall_ms": wall_ms,
        "kernel_ms_weighted": kernel_ms, "idle_share_unprofiled": 1.0 - kernel_ms / wall_ms,
        "group_ms_weighted": groups,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    trainer.close()


if __name__ == "__main__":
    main()
