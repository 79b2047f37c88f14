"""Where the time of full-width R2R greedy evaluation goes on the card.

    python -m vln_hamt_torch.run.profile_eval [--batch_size 32] [--out DIR]

Builds the evaluation that ``chip_smoke.py`` drives (``r2r`` preset,
fp32, seeded random weights, synthetic world of 2 scans x 36 nodes and
96 items), warms it up, then traces one ``eval_split_device`` with
``torch.profiler``. Prints one JSON line: wall time without and with
the profiler, summed kernel time (one stream: the device is busy that
long), the idle share against both wall times, and kernel time by group (the
attention forward kernel, matrix products, the rest); writes the per-kernel
table to ``DIR/profile_eval.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from ..agents.agent import HAMTAgent, resolve_device
from ..configs import HAMTConfig, get_preset
from ..data.fixtures import SyntheticWorld, make_synthetic_world
from ..env import ObsSpec, R2RNavEnv


def slice_config(batch_size: int, seed: int = 0) -> Tuple[HAMTConfig, SyntheticWorld]:
    """The measured greedy-evaluation configuration (also ``chip_smoke.py``'s):
    the ``r2r`` preset at full width and depth over a synthetic world of
    2 scans x 36 viewpoints and 96 R2R items, candidate slots sized to
    the world's largest degree."""
    cfg = get_preset("r2r")
    world = make_synthetic_world(num_scans=2, nodes_per_scan=36, num_items=96,
                                 feat_dim=cfg.env.image_feat_size, seed=seed)
    max_deg = max(g.max_degree for g in world.graphs.values())
    cfg = cfg.replace(env={"max_candidates": max_deg}, train={"batch_size": batch_size})
    return cfg, world


def slice_env(cfg: HAMTConfig, world: SyntheticWorld, seed: int = 0) -> R2RNavEnv:
    spec = ObsSpec(max_candidates=cfg.env.max_candidates,
                   image_feat_size=cfg.env.image_feat_size)
    return R2RNavEnv(world.graphs, world.feat_db, world.instr_data, spec,
                     batch_size=cfg.train.batch_size, max_instr_len=cfg.env.max_instr_len,
                     max_action_len=cfg.env.max_action_len, seed=seed)


def _group(name: str) -> str:
    low = name.lower()
    if "attention_fwd_kernel" in low:
        return "attention_fwd_kernel"
    if "attention_bwd" in low:  # the backward kernel, its block-sum and dm passes
        return "attention_bwd_kernel"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "cublas", "matmul")):
        return "matmul"
    return "other"


def kernel_table(prof) -> Tuple[List[Tuple[str, float, int]], Dict[str, dict]]:
    """Device kernels of a ``torch.profiler`` trace, longest first, as
    (name, device ms, launches), and their sums by group (the attention
    forward and backward kernels, matrix products, the rest). Raises when
    the trace holds no device time."""
    # device-side events only: the CPU ops that launched them carry the
    # same time again as their "self device time", and so does a
    # user-annotated range on the device's timeline (the optimizers'
    # ``Optimizer.step#...``) over the kernels inside it
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    kernels.sort(key=lambda r: -r[1])
    groups: Dict[str, dict] = {}
    for name, ms, n in kernels:
        g = groups.setdefault(_group(name), {"ms": 0.0, "launches": 0})
        g["ms"] += ms
        g["launches"] += n
    return kernels, groups


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/profile_eval")
    args = p.parse_args(argv)
    device = resolve_device()  # the card; raises without one

    cfg, world = slice_config(args.batch_size, args.seed)
    agent = HAMTAgent(cfg, slice_env(cfg, world, args.seed), seed=args.seed, device=device)
    agent.enable_feature_table()
    agent.eval_split_device()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent.eval_split_device()
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        preds = agent.eval_split_device()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    kernels, groups = kernel_table(prof)
    busy_ms = sum(ms for _, ms, _ in kernels)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_eval.txt"), "w") as f:
        f.write(f"{'device ms':>10} {'launches':>9}  kernel\n")
        for name, ms, n in kernels:
            f.write(f"{ms:10.3f} {n:9d}  {name}\n")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "batch": args.batch_size,
        "episodes": len(preds), "unprofiled_wall_ms": unprofiled_ms, "wall_ms": wall_ms,
        "kernel_ms": busy_ms,
        # kernel durations barely change under the tracer, the host's
        # launches do: the unprofiled wall time is the fairer divisor
        "idle_share_traced": 1.0 - busy_ms / wall_ms,
        "idle_share_unprofiled": 1.0 - busy_ms / unprofiled_ms,
        "kernel_launches": sum(n for *_, n in kernels),
        "groups": groups, "top": kernels[:8],
    }))


if __name__ == "__main__":
    main()
