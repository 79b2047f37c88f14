"""Where the time of full-width greedy evaluation goes on the card.

    python -m vln_hamt_torch.run.profile_eval
        [--task r2r|r2r_last|r4r|rxr|r2r_back|cvdn|reverie]
        [--batch_size 32] [--evaluator device|lockstep|packed] [--bf16] [--out DIR]

Builds the evaluation that ``chip_smoke.py`` drives (the task's preset,
``r2r`` by default, fp32 or with ``--bf16`` bfloat16, seeded random weights, synthetic world of 2
scans x 36 nodes and 96 items), warms it up, then traces one evaluation of the split with
``torch.profiler``: the device rollout (``eval_split_device``, the default), or the host loop,
lock-step (``eval_split``) or continuation-packed (``eval_split_packed``). Prints one JSON line: wall time without and with
the profiler, summed kernel time (one stream: the device is busy that
long), the idle share against both wall times, and kernel time by group (the
attention forward kernel, matrix products, the rest); writes the per-kernel
table to ``DIR/profile_eval[_{task}][_lockstep|_packed][_bf16].txt`` (no task
part for ``r2r``).
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
from ..data.fixtures import (SyntheticWorld, add_synthetic_objects, make_synthetic_cvdn_items,
                             make_synthetic_r2rback_items, make_synthetic_world)
from ..env import ObsSpec, R2RNavEnv
from ..utils.xprof import kernel_group
from .finetune import _AGENT_CLS, _ENV_CLS

TASKS = tuple(_ENV_CLS)


def slice_config(batch_size: int, seed: int = 0, task: str = "r2r"
                 ) -> Tuple[HAMTConfig, SyntheticWorld]:
    """The measured configuration (also ``chip_smoke.py``'s): the task's
    preset (``r2r`` by default) at full width and depth over a synthetic
    world of 2 scans x 36 viewpoints and 96 items with the preset's
    feature width, candidate slots sized to the world's largest degree;
    for REVERIE with 2 objects per viewpoint at the preset's object
    width (``world.objects``: the object database and object-to-viewpoint
    map; the items gain their target object)."""
    cfg = get_preset(task)
    world = make_synthetic_world(num_scans=2, nodes_per_scan=36, num_items=96,
                                 feat_dim=cfg.env.image_feat_size, seed=seed)
    if cfg.model.obj_feat_size > 0:
        world.objects = add_synthetic_objects(world, obj_feat_size=cfg.model.obj_feat_size,
                                              seed=seed)
    max_deg = max(g.max_degree for g in world.graphs.values())
    cfg = cfg.replace(env={"max_candidates": max_deg}, train={"batch_size": batch_size})
    return cfg, world


def slice_env(cfg: HAMTConfig, world: SyntheticWorld, seed: int = 0) -> R2RNavEnv:
    """The task's env over the slice's world (``cfg.env.dataset``): the
    world's items, R2R-Back's out-and-back items, CVDN's dialog items, or
    REVERIE's items with the world's objects (endpoint resampling as the
    preset says)."""
    task = cfg.env.dataset
    spec = ObsSpec(max_candidates=cfg.env.max_candidates,
                   image_feat_size=cfg.env.image_feat_size)
    items, extra = world.instr_data, {}
    if task == "r2r_back":
        items = make_synthetic_r2rback_items(world)
    elif task == "cvdn":
        items = make_synthetic_cvdn_items(world)
        extra["use_player_path"] = cfg.env.use_player_path
    elif task == "reverie":
        obj_db, obj2vp = world.objects
        extra.update(obj_db=obj_db, obj2viewpoint=obj2vp, max_objects=cfg.env.max_objects,
                     obj_feat_size=cfg.model.obj_feat_size,
                     multi_endpoints=cfg.env.multi_endpoints)
    return _ENV_CLS[task](world.graphs, world.feat_db, items, spec,
                          batch_size=cfg.train.batch_size,
                          max_instr_len=cfg.env.max_instr_len,
                          max_action_len=cfg.env.max_action_len, seed=seed, **extra)


def slice_agent(cfg: HAMTConfig, world: SyntheticWorld, seed: int = 0, device=None
                ) -> HAMTAgent:
    """The task's agent (``cfg.env.dataset``) over :func:`slice_env`, seeded
    random weights, on the card unless ``device`` says otherwise."""
    return _AGENT_CLS[cfg.env.dataset](cfg, slice_env(cfg, world, seed), seed=seed,
                                       device=device)


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
        g = groups.setdefault(kernel_group(name), {"ms": 0.0, "launches": 0})
        g["ms"] += ms
        g["launches"] += n
    return kernels, groups


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--task", default="r2r", choices=TASKS)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--evaluator", default="device", choices=("device", "lockstep", "packed"))
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/profile_eval")
    args = p.parse_args(argv)
    device = resolve_device()  # the card; raises without one

    cfg, world = slice_config(args.batch_size, args.seed, args.task)
    cfg = cfg.replace(model={"dtype": "bfloat16" if args.bf16 else "float32"})
    agent = slice_agent(cfg, world, args.seed, device)
    agent.enable_feature_table()
    evaluate = {"device": agent.eval_split_device, "lockstep": agent.eval_split,
                "packed": agent.eval_split_packed}[args.evaluator]
    evaluate()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate()
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        preds = evaluate()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    kernels, groups = kernel_table(prof)
    busy_ms = sum(ms for _, ms, _ in kernels)
    os.makedirs(args.out, exist_ok=True)
    stem = ("profile_eval" + ("" if args.task == "r2r" else f"_{args.task}")
            + ("" if args.evaluator == "device" else f"_{args.evaluator}")
            + ("_bf16" if args.bf16 else ""))
    with open(os.path.join(args.out, stem + ".txt"), "w") as f:
        f.write(f"{'device ms':>10} {'launches':>9}  kernel\n")
        for name, ms, n in kernels:
            f.write(f"{ms:10.3f} {n:9d}  {name}\n")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "task": args.task, "batch": args.batch_size,
        "evaluator": args.evaluator, "dtype": cfg.model.dtype,
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
