"""R2R fine-tuning and evaluation entry point (torch), the port of
``vln_hamt_tpu/run/finetune.py``.

    python -m vln_hamt_torch.run.finetune --task r2r --synthetic \
        [--feedback teacher] [--no_merged_sample] [--iters N --log_every K]
    python -m vln_hamt_torch.run.finetune --task r2r --valid_only --synthetic

run the full-width ``r2r`` preset with seeded random weights over a
hermetic fixture world on the GPU (``--cpu`` runs on the CPU through the
plain attention; ``--tiny`` shrinks the model and episodes). Training
takes ``--iters`` updates with the preset's ``sample`` feedback (IL plus
A2C on a sampling rollout; merged, or fused with ``--no_merged_sample``)
or with ``--feedback teacher`` (IL alone); every ``--log_every`` it
records the interval's mean losses and episodes/s in ``train.txt``,
evaluates the validation split greedily, and writes ``latest.pt`` and,
on a better SR + SPL, ``best_val_unseen.pt``; it prints
``{"best": {...}}``. ``--valid_only`` evaluates instead, prints
``{"valid": {split: metrics}}`` and writes ``valid.txt`` (and
``submit_{split}.json`` with ``--submit``). Reference checkpoints, real
data and the other task families are not ported yet; their flags raise
and name the ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..agents.agent import HAMTAgent, resolve_device
from ..configs import HAMTConfig, get_preset
from ..configs.config import PRESETS
from ..data.fixtures import make_synthetic_world
from ..env import ObsSpec, R2RNavEnv


def write_record(path: str, text: str) -> None:
    """Append-only record file (utils/logger.py:8-13)."""
    with open(path, "a") as f:
        f.write(text.rstrip() + "\n")


def build_synthetic_dataset(cfg: HAMTConfig, seed: int = 0, test_split: bool = False):
    """Fixture-backed R2R envs for hermetic runs (no Matterport data);
    the R2R branch of the JAX package's ``build_synthetic_dataset``."""
    world = make_synthetic_world(
        num_scans=2, nodes_per_scan=24, num_items=48,
        feat_dim=cfg.env.image_feat_size, seed=seed,
    )
    max_deg = max(g.max_degree for g in world.graphs.values())
    cfg = cfg.replace(env={"max_candidates": max_deg})
    spec = ObsSpec(max_candidates=max_deg,
                   image_feat_size=cfg.env.image_feat_size,
                   ob_type=cfg.env.ob_type)
    items = world.instr_data
    n_train = int(len(items) * 0.75)

    def make_env(data, name):
        return R2RNavEnv(
            world.graphs, world.feat_db, data, spec,
            batch_size=cfg.train.batch_size,
            max_instr_len=cfg.env.max_instr_len,
            max_action_len=cfg.env.max_action_len,
            seed=cfg.train.seed, name=name,
            reuse_episode_buffers=(name == "train"),
        )

    train_env = make_env(items[:n_train], "train")
    val_envs = {"val_unseen": make_env(items[n_train:], "val_unseen")}
    if test_split:
        # GT-less test items: path truncated to the start viewpoint,
        # mirroring the official test annotations (r2r/main.py:66-69)
        test_items = [{**it, "path": it["path"][:1]} for it in items[n_train:]]
        val_envs["test"] = make_env(test_items, "test")
    return cfg, train_env, val_envs


def _merge_preds(preds: List[dict]) -> List[dict]:
    """Predictions deduped by instr_id (one process; the cross-process
    gather arrives with multi-GPU, ROADMAP item A13)."""
    merged: Dict[str, dict] = {}
    for p in preds:
        merged.setdefault(p["instr_id"], p)
    return list(merged.values())


def valid(cfg: HAMTConfig, val_envs: Dict[str, R2RNavEnv], output_dir: str,
          submit: bool = False, device=None) -> Dict[str, Dict[str, float]]:
    """Stand-alone greedy evaluation (main.py:225-269): greedy eval per
    split, metrics for GT splits, ``submit_{split}.json`` dumps, and a
    valid.txt record file."""
    os.makedirs(output_dir, exist_ok=True)
    record_file = os.path.join(output_dir, "valid.txt")
    agent = HAMTAgent(cfg, None, seed=cfg.train.seed, device=device)
    first = next(iter(val_envs.values()))
    agent.env = first
    agent.enable_feature_table(first)  # all envs share the graphs
    for env in val_envs.values():
        env.feat_offsets = first.feat_offsets
    results = {}
    for name, env in val_envs.items():
        agent.env = env
        merged = _merge_preds(agent.eval_split_fast(env))
        if "test" not in name:  # test splits have no GT (main.py:258-262)
            metrics, _ = env.eval_metrics(merged)
            results[name] = metrics
            write_record(record_file, f"{name}: " + ", ".join(
                f"{k}={v:.2f}" for k, v in metrics.items()))
        if submit:
            path = os.path.join(output_dir, f"submit_{name}.json")
            with open(path, "w") as f:
                json.dump([{"instr_id": p["instr_id"],
                            "trajectory": [[vp, h, e] for vp, h, e in p["trajectory"]]}
                           for p in merged], f, sort_keys=True, indent=2)
    return results


def selection_score(metrics: Dict[str, float]) -> float:
    """R2R model selection: SR + SPL (main.py:204-210)."""
    return metrics.get("spl", 0.0) + metrics.get("sr", 0.0)


def train(cfg: HAMTConfig, train_env: R2RNavEnv, val_envs: Dict[str, R2RNavEnv],
          output_dir: str, iters: Optional[int] = None, log_every: Optional[int] = None,
          device=None, merged_sample: bool = True) -> Dict[str, float]:
    """The train/validate loop (main.py:86-222) with the config's
    feedback; ``sample`` updates are merged (the JAX CLI's production
    default) unless ``merged_sample`` is off, then fused."""
    os.makedirs(output_dir, exist_ok=True)
    record_file = os.path.join(output_dir, "train.txt")
    agent = HAMTAgent(cfg, train_env, seed=cfg.train.seed, device=device)
    agent.merged_sample_update = merged_sample
    agent.enable_feature_table(train_env)
    for env in val_envs.values():
        env.feat_offsets = train_env.feat_offsets  # same graphs, one table
    with open(os.path.join(output_dir, "training_config.json"), "w") as f:
        f.write(cfg.to_json())

    iters = iters or cfg.train.iters
    log_every = log_every or cfg.train.log_every
    best = {"score": -np.inf, "iter": 0}
    step = 0
    while step < iters:
        interval = min(log_every, iters - step)
        t0 = time.perf_counter()
        # the host assembles the next episode while the device works;
        # the losses are read once per interval
        outs = [agent.train_iteration(sync=False) for _ in range(interval)]
        keys = [k for k in ("loss", "IL_loss", "RL_loss", "entropy") if k in outs[0]]
        # one read of the interval's scalars, which waits for its work
        vals = torch.stack([torch.stack([o[k] for k in keys]) for o in outs]).cpu().numpy()
        dt = time.perf_counter() - t0
        step += interval
        if not np.isfinite(vals).all():
            raise FloatingPointError(f"non-finite loss by iter {step}: {dict(zip(keys, vals.T))}")
        means = ", ".join(f"{k}={v:.4f}" for k, v in zip(keys, vals.mean(axis=0)))
        # batch_size episodes per update, as the JAX CLI counts them
        write_record(record_file, f"iter {step}: {means}, "
                                  f"eps_per_sec={interval * cfg.train.batch_size / dt:.2f}")
        for name, env in val_envs.items():
            if "test" in name:  # no ground truth to score (main.py:258-262)
                continue
            metrics, _ = env.eval_metrics(_merge_preds(agent.eval_split_fast(env)))
            write_record(record_file, f"iter {step} {name}: " + ", ".join(
                f"{k}={v:.2f}" for k, v in metrics.items()))
            if name == "val_unseen" and selection_score(metrics) > best["score"]:
                best = {"score": selection_score(metrics), "iter": step, **metrics}
                agent.save(os.path.join(output_dir, "best_val_unseen.pt"))
        agent.save(os.path.join(output_dir, "latest.pt"))
    return best


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="HAMT fine-tuning and evaluation (PyTorch/CUDA)")
    p.add_argument("--task", default="r2r", choices=sorted(PRESETS))
    p.add_argument("--output_dir", default="runs/finetune_torch")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--feedback", default=None, choices=("teacher", "sample"),
                   help="training feedback (the preset's: sample)")
    p.add_argument("--no_merged_sample", action="store_true",
                   help="sample feedback as the fused update (teacher episode forward, "
                        "then the rollout) instead of the merged one (the teacher "
                        "episode as extra lanes of the rollout)")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--log_every", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="run on hermetic fixture worlds")
    p.add_argument("--tiny", action="store_true",
                   help="small model + short episodes (smoke tests/demos)")
    p.add_argument("--valid_only", action="store_true",
                   help="skip training; greedy evaluation of the val/test "
                        "splits (reference valid(), main.py:225-269)")
    p.add_argument("--submit", action="store_true",
                   help="dump submit_{split}.json predictions and include "
                        "the GT-less test split")
    p.add_argument("--resume_file", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain attention, no kernel)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.task != "r2r":
        raise NotImplementedError(f"--task {args.task}: task variants are ROADMAP item A11")
    cfg = get_preset(args.task)
    feedback = args.feedback or cfg.train.feedback
    if not args.synthetic:
        raise NotImplementedError("real Matterport data is ROADMAP item A12; pass --synthetic")
    if args.resume_file:
        raise NotImplementedError("--resume_file: checkpoint ingestion is ROADMAP item A12")
    device = resolve_device("cpu" if args.cpu else None)

    tcfg = {"seed": args.seed, "feedback": feedback}
    if args.batch_size is not None:
        tcfg["batch_size"] = args.batch_size
    if args.lr is not None:
        tcfg["lr"] = args.lr
    cfg = cfg.replace(train=tcfg)
    if args.tiny:
        cfg = cfg.replace(
            model={"hidden_size": 64, "num_attention_heads": 4,
                   "intermediate_size": 128, "num_l_layers": 2,
                   "num_x_layers": 1, "num_h_pano_layers": 1,
                   "image_feat_size": 32, "max_position_embeddings": 128,
                   "max_action_steps": 32},
            env={"max_action_len": 8, "max_instr_len": 32,
                 "image_feat_size": 32},
            train={"batch_size": args.batch_size or 4},
        )

    cfg, train_env, val_envs = build_synthetic_dataset(cfg, args.seed,
                                                       test_split=args.submit)
    if args.valid_only:
        results = valid(cfg, val_envs, args.output_dir, submit=args.submit, device=device)
        print(json.dumps({"valid": results}, default=float))
        return results
    best = train(cfg, train_env, val_envs, args.output_dir, args.iters, args.log_every,
                 device=device, merged_sample=not args.no_merged_sample)
    print(json.dumps({"best": best}, default=float))
    return best


if __name__ == "__main__":
    main()
