"""Fine-tuning and evaluation entry point (torch), the port of
``vln_hamt_tpu/run/finetune.py``.

    python -m vln_hamt_torch.run.finetune \\
        --task r2r|r2r_last|r4r|rxr|r2r_back|cvdn|reverie \\
        --anno_dir DIR --connectivity_dir DIR --img_ft_file FILE.hdf5 \\
        [--obj_ft_file OBJ.hdf5] \\
        [--aug AUG.json] [--init_pretrain P.pt | --init_ref_ckpt REF.pt] \\
        [--resume_file latest.pt] \\
        [--eval_first] [--feedback teacher [--packed_il]] [--no_merged_sample] [--bf16] \\
        [--no_feat_table] [--no_cand_backtrack] [--iters N --log_every K] \
        [--orbax_ckpt]
    python -m vln_hamt_torch.run.finetune --task rxr --synthetic [--valid_only] ...
    torchrun --nproc_per_node 2 -m vln_hamt_torch.run.finetune ... \
        --data_shards 2 [--sharded_feed] | --model_shards 2

runs the task's preset (the R2R family, R2R-Back, CVDN, or REVERIE with
its object grounding) at full width on the GPU (``--cpu`` runs on the
CPU through the plain attention; ``--tiny`` shrinks the model and
episodes), over the reference's files (Matterport connectivity, the
task's annotation files, HDF5 panorama features; for REVERIE also
``BBoxes.json`` in the annotation directory and ``--obj_ft_file``'s object
features) or, with
``--synthetic``, over a hermetic fixture world with the preset's feature
width. Weights start from a seed, from a port pretraining checkpoint
(``--init_pretrain``, ``run/pretrain.py``'s ``model_step_N.pt``) or a
released reference checkpoint (``--init_ref_ckpt``: an agent save or a
pretrain ``ModelSaver`` state dict), and/or from a port checkpoint
(``--resume_file``, which wins).

Training takes ``--iters`` updates with the preset's ``sample`` feedback
(IL plus A2C on a sampling rollout; merged, or fused with
``--no_merged_sample``) or with ``--feedback teacher`` (IL alone); with
``--aug`` the updates of an interval alternate between the GT and the
aug env. ``--packed_il`` packs several teacher episodes into each slot
of the IL episode loop (teacher feedback only); ``--bf16`` computes in
bfloat16 (parameters, optimizers and losses fp32, features bf16).
``--no_feat_table`` keeps the features on the host and ships them per
step: evaluation then runs on the packed host-loop evaluator and the
``sample`` update samples on the host loop, then replays.
``--no_cand_backtrack`` forbids candidates the episode has visited in
every evaluation (the packed evaluator).
Every ``--log_every`` it appends the interval's loss,
episodes/s and MFU to ``metrics.jsonl`` (and its mean losses to
``train.txt``), evaluates the validation splits greedily, and writes
``latest.pt`` and, on a better selection score, ``best_val_unseen.pt``;
it prints ``{"best": {...}}``; the selection score is the task's
(SR + SPL, REVERIE's SPL + RGSPL, CVDN's GP). ``--valid_only`` evaluates
instead (``--resume_file`` and/or ``--init_ref_ckpt`` give the weights),
prints ``{"valid": {split: metrics}}`` and writes ``valid.txt`` (and
``submit_{split}.json`` with ``--submit``, with R2R-Back's ``midstop``
and REVERIE's ``predObjId``). ``--orbax_ckpt`` writes the checkpoints as
``torch.distributed.checkpoint`` directories (``latest``,
``best_val_unseen``; asynchronously, waited for before exit), which
``--resume_file`` also takes. The JAX CLI's other flags are accepted and
raise, naming their ROADMAP item.

Across GPUs, one rank per process (``parallel/mesh.py``; ``torchrun`` or
RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT): ``--data_shards`` x
``--model_shards`` must be the number of ranks. Data parallelism trains
each rank on its rows of the global batch that every rank's env replica
builds, or with ``--sharded_feed`` on its own shard of the train split
at ``batch / data_shards``; ``--model_shards`` splits the transformer
blocks (tensor parallelism). The validation splits are sharded over the
data ranks (a model group's ranks take the same shard), their
predictions gathered before the metrics. Rank 0 alone writes records,
``metrics.jsonl`` and checkpoints.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..agents.agent import HAMTAgent, resolve_device
from ..agents.reverie import ReverieAgent
from ..agents.variants import CVDNAgent, R2RBackAgent
from ..configs import HAMTConfig, get_preset
from ..configs.config import PRESETS
from ..data.feature_db import (FeatureDB, HDF5FeatureDB, load_obj2viewpoint,
                               load_object_db)
from ..data.fixtures import (add_synthetic_objects, make_synthetic_cvdn_items,
                             make_synthetic_r2rback_items, make_synthetic_world)
from ..data.instructions import construct_instrs
from ..data.nav_graph import load_nav_graphs
from ..env import CVDNNavEnv, ObsSpec, R2RBackNavEnv, R2RNavEnv, ReverieNavEnv
from ..parallel.mesh import (Mesh, host_allgather, init_distributed, is_default_process,
                             local_device, make_mesh)
from ..utils.flops import update_flops_and_peak
from ..utils.logging import MetricsLogger, SpanRecorder, write_record
from ..utils.misc import apply_rng_impl

#: each task's env and agent; the R2R family shares R2R's
_ENV_CLS = {**{task: R2RNavEnv for task in ("r2r", "r2r_last", "r4r", "rxr")},
            "r2r_back": R2RBackNavEnv, "reverie": ReverieNavEnv, "cvdn": CVDNNavEnv}
_AGENT_CLS = {**{task: HAMTAgent for task in ("r2r", "r2r_last", "r4r", "rxr")},
              "r2r_back": R2RBackAgent, "reverie": ReverieAgent, "cvdn": CVDNAgent}

#: flags of the JAX CLI that the port does not run yet, with their
#: ROADMAP item (none left)
_UNPORTED_FLAGS: Dict[str, str] = {}


def selection_score(dataset: str, metrics: Dict[str, float]) -> float:
    """Model-selection metric per task: SR + SPL for the R2R family and
    R2R-Back (main.py:204-210), SPL + RGSPL for REVERIE
    (reverie/main_navref.py:197-203), GP for CVDN (cvdn/main.py:196-201)."""
    if dataset == "reverie":
        return metrics.get("spl", 0.0) + metrics.get("rgspl", 0.0)
    if dataset == "cvdn":
        return metrics.get("gp", 0.0)
    return metrics.get("spl", 0.0) + metrics.get("sr", 0.0)


def _env_layout(cfg: HAMTConfig, mesh: Optional[Mesh], sharded_feed: bool):
    """(train split's shard, train batch, val shard, val batch): the data
    index's shard of a split at ``batch / data_shards``, or None and the
    whole batch (the train env's replicated feed, or one data rank)."""
    b = cfg.train.batch_size
    if mesh is None or mesh.data_shards == 1:
        return None, b, None, b
    if b % mesh.data_shards:
        raise ValueError(f"batch {b} is not divisible by {mesh.data_shards} data shards")
    shard, local = (mesh.data_index, mesh.data_shards), b // mesh.data_shards
    return (shard if sharded_feed else None), (local if sharded_feed else b), shard, local


def build_synthetic_dataset(cfg: HAMTConfig, seed: int = 0, test_split: bool = False,
                            aug: bool = False, mesh: Optional[Mesh] = None,
                            sharded_feed: bool = False):
    """Fixture-backed envs for hermetic runs (no Matterport data), with the
    preset's feature width.

    ``aug=True`` builds a synthetic aug env over the train items
    (differently seeded episode stream), so the GT/aug interval
    alternation (main.py:146-161) runs hermetically. The variants take
    the world's items as their fixtures make them (R2R-Back's out-and-back
    paths, CVDN's dialog items with end panos, REVERIE's target objects
    and object database), as the JAX CLI wires them. ``mesh`` shards the
    splits as :func:`_env_layout` says.
    """
    dataset = cfg.env.dataset
    world = make_synthetic_world(
        num_scans=2, nodes_per_scan=24, num_items=48,
        feat_dim=cfg.env.image_feat_size, seed=seed,
    )
    max_deg = max(g.max_degree for g in world.graphs.values())
    cfg = cfg.replace(env={"max_candidates": max_deg})
    spec = ObsSpec(max_candidates=max_deg,
                   image_feat_size=cfg.env.image_feat_size,
                   ob_type=cfg.env.ob_type)
    env_kwargs = {}
    if dataset == "r2r_back":
        items = make_synthetic_r2rback_items(world)
    elif dataset == "cvdn":
        items = make_synthetic_cvdn_items(world)
        env_kwargs["use_player_path"] = cfg.env.use_player_path
    elif dataset == "reverie":
        obj_db, obj2vp = add_synthetic_objects(world, obj_feat_size=cfg.model.obj_feat_size)
        items = world.instr_data
        env_kwargs.update(obj_db=obj_db, obj2viewpoint=obj2vp,
                          max_objects=cfg.env.max_objects,
                          obj_feat_size=cfg.model.obj_feat_size,
                          multi_endpoints=cfg.env.multi_endpoints)
    else:
        items = world.instr_data
    n_train = int(len(items) * 0.75)
    env_cls = _ENV_CLS[dataset]
    train_shard, train_bs, val_shard, val_bs = _env_layout(cfg, mesh, sharded_feed)

    def make_env(data, name, seed_shift=0):
        is_train = name in ("train", "aug")
        return env_cls(
            world.graphs, world.feat_db, data, spec,
            batch_size=train_bs if is_train else val_bs,
            max_instr_len=cfg.env.max_instr_len,
            max_action_len=cfg.env.max_action_len,
            seed=cfg.train.seed + seed_shift, name=name,
            sel_data_idxs=train_shard if is_train else val_shard,
            reuse_episode_buffers=is_train,
            **env_kwargs,
        )

    train_env = make_env(items[:n_train], "train")
    if aug:
        train_env = (train_env, make_env(items[:n_train], "aug", seed_shift=1))
    val_envs = {"val_unseen": make_env(items[n_train:], "val_unseen")}
    if test_split:
        # GT-less test items: path truncated to the start viewpoint,
        # mirroring the official test annotations (r2r/main.py:66-69);
        # CVDN's dialog items carry their goal as end panos instead
        test_items = [{k: v for k, v in it.items() if k != "end_panos"} if "path" not in it
                      else {**it, "path": it["path"][:1]} for it in items[n_train:]]
        val_envs["test"] = make_env(test_items, "test")
    return cfg, train_env, val_envs


def build_real_dataset(cfg: HAMTConfig, args, valid_only: bool = False,
                       feat_db: Optional[FeatureDB] = None,
                       obj_db: Optional[dict] = None, mesh: Optional[Mesh] = None) -> Tuple:
    """Envs over the reference's files (main.py:26-83), sharded over
    ``mesh``'s data ranks as :func:`_env_layout` says (``args.sharded_feed``).

    ``valid_only`` builds only the evaluation envs: the reference's
    ``valid()`` never touches the train split (r2r/main.py:225-269), so a
    checkpoint can be evaluated with only val/test annotation files
    present. ``feat_db`` stands in for ``HDF5FeatureDB(args.img_ft_file)``
    (a caller holding the features in memory); ``obj_db`` for
    ``load_object_db(args.obj_ft_file)`` (REVERIE).

    The task's wiring (reverie/main_navref.py:26-80, cvdn/main.py:43-60):
    REVERIE's envs take the object database and ``BBoxes.json``'s
    object-to-viewpoint map, endpoint resampling in the train and aug
    envs only, start resampling in the aug env only; CVDN's take
    ``use_player_path``.
    """
    dataset = cfg.env.dataset
    if feat_db is None:
        feat_db = HDF5FeatureDB(args.img_ft_file, cfg.env.image_feat_size)
    splits = {} if valid_only else {"train": ["train"]}
    splits.update({"val_train_seen": ["val_train_seen"], "val_seen": ["val_seen"]})
    # R4R's val_unseen is too large to evaluate during training; the
    # reference substitutes a sampled subset (r2r/main.py:59-63)
    if dataset == "r4r" and not args.test:
        splits["val_unseen_sampled"] = ["val_unseen_sampled"]
    else:
        splits["val_unseen"] = ["val_unseen"]
    if args.submit:
        # leaderboard test splits, GT-less (main.py:64-69)
        for sp in (("test",) if dataset != "rxr"
                   else ("test_challenge_public", "test_standard_public")):
            splits[sp] = [sp]
    if args.aug and not valid_only:
        # a separate aug env; training alternates GT/aug batches
        # (main.py:150-161)
        splits["aug"] = [args.aug]

    instr = {}
    for name, sp in splits.items():
        try:
            instr[name] = construct_instrs(args.anno_dir, dataset, sp,
                                           max_instr_len=cfg.env.max_instr_len)
        except FileNotFoundError:
            if name == "train":
                raise
            print(f"split {name}: annotation file missing, skipped")
    scans = sorted({x["scan"] for items in instr.values() for x in items})
    graphs = load_nav_graphs(args.connectivity_dir, scans)
    max_deg = max(g.max_degree for g in graphs.values())
    cfg = cfg.replace(env={"max_candidates": max_deg})
    spec = ObsSpec(max_candidates=max_deg,
                   image_feat_size=cfg.env.image_feat_size,
                   ob_type=cfg.env.ob_type)
    env_cls = _ENV_CLS[dataset]
    env_kwargs: Dict[str, object] = {}
    if dataset == "reverie":
        if obj_db is None:
            obj_db = (load_object_db(args.obj_ft_file, cfg.model.obj_feat_size)
                      if args.obj_ft_file else {})
        env_kwargs.update(obj_db=obj_db, obj2viewpoint=load_obj2viewpoint(args.anno_dir),
                          max_objects=cfg.env.max_objects,
                          obj_feat_size=cfg.model.obj_feat_size)
    elif dataset == "cvdn":
        env_kwargs["use_player_path"] = cfg.env.use_player_path
    train_shard, train_bs, val_shard, val_bs = _env_layout(
        cfg, mesh, bool(getattr(args, "sharded_feed", False)))

    def make_env(data, name):
        is_train = name in ("train", "aug")
        kwargs = dict(env_kwargs)
        if dataset == "reverie":
            kwargs.update(multi_endpoints=cfg.env.multi_endpoints and is_train,
                          multi_startpoints=name == "aug")
        return env_cls(
            graphs, feat_db, data, spec,
            batch_size=train_bs if is_train else val_bs,
            max_instr_len=cfg.env.max_instr_len,
            max_action_len=cfg.env.max_action_len,
            seed=cfg.train.seed, name=name,
            sel_data_idxs=train_shard if is_train else val_shard,
            reuse_episode_buffers=is_train, **kwargs,
        )

    train_env = None
    if not valid_only:
        train_env = make_env(instr["train"], "train")
        if args.aug:
            train_env = (train_env, make_env(instr["aug"], "aug"))
    val_envs = {name: make_env(items, name) for name, items in instr.items()
                if name not in ("train", "aug")}
    return cfg, train_env, val_envs


def _merge_preds(preds: List[dict], mesh: Optional[Mesh] = None) -> List[dict]:
    """Every rank's predictions (``host_allgather``), deduped by instr_id:
    the data ranks' shards join, a model group's copies collapse."""
    merged: Dict[str, dict] = {}
    for p in (q for shard in host_allgather(preds, mesh) for q in shard):
        merged.setdefault(p["instr_id"], p)
    return list(merged.values())


def _apply_weight_init(agent: HAMTAgent, init_ref_ckpt: Optional[str],
                       record_file: Optional[str] = None) -> None:
    """Weights from a released reference torch checkpoint
    (vlnbert_init.py:20-31) or a port pretraining checkpoint, which has
    the same format, reporting what did not fit."""
    if not init_ref_ckpt:
        return
    skipped = agent.init_from_reference(init_ref_ckpt)
    msg = (f"initialized weights from {init_ref_ckpt}"
           + (f" (skipped {len(skipped)} mismatched leaves: {', '.join(skipped[:8])}"
              + ("..." if len(skipped) > 8 else "") + ")" if skipped else ""))
    print(msg)
    if record_file:
        write_record(record_file, msg)


def _share_feature_table(agent: HAMTAgent, env: R2RNavEnv, others) -> None:
    """Move ``env``'s graphs' features to the device once; every other env
    shares the graphs and so the table's offsets."""
    agent.enable_feature_table(env)
    for e in others:
        e.feat_offsets = env.feat_offsets


def train(cfg: HAMTConfig, train_env, val_envs: Dict[str, R2RNavEnv], output_dir: str,
          iters: Optional[int] = None, log_every: Optional[int] = None,
          eval_first: bool = False, resume_file: Optional[str] = None,
          merged_sample: bool = True, init_ref_ckpt: Optional[str] = None,
          packed_il: bool = False, no_cand_backtrack: bool = False,
          device=None, mesh: Optional[Mesh] = None, sharded_feed: bool = False,
          orbax_ckpt: bool = False) -> Dict[str, float]:
    """The train/validate loop (main.py:86-222) with the config's
    feedback; ``sample`` updates are merged (the JAX CLI's production
    default) unless ``merged_sample`` is off, then fused; ``packed_il``
    packs the ``teacher`` updates' episodes (one packer per env);
    ``no_cand_backtrack`` goes to every evaluation. Without the config's
    ``feat_table`` the features stay on the host.
    ``train_env`` may be a (train_env, aug_env) pair: the updates of an
    interval then alternate between the two (main.py:150-161).
    ``mesh``: train as its rank (``agent.enable_mesh``; with
    ``sharded_feed`` the envs hold the rank's shard); ``orbax_ckpt``:
    directory checkpoints written asynchronously."""
    os.makedirs(output_dir, exist_ok=True)
    logger = MetricsLogger(output_dir)
    record_file = os.path.join(output_dir, "train.txt")
    dataset = cfg.env.dataset
    aug_env = None
    if isinstance(train_env, tuple):
        train_env, aug_env = train_env
    agent = _AGENT_CLS[dataset](cfg, train_env, seed=cfg.train.seed, device=device)
    agent.merged_sample_update = merged_sample
    if mesh is not None:  # before any weights land: they are split on load
        agent.enable_mesh(mesh)
        if sharded_feed:
            if packed_il:
                raise ValueError("--packed_il with --sharded_feed is not supported (the "
                                 "JAX CLI's guard)")
            agent.enable_host_sharded_feed()
    # reference or pretrained weights first, then the feature table, then
    # a resumed checkpoint, which wins
    _apply_weight_init(agent, init_ref_ckpt, record_file)
    if cfg.train.feat_table:
        _share_feature_table(agent, train_env, ([aug_env] if aug_env is not None else [])
                             + list(val_envs.values()))
    if packed_il:
        # the JAX CLI's guard (finetune.py:365-379); main() refuses
        # --no_feat_table with it, and the agent packs from the table only
        if cfg.train.feedback != "teacher":
            raise ValueError("--packed_il applies to teacher feedback only (an interactive "
                             "'sample' rollout has policy-dependent lengths)")
        agent.enable_packed_il()
    if resume_file:
        agent.load(resume_file, resume_optimizer=cfg.train.resume_optimizer)
    if is_default_process():
        with open(os.path.join(output_dir, "training_config.json"), "w") as f:
            f.write(cfg.to_json())

    def save(stem: str) -> None:
        if orbax_ckpt:
            agent.save_dir(os.path.join(output_dir, stem), async_=True)
        else:
            agent.save(os.path.join(output_dir, stem + ".pt"))

    if eval_first:  # sanity eval before training (main.py:112-128)
        for name, env in val_envs.items():
            metrics, _ = env.eval_metrics(_merge_preds(
                agent.eval_split_fast(env, no_cand_backtrack), mesh))
            write_record(record_file, f"eval_first {name}: {metrics}")

    iters = iters or cfg.train.iters
    log_every = log_every or cfg.train.log_every
    best = {"score": -np.inf, "iter": 0}

    # per-interval throughput and MFU (analytic matmul FLOPs over wall
    # time over the ranks' cards' bf16 peak, utils/flops.py); null on the
    # CPU and on a card of unknown peak
    flops_per_iter, peak = update_flops_and_peak(
        cfg, torch.cuda.get_device_name(agent.device) if agent.device.type == "cuda" else None,
        1 if mesh is None else mesh.data_shards * mesh.model_shards)

    # the phases of each update (agents/agent.py's spans), logged per
    # interval as span/<name>_ms and count/<name> per update
    with SpanRecorder() as spans:
        step = 0
        while step < iters:
            interval = min(log_every, iters - step)
            with logger.timer("train") as train_t:
                outs = []
                for j in range(interval):
                    if aug_env is not None:
                        agent.env = train_env if j % 2 == 0 else aug_env
                    # the host assembles the next episode while the device works
                    outs.append(agent.train_iteration(sync=False))
                keys = [k for k in ("loss", "IL_loss", "RL_loss", "entropy") if k in outs[0]]
                # one read of the interval's scalars, which waits for its work
                vals = torch.stack([torch.stack([o[k] for k in keys])
                                    for o in outs]).cpu().numpy()
            step += interval
            if not np.isfinite(vals).all():
                raise FloatingPointError(
                    f"non-finite loss by iter {step}: {dict(zip(keys, vals.T))}")
            dt = train_t.last
            # a packed update trains a varying number of episodes
            eps_per_sec = sum(o.get("episodes", cfg.train.batch_size) for o in outs) / dt
            logger.log(step, {"loss": float(vals[:, 0].mean()), "eps_per_sec": eps_per_sec,
                              "mfu": None if peak is None else interval * flops_per_iter / dt / peak})
            means = ", ".join(f"{k}={v:.4f}" for k, v in zip(keys, vals.mean(axis=0)))
            write_record(record_file, f"iter {step}: {means}, eps_per_sec={eps_per_sec:.2f}")

            for name, env in val_envs.items():
                with logger.timer(f"eval_{name}"):
                    metrics, _ = env.eval_metrics(_merge_preds(
                        agent.eval_split_fast(env, no_cand_backtrack), mesh))
                logger.log(step, metrics, prefix=f"{name}/")
                write_record(record_file, f"iter {step} {name}: " + ", ".join(
                    f"{k}={v:.2f}" for k, v in metrics.items()))
                if name in ("val_unseen", "val_unseen_sampled"):
                    score = selection_score(dataset, metrics)
                    if score > best["score"]:
                        best = {"score": score, "iter": step, **metrics}
                        save("best_val_unseen")
            save("latest")
            logger.log_timers(step, spans)
    agent.wait_for_checkpoints()
    logger.close()
    return best


def valid(cfg: HAMTConfig, ckpt: Optional[str], val_envs: Dict[str, R2RNavEnv],
          output_dir: str, submit: bool = False, init_ref_ckpt: Optional[str] = None,
          no_cand_backtrack: bool = False, device=None,
          mesh: Optional[Mesh] = None) -> Dict[str, Dict[str, float]]:
    """Stand-alone greedy evaluation of a checkpoint (main.py:225-269):
    greedy eval per split, metrics for GT splits, ``submit_{split}.json``
    dumps, and a valid.txt record file; as ``mesh``'s rank over its
    shards when given."""
    os.makedirs(output_dir, exist_ok=True)
    record_file = os.path.join(output_dir, "valid.txt")
    agent = _AGENT_CLS[cfg.env.dataset](cfg, None, seed=cfg.train.seed, device=device)
    if mesh is not None:
        agent.enable_mesh(mesh)
    _apply_weight_init(agent, init_ref_ckpt, record_file)
    if ckpt:
        step = agent.load(ckpt)
        write_record(record_file, f"loaded {ckpt} at iter {step}")
    first = next(iter(val_envs.values()))
    agent.env = first
    if cfg.train.feat_table:
        _share_feature_table(agent, first, val_envs.values())
    results = {}
    for name, env in val_envs.items():
        agent.env = env
        merged = _merge_preds(agent.eval_split_fast(env, no_cand_backtrack), mesh)
        if "test" not in name:  # test splits have no GT (main.py:258-262)
            metrics, _ = env.eval_metrics(merged)
            results[name] = metrics
            write_record(record_file, f"{name}: " + ", ".join(
                f"{k}={v:.2f}" for k, v in metrics.items()))
        if submit and is_default_process():
            path = os.path.join(output_dir, f"submit_{name}.json")
            with open(path, "w") as f:
                # the task's extras ride along, as in the reference's
                # get_results dumps (main_navref.py:252-256)
                json.dump([{"instr_id": p["instr_id"],
                            "trajectory": [[vp, h, e] for vp, h, e in p["trajectory"]],
                            **{k: p[k] for k in ("predObjId", "midstop") if k in p}}
                           for p in merged], f, sort_keys=True, indent=2)
    return results


def parse_args(argv=None):
    """The JAX CLI's flags, every one of them (``vln_hamt_tpu/run/
    finetune.py:parse_args``); those in ``_UNPORTED_FLAGS`` raise in
    :func:`main`."""
    p = argparse.ArgumentParser(description="HAMT fine-tuning and evaluation (PyTorch/CUDA)")
    p.add_argument("--task", default="r2r", choices=sorted(PRESETS),
                   help="r2r | r2r_last | r4r | rxr | r2r_back | cvdn | reverie")
    p.add_argument("--output_dir", default="runs/finetune_torch")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--log_every", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--feedback", default=None, choices=("teacher", "sample"),
                   help="training feedback (the preset's: sample)")
    p.add_argument("--synthetic", action="store_true",
                   help="run on hermetic fixture worlds")
    p.add_argument("--tiny", action="store_true",
                   help="small model + short episodes (smoke tests/demos)")
    p.add_argument("--anno_dir", default=None)
    p.add_argument("--connectivity_dir", default=None)
    p.add_argument("--img_ft_file", default=None)
    p.add_argument("--obj_ft_file", default=None,
                   help="REVERIE object features (HDF5, one {scan}_{viewpoint} dataset "
                        "with obj_ids, bboxes and viewindexs attributes)")
    p.add_argument("--aug", default=None,
                   help="augmented-instruction annotation file (prevalent_aug); "
                        "training then alternates GT/aug batches (main.py:146-161). "
                        "With --synthetic any value builds a fixture aug env.")
    p.add_argument("--resume_file", default=None,
                   help="a checkpoint of this port (latest.pt, best_val_unseen.pt): "
                        "the weights to evaluate with --valid_only, or to resume "
                        "training from (the optimizers too if the config says "
                        "resume_optimizer)")
    init = p.add_mutually_exclusive_group()
    init.add_argument("--init_pretrain", default=None,
                      help="a checkpoint of this port's run/pretrain.py (model_step_N.pt): "
                           "the trunk, with the SAP head grafted onto the action head")
    init.add_argument("--init_ref_ckpt", default=None,
                      help="released reference torch checkpoint (agent save or pretrain "
                           "ModelSaver state dict) to initialize weights from")
    p.add_argument("--eval_first", action="store_true")
    p.add_argument("--valid_only", action="store_true",
                   help="skip training; greedy evaluation of the val/test splits "
                        "(reference valid(), main.py:225-269)")
    p.add_argument("--submit", action="store_true",
                   help="dump submit_{split}.json predictions and include the "
                        "leaderboard test split")
    p.add_argument("--test", action="store_true",
                   help="use the full val_unseen for R4R instead of val_unseen_sampled "
                        "(r2r/main.py:59-63)")
    p.add_argument("--no_cand_backtrack", action="store_true",
                   help="greedy evaluation never moves to a visited viewpoint (the "
                        "packed host-loop evaluator)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain attention, no kernel)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (parameters, optimizers and losses fp32; the "
                        "feature table bf16)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each rollout step's activations in backward (less "
                        "memory, one more forward of the steps)")
    p.add_argument("--remat_policy", default=None, choices=["full", "dots"],
                   help="full: recompute the whole step; dots: keep the dense layers' "
                        "outputs, recompute the rest (the preset's: full)")
    p.add_argument("--no_feat_table", action="store_true",
                   help="keep the features on the host, shipped per step: host-loop "
                        "evaluation and rollout-then-replay sample updates")
    p.add_argument("--no_merged_sample", action="store_true",
                   help="sample feedback as the fused update (teacher episode forward, "
                        "then the rollout) instead of the merged one (the teacher "
                        "episode as extra lanes of the rollout)")
    p.add_argument("--rng_impl", default=None, choices=["threefry2x32", "rbg"],
                   help="the JAX package's dropout PRNG name, validated and recorded; the "
                        "port draws from the same streams under either (utils/misc.py)")
    p.add_argument("--orbax_ckpt", action="store_true",
                   help="write directory checkpoints (torch.distributed.checkpoint, "
                        "asynchronous) instead of .pt files; --resume_file takes either")
    p.add_argument("--sharded_feed", action="store_true",
                   help="each data rank's train env holds its shard of the split at "
                        "batch / data_shards (else every rank builds the global batch)")
    p.add_argument("--packed_il", action="store_true",
                   help="pack several teacher episodes into each slot of the IL episode "
                        "loop (agents/packing.py): about T / mean length more episodes "
                        "per update, the same per-episode estimator; teacher feedback "
                        "and the feature table only")
    p.add_argument("--data_shards", type=int, default=None,
                   help="data-parallel ranks (the batch split over them)")
    p.add_argument("--model_shards", type=int, default=None,
                   help="tensor-parallel ranks (the transformer blocks split over them)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    # the ranks' process group first (a no-op on one process)
    dist_up = init_distributed(cpu=args.cpu)
    mesh = make_mesh(args.data_shards or 1, args.model_shards or 1)
    mesh = mesh if dist_up else None
    if args.packed_il and args.no_feat_table:
        raise ValueError("--packed_il requires the feature table")
    if args.packed_il and args.sharded_feed:
        raise ValueError("--packed_il with --sharded_feed is not supported (the JAX CLI's "
                         "guard)")
    for flag, item in _UNPORTED_FLAGS.items():
        value = getattr(args, flag)
        if value not in (None, False):
            raise NotImplementedError(f"--{flag} is ROADMAP item {item}")
    if not args.synthetic and not (args.anno_dir and args.connectivity_dir
                                   and args.img_ft_file):
        raise ValueError("real-data runs need --anno_dir --connectivity_dir --img_ft_file "
                         "(or pass --synthetic)")
    device = resolve_device(local_device(args.cpu) if dist_up else
                            ("cpu" if args.cpu else None))
    # a port pretraining checkpoint is a reference pretrain ModelSaver file
    init_ckpt = args.init_ref_ckpt or args.init_pretrain

    cfg = get_preset(args.task)
    overrides = {key: getattr(args, key) for key in ("batch_size", "lr", "feedback")
                 if getattr(args, key) is not None}
    # validated and recorded (training_config.json); the port's streams
    # are the same under every name (utils/misc.py)
    overrides["rng_impl"] = apply_rng_impl(args.rng_impl or cfg.train.rng_impl)
    cfg = cfg.replace(train={**overrides, "seed": args.seed,
                             "num_data_shards": args.data_shards or 1,
                             "model_shards": args.model_shards or 1})
    if args.no_feat_table:
        cfg = cfg.replace(train={"feat_table": False})
    if args.bf16:
        cfg = cfg.replace(model={"dtype": "bfloat16"})
    if args.remat:
        cfg = cfg.replace(model={"remat": True})
    if args.remat_policy is not None:
        cfg = cfg.replace(model={"remat_policy": args.remat_policy})
    if args.tiny:
        cfg = cfg.replace(
            model={"hidden_size": 64, "num_attention_heads": 4,
                   "intermediate_size": 128, "num_l_layers": 2,
                   "num_x_layers": 1, "num_h_pano_layers": 1,
                   "image_feat_size": 32, "max_position_embeddings": 128,
                   "max_action_steps": 32,
                   **({"obj_feat_size": 32} if cfg.model.obj_feat_size > 0 else {})},
            env={"max_action_len": 8, "max_instr_len": 32, "image_feat_size": 32},
            # explicit CLI flags win over the tiny defaults
            train={"batch_size": args.batch_size or 4,
                   "lr": args.lr if args.lr is not None else 1e-3},
        )

    if args.synthetic:
        cfg, train_env, val_envs = build_synthetic_dataset(
            cfg, args.seed, test_split=args.submit, aug=bool(args.aug) and not args.valid_only,
            mesh=mesh, sharded_feed=args.sharded_feed)
    else:
        cfg, train_env, val_envs = build_real_dataset(cfg, args, valid_only=args.valid_only,
                                                      mesh=mesh)

    if args.valid_only:
        results = valid(cfg, args.resume_file, val_envs, args.output_dir, submit=args.submit,
                        init_ref_ckpt=init_ckpt, no_cand_backtrack=args.no_cand_backtrack,
                        device=device, mesh=mesh)
        print(json.dumps({"valid": results}, default=float))
        return results

    # leaderboard test splits are evaluated only in valid_only mode
    train_val_envs = {k: v for k, v in val_envs.items() if "test" not in k}
    best = train(cfg, train_env, train_val_envs, args.output_dir, iters=args.iters,
                 log_every=args.log_every, eval_first=args.eval_first,
                 resume_file=args.resume_file, merged_sample=not args.no_merged_sample,
                 init_ref_ckpt=init_ckpt, packed_il=args.packed_il,
                 no_cand_backtrack=args.no_cand_backtrack, device=device, mesh=mesh,
                 sharded_feed=args.sharded_feed, orbax_ckpt=args.orbax_ckpt)
    print(json.dumps({"best": best}, default=float))
    return best


if __name__ == "__main__":
    main()
