"""Proxy-task pretraining entry point (torch), the port of
``vln_hamt_tpu/run/pretrain.py``.

    python -m vln_hamt_torch.run.pretrain --synthetic [--preset r2r|rxr] \\
        [--num_steps N --valid_steps K] [--optim adamw|adam|radam|ralamb|lookahead|rangerlars]
    python -m vln_hamt_torch.run.pretrain --train_traj_files train.jsonl \\
        --val_traj_files seen=val_seen.jsonl unseen=val_unseen.jsonl \\
        --img_ft_file FEATS.hdf5 --connectivity_dir DIR [--bert_init BERT.bin]

Parity target: ``pretrain_src/main_r2r.py``. Trains the preset's model
(``r2r``: hidden 768, 12 heads, 9 text, 4 cross-modal and 2 panorama
layers; ``rxr``: XLM-R text, 512-d CLIP features, candidate-first
observations, 250-token instructions, no MRC) on the six proxy tasks in
the preset's mix (r2r: MLM, MRC, ITM, SAP, SAR, SpRel 5:1:1:1:2:2) with
the JAX CLI's defaults (batch 16, 80 text tokens, 25 history steps,
adamw lr 5e-5 with warmup-linear, grad-norm 5), on the GPU unless
``--cpu``, over a synthetic world (``--synthetic``) or reference-format
trajectory JSONL, HDF5 features and connectivity files. Every stack is
trained: the fine-tuning presets' ``fix_lang_embedding`` and
``fix_hist_embedding`` do not apply to pretraining (the reference's
pretraining config has neither; the JAX CLI takes them from the preset,
ROADMAP §C). Features live on the device and batches ship table rows
unless ``--no_feat_table``. ``--bf16`` computes in bfloat16 (the JAX
CLI's ``dtype="bfloat16"``: parameters, optimizer and losses fp32, the
feature table bf16).

Every ``valid_steps // 10`` steps it appends the task's loss, metrics
and examples/s to ``metrics.jsonl``; every ``valid_steps`` (and at the
end) it validates every stream on every task over the whole split and
writes ``model_step_N.pt``: the model's state dict in the reference's
pretrain format plus ``step``, which ``run/finetune.py --init_pretrain``
takes. The JAX CLI's flags that the port does not run raise, naming
their ROADMAP item.

Across GPUs, one rank per process (``parallel/mesh.py``): launch
``--data_shards x --model_shards`` ranks with ``torchrun
--nproc_per_node N -m vln_hamt_torch.run.pretrain ...``. Data
parallelism trains each rank on its rows of the global batch that every
rank's batcher builds, or with ``--sharded_feed`` on a batch of
``batch_size / data_shards`` from its own batcher (seed + 1000 x the data
index; ITM's negatives within it); ``--model_shards`` splits the
transformer blocks. Rank 0 alone writes ``metrics.jsonl`` and the
checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..agents.agent import resolve_device
from ..configs import ModelConfig, get_preset
from ..data.feature_db import HDF5FeatureDB, build_feature_table
from ..data.fixtures import make_synthetic_world
from ..data.nav_graph import load_nav_graphs
from ..models.convert import convert_hf_bert_state_dict, convert_hf_xlmr_state_dict
from ..pretrain import (PretrainBatcher, PretrainTrainer, TrajectoryDataset,
                        make_synthetic_trajectories)
from ..parallel.mesh import (Mesh, init_distributed, is_default_process, local_device,
                             make_mesh)
from ..pretrain.trajectory_data import load_trajectory_jsonl
from ..utils.logging import MetricsLogger
from ..utils.misc import apply_rng_impl

# pretrain_r2r.json task mix (config/pretrain_r2r.json:45-60)
DEFAULT_TASKS = ("mlm", "mrc", "itm", "sap", "sar", "sprel")
DEFAULT_MIX = (5, 1, 1, 1, 2, 2)
# pretrain_rxr.json: xlmr text / CLIP 512-d feats (no prob tail, so no
# MRC), candidate-first observations, 250-token instructions (:7,31-55)
RXR_TASKS = ("mlm", "sap", "sar", "sprel", "itm")
RXR_MIX = (5, 1, 1, 1, 2)

#: flags of the JAX CLI that the port does not run yet, with their
#: ROADMAP item (none left)
_UNPORTED_FLAGS: Dict[str, str] = {}


def parse_val_specs(entries: List[str]) -> Dict[str, List[str]]:
    """``--val_traj_files`` entries: plain paths (one stream named 'val')
    or ``name=path`` pairs (repeat a name to add files): the reference
    validates val_seen and val_unseen every valid_steps
    (main_r2r.py:155-198, 303-308)."""
    out: Dict[str, List[str]] = {}
    for e in entries:
        name, _, path = e.rpartition("=")
        out.setdefault(name or "val", []).append(path)
    return out


def pretrain_model_config(preset: str, tiny: bool, max_txt_len: int,
                          bf16: bool = False) -> ModelConfig:
    """The preset's model with every stack trained (no ``fix_*``);
    ``tiny``: the JAX CLI's small model for smoke runs; ``bf16``:
    bfloat16 compute."""
    mcfg = dataclasses.replace(get_preset(preset).model, fix_lang_embedding=False,
                               fix_hist_embedding=False,
                               dtype="bfloat16" if bf16 else "float32")
    if tiny:
        mcfg = dataclasses.replace(
            mcfg, hidden_size=64, num_attention_heads=4, intermediate_size=128,
            num_l_layers=2, num_x_layers=1, num_h_pano_layers=1, image_feat_size=32,
            image_prob_size=16, max_position_embeddings=max(128, max_txt_len + 2),
            max_action_steps=32)
    if max_txt_len > mcfg.max_position_embeddings:
        raise ValueError(f"max_txt_len {max_txt_len} exceeds the model's "
                         f"max_position_embeddings {mcfg.max_position_embeddings}")
    return mcfg


def _dataset(args, mcfg: ModelConfig, recs, graphs, feat_db) -> TrajectoryDataset:
    return TrajectoryDataset(recs, graphs, feat_db, image_feat_size=mcfg.image_feat_size,
                             image_prob_size=mcfg.image_prob_size,
                             max_txt_len=args.max_txt_len, max_hist_len=args.max_hist_len,
                             ob_cand_pano_view=bool(getattr(args, "ob_cand_pano_view", False)),
                             ob_cand_extra=getattr(args, "ob_cand_extra", 4))


def build_synthetic(args, mcfg: ModelConfig
                    ) -> Tuple[TrajectoryDataset, Dict[str, TrajectoryDataset]]:
    """A hermetic world (2 scans x 20 viewpoints, 64 trajectories, the
    model's feature and prob widths); the val remainder splits into seen
    and unseen streams, as the JAX CLI's."""
    world = make_synthetic_world(num_scans=2, nodes_per_scan=20, num_items=64,
                                 feat_dim=mcfg.image_feat_size + mcfg.image_prob_size,
                                 seed=args.seed)
    recs = make_synthetic_trajectories(world)
    n_train = int(len(recs) * 0.85)
    val = recs[n_train:]
    half = max(len(val) // 2, 1)
    mk = lambda rs: _dataset(args, mcfg, rs, world.graphs, world.feat_db)  # noqa: E731
    return mk(recs[:n_train]), {"seen": mk(val[:half]), "unseen": mk(val[half:] or val[:half])}


def build_real(args, mcfg: ModelConfig
               ) -> Tuple[TrajectoryDataset, Dict[str, TrajectoryDataset]]:
    """The reference's files: trajectory JSONL (``run/build_trajectories.py``
    writes them), HDF5 features with the prob tail, connectivity."""
    feat_db = HDF5FeatureDB(args.img_ft_file, mcfg.image_feat_size + mcfg.image_prob_size)
    recs = load_trajectory_jsonl(args.train_traj_files)
    val_recs = {name: load_trajectory_jsonl(files)
                for name, files in parse_val_specs(args.val_traj_files or []).items()}
    scans = sorted({r.scan for rs in [recs, *val_recs.values()] for r in rs})
    graphs = load_nav_graphs(args.connectivity_dir, scans)
    return (_dataset(args, mcfg, recs, graphs, feat_db),
            {name: _dataset(args, mcfg, rs, graphs, feat_db) for name, rs in val_recs.items()})


def load_bert_partial(path: str, mcfg: ModelConfig, bert_type: str = "bert"
                      ) -> Dict[str, np.ndarray]:
    """HuggingFace BERT / XLM-R weights -> the trunk's partial state dict
    (main_r2r.py:131-144, with XLM-R's type-embedding duplication). The
    file is read with ``weights_only=True``; a HuggingFace model directory
    would need the ``transformers`` package, which the port does not
    use."""
    if os.path.isdir(path):
        raise ValueError(f"--bert_init {path} is a directory: reading a HuggingFace model "
                         "directory needs the transformers package; pass its state-dict "
                         "file (pytorch_model.bin) instead")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if bert_type == "xlmr":
        return convert_hf_xlmr_state_dict(sd, mcfg.num_l_layers, mcfg.max_position_embeddings)
    return convert_hf_bert_state_dict(sd, mcfg.num_l_layers)


def parse_args(argv=None):
    """The JAX CLI's flags, every one of them (``vln_hamt_tpu/run/
    pretrain.py:parse_args``), plus ``--cpu``; those in
    ``_UNPORTED_FLAGS`` raise in :func:`main`."""
    p = argparse.ArgumentParser(description="HAMT proxy-task pretraining (PyTorch/CUDA)")
    p.add_argument("--output_dir", default="runs/pretrain_torch")
    p.add_argument("--num_steps", type=int, default=200_000)
    p.add_argument("--warmup_steps", type=int, default=10_000)
    p.add_argument("--valid_steps", type=int, default=5_000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--preset", default="r2r", choices=["r2r", "rxr"],
                   help="'rxr' = pretrain_rxr.json (xlmr vocab, 512-d CLIP features, "
                        "candidate-first observations, 250-token instructions, no MRC); "
                        "unset task / text-length / layout flags take the preset's values")
    p.add_argument("--max_txt_len", type=int, default=None,
                   help="default 80 (r2r) / 250 (rxr preset)")
    p.add_argument("--max_hist_len", type=int, default=25)
    p.add_argument("--tasks", nargs="+", default=None)
    p.add_argument("--mix_ratio", nargs="+", type=float, default=None)
    p.add_argument("--ob_cand_pano_view", action="store_true", default=None,
                   help="candidate-first observation layout for SAP/SAR (default on "
                        "under --preset rxr)")
    p.add_argument("--ob_cand_extra", type=int, default=4,
                   help="padding slots beyond 37 observation tokens in the "
                        "candidate-first layout")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--no_feat_table", action="store_true",
                   help="ship feature batches from the host instead of table rows into "
                        "the device-resident feature table")
    p.add_argument("--tiny", action="store_true", help="small model (smoke tests/demos)")
    p.add_argument("--train_traj_files", nargs="+", default=None)
    p.add_argument("--val_traj_files", nargs="+", default=None,
                   help="validation streams: plain paths (one stream 'val') or name=path "
                        "pairs, each validated per task every --valid_steps")
    p.add_argument("--img_ft_file", default=None)
    p.add_argument("--connectivity_dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain attention, no kernel)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (parameters, optimizer and losses fp32; the "
                        "feature table bf16)")
    p.add_argument("--data_shards", type=int, default=None)
    p.add_argument("--model_shards", type=int, default=None)
    p.add_argument("--sharded_feed", action="store_true")
    p.add_argument("--optim", default="adamw",
                   choices=["adamw", "adam", "radam", "ralamb", "lookahead", "rangerlars"])
    p.add_argument("--bert_init", default=None,
                   help="HuggingFace BERT / XLM-R state-dict file to initialize the text "
                        "embeddings and stack from")
    p.add_argument("--bert_type", default="bert", choices=["bert", "xlmr"])
    p.add_argument("--init_ckpt", default=None,
                   help="a pretraining checkpoint (model_step_N.pt) to start from; the "
                        "step restarts")
    p.add_argument("--rng_impl", default=None, choices=["threefry2x32", "rbg"],
                   help="the JAX package's dropout PRNG name, validated and recorded; the "
                        "port draws from the same streams under either (utils/misc.py)")
    p.add_argument("--resume", default=None,
                   help="a pretraining checkpoint to resume from (weights and step)")
    return p.parse_args(argv)


def resolve(args) -> ModelConfig:
    """Fill the preset's defaults into parsed ``args`` where a flag was
    left unset (tasks, mix, text length, observation layout); returns
    the model config."""
    rxr = args.preset == "rxr"
    args.tasks = args.tasks or list(RXR_TASKS if rxr else DEFAULT_TASKS)
    args.mix_ratio = args.mix_ratio or list(RXR_MIX if rxr else DEFAULT_MIX)
    args.max_txt_len = args.max_txt_len or (250 if rxr else 80)
    if args.ob_cand_pano_view is None:
        args.ob_cand_pano_view = rxr
    return pretrain_model_config(args.preset, args.tiny, args.max_txt_len, args.bf16)


def build(args, device, mesh: Mesh = None
          ) -> Tuple[PretrainTrainer, Dict[str, PretrainBatcher]]:
    """The trainer and the validation batchers of parsed ``args``
    (:func:`resolve` first), as this rank of ``mesh`` when given (the
    sharded feed's batcher seeded per data index)."""
    mcfg = resolve(args)
    train_ds, val_dss = (build_synthetic if args.synthetic else build_real)(args, mcfg)
    feat_table = None
    if not args.no_feat_table:
        feat_table, offsets = build_feature_table(train_ds.graphs, train_ds.feat_db)
        for ds in (train_ds, *val_dss.values()):
            ds.set_feat_offsets(offsets)
    sharded = mesh is not None and args.sharded_feed
    rank_seed = args.seed + 1000 * mesh.data_index if sharded else args.seed
    trainer = PretrainTrainer(
        mcfg, PretrainBatcher(train_ds, seed=rank_seed), tasks=args.tasks,
        mix_ratio=args.mix_ratio, batch_size=args.batch_size, lr=args.lr,
        warmup_steps=args.warmup_steps, total_steps=args.num_steps,
        grad_accum=args.grad_accum, seed=args.seed, optim=args.optim, feat_table=feat_table,
        device=device)
    if mesh is not None:
        trainer.enable_mesh(mesh, sharded_feed=sharded)
    return trainer, {name: PretrainBatcher(ds, seed=args.seed + 1)
                     for name, ds in val_dss.items()}


def rank_setup(args) -> Tuple[torch.device, Mesh]:
    """Join the ranks' process group (none without WORLD_SIZE) and check
    the mesh against it; the rank's device and mesh (None on one
    process)."""
    dist_up = init_distributed(cpu=args.cpu)
    mesh = make_mesh(args.data_shards or 1, args.model_shards or 1)
    if not dist_up:
        return resolve_device("cpu" if args.cpu else None), None
    return resolve_device(local_device(args.cpu)), mesh


def main(argv=None):
    args = parse_args(argv)
    for flag, item in _UNPORTED_FLAGS.items():
        if getattr(args, flag) not in (None, False):
            raise NotImplementedError(f"--{flag} is ROADMAP item {item}")
    args.rng_impl = apply_rng_impl(args.rng_impl or "threefry2x32")  # utils/misc.py
    if not args.synthetic and not (args.train_traj_files and args.img_ft_file
                                   and args.connectivity_dir):
        raise ValueError("file-backed runs need --train_traj_files --img_ft_file "
                         "--connectivity_dir (or pass --synthetic)")
    device, mesh = rank_setup(args)
    trainer, val_batchers = build(args, device, mesh)
    mcfg = trainer.cfg
    # initialization (main_r2r.py:131-148): HF BERT/XLM-R text, a prior
    # checkpoint, or a resumed run
    if args.bert_init:
        sd = trainer.model.state_dict()
        sd.update({"bert." + k: torch.from_numpy(v) for k, v in
                   load_bert_partial(args.bert_init, mcfg, args.bert_type).items()})
        trainer.set_params(sd)
    if args.init_ckpt:
        blob = torch.load(args.init_ckpt, map_location="cpu", weights_only=True)
        blob.pop("step", None)
        trainer.set_params(blob)
    start = trainer.resume(args.resume) if args.resume else 0
    ckpt = train_loop(trainer, val_batchers, args, start)
    trainer.close()
    print(json.dumps({"final_step": trainer.step}))
    return {"final_step": trainer.step, "checkpoint": ckpt}


def train_loop(trainer: PretrainTrainer, val_batchers: Dict[str, PretrainBatcher], args,
               start: int):
    """Steps ``start`` to ``args.num_steps``: every ``valid_steps // 10``
    the task's loss, metrics and examples/s to ``metrics.jsonl``, every
    ``valid_steps`` (and at the end) full-split validation of every
    stream and ``model_step_N.pt``; the run's flags and model config go to
    ``training_config.json`` first. Returns the last checkpoint's path."""
    logger = MetricsLogger(args.output_dir)
    if is_default_process():
        with open(os.path.join(args.output_dir, "training_config.json"), "w") as f:
            json.dump({"args": vars(args), "model": dataclasses.asdict(trainer.cfg)}, f,
                      indent=2, sort_keys=True)
    # unsynchronized updates; the host waits (and measures ex/s, as
    # main_r2r.py:283-301) only at log points
    t_last, n_since, ckpt = time.perf_counter(), 0, None
    for step in range(start, args.num_steps):
        task, loss, aux = trainer.train_step()
        n_since += 1
        if (step + 1) % max(args.valid_steps // 10, 1) == 0:
            loss = float(loss)  # waits for the update
            now = time.perf_counter()
            ex_s = n_since * args.batch_size / (now - t_last)
            t_last, n_since = now, 0
            logger.log(step + 1, {f"{task}/loss": loss, "ex_per_sec": round(ex_s, 2),
                                  **{f"{task}/{k}": float(v) for k, v in aux.items()}})
        if (step + 1) % args.valid_steps == 0 or step + 1 == args.num_steps:
            flat = {}
            for name, vb in val_batchers.items():
                flat.update({f"val_{name}/{t}/{k}": v
                             for t, stats in trainer.validate(vb).items()
                             for k, v in stats.items()})
            logger.log(step + 1, flat)
            ckpt = os.path.join(args.output_dir, f"model_step_{step + 1}.pt")
            trainer.save(ckpt)
    logger.close()
    return ckpt


if __name__ == "__main__":
    main()
