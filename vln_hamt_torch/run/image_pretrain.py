"""End-to-end image pretraining entry point, ViT in the loop (torch): the
port of ``vln_hamt_tpu/run/image_pretrain.py``.

    python -m vln_hamt_torch.run.image_pretrain --synthetic [--num_steps N --valid_steps K]
    python -m vln_hamt_torch.run.image_pretrain --tiny --synthetic --cpu --num_steps 4 \\
        --valid_steps 2 --output_dir /tmp/e2e
    python -m vln_hamt_torch.run.image_pretrain --train_traj_files train.jsonl \\
        --val_traj_files val.jsonl --img_ft_file FEATS.hdf5 --connectivity_dir DIR \\
        (--lmdb_path PANOS.lmdb | --npy_dir PANOS/) [--vit_ckpt VIT.pth]

Parity target: ``pretrain_src/main_r2r_image.py:91-262`` (the variant
where panorama features are replaced by a trainable ViT over raw
panorama pixels) at the JAX CLI's defaults: the ``r2r`` trunk
(``HAMTPretrain``, hidden 768) with ViT-B/16 at 224 in the loop, batch
1 with ``--grad_accum 8``, 80 text tokens, 25 history steps, the six
tasks in the 5:1:1:1:2:2 mix, ``rangerlars`` lr 1e-4 warmup-linear
(``config/pretrain_r2r_e2e.json:14-24``). The store's records are 248 x
330 (``pretrain/image_data.py``); the train stream goes through
RandomResizedCrop and a flip to 224, the validation streams through the
eval resize and center crop. Runs on the GPU unless ``--cpu``.

The trunk's config is ``run/pretrain.py:pretrain_model_config``'s: every
stack trained, the fine-tuning preset's ``fix_lang_embedding`` and
``fix_hist_embedding`` cleared, where the JAX CLI takes the preset as it
is (the deviation of ``run/pretrain.py``). ``--tiny`` is the JAX CLI's
small model for the CPU: its ViT (hidden 48, 4 heads: Dh 12) is a width
the CUDA kernels do not take, and on the card it raises.

Every ``valid_steps // 10`` steps the task's loss, metrics and
examples/s go to ``metrics.jsonl``; every ``valid_steps`` (and at the
end) every validation stream runs per task over its whole split and
``model_step_N.pt`` is written (the trunk's pretraining state dict plus
``vit.*`` and ``step``), which ``--init_ckpt`` and ``--resume`` take.
``--device_bench N`` times N updates per task on one batch resident on
the card and exits. The JAX CLI's flags that the port does not run
raise, naming their ROADMAP item. ``--data_shards``, ``--model_shards``
and ``--sharded_feed`` run as ``run/pretrain.py``'s (the ViT stays
replicated; the sharded feed seeds each rank's stream and transform
1000 apart).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict

import torch

from ..pretrain import PretrainTrainer
from ..pretrain.image_data import (DEFAULT_IMAGE_SIZE, ImagePretrainBatcher,
                                   LMDBPanoImageStore, NpyDirPanoImageStore,
                                   SyntheticPanoImageStore)
from ..pretrain.image_model import init_image_pretrain
from ..pretrain.model import batch_to_device
from ..utils.misc import apply_rng_impl
from ..vision.transforms import ImageTransform
from ..vision.vit import ViTConfig
from .pretrain import (DEFAULT_MIX, DEFAULT_TASKS, build_real, build_synthetic,
                       pretrain_model_config, rank_setup, train_loop)

#: flags of the JAX CLI that the port does not run yet, with their
#: ROADMAP item (none left)
_UNPORTED_FLAGS: Dict[str, str] = {}


def parse_args(argv=None):
    """The JAX CLI's flags, every one of them, plus ``--cpu``; those in
    ``_UNPORTED_FLAGS`` raise in :func:`main`."""
    p = argparse.ArgumentParser(description="HAMT end-to-end image pretraining (PyTorch/CUDA)")
    p.add_argument("--output_dir", default="runs/image_pretrain_torch")
    p.add_argument("--num_steps", type=int, default=200_000)
    p.add_argument("--warmup_steps", type=int, default=10_000)
    p.add_argument("--valid_steps", type=int, default=5_000)
    # the reference e2e config trains at batch 1 with gradient accumulation
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--grad_accum", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--optim", default="rangerlars",
                   choices=["adamw", "adam", "radam", "ralamb", "lookahead", "rangerlars"],
                   help="e2e default rangerlars (pretrain_r2r_e2e.json:14)")
    p.add_argument("--max_txt_len", type=int, default=80)
    p.add_argument("--max_hist_len", type=int, default=25)
    p.add_argument("--tasks", nargs="+", default=list(DEFAULT_TASKS))
    p.add_argument("--mix_ratio", nargs="+", type=float, default=list(DEFAULT_MIX))
    p.add_argument("--image_size", type=int, nargs=2, default=list(DEFAULT_IMAGE_SIZE),
                   help="the store's record size (the reference LMDB is 248x330); the ViT "
                        "sees --vit_image_size through the transform")
    p.add_argument("--vit_image_size", type=int, default=224,
                   help="the ViT's input resolution, the transform's output")
    p.add_argument("--transform", default="timm", choices=["timm", "none"],
                   help="'timm': the reference pipeline between store and ViT (train "
                        "stream RandomResizedCrop + flip, validation bicubic resize + "
                        "center crop at crop_pct 0.9, mean/std 0.5); 'none': the store's "
                        "pixels straight into the ViT")
    p.add_argument("--hflip", type=float, default=0.5,
                   help="train-stream horizontal-flip probability")
    p.add_argument("--re_prob", type=float, default=0.0,
                   help="train-stream random-erasing probability (image_data.py:39)")
    p.add_argument("--re_mode", default="const", choices=["const", "rand"])
    p.add_argument("--auto_augment", default=None,
                   help="not implemented (reference default None); a value raises")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="small model and 32x32 images (CPU smoke runs)")
    p.add_argument("--lmdb_path", default=None,
                   help="reference-format panorama LMDB (needs the lmdb package)")
    p.add_argument("--npy_dir", default=None, help="{scan}_{vp}.npy panorama directory")
    p.add_argument("--aug_traj_files", nargs="+", default=None,
                   help="augmented trajectory stream, drawn with the GT stream at 0.5")
    p.add_argument("--train_traj_files", nargs="+", default=None)
    p.add_argument("--val_traj_files", nargs="+", default=None,
                   help="plain paths (one stream 'val') or name=path pairs")
    p.add_argument("--img_ft_file", default=None,
                   help="feature HDF5 for MRC's soft labels (ViT class probabilities)")
    p.add_argument("--connectivity_dir", default=None)
    p.add_argument("--vit_ckpt", default=None,
                   help="pretrained ViT-B/16 (timm .pth/.pt or .npz state dict)")
    p.add_argument("--init_ckpt", default=None,
                   help="a checkpoint of this CLI (model_step_N.pt) to start from; the "
                        "step restarts")
    p.add_argument("--resume", default=None,
                   help="a checkpoint of this CLI to resume from (weights and step)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute in the trunk and the ViT (parameters, optimizer "
                        "and losses fp32)")
    p.add_argument("--data_shards", type=int, default=None)
    p.add_argument("--sharded_feed", action="store_true")
    p.add_argument("--model_shards", type=int, default=None)
    p.add_argument("--rng_impl", default=None, choices=["threefry2x32", "rbg"],
                   help="the JAX package's dropout PRNG name, validated and recorded; the "
                        "port draws from the same streams under either (utils/misc.py)")
    p.add_argument("--device_bench", type=int, default=0,
                   help="time N updates per task on one batch resident on the card "
                        "(examples/s without the host's batch building), then exit")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain attention, no kernel)")
    return p.parse_args(argv)


def model_configs(args):
    """The trunk's and the ViT's configs of parsed ``args`` (``--tiny``
    also switches the transform off and the store to 32 x 32, as the JAX
    CLI does)."""
    mcfg = pretrain_model_config("r2r", args.tiny, args.max_txt_len, args.bf16)
    vit_kwargs = dict(img_size=((args.vit_image_size,) * 2 if args.transform == "timm"
                                else tuple(args.image_size)),
                      dtype="bfloat16" if args.bf16 else "float32")
    if args.tiny:
        mcfg = dataclasses.replace(mcfg, image_feat_size=48)
        args.transform, args.image_size = "none", (32, 32)
        vit_kwargs.update(img_size=(32, 32), patch_size=16, hidden_size=48, num_layers=2,
                          num_heads=4, num_classes=16)
    else:
        # the ViT's features are the trunk's image features; MRC classifies
        # over the ViT's classes
        vit_kwargs.update(hidden_size=mcfg.image_feat_size, num_classes=mcfg.image_prob_size)
    return mcfg, ViTConfig(**vit_kwargs)


def build_batchers(args, mcfg, rank_off: int = 0):
    """The train batcher, the validation batchers by stream and the aug
    stream's batcher (or None) of parsed ``args`` (after
    :func:`model_configs`); ``rank_off``, the sharded feed's data
    index, offsets the train stream's and its transform's seeds by 1000
    each."""
    if args.synthetic:
        train_ds, val_dss = build_synthetic(args, mcfg)
        store = SyntheticPanoImageStore(tuple(args.image_size))
    else:
        train_ds, val_dss = build_real(args, mcfg)
        store = (LMDBPanoImageStore(args.lmdb_path, tuple(args.image_size)) if args.lmdb_path
                 else NpyDirPanoImageStore(args.npy_dir, tuple(args.image_size)))
    train_tf = val_tf = None
    if args.transform == "timm":
        # the train stream is timm's is_training pipeline, validation the
        # deterministic resize + crop (image_data.py:70-80,
        # main_r2r_image.py:149,162)
        train_tf = ImageTransform(out_size=args.vit_image_size, train=True, hflip=args.hflip,
                                  re_prob=args.re_prob, re_mode=args.re_mode,
                                  auto_augment=args.auto_augment,
                                  seed=args.seed + 7000 + 1000 * rank_off)
        val_tf = ImageTransform(out_size=args.vit_image_size, train=False)
    batcher = ImagePretrainBatcher(train_ds, store, transform=train_tf,
                                   seed=args.seed + 1000 * rank_off)
    val_batchers = {name: ImagePretrainBatcher(ds, store, transform=val_tf, seed=args.seed + 1)
                    for name, ds in val_dss.items()}
    aug_batcher = None
    if args.aug_traj_files:
        from ..pretrain.trajectory_data import TrajectoryDataset, load_trajectory_jsonl

        aug_ds = TrajectoryDataset(
            load_trajectory_jsonl(args.aug_traj_files), train_ds.graphs, train_ds.feat_db,
            image_feat_size=mcfg.image_feat_size, image_prob_size=mcfg.image_prob_size,
            max_txt_len=args.max_txt_len, max_hist_len=args.max_hist_len)
        aug_batcher = ImagePretrainBatcher(aug_ds, store, transform=train_tf,
                                           seed=args.seed + 2)
    return batcher, val_batchers, aug_batcher


def build(args, device, mesh=None):
    """The trainer and the validation batchers of parsed ``args``, as this
    rank of ``mesh`` when given (``run/pretrain.py:build``'s ranks; the
    ViT stays replicated)."""
    mcfg, vit_cfg = model_configs(args)
    sharded = mesh is not None and args.sharded_feed
    batcher, val_batchers, aug_batcher = build_batchers(
        args, mcfg, mesh.data_index if sharded else 0)
    model = init_image_pretrain(mcfg, vit_cfg, args.seed)
    if args.vit_ckpt:
        from ..models.convert import load_vit_checkpoint

        sd = load_vit_checkpoint(args.vit_ckpt, model.vit_config)
        model.vit.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    trainer = PretrainTrainer(
        mcfg, batcher, tasks=args.tasks, mix_ratio=args.mix_ratio, batch_size=args.batch_size,
        lr=args.lr, warmup_steps=args.warmup_steps, total_steps=args.num_steps,
        grad_accum=args.grad_accum, seed=args.seed, optim=args.optim, device=device,
        model=model, aug_batcher=aug_batcher)
    if mesh is not None:
        trainer.enable_mesh(mesh, sharded_feed=sharded)
    return trainer, val_batchers


def device_bench(trainer: PretrainTrainer, args) -> dict:
    """Examples/s of ``args.device_bench`` updates per task on one batch
    already on the card (one warm-up update first): the ViT over raw
    pixels, the trunk, the heads and the optimizer, without the host's
    batch building and copies."""
    out = {}
    for task in args.tasks:
        if task == "itm" and args.batch_size < 2:
            continue
        batch = batch_to_device(trainer.batcher.batch(task, args.batch_size), trainer.device)
        float(trainer.update_device(task, batch)[0])  # warm-up, waited for
        t0 = time.perf_counter()
        for _ in range(args.device_bench):
            loss, _ = trainer.update_device(task, batch)
        float(loss)  # waits for the last update
        out[task] = args.device_bench * args.batch_size / (time.perf_counter() - t0)
    return {"device_bench_iters": args.device_bench, "batch_size": args.batch_size,
            "ex_per_sec_compute_bound": out}


def main(argv=None):
    args = parse_args(argv)
    for flag, item in _UNPORTED_FLAGS.items():
        if getattr(args, flag) not in (None, False):
            raise NotImplementedError(f"--{flag} is ROADMAP item {item}")
    args.rng_impl = apply_rng_impl(args.rng_impl or "threefry2x32")  # utils/misc.py
    if not args.synthetic and not (args.train_traj_files and args.img_ft_file
                                   and args.connectivity_dir and (args.lmdb_path or args.npy_dir)):
        raise ValueError("file-backed runs need --train_traj_files --img_ft_file "
                         "--connectivity_dir and --lmdb_path or --npy_dir (or pass --synthetic)")
    device, mesh = rank_setup(args)
    trainer, val_batchers = build(args, device, mesh)
    if args.init_ckpt:
        blob = torch.load(args.init_ckpt, map_location="cpu", weights_only=True)
        blob.pop("step", None)
        trainer.set_params(blob)
    start = trainer.resume(args.resume) if args.resume else 0
    if args.device_bench:
        result = device_bench(trainer, args)
        trainer.close()
        print(json.dumps(result))
        return result
    ckpt = train_loop(trainer, val_batchers, args, start)
    trainer.close()
    print(json.dumps({"final_step": trainer.step}))
    return {"final_step": trainer.step, "checkpoint": ckpt}


if __name__ == "__main__":
    main()
