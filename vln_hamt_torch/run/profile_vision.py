"""Where the time of the vision pipeline goes on the card.

    python -m vln_hamt_torch.run.profile_vision [--panos 24] [--updates 3] [--bf16]
        [--out DIR]

Two paths at full width, both as their CLIs build them, with seeded
random weights:

- feature extraction (``run/precompute_features.py``): ViT-B/16 at 224
  behind ``PanoramaFeaturizer`` (4 panoramas per call), over panoramas
  rendered by the native sampler (640 x 480, 60 degree vertical field of
  view) from seeded equirects and put through the timm eval transform
  beforehand: images/s through ``extract`` (the feeder thread, pinned
  copies on the side stream, readback ``pipeline_depth`` calls later)
  and with the batch resident on the card (``--device_bench``'s number),
  the kernel time of one call by group and the idle share against the
  resident call's wall, peak memory;
- end-to-end image pretraining (``run/image_pretrain.py --synthetic``:
  the ``r2r`` trunk with ViT-B/16 in the loop, batch 1, 80 tokens, 25
  history steps, rangerlars with ``--grad_accum 8``): per task the host's
  batch building (the store and RandomResizedCrop + flip of 936 images)
  and ``--updates`` unprofiled updates on batches built beforehand, then
  one traced: examples/s of the update alone and with the batch building
  in series, the kernel time by group, the idle share against the
  unprofiled update's wall, peak memory.

``--bf16`` computes in bfloat16 (the featurizer CLI's default). Prints
one JSON line per path and task; writes the per-kernel tables to
``DIR``. ``chip_smoke.py`` phase 18 imports the set-up and timing
helpers.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..agents.agent import resolve_device
from ..native import sample_panorama
from ..pretrain.trainer import PretrainTrainer
from ..vision import PanoramaFeaturizer, eval_transform, vit_base_patch16
from ..vision.transforms import RENDER_HEIGHT, RENDER_VFOV_DEG, RENDER_WIDTH
from . import image_pretrain
from .profile_attention import image_pretrain_launch_mix
from .profile_eval import kernel_table

PANOS_PER_BATCH = 4  # the featurizer CLI's default
NUM_VIEWS = 36


def render_panoramas(n: int, seed: int = 0) -> List[np.ndarray]:
    """``n`` panoramas as the featurizer CLI feeds them: 36 views per
    seeded equirect (1024 x 2048, 16 x 16 blocks of random colour),
    rendered by the native sampler at 640 x 480 with a 60 degree vertical
    field of view, then the timm eval transform: (36, 224, 224, 3) uint8."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        eq = np.repeat(np.repeat(rng.integers(0, 256, (64, 128, 3), dtype=np.uint8), 16, 0),
                       16, 1)
        views = sample_panorama(eq, np.deg2rad(RENDER_VFOV_DEG), RENDER_WIDTH, RENDER_HEIGHT)
        out.append(eval_transform(views))
    return out


def slice_featurizer(dtype: str = "float32", seed: int = 0, device=None) -> PanoramaFeaturizer:
    """The featurizer CLI's ViT-B/16 (224, 1000 classes) at its batch of 4
    panoramas, weights from ``seed``."""
    return PanoramaFeaturizer(vit_base_patch16(dtype=dtype, seed=seed),
                              panos_per_batch=PANOS_PER_BATCH, device=resolve_device(device))


def pipelined_images_per_s(feat: PanoramaFeaturizer, panos: List[np.ndarray], count: int
                           ) -> Tuple[float, Dict[str, np.ndarray]]:
    """Images/s of ``extract`` over ``count`` viewpoints cycling through
    ``panos`` (the host transform already done), and its output."""
    source = (("synth", f"vp{i:05d}", panos[i % len(panos)]) for i in range(count))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = feat.extract(source)
    return NUM_VIEWS * count / (time.perf_counter() - t0), out


def resident_call_ms(feat: PanoramaFeaturizer, images: torch.Tensor, iters: int) -> float:
    """Wall ms per featurize call on a batch already on the card, the host
    waiting only after the last (``--device_bench``)."""
    feat.featurize_device(images)[0].cpu()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = feat.featurize_device(images)
    out[0].cpu()
    return (time.perf_counter() - t0) / iters * 1e3


def traced(fn: Callable[[], object], launches: Optional[Dict[str, int]] = None
           ) -> Tuple[List[Tuple[str, float, int]], Dict[str, dict], bool]:
    """One call of ``fn`` under torch.profiler: its device kernels, their
    groups (``profile_eval.kernel_table``) and whether the trace is whole.
    With ``launches`` (the attention kernels the call makes, by kernel
    name) a trace that holds other counts of them has lost events, as
    traces late in a long process (``chip_smoke.py``'s) were seen to, and
    its kernel time and idle share are not to be read."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, groups = kernel_table(prof)
    whole = launches is None or all(
        groups.get(f"{name}_kernel", {"launches": 0})["launches"] == n
        for name, n in launches.items())
    return kernels, groups, whole


def e2e_args(extra=()) -> argparse.Namespace:
    """``run/image_pretrain.py --synthetic``'s arguments at its defaults."""
    return image_pretrain.parse_args(["--synthetic", *extra])


def slice_e2e_trainer(extra=(), device=None) -> Tuple[PretrainTrainer, Dict[str, object]]:
    """The CLI's trainer and validation batchers (seed 0 unless ``extra``
    says otherwise)."""
    return image_pretrain.build(e2e_args(extra), resolve_device(device))


def e2e_batcher(extra=()):
    """The CLI's train batcher alone for ``extra`` arguments (another
    history length, say), with its parsed arguments."""
    args = e2e_args(extra)
    mcfg, _ = image_pretrain.model_configs(args)
    return image_pretrain.build_batchers(args, mcfg)[0], args


def e2e_mixes(trainer: PretrainTrainer, args: argparse.Namespace) -> Dict[str, tuple]:
    """Per task its attention launches per update by (lanes, Lq, Lk),
    forward and backward (``image_pretrain_launch_mix``)."""
    return {task: image_pretrain_launch_mix(trainer.cfg, trainer.model.vit_config, task,
                                            args.batch_size, args.max_txt_len,
                                            args.max_hist_len)
            for task in trainer.scheduler.tasks}


def timed_build_and_updates(trainer: PretrainTrainer, task: str, n: int, batch_size: int = 1
                            ) -> Dict[str, float]:
    """Host ms to build one batch of ``task`` (the mean over ``n``), then
    wall ms per unsynchronized update over those ``n`` batches (the last
    waited for)."""
    t0 = time.perf_counter()
    batches = [trainer.batcher.batch(task, batch_size) for _ in range(n)]
    build_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        loss, _ = trainer.update(task, batch)
    float(loss)
    return {"build_ms": build_ms, "update_ms": (time.perf_counter() - t0) / n * 1e3}


def _write_table(path: str, kernels) -> None:
    with open(path, "w") as f:
        f.write(f"{'device ms':>10} {'launches':>9}  kernel\n")
        for name, ms, n in kernels:
            f.write(f"{ms:10.3f} {n:9d}  {name}\n")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--panos", type=int, default=24, help="viewpoints through extract")
    p.add_argument("--updates", type=int, default=3, help="timed updates per task")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--out", default="runs/profile_vision")
    args = p.parse_args(argv)
    dtype = "bfloat16" if args.bf16 else "float32"
    os.makedirs(args.out, exist_ok=True)
    device = torch.cuda.get_device_name(resolve_device())  # the card; raises without one

    feat = slice_featurizer(dtype)
    panos = render_panoramas(PANOS_PER_BATCH)
    resident = feat.to_device(np.concatenate(panos))
    # warm-up outside the clock: the kernel build, cuBLAS handles, the allocator
    feat.featurize_device(resident)[0].cpu()
    torch.cuda.reset_peak_memory_stats()
    pipelined, _ = pipelined_images_per_s(feat, panos, args.panos)
    call_ms = resident_call_ms(feat, resident, 10)
    kernels, groups, whole = traced(lambda: feat.featurize_device(resident)[0].cpu(),
                                    {"attention_fwd": feat.vit.config.num_layers})
    _write_table(os.path.join(args.out, f"featurizer_{dtype}.txt"), kernels)
    kernel_ms = sum(ms for _, ms, _ in kernels)
    print(json.dumps({"device": device, "path": "featurizer", "dtype": dtype,
                      "panos_per_call": PANOS_PER_BATCH, "viewpoints": args.panos,
                      "images_per_s_pipelined": pipelined,
                      "images_per_s_resident": NUM_VIEWS * PANOS_PER_BATCH / call_ms * 1e3,
                      "call_ms_resident": call_ms, "kernel_ms_per_call": kernel_ms,
                      "idle_share_resident": 1.0 - kernel_ms / call_ms, "groups": groups,
                      "trace_whole": whole, "kernel_launches": sum(n for *_, n in kernels),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    del feat, resident
    torch.cuda.empty_cache()

    trainer, _ = slice_e2e_trainer(("--bf16",) if args.bf16 else ())
    mixes = e2e_mixes(trainer, e2e_args())
    for task in trainer.scheduler.tasks:  # warm-up: allocator, cuBLAS handles
        trainer.update(task, trainer.batcher.batch(task, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for task in trainer.scheduler.tasks:
        t = timed_build_and_updates(trainer, task, args.updates)
        batch = trainer.batcher.batch(task, 1)
        kernels, groups, whole = traced(
            lambda: float(trainer.update(task, batch)[0]),
            {name: sum(m.values()) for name, m in zip(("attention_fwd", "attention_bwd"),
                                                      mixes[task])})
        _write_table(os.path.join(args.out, f"e2e_{task}_{dtype}.txt"), kernels)
        kernel_ms = sum(ms for _, ms, _ in kernels)
        print(json.dumps({
            "device": device, "path": "e2e", "dtype": dtype, "task": task, "batch": 1,
            "updates": args.updates, **t,
            "examples_per_s_update": 1e3 / t["update_ms"],
            "examples_per_s_in_series": 1e3 / (t["update_ms"] + t["build_ms"]),
            "kernel_ms": kernel_ms, "idle_share_unprofiled": 1.0 - kernel_ms / t["update_ms"],
            "groups": groups, "trace_whole": whole, "kernel_launches": sum(n for *_, n in kernels),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    trainer.close()


if __name__ == "__main__":
    main()
