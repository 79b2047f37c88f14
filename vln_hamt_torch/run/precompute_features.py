"""Panorama feature precomputation CLI (torch), the port of
``vln_hamt_tpu/run/precompute_features.py``.

    python -m vln_hamt_torch.run.precompute_features --synthetic 64 --output_file F.hdf5
    python -m vln_hamt_torch.run.precompute_features --connectivity_dir DIR --pano_dir PANOS \\
        --output_file F.hdf5 [--vit_ckpt VIT.pth] [--no-bf16] [--device_bench 20]

Parity target: ``preprocess/precompute_img_features_vit.py``: for every
(scan, viewpoint), a (36, 768 + 1000) ViT-B/16 feature matrix in gzip
HDF5 keyed ``{scan}_{viewpoint}``:

- view synthesis: the native equirect sampler (``native/navsim.py:
  sample_panorama``) on host threads, fed from a directory of
  equirectangular panoramas (``{scan}_{viewpoint}.npy|jpg|png``; JPEG and
  PNG need PIL);
- the reference geometry end to end: 36 views rendered at 640 x 480 with
  a 60 degree vertical field of view, then the timm eval transform
  (bicubic resize of the shorter side to 248, center crop 224, mean =
  std = 0.5 on the card; ``vision/transforms.py``);
- inference: ViT-B/16 on the card (bf16 by default, as the JAX CLI;
  ``--no-bf16`` for fp32) over ``--panos_per_batch`` panoramas per call,
  the attention through the CUDA kernel, with the pipelined featurizer.

``--synthetic N`` featurizes N synthetic viewpoints instead (random
renders). ``--device_bench N`` first times N calls on one batch resident
on the card: the images/s the ViT sustains when the host keeps up.
``h5py`` is imported for the output file only.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch


def load_viewpoint_ids(connectivity_dir: str):
    """scans.txt + connectivity enumeration (preprocess/utils.py:5-14)."""
    with open(os.path.join(connectivity_dir, "scans.txt")) as f:
        scans = [x.strip() for x in f if x.strip()]
    out = []
    for scan in scans:
        with open(os.path.join(connectivity_dir, f"{scan}_connectivity.json")) as f:
            out += [(scan, item["image_id"]) for item in json.load(f) if item["included"]]
    return out


def _load_equirect(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


def find_panorama(pano_dir: str, scan: str, vp: str) -> str:
    for ext in (".npy", ".jpg", ".png"):
        path = os.path.join(pano_dir, f"{scan}_{vp}{ext}")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no panorama for {scan}_{vp} in {pano_dir}")


def equirect_view_source(pano_dir: str, viewpoint_ids, width: int, height: int, vfov: float,
                         workers: int = 4, transform=None
                         ) -> Iterator[Tuple[str, str, np.ndarray]]:
    """Sample 36 views per viewpoint with the native sampler on a thread
    pool, so view synthesis (and the host transform) overlaps the card's
    work."""
    from ..native import sample_panorama

    def job(sv):
        scan, vp = sv
        views = sample_panorama(_load_equirect(find_panorama(pano_dir, scan, vp)), vfov,
                                width, height)
        return scan, vp, (views if transform is None else transform(views))

    with ThreadPoolExecutor(workers) as pool:
        yield from pool.map(job, viewpoint_ids)


def synthetic_view_source(n: int, width: int, height: int, transform=None):
    rng = np.random.default_rng(0)
    for i in range(n):
        views = rng.integers(0, 255, (36, height, width, 3), dtype=np.uint8)
        yield ("synthscan", f"vp{i:05d}", views if transform is None else transform(views))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="36-view ViT feature extraction (PyTorch/CUDA)")
    p.add_argument("--output_file", required=True)
    p.add_argument("--connectivity_dir", default=None)
    p.add_argument("--pano_dir", default=None,
                   help="dir of equirect panoramas {scan}_{vp}.{npy,jpg,png}")
    p.add_argument("--synthetic", type=int, default=0,
                   help="featurize N synthetic viewpoints instead")
    p.add_argument("--image_size", type=int, nargs=2, default=(224, 224),
                   help="ViT input size (after the transform)")
    p.add_argument("--render_size", type=int, nargs=2, default=(480, 640),
                   help="(H, W) the 36 views are rendered at before the transform (the "
                        "reference renders 640x480, precompute_img_features_vit.py:37-38)")
    p.add_argument("--transform", default="timm", choices=["timm", "none"],
                   help="'timm': bicubic resize shorter->floor(224/0.9), center-crop 224, "
                        "mean/std 0.5 (the reference's pipeline); 'none': render at "
                        "--image_size and normalize with ImageNet statistics")
    p.add_argument("--crop_pct", type=float, default=0.9)
    p.add_argument("--vfov_deg", type=float, default=60.0)
    p.add_argument("--panos_per_batch", type=int, default=4)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="bfloat16 compute (the default; --no-bf16 for fp32)")
    p.add_argument("--vit_ckpt", default=None,
                   help="pretrained ViT-B/16 checkpoint (timm .pth/.pt or .npz state dict)")
    p.add_argument("--device_bench", type=int, default=0,
                   help="time N calls on one batch resident on the card first")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain attention, no kernel)")
    return p.parse_args(argv)


def build(args):
    """The featurizer of parsed ``args`` on its device, its view source and
    the ViT's input (H, W)."""
    from ..agents.agent import resolve_device
    from ..models.convert import load_vit_checkpoint
    from ..vision import PanoramaFeaturizer, eval_transform, vit_base_patch16
    from ..vision.featurizer import IMAGENET_MEAN, IMAGENET_STD

    device = resolve_device("cpu" if args.cpu else None)
    h, w = args.image_size
    vit = vit_base_patch16(img_size=(h, w), dtype="bfloat16" if args.bf16 else "float32")
    if args.vit_ckpt:
        sd = load_vit_checkpoint(args.vit_ckpt, vit.config)
        vit.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    if args.transform == "timm":
        if h != w:
            raise ValueError("--transform timm produces square crops")
        transform = lambda views: eval_transform(views, h, args.crop_pct)  # noqa: E731
        (rh, rw), norm = args.render_size, {}  # the reference's mean = std = 0.5
    else:
        transform, (rh, rw) = None, (h, w)
        norm = dict(mean=IMAGENET_MEAN, std=IMAGENET_STD)
    feat = PanoramaFeaturizer(vit, panos_per_batch=args.panos_per_batch, device=device, **norm)

    if args.synthetic:
        source = synthetic_view_source(args.synthetic, rw, rh, transform)
    else:
        if not (args.connectivity_dir and args.pano_dir):
            raise ValueError("pass --connectivity_dir and --pano_dir, or --synthetic N")
        source = equirect_view_source(args.pano_dir, load_viewpoint_ids(args.connectivity_dir),
                                      rw, rh, np.deg2rad(args.vfov_deg), transform=transform)
    return feat, source, (h, w)


def main(argv=None):
    from ..vision.featurizer import hdf5_writer

    args = parse_args(argv)
    feat, source, (h, w) = build(args)

    # warm-up outside the clock: cuBLAS handles, the kernel build, the allocator
    warm = np.zeros((36 * args.panos_per_batch, h, w, 3), np.uint8)
    feat.featurize_images(warm)[0].cpu()
    result = {}
    if args.device_bench:
        # images already on the card: the ViT's own pace, what a host that
        # keeps up with it would see
        dev_images = feat.to_device(np.random.default_rng(0).integers(
            0, 255, warm.shape, dtype=np.uint8))
        feat.featurize_device(dev_images)[0].cpu()
        t0 = time.perf_counter()
        for _ in range(args.device_bench):
            out = feat.featurize_device(dev_images)
        out[0].cpu()  # waits for the last call
        ips = args.device_bench * warm.shape[0] / (time.perf_counter() - t0)
        result.update(device_bench_iters=args.device_bench,
                      images_per_sec_compute_bound=ips,
                      viewpoints_per_sec_compute_bound=ips / 36)
        print(json.dumps(result))

    writer = hdf5_writer(args.output_file)
    t0 = time.perf_counter()
    try:
        out = feat.extract(source, writer=writer)
    finally:
        writer.close()
    dt = time.perf_counter() - t0
    result.update(viewpoints=len(out), seconds=dt, viewpoints_per_sec=len(out) / dt,
                  views_per_sec=36 * len(out) / dt)
    print(json.dumps({k: result[k] for k in ("viewpoints", "seconds", "viewpoints_per_sec",
                                             "views_per_sec")}))
    return result


if __name__ == "__main__":
    main()
