"""Panorama feature extraction pipeline, the port of
``vln_hamt_tpu/vision/featurizer.py``.

Parity target: ``preprocess/precompute_img_features_vit.py``: for each
viewpoint, 36 perspective views go through ViT-B/16 and give a
(36, 768 + 1000) feature matrix stored in HDF5 keyed
``{scan}_{viewpoint}``.

The pipeline, as the JAX package's: a feeder thread pulls panoramas from
the source (image I/O, view synthesis and the host transform overlap
everything else); ``panos_per_batch`` panoramas go to the card per call
as uint8 (a quarter of float32's bytes), copied from pinned memory on a
side stream so the copy of batch k+1 overlaps the ViT of batch k; the
normalization runs on the card; and ``pipeline_depth`` batches are in
flight before the host reads the oldest result back. Every attention of
the ViT runs through the CUDA kernel: 12 forward launches per call at
ViT-B/16.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..agents.agent import resolve_device
from .transforms import VIT_MEAN, VIT_STD, normalize_images
from .vit import ViT

# for callers that featurize with ImageNet-normalized backbones; the
# default is the reference ViT config's mean = std = 0.5
# (vision_transformer.py:58 via resolve_data_config,
# precompute_img_features_vit.py:51)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NUM_VIEWS = 36


class PanoramaFeaturizer:
    """The ViT in eval mode on ``device`` (the card unless told
    otherwise) behind the extraction pipeline."""

    def __init__(self, vit: ViT, panos_per_batch: int = 2, pipeline_depth: int = 3,
                 mean: Tuple[float, float, float] = VIT_MEAN,
                 std: Tuple[float, float, float] = VIT_STD, device=None):
        self.device = resolve_device(device)
        self.vit = vit.to(self.device).eval()
        self.panos_per_batch = panos_per_batch
        self.pipeline_depth = pipeline_depth
        self.mean, self.std = mean, std
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)

    # ------------------------------------------------------------------
    def to_device(self, images_u8: np.ndarray) -> torch.Tensor:
        """(N, H, W, 3) uint8 host images as a uint8 tensor on the device;
        on the card copied from pinned memory on the side stream, which
        the compute stream then waits for (the host does not)."""
        host = torch.from_numpy(np.ascontiguousarray(images_u8, dtype=np.uint8))
        if self._copy_stream is None:
            return host.to(self.device)
        host = host.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
        compute = torch.cuda.current_stream(self.device)
        compute.wait_stream(self._copy_stream)
        dev.record_stream(compute)
        return dev

    @torch.no_grad()
    def featurize_device(self, images_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, H, W, 3) uint8 device tensor -> ((N, D) features, (N, C)
        logits), fp32 device tensors; the host does not wait."""
        x = normalize_images(images_u8, self.mean, self.std)
        return self.vit(x)

    def featurize_images(self, images_u8: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, H, W, 3) uint8 host images -> ((N, D), (N, C)) on the device."""
        return self.featurize_device(self.to_device(images_u8))

    def extract(self, viewpoints: Iterable[Tuple[str, str, np.ndarray]],
                writer: Optional[Callable[[str, str, np.ndarray], None]] = None
                ) -> Dict[str, np.ndarray]:
        """Run the pipeline over (scan, viewpoint, images36) tuples, images36
        (36, H, W, 3) uint8; returns ``{scan}_{viewpoint}`` -> (36, D + C)
        float32 and hands each matrix to ``writer`` as it arrives. An
        error of the source is raised here."""
        out: Dict[str, np.ndarray] = {}
        pending = []  # [(keys, feats on the device, logits on the device)]
        q: queue.Queue = queue.Queue(maxsize=2 * self.panos_per_batch)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def feed():
            try:
                for item in viewpoints:
                    if not put(item):
                        return
            except Exception as e:  # handed to the consumer, raised there
                put((end, e))
                return
            put((end, None))

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()

        def drain(block_all: bool = False):
            while pending and (block_all or len(pending) >= self.pipeline_depth):
                keys, feats_dev, logits_dev = pending.pop(0)
                feats = feats_dev.cpu().numpy()  # waits for this batch only
                logits = logits_dev.cpu().numpy()
                for j, (scan, vp) in enumerate(keys):
                    rows = slice(j * NUM_VIEWS, (j + 1) * NUM_VIEWS)
                    mat = np.concatenate([feats[rows], logits[rows]], axis=1).astype(np.float32)
                    out[f"{scan}_{vp}"] = mat
                    if writer is not None:
                        writer(scan, vp, mat)

        def submit(keys, imgs):
            feats, logits = self.featurize_images(np.concatenate(imgs, axis=0))
            pending.append((keys, feats, logits))

        try:
            batch_keys, batch_imgs = [], []
            while True:
                item = q.get()
                if isinstance(item, tuple) and len(item) == 2 and item[0] is end:
                    if item[1] is not None:
                        raise item[1]
                    break
                scan, vp, images = item
                if images.shape[0] != NUM_VIEWS:
                    raise ValueError(f"{scan}_{vp}: {images.shape[0]} views, expected 36")
                batch_keys.append((scan, vp))
                batch_imgs.append(images)
                if len(batch_keys) == self.panos_per_batch:
                    submit(batch_keys, batch_imgs)
                    batch_keys, batch_imgs = [], []
                    drain()
            if batch_keys:
                submit(batch_keys, batch_imgs)
            drain(block_all=True)
        finally:
            stop.set()
            feeder.join(timeout=10.0)
        return out


def hdf5_writer(path: str):
    """Writer callback storing (36, D+C) matrices keyed scan_vp
    (precompute_img_features_vit.py:141-162 output format); ``h5py`` is
    imported here, at the call."""
    import h5py

    f = h5py.File(path, "w")

    def write(scan: str, vp: str, mat: np.ndarray) -> None:
        ds = f.create_dataset(f"{scan}_{vp}", data=mat, compression="gzip")
        ds.attrs["scanId"] = scan
        ds.attrs["viewpointId"] = vp

    write.close = f.close  # type: ignore[attr-defined]
    return write
