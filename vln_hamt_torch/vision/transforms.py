"""Reference-faithful image transforms for the ViT pipelines, the port of
``vln_hamt_tpu/vision/transforms.py``.

Parity target: the timm transform the reference applies between raw
rendered panoramas and the ViT, in both places it appears:

- feature extraction (``preprocess/precompute_img_features_vit.py:
  42-54``): input 224, bicubic, ``crop_pct 0.9``, mean = std =
  (0.5, 0.5, 0.5) (``pretrain_src/model/vision_transformer.py:42,58``):
  ``Resize(floor(224/0.9)=248, bicubic)`` -> ``CenterCrop(224)`` ->
  ``ToTensor`` -> ``Normalize``;
- end-to-end image pretraining (``pretrain_src/data/image_data.py:
  70-80``): the same config, the train stream through timm's training
  pipeline (RandomResizedCrop(224, bicubic) + RandomHorizontalFlip(0.5)
  + optional RandomErasing).

The geometry (resize, crop, flip, erase) runs on the host over uint8
arrays and :func:`normalize_images` runs on the device over the uint8
crops, so host-to-device copies stay uint8. The crop boxes, flips and
erasures are the JAX package's, drawn from the same numpy generator in
the same order. The bicubic resampling is torch's antialiased bicubic on
uint8 CPU tensors (``F.interpolate(mode="bicubic", antialias=True)``,
PIL's filter, a = -0.5) where the JAX package calls PIL, which the
card's machine does not have; on 480 x 640 -> 248 x 330 and on crops
resized to 224 the two agree within one level
(``tests/test_torch_vision.py``). The JAX package's deviations stay:
random erasing fills before normalization, ``auto_augment`` raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the reference ViT data config (vision_transformer.py:42,58)
VIT_MEAN = (0.5, 0.5, 0.5)
VIT_STD = (0.5, 0.5, 0.5)
VIT_CROP_PCT = 0.9
# MatterSim render resolution in both preprocess scripts
# (precompute_img_features_vit.py:37-39, build_image_lmdb.py:16-18)
RENDER_HEIGHT = 480
RENDER_WIDTH = 640
RENDER_VFOV_DEG = 60.0


def timm_scale_size(out_size: int, crop_pct: float = VIT_CROP_PCT) -> int:
    """Pre-crop shorter-side target: floor(out/crop_pct)
    (timm transforms_factory eval path). 224 @ 0.9 -> 248."""
    return int(math.floor(out_size / crop_pct))


def bicubic_resize(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (oh, ow, 3) uint8, antialiased bicubic on the
    CPU (torch's uint8 path, PIL's filter and rounding)."""
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    out = F.interpolate(t, size=(oh, ow), mode="bicubic", antialias=True, align_corners=False)
    return out[0].permute(1, 2, 0).numpy()


def _resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    """Bicubic resize with the shorter side -> ``size``, aspect kept.

    Output dims follow torchvision's integer math (truncation):
    h<=w -> (size, int(size * w / h)); 480x640 -> 248x330, matching the
    reference LMDB records (build_image_lmdb.py:43-44)."""
    h, w = img.shape[:2]
    if h <= w:
        oh, ow = size, int(size * w / h)
    else:
        oh, ow = int(size * h / w), size
    if (oh, ow) == (h, w):
        return img
    return bicubic_resize(img, oh, ow)


def _center_crop(img: np.ndarray, out: int) -> np.ndarray:
    """torchvision CenterCrop offsets: round((dim - out) / 2)."""
    h, w = img.shape[:2]
    top = int(round((h - out) / 2.0))
    left = int(round((w - out) / 2.0))
    return img[top: top + out, left: left + out]


def eval_transform(images: np.ndarray, out_size: int = 224,
                   crop_pct: float = VIT_CROP_PCT) -> np.ndarray:
    """timm eval transform, uint8 in / uint8 out (normalize on device).

    (..., H, W, 3) uint8 -> (..., out, out, 3) uint8:
    bicubic resize shorter side -> floor(out/crop_pct), center crop.
    """
    lead = images.shape[:-3]
    flat = images.reshape((-1,) + images.shape[-3:])
    scale = timm_scale_size(out_size, crop_pct)
    out = np.empty((flat.shape[0], out_size, out_size, 3), np.uint8)
    for i in range(flat.shape[0]):
        out[i] = _center_crop(_resize_shorter(flat[i], scale), out_size)
    return out.reshape(lead + (out_size, out_size, 3))


def _rrc_params(rng: np.random.Generator, h: int, w: int,
                scale: Tuple[float, float],
                ratio: Tuple[float, float]) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params: 10 attempts, then the
    center-crop fallback clamped to the ratio range."""
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def _erase_params(rng: np.random.Generator, h: int, w: int,
                  area_range=(0.02, 1 / 3.0),
                  log_aspect=(math.log(0.3), math.log(1 / 0.3))):
    """timm RandomErasing region sampling (10 attempts)."""
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*area_range)
        aspect = math.exp(rng.uniform(*log_aspect))
        eh = int(round(math.sqrt(target * aspect)))
        ew = int(round(math.sqrt(target / aspect)))
        if eh < h and ew < w:
            top = int(rng.integers(0, h - eh))
            left = int(rng.integers(0, w - ew))
            return top, left, eh, ew
    return None


def train_transform(images: np.ndarray, rng: np.random.Generator,
                    out_size: int = 224,
                    scale: Tuple[float, float] = (0.08, 1.0),
                    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                    hflip: float = 0.5,
                    re_prob: float = 0.0,
                    re_mode: str = "const") -> np.ndarray:
    """timm train transform, uint8 in / uint8 out: RandomResizedCrop
    (bicubic) + horizontal flip (+ optional random erasing, filled
    before normalization). Per-image params are drawn independently,
    like per-__getitem__ torch transforms."""
    lead = images.shape[:-3]
    flat = images.reshape((-1,) + images.shape[-3:])
    out = np.empty((flat.shape[0], out_size, out_size, 3), np.uint8)
    for i in range(flat.shape[0]):
        img = flat[i]
        top, left, ch, cw = _rrc_params(rng, img.shape[0], img.shape[1], scale, ratio)
        arr = bicubic_resize(img[top: top + ch, left: left + cw], out_size, out_size)
        if hflip > 0 and rng.random() < hflip:
            arr = arr[:, ::-1]
        if re_prob > 0 and rng.random() < re_prob:
            params = _erase_params(rng, out_size, out_size)
            if params is not None:
                et, el, eh, ew = params
                arr = arr.copy()
                if re_mode == "const":
                    arr[et: et + eh, el: el + ew] = 128
                else:  # 'rand' / 'pixel': normalized gaussian noise
                    noise = rng.normal(127.5, 127.5, (eh, ew, 3))
                    arr[et: et + eh, el: el + ew] = np.clip(noise, 0, 255).astype(np.uint8)
        out[i] = arr
    return out.reshape(lead + (out_size, out_size, 3))


@dataclasses.dataclass
class ImageTransform:
    """The timm transform bundle (image_data.py:70-80), host-side.

    ``train=False``: deterministic resize+crop. ``train=True``: the
    stochastic pipeline (reference ``is_training=True`` on the train
    stream). uint8 in/out; pair with :func:`normalize_images` on
    device.
    """

    out_size: int = 224
    crop_pct: float = VIT_CROP_PCT
    train: bool = False
    scale: Tuple[float, float] = (0.08, 1.0)
    ratio: Tuple[float, float] = (3 / 4, 4 / 3)
    hflip: float = 0.5
    re_prob: float = 0.0
    re_mode: str = "const"
    auto_augment: Optional[str] = None
    seed: int = 0

    def __post_init__(self):
        if self.auto_augment:
            raise ValueError("auto_augment policies are not implemented (the reference "
                             "defaults auto_augment=None, image_data.py:37)")
        self._rng = np.random.default_rng(self.seed)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        if self.train:
            return train_transform(images, self._rng, self.out_size, self.scale, self.ratio,
                                   self.hflip, self.re_prob, self.re_mode)
        return eval_transform(images, self.out_size, self.crop_pct)


def normalize_images(images_u8: torch.Tensor, mean=VIT_MEAN, std=VIT_STD) -> torch.Tensor:
    """(..., H, W, 3) uint8 -> float32 ToTensor + Normalize equivalent,
    (x/255 - mean) / std, on the tensor's device."""
    x = images_u8.to(torch.float32) / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s
