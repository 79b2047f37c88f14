"""The vision pipeline (torch), the port of ``vln_hamt_tpu/vision``: the
ViT-B/16 backbone, the timm image transforms and the panorama feature
extractor."""

from .featurizer import PanoramaFeaturizer
from .transforms import ImageTransform, eval_transform, normalize_images, train_transform
from .vit import ViT, ViTConfig, init_vit, vit_base_patch16

__all__ = [
    "ViT",
    "ViTConfig",
    "vit_base_patch16",
    "init_vit",
    "PanoramaFeaturizer",
    "ImageTransform",
    "eval_transform",
    "train_transform",
    "normalize_images",
]
