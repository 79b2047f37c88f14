"""End-to-end image pretraining, ViT in the loop (torch): the port of
``vln_hamt_tpu/pretrain/image_model.py``.

Parity target: ``pretrain_src/model/image_vilmodel.py`` /
``image_pretrain.py`` (NavTHORImagePreTrainedModel), the variant where
the panorama features are computed by a trainable ViT over raw pixels.
The behavioral contract, as the JAX package reconstructs it:

- history panoramas are encoded without gradient (``torch.no_grad``, "due
  to memory", image_vilmodel.py:40-59): no graph is kept for them;
- the current observation's 36 views keep their gradient;
- MRC masks the features after the ViT (image_vilmodel.py:83-85);
- ``ob_v_exists`` zeroes the views and the STOP token is appended on the
  device (:101-106).

:class:`HAMTImagePretrain` is :class:`~vln_hamt_torch.pretrain.model.HAMTPretrain`
(the same trunk and heads, under the same names) with a ``vit``: its
state dict is a pretraining checkpoint plus ``vit.*`` in timm's names.
The ViT has no classification head (the JAX model never calls it, so its
params hold none). At ViT-B/16 every update runs the ViT's 12 forward
attentions over the history's B x T x 36 images, and for SAP, SAR and
SpRel 12 forward and 12 backward over the observation's B x 36.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..configs import ModelConfig
from ..models.hamt import init_weights_
from ..vision.transforms import normalize_images
from ..vision.vit import ViT, ViTConfig, init_vit_weights_
from .model import Batch, HAMTPretrain


class HAMTImagePretrain(HAMTPretrain):
    """ViT + HAMTPretrain: raw panorama pixels in, task losses out."""

    def __init__(self, cfg: ModelConfig, vit_cfg: ViTConfig):
        super().__init__(cfg)
        if vit_cfg.hidden_size != cfg.image_feat_size:
            raise ValueError(f"the ViT's width {vit_cfg.hidden_size} must be the trunk's "
                             f"image_feat_size {cfg.image_feat_size}")
        self.vit_config = dataclasses.replace(vit_cfg, num_classes=0)
        self.vit = ViT(self.vit_config)

    def _encode_views(self, images: torch.Tensor, with_grad: bool) -> torch.Tensor:
        """(..., H, W, 3) uint8 -> (..., D) fp32 ViT features; the
        normalization is the reference ViT data config's mean = std = 0.5
        (the geometry runs on the host, ``ImagePretrainBatcher``'s
        transform)."""
        lead = images.shape[:-3]
        x = normalize_images(images.reshape(-1, *images.shape[-3:]))
        with torch.set_grad_enabled(with_grad and torch.is_grad_enabled()):
            feats, _ = self.vit(x, return_logits=False)
        return feats.reshape(*lead, feats.shape[-1])

    def forward(self, batch: Batch, task: str, feat_table: Optional[torch.Tensor] = None,
                rows: Optional[Tuple[int, int]] = None):
        """Replace the image tensors with ViT features, then the trunk's task
        forward. Image keys (uint8): ``hist_pano_images`` (B, T, 36, H, W,
        3) with ``hist_viewindex`` (B, T), the view faced at each step;
        ``ob_images`` (B, 36, H, W, 3). Other entries pass through.
        ``feat_table`` is accepted for the trainer's call and unused;
        ``rows`` as the trunk's (ITM's rows of a global batch)."""
        fed: Dict[str, torch.Tensor] = dict(batch)
        b = batch["txt_ids"].shape[0]
        if "hist_pano_images" in fed:
            pano = self._encode_views(fed.pop("hist_pano_images"), with_grad=False)
            vidx = fed.pop("hist_viewindex")  # (B, T)
            hist = pano.gather(2, vidx[:, :, None, None].expand(-1, -1, 1, pano.shape[-1]))
            hist = hist[:, :, 0]
            if task == "mrc":  # post-ViT input masking (image_vilmodel.py:83-85)
                m = batch["hist_mrc_masks"]
                hist = torch.where(m[..., None], 0.0, hist)
                pano = torch.where(m[..., None, None], 0.0, pano)
            fed["hist_img"], fed["hist_pano_img"] = hist, pano
        if "ob_images" in fed:
            ob = self._encode_views(fed.pop("ob_images"), with_grad=True)
            if "ob_v_exists" in fed:  # random visual kill (:101-102)
                ob = ob * fed["ob_v_exists"][:, None, None]
            fed["ob_img"] = torch.cat([ob, ob.new_zeros((b, 1, ob.shape[-1]))], dim=1)
        return super().forward(fed, task, rows=rows)


def init_image_pretrain(cfg: ModelConfig, vit_cfg: ViTConfig, seed: int = 0
                        ) -> HAMTImagePretrain:
    """A :class:`HAMTImagePretrain` on the CPU initialized from ``seed``
    with flax's default initializers (the MLM bias zero), built on the
    meta device first so nothing is drawn from torch's global
    generator."""
    with torch.device("meta"):
        model = HAMTImagePretrain(cfg, vit_cfg)
    model.to_empty(device="cpu")
    g = torch.Generator().manual_seed(seed)
    init_weights_(model, g)
    init_vit_weights_(model.vit, g)
    with torch.no_grad():
        model.mlm_head.predictions.bias.zero_()
    return model
