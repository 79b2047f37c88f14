"""Vision Transformer backbone (torch), the port of
``vln_hamt_tpu/vision/vit.py``.

Parity target: the vendored timm ViT-B/16 of the reference
(``pretrain_src/model/vision_transformer.py``: conv patch embedding, cls
token, learned position embeddings, pre-LN blocks, final LN;
``forward_features`` returns the pre-logits CLS state, ``head`` the
1000-way ImageNet logits; :336-348, :399-434 for pos-embed resizing).

The modules carry timm's state-dict names (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.norm1`` / ``attn.qkv`` /
``attn.proj`` / ``norm2`` / ``mlp.fc1`` / ``mlp.fc2``, ``norm``,
``head``), so a timm checkpoint loads after the JAX loader's filtering
(``models/convert.py:load_vit_checkpoint``). LayerNorm eps 1e-6, exact
(erf) GELU; features are the final-LN CLS state in fp32.

Images come in NHWC, normalized. The patch embedding is the conv as one
matrix product over the patches. Every attention goes through
``ops/attention.py:fused_attention`` with an all-zero (B, 1 + N) mask
and the config's dropout rate: the CUDA kernels on the card (197 x 197
at Dh 64 for ViT-B/16 at 224), their plain twins on the CPU. The JAX
package's ViT uses flax's attention instead, which computes in bf16
under bf16; the kernels compute in fp32. Compute dtype as in
``models/layers.py``: fp32 parameters, casts at the point of use.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.hamt import init_weights_
from ..models.layers import (DropoutRNG, LayerNorm, Linear, _rng, erf_gelu,
                             set_compute_dtype)
from ..ops.attention import fused_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: Tuple[int, int] = (224, 224)
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_classes: int = 1000  # 0: no head (features only)
    dropout: float = 0.0  # attention-probability dropout
    dtype: str = "float32"

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.patch_size, self.img_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid
        return gh * gw

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute dtype {self.dtype!r}: float32 or bfloat16")
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


class PatchEmbed(nn.Module):
    """timm's conv patch embedding (``proj``: (D, 3, p, p)), computed as
    one product of the flattened patches with the flattened kernel."""

    compute_dtype = torch.float32

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.patch_size = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, gh * gw, D) in the compute dtype, patches in
        row-major grid order."""
        b, h, w, c = images.shape
        p, dt = self.patch_size, self.compute_dtype
        gh, gw = h // p, w // p
        x = images[:, :gh * p, :gw * p].to(dt).reshape(b, gh, p, gw, p, c)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, gh * gw, c * p * p)  # (c, ky, kx)
        weight = self.proj.weight.reshape(self.proj.out_channels, -1)
        return F.linear(x, weight.to(dt), self.proj.bias.to(dt))


class ViTAttention(nn.Module):
    """timm ``Attention``: fused ``qkv`` projection, the attention kernel,
    output ``proj``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.dropout_prob = cfg.dropout
        self.rng: Optional[DropoutRNG] = None
        self.qkv = Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.proj = Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        # q, k, v as (B, H, N, Dh) strided views of the one projection
        qkv = self.qkv(x).view(b, n, 3, h, d // h)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        rate = self.dropout_prob if self.training else 0.0
        seed = _rng(self).attention_seed() if rate > 0.0 else None
        mask = x.new_zeros((b, n), dtype=torch.float32)
        out = fused_attention(q, k, v, mask, rate, seed)
        return self.proj(out.transpose(1, 2).reshape(b, n, d).to(x.dtype))


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.fc1 = Linear(cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio))
        self.fc2 = Linear(int(cfg.hidden_size * cfg.mlp_ratio), cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(erf_gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    """Pre-LN block: x + attn(norm1(x)), then x + mlp(norm2(x))."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = LayerNorm(cfg.hidden_size, eps=1e-6)
        self.attn = ViTAttention(cfg)
        self.norm2 = LayerNorm(cfg.hidden_size, eps=1e-6)
        self.mlp = Mlp(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.config = cfg
        d = cfg.hidden_size
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d))
        self.blocks = nn.ModuleList(ViTBlock(cfg) for _ in range(cfg.num_layers))
        self.norm = LayerNorm(d, eps=1e-6)
        self.head = Linear(d, cfg.num_classes) if cfg.num_classes > 0 else None
        self.compute_dtype = cfg.compute_dtype
        set_compute_dtype(self, self.compute_dtype)
        self.patch_embed.compute_dtype = self.compute_dtype

    def forward(self, images: torch.Tensor, return_logits: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """images: (B, H, W, 3) float, normalized. Returns (features
        (B, D), logits (B, C) or None), both fp32; the features are the
        final-LN CLS state (timm ``forward_features``)."""
        dt = self.compute_dtype
        x = self.patch_embed(images)
        cls = self.cls_token.to(dt).expand(x.shape[0], 1, x.shape[2])
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        for block in self.blocks:
            x = block(x)
        x = self.norm(x[:, 0])  # the LayerNorm is per token: the CLS row alone
        if not return_logits or self.head is None:
            return x.float(), None
        return x.float(), self.head(x).float()


def init_vit_weights_(vit: ViT, generator: torch.Generator) -> None:
    """The rest of flax's default initializers of the JAX ViT after
    ``models/hamt.py:init_weights_`` (Dense kernels lecun-normal, biases
    zero, LayerNorm ones/zeros), drawn from ``generator``: the conv
    kernel lecun-normal (truncated at 2 std) and its bias zero, the cls
    token zero, the position embeddings normal(0.02)."""
    w = vit.patch_embed.proj.weight
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        vit.patch_embed.proj.bias.zero_()
        vit.cls_token.zero_()
        vit.pos_embed.normal_(0.0, 0.02, generator=generator)


def init_vit(cfg: ViTConfig, seed: int = 0) -> ViT:
    """A :class:`ViT` on the CPU initialized from ``seed``, built on the
    meta device first so that nothing is drawn from torch's global
    generator."""
    with torch.device("meta"):
        vit = ViT(cfg)
    vit.to_empty(device="cpu")
    g = torch.Generator().manual_seed(seed)
    init_weights_(vit, g)
    init_vit_weights_(vit, g)
    return vit


def vit_base_patch16(img_size=(224, 224), dtype: str = "float32", num_classes: int = 1000,
                     seed: int = 0) -> ViT:
    """ViT-B/16 (hidden 768, 12 layers, 12 heads, patch 16) on the CPU,
    initialized from ``seed``."""
    return init_vit(ViTConfig(img_size=tuple(img_size), dtype=dtype, num_classes=num_classes),
                    seed)


def resize_pos_embed(pos: torch.Tensor, new_grid: Tuple[int, int],
                     old_grid: Tuple[int, int]) -> torch.Tensor:
    """Bilinear position-embedding resize for another input size
    (vision_transformer.py:399-419): (1, 1 + old_h * old_w, D) ->
    (1, 1 + new_h * new_w, D), the cls row kept, half-pixel centers
    (``align_corners=False``), no antialiasing."""
    cls_tok, grid_tok = pos[:, :1], pos[:, 1:]
    d = pos.shape[-1]
    grid_tok = grid_tok.reshape(1, *old_grid, d).permute(0, 3, 1, 2)
    grid_tok = F.interpolate(grid_tok, size=tuple(new_grid), mode="bilinear",
                             align_corners=False, antialias=False)
    return torch.cat([cls_tok, grid_tok.permute(0, 2, 3, 1).reshape(1, -1, d)], dim=1)
