# pixelrec_multimodal_tpu_torch/encoders/dinov2.py
"""DINOv2 ViT-B/14 vision tower.

Counterpart of ``pixelrec_multimodal_tpu/encoders/dinov2.py``
(facebook/dinov2-base as HF's ``Dinov2Model``; the feature is
``pooler_output``, the LayerNormed CLS token, 768): a patch-14 ViT,
pre-LN blocks with LayerScale and a plain MLP. The position embeddings
are stored for the 518-px grid (37x37 patches) and interpolated bicubically
to the input grid (16x16 at 224 px) by ``bicubic_resize_matrix``, a copy
of the JAX package's: the same float64 matrix rounded to float32, so the
interpolation computes what JAX's does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, Dense, LayerNorm, MultiHeadSelfAttention


def _cubic_kernel(x: np.ndarray, a: float = -0.75):
    x = np.abs(x)
    return np.where(
        x <= 1, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
        np.where(x < 2, a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a, 0.0))


def bicubic_resize_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] float32 matrix of torch's bicubic resize
    (align_corners=False, a=-0.75, edge-clamped), the convention of HF
    Dinov2's position-embedding interpolation; built in float64."""
    M = np.zeros((dst, src), np.float64)
    scale = src / dst
    for i in range(dst):
        x = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(x))
        t = x - i0
        for off in (-1, 0, 1, 2):
            idx = min(max(i0 + off, 0), src - 1)
            M[i, idx] += _cubic_kernel(np.asarray(off - t))
    return M.astype(np.float32)


@dataclass(frozen=True)
class Dinov2Config:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    patch_size: int = 14
    # The grid size the stored position embeddings correspond to (518/14).
    pos_embed_grid: int = 37
    layer_norm_eps: float = 1e-6
    layerscale_init: float = 1.0


class Dinov2Layer(nn.Module):
    def __init__(self, c: Dinov2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.attention = MultiHeadSelfAttention(c.hidden_size, c.num_heads,
                                                dtype)
        self.layerscale1 = nn.Parameter(
            torch.full((c.hidden_size,), c.layerscale_init))
        self.norm2 = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.fc1 = Dense(c.hidden_size, c.hidden_size * c.mlp_ratio, dtype)
        self.fc2 = Dense(c.hidden_size * c.mlp_ratio, c.hidden_size, dtype)
        self.layerscale2 = nn.Parameter(
            torch.full((c.hidden_size,), c.layerscale_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.norm1(x)) * self.layerscale1
        h = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate='none'))
        return x + h * self.layerscale2


class Dinov2Tower(nn.Module):
    """DINOv2 tower; pooled output = LayerNormed CLS (768)."""

    def __init__(self, config: Dinov2Config = Dinov2Config(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        self.patch_embedding = Conv(3, c.hidden_size, c.patch_size,
                                    c.patch_size, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(
            1, c.pos_embed_grid * c.pos_embed_grid + 1, c.hidden_size))
        for i in range(c.num_layers):
            self.add_module(f'layer_{i}', Dinov2Layer(c, dtype))
        self.layernorm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.config
        B, _, H, W = pixel_values.shape
        gh, gw = H // c.patch_size, W // c.patch_size
        x = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)

        # The patch positions interpolated to the input grid (HF
        # interpolate_pos_encoding); the CLS slot as is.
        pos = self.position_embeddings
        cls_pos = pos[:, :1]
        patch_pos = pos[:, 1:].reshape(1, c.pos_embed_grid, c.pos_embed_grid,
                                       c.hidden_size)
        if (gh, gw) != (c.pos_embed_grid, c.pos_embed_grid):
            Mh = torch.from_numpy(bicubic_resize_matrix(
                c.pos_embed_grid, gh)).to(pos.device)
            Mw = torch.from_numpy(bicubic_resize_matrix(
                c.pos_embed_grid, gw)).to(pos.device)
            patch_pos = torch.einsum('oh,bhwd,pw->bopd', Mh, patch_pos, Mw)
        patch_pos = patch_pos.reshape(1, gh * gw, c.hidden_size)

        wide = torch.promote_types(x.dtype, self.cls_token.dtype)
        x = torch.cat([self.cls_token.expand(B, 1, -1).to(wide),
                       x.to(wide)], dim=1)
        x = x + torch.cat([cls_pos, patch_pos], dim=1).to(x.dtype)
        for i in range(c.num_layers):
            x = getattr(self, f'layer_{i}')(x)
        x = self.layernorm(x)
        return x, x[:, 0]

    def pooled(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self(pixel_values)[1]
