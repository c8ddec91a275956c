# pixelrec_multimodal_tpu_torch/encoders/convnext.py
"""ConvNeXt-Base vision tower.

Counterpart of ``pixelrec_multimodal_tpu/encoders/convnext.py``
(facebook/convnext-base-224 as HF's ``ConvNextModel``; the feature is
``pooler_output``, a LayerNorm over the mean-pooled last feature map,
1024): a 4x4/4 patchify stem + LayerNorm, four stages of depths
[3, 3, 27, 3] and widths [128, 256, 512, 1024], a LayerNorm + 2x2/2 conv
downsample between stages. Block: 7x7 depthwise conv -> LayerNorm over
channels -> 1x1 expand (4x) -> exact GELU -> 1x1 project -> layer-scaled
residual. The convolutions run on NCHW tensors; each LayerNorm and the
block's MLP on the NHWC view, as in the JAX tower.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, Dense, LayerNorm


@dataclass(frozen=True)
class ConvNextConfig:
    hidden_sizes: Tuple[int, ...] = (128, 256, 512, 1024)
    depths: Tuple[int, ...] = (3, 3, 27, 3)
    patch_size: int = 4
    layer_norm_eps: float = 1e-12
    layer_scale_init: float = 1e-6
    # HF applies LayerNorm inside blocks/stems with eps 1e-6.
    block_ln_eps: float = 1e-6


def _channels_last(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` over the NHWC view of an NCHW tensor, back to NCHW."""
    return fn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNextBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float, ln_eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dwconv = Conv(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = LayerNorm(dim, eps=ln_eps)
        self.pwconv1 = Dense(dim, 4 * dim, dtype)
        self.pwconv2 = Dense(4 * dim, dim, dtype)
        self.layer_scale = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def mlp(h):
            h = self.pwconv1(self.norm(h))
            return self.pwconv2(F.gelu(h, approximate='none')) \
                * self.layer_scale
        return x + _channels_last(mlp, self.dwconv(x))


class ConvNextTower(nn.Module):
    """ConvNeXt-Base; pooled output = LN(global mean pool) (1024)."""

    def __init__(self, config: ConvNextConfig = ConvNextConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        self.stem_conv = Conv(3, c.hidden_sizes[0], c.patch_size,
                              c.patch_size, dtype=dtype)
        self.stem_norm = LayerNorm(c.hidden_sizes[0], eps=c.block_ln_eps)
        self.stages = []
        for stage, (dim, depth) in enumerate(zip(c.hidden_sizes, c.depths)):
            names = []
            if stage > 0:
                prev = c.hidden_sizes[stage - 1]
                self.add_module(f'downsample_norm_{stage}',
                                LayerNorm(prev, eps=c.block_ln_eps))
                self.add_module(f'downsample_conv_{stage}',
                                Conv(prev, dim, 2, 2, dtype=dtype))
            for block in range(depth):
                name = f'stage_{stage}_block_{block}'
                self.add_module(name, ConvNextBlock(
                    dim, c.layer_scale_init, c.block_ln_eps, dtype))
                names.append(name)
            self.stages.append(names)
        self.final_layernorm = LayerNorm(c.hidden_sizes[-1],
                                         eps=c.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (the final feature map, NHWC as the JAX tower returns it,
        and the pooled (B, 1024))."""
        x = _channels_last(self.stem_norm, self.stem_conv(pixel_values))
        for stage, names in enumerate(self.stages):
            if stage > 0:
                x = _channels_last(getattr(self, f'downsample_norm_{stage}'),
                                   x)
                x = getattr(self, f'downsample_conv_{stage}')(x)
            for name in names:
                x = getattr(self, name)(x)
        pooled = self.final_layernorm(x.mean(dim=(2, 3)))
        return x.permute(0, 2, 3, 1), pooled

    def pooled(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self(pixel_values)[1]
