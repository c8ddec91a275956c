# pixelrec_multimodal_tpu_torch/encoders/resnet.py
"""ResNet-50 (v1.5) vision tower.

Counterpart of ``pixelrec_multimodal_tpu/encoders/resnet.py``
(microsoft/resnet-50 as HF's ``ResNetModel``; the feature is
``pooler_output``, the global average pool of the last stage, 2048):
7x7/2 stem conv + frozen BN + ReLU + 3x3/2 max pool, four bottleneck
stages [3, 4, 6, 3] with channels [256, 512, 1024, 2048], the stride on
the 3x3 conv (v1.5), stride 1 in the first stage. BatchNorm runs on its
stored running statistics, which are parameters as in JAX: a frozen
tower never moves them, and an unfrozen one (``models/end_to_end.py``)
trains, decays and clips them with the rest.

The JAX tower evaluates the stem as a 4x4/1 conv on space-to-depth
packed input, a rewrite for the TPU's matrix unit whose parameter is the
canonical [7, 7, 3, F] kernel. This tower computes that canonical 7x7/2
convolution with padding 3 directly (the same function; cuDNN chooses
its own algorithm), on NCHW tensors throughout.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv


@dataclass(frozen=True)
class ResNetConfig:
    embedding_size: int = 64
    hidden_sizes: Tuple[int, ...] = (256, 512, 1024, 2048)
    depths: Tuple[int, ...] = (3, 4, 6, 3)
    bn_eps: float = 1e-5


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm over NCHW channels. Its four values are
    parameters, as Flax's ``scale``, ``bias``, ``mean`` and ``var`` are:
    ``weight``, ``bias``, ``running_mean`` and ``running_var`` (the
    names of torch's BatchNorm, so state dicts keep their keys). The
    forward never updates the statistics; an optimizer over the tower's
    parameters moves, decays and clips them, as optax does in JAX."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def c(t):
            return t.view(1, -1, 1, 1)
        inv = torch.rsqrt(self.running_var + self.eps)
        return ((x - c(self.running_mean)) * c(inv) * c(self.weight)
                + c(self.bias)).to(x.dtype)


class ConvBN(nn.Module):
    """Conv -> frozen BN (-> ReLU), as HF's ResNetConvLayer."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int = 1, act: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.conv = Conv(in_channels, features, kernel, stride,
                         padding=kernel // 2, bias=False, dtype=dtype)
        self.bn = FrozenBatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class Bottleneck(nn.Module):
    """v1.5 bottleneck: 1x1 reduce -> 3x3 (stride) -> 1x1 expand +
    shortcut."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        reduced = out_channels // 4
        if in_channels != out_channels or stride != 1:
            self.shortcut = ConvBN(in_channels, out_channels, 1, stride,
                                   act=False, dtype=dtype)
        self.conv1 = ConvBN(in_channels, reduced, 1, 1, dtype=dtype)
        self.conv2 = ConvBN(reduced, reduced, 3, stride, dtype=dtype)
        self.conv3 = ConvBN(reduced, out_channels, 1, act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.shortcut(x) if hasattr(self, 'shortcut') else x
        h = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(h + shortcut)


class ResNetTower(nn.Module):
    """ResNet-50; pooled output = global average pool (2048)."""

    def __init__(self, config: ResNetConfig = ResNetConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        self.stem = ConvBN(3, c.embedding_size, 7, 2, dtype=dtype)
        self.blocks = []
        channels_in = c.embedding_size
        for stage, (channels, depth) in enumerate(zip(c.hidden_sizes,
                                                      c.depths)):
            stride = 1 if stage == 0 else 2
            for block in range(depth):
                name = f'stage_{stage}_block_{block}'
                self.add_module(name, Bottleneck(
                    channels_in, channels, stride if block == 0 else 1,
                    dtype=dtype))
                self.blocks.append(name)
                channels_in = channels

    def forward(self, pixel_values: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixel_values: (B, 3, H, W). Returns (the final feature map,
        NHWC as the JAX tower returns it, and the pooled (B, 2048))."""
        x = self.stem(pixel_values)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x.permute(0, 2, 3, 1), x.mean(dim=(2, 3))

    def pooled(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self(pixel_values)[1]
