# pixelrec_multimodal_tpu_torch/models/layers.py
"""Layer building blocks of the port's model, in PyTorch.

Counterpart of ``pixelrec_multimodal_tpu/models/layers.py``: the fusion
layers, plus the Flax-style Dense helpers the model's modules share.
``AttentionFusionLayer`` and ``CrossModalAttention`` are not ported yet
(ROADMAP item A9).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def variance_scaling(shape: Tuple[int, int], scale: float, mode: str,
                     distribution: str,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``variance_scaling`` on a [fan_in, fan_out] shape (Flax
    layout: rows are the input axis)."""
    fan_in, fan_out = shape
    denom = {'fan_in': fan_in, 'fan_out': fan_out,
             'fan_avg': (fan_in + fan_out) / 2}[mode]
    variance = scale / max(1.0, denom)
    if distribution == 'uniform':
        limit = math.sqrt(3.0 * variance)
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit
    # truncated normal on [-2, 2], rescaled to the target variance
    out = torch.empty(shape)
    nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out * (math.sqrt(variance) / 0.87962566103423978)


def dense(in_dim: int, out_dim: int,
          generator: Optional[torch.Generator]) -> nn.Linear:
    """nn.Linear with Flax Dense's default init (LeCun normal kernel,
    zero bias)."""
    layer = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        layer.weight.copy_(variance_scaling(
            (in_dim, out_dim), 1.0, 'fan_in', 'truncated_normal',
            generator).T)
        layer.bias.zero_()
    return layer


def apply_dense(layer: nn.Linear, x: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Flax Dense with ``dtype``: input, kernel and bias cast to dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class GatedFusionLayer(nn.Module):
    """Softmax-gated weighted sum of the modalities, eval mode (dropout is
    then the identity). The child Linear is named ``gating`` as the Flax
    Dense is, so ``params/fusion_layer/gating/{kernel,bias}`` converts by
    name."""

    def __init__(self, embedding_dim: int, num_modalities: int,
                 dropout_rate: float, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.num_modalities = num_modalities
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.gating = dense(num_modalities * embedding_dim, num_modalities,
                            generator)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """features: (B, num_modalities, D) -> (B, D)."""
        concat = features.reshape(features.shape[0],
                                  self.num_modalities * self.embedding_dim)
        gates = torch.softmax(apply_dense(self.gating, concat, self.dtype),
                              dim=-1)
        return (features * gates[:, :, None]).sum(dim=1)
