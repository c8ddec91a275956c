# pixelrec_multimodal_tpu_torch/encoders/clip.py
"""CLIP ViT-B/32 vision and text towers.

Counterpart of ``pixelrec_multimodal_tpu/encoders/clip.py``
(openai/clip-vit-base-patch32 as HF's ``CLIPVisionModel`` and
``CLIPTextModel``):

  * vision: ``pooler_output``, the post-LayerNorm CLS token, 768;
  * text: ``pooler_output``, the final-LayerNorm hidden state at the EOT
    position (the first maximum of the input ids), 512.

Pre-LN transformers with QuickGELU, a learned class embedding and absolute
position embeddings; the text side adds a causal bias to the padding bias.
The JAX vision tower embeds patches as one product over reshaped patches
(a rewrite for the TPU's matrix unit); its parameter is the conv-layout
[P, P, 3, H] kernel, which this tower applies as the stride-P convolution
it stands for.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from .common import (
    MASK_BIAS,
    Conv,
    Dense,
    Embed,
    LayerNorm,
    MultiHeadSelfAttention,
    causal_attention_bias,
    quick_gelu,
)


@dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_layers: int = 12
    num_heads: int = 8
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5


class CLIPEncoderLayer(nn.Module):
    """Pre-LN block with a QuickGELU MLP."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_heads: int, layer_norm_eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(hidden_size, eps=layer_norm_eps)
        self.attention = MultiHeadSelfAttention(hidden_size, num_heads, dtype)
        self.norm2 = LayerNorm(hidden_size, eps=layer_norm_eps)
        self.fc1 = Dense(hidden_size, intermediate_size, dtype)
        self.fc2 = Dense(intermediate_size, hidden_size, dtype)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attention(self.norm1(x), bias)
        return x + self.fc2(quick_gelu(self.fc1(self.norm2(x))))


def _layers(module: nn.Module, c, dtype: torch.dtype):
    for i in range(c.num_layers):
        module.add_module(f'layer_{i}', CLIPEncoderLayer(
            c.hidden_size, c.intermediate_size, c.num_heads,
            c.layer_norm_eps, dtype))


class CLIPVisionTower(nn.Module):
    """CLIP vision transformer; pooled output = post-LN CLS (768)."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        self.patch_embedding = Conv(3, c.hidden_size, c.patch_size,
                                    c.patch_size, padding=0, bias=False,
                                    dtype=dtype)
        n_pos = (c.image_size // c.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(c.hidden_size))
        self.position_embedding = nn.Parameter(
            torch.zeros(n_pos, c.hidden_size))
        self.pre_layrnorm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        _layers(self, c, dtype)
        self.post_layernorm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixel_values: (B, 3, H, W) normalized. Returns
        (last_hidden_state, pooler_output)."""
        c = self.config
        x = self.patch_embedding(pixel_values)       # (B, H, gh, gw)
        x = x.flatten(2).transpose(1, 2)              # (B, gh * gw, H)
        # the float32 class token promotes the patches, as in JAX
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x.float()], dim=1) + self.position_embedding[None]
        x = self.pre_layrnorm(x)
        for i in range(c.num_layers):
            x = getattr(self, f'layer_{i}')(x)
        return x, self.post_layernorm(x[:, 0])

    def pooled(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self(pixel_values)[1]


class CLIPTextTower(nn.Module):
    """CLIP text transformer; pooled output = final-LN hidden at EOT
    (512)."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        self.token_embedding = Embed(c.vocab_size, c.hidden_size, dtype)
        self.position_embedding = nn.Parameter(
            torch.zeros(c.max_position_embeddings, c.hidden_size))
        _layers(self, c, dtype)
        self.final_layer_norm = LayerNorm(c.hidden_size,
                                          eps=c.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.config
        B, T = input_ids.shape
        x = self.token_embedding(input_ids) + self.position_embedding[None, :T]
        bias = causal_attention_bias(T, device=input_ids.device)
        if attention_mask is not None:
            pad = (1.0 - attention_mask.to(torch.float32)) * MASK_BIAS
            bias = bias + pad[:, None, None, :]
        for i in range(c.num_layers):
            x = getattr(self, f'layer_{i}')(x, bias)
        x = self.final_layer_norm(x)
        # EOT pooling: the first position of the highest token id.
        eot = torch.argmax(input_ids, dim=-1)
        return x, x[torch.arange(B, device=x.device), eot]

    def pooled(self, input_ids, attention_mask=None) -> torch.Tensor:
        return self(input_ids, attention_mask)[1]
