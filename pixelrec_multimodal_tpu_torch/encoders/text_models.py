# pixelrec_multimodal_tpu_torch/encoders/text_models.py
"""Text towers: the BERT family (bert, MiniLM, RoBERTa) and MPNet.

Counterpart of ``pixelrec_multimodal_tpu/encoders/text_models.py``:

  * bert-base-uncased, sentence-transformers/all-MiniLM-L6-v2: post-LN
    transformer with absolute positions, token types and a tanh pooler;
  * roberta-base: the same body, position ids counted past the padding
    index (padding_idx=1), one token type;
  * sentence-transformers/all-mpnet-base-v2: RoBERTa-style embeddings, no
    token types, and a shared T5-style relative attention bias added to
    the padding bias in every layer.

All four return (last_hidden_state, pooler_output); the pooler is
tanh(Dense(token 0)), as HF's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from .common import (
    Dense,
    Embed,
    LayerNorm,
    MultiHeadSelfAttention,
    create_position_ids_from_input_ids,
    get_activation,
    padding_attention_bias,
)


@dataclass(frozen=True)
class TextEncoderConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = 'gelu'
    pad_token_id: int = 0
    # 'absolute' (BERT), 'absolute_offset' (RoBERTa/MPNet: ids start after
    # padding_idx), with optional T5-style relative bias (MPNet).
    position_style: str = 'absolute'
    use_relative_bias: bool = False
    relative_num_buckets: int = 32
    relative_max_distance: int = 128


# Configurations of the four supported checkpoints.
TEXT_CONFIGS = {
    'bert': TextEncoderConfig(vocab_size=30522, hidden_size=768, num_layers=12,
                              num_heads=12, intermediate_size=3072),
    'sentence-bert': TextEncoderConfig(vocab_size=30522, hidden_size=384,
                                       num_layers=6, num_heads=12,
                                       intermediate_size=1536),
    'roberta': TextEncoderConfig(vocab_size=50265, hidden_size=768,
                                 num_layers=12, num_heads=12,
                                 intermediate_size=3072,
                                 max_position_embeddings=514,
                                 type_vocab_size=1, layer_norm_eps=1e-5,
                                 pad_token_id=1,
                                 position_style='absolute_offset'),
    'mpnet': TextEncoderConfig(vocab_size=30527, hidden_size=768,
                               num_layers=12, num_heads=12,
                               intermediate_size=3072,
                               max_position_embeddings=514,
                               type_vocab_size=0, layer_norm_eps=1e-5,
                               pad_token_id=1,
                               position_style='absolute_offset',
                               use_relative_bias=True),
}


class TransformerLayer(nn.Module):
    """Post-LN transformer block (BERT/MPNet layout)."""

    def __init__(self, c: TextEncoderConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = get_activation(c.hidden_act)
        self.attention = MultiHeadSelfAttention(c.hidden_size, c.num_heads,
                                                dtype)
        self.attention_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.intermediate = Dense(c.hidden_size, c.intermediate_size, dtype)
        self.output = Dense(c.intermediate_size, c.hidden_size, dtype)
        self.output_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.attention_norm(x + self.attention(x, bias))
        h = self.output(self.act(self.intermediate(x)))
        return self.output_norm(x + h)


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5 bidirectional relative position bucketing (HF MPNet semantics),
    in JAX's arithmetic: the log in float32, truncated toward zero (a
    float64 log moves buckets at their boundaries)."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    num_buckets //= 2
    ret = ret + (n < 0).to(ret.dtype) * num_buckets
    n = n.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    scaled = (torch.log(n.clamp(min=1).to(torch.float32) / max_exact)
              / math.log(max_distance / max_exact)
              * (num_buckets - max_exact))
    val_if_large = max_exact + scaled.to(torch.int32).to(ret.dtype)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class TextTransformer(nn.Module):
    """BERT-family / MPNet text tower with the tanh pooler."""

    def __init__(self, config: TextEncoderConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        self.word_embeddings = Embed(c.vocab_size, c.hidden_size, dtype)
        self.position_embeddings = Embed(c.max_position_embeddings,
                                         c.hidden_size, dtype)
        if c.type_vocab_size > 0:
            self.token_type_embeddings = Embed(c.type_vocab_size,
                                               c.hidden_size, dtype)
        self.embeddings_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        if c.use_relative_bias:
            self.relative_attention_bias = Embed(c.relative_num_buckets,
                                                 c.num_heads)
        for i in range(c.num_layers):
            self.add_module(f'layer_{i}', TransformerLayer(c, dtype))
        self.pooler = Dense(c.hidden_size, c.hidden_size, dtype)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.config
        B, T = input_ids.shape
        dev = input_ids.device
        input_ids = input_ids.long()
        if attention_mask is None:
            attention_mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        if c.position_style == 'absolute_offset':
            position_ids = create_position_ids_from_input_ids(
                input_ids, c.pad_token_id)
        else:
            position_ids = torch.arange(T, device=dev).expand(B, T)
        x = self.word_embeddings(input_ids) \
            + self.position_embeddings(position_ids)
        if c.type_vocab_size > 0:
            x = x + self.token_type_embeddings(
                torch.zeros((B, T), dtype=torch.int64, device=dev))
        x = self.embeddings_norm(x)

        bias = padding_attention_bias(attention_mask)
        if c.use_relative_bias:
            pos = torch.arange(T, device=dev)
            buckets = relative_position_bucket(
                pos[None, :] - pos[:, None], c.relative_num_buckets,
                c.relative_max_distance)
            rel = self.relative_attention_bias(buckets)  # (T, T, heads)
            bias = bias + rel.permute(2, 0, 1)[None]     # (1, heads, T, T)

        for i in range(c.num_layers):
            x = getattr(self, f'layer_{i}')(x, bias)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled

    def pooled(self, input_ids, attention_mask=None) -> torch.Tensor:
        """The feature the recommender consumes: pooler_output (all four
        models have one)."""
        return self(input_ids, attention_mask)[1]


def build_text_encoder(model_key: str,
                       dtype: torch.dtype = torch.float32
                       ) -> TextTransformer:
    if model_key not in TEXT_CONFIGS:
        raise ValueError(f"Unknown language model key: {model_key}")
    return TextTransformer(TEXT_CONFIGS[model_key], dtype=dtype)
