# pixelrec_multimodal_tpu_torch/encoders/common.py
"""Shared building blocks of the frozen encoder towers, in PyTorch.

Counterpart of ``pixelrec_multimodal_tpu/encoders/common.py``. The towers
carry the Flax modules' names, so a Flax parameter tree maps onto their
state dicts by ``utils/flax_convert.encoder_state_dict``. Their arithmetic
follows the Flax modules: a ``Dense`` or a convolution computes in the
tower's ``dtype`` (its float32 parameters cast to it, as Flax's ``dtype=``
does), a LayerNorm in float32, the attention softmax in float32 and then
cast back. The attention is written as plain tensor operations with
Flax's arithmetic, not ``scaled_dot_product_attention``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

# The additive bias on masked attention positions (HF's extended attention
# mask); -1e9, not -inf, so a fully masked row stays finite.
MASK_BIAS = -1e9


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


ACT2FN = {
    'gelu': lambda x: F.gelu(x, approximate='none'),
    'gelu_new': lambda x: F.gelu(x, approximate='tanh'),
    'quick_gelu': quick_gelu,
    'relu': F.relu,
    'silu': F.silu,
    'tanh': torch.tanh,
}


def get_activation(name: str) -> Callable:
    return ACT2FN.get(name, ACT2FN['gelu'])


class Dense(nn.Linear):
    """Flax ``nn.Dense(dtype=...)``: float32 parameters, the product in
    ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv(nn.Conv2d):
    """Flax ``nn.Conv`` on NCHW tensors: float32 parameters, the
    convolution in ``dtype``. ``padding='SAME'`` pads as Flax (and
    TensorFlow) do, the odd pixel after; an int pads both sides."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, padding='SAME', groups: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=0, groups=groups, bias=bias)
        self.same = padding == 'SAME'
        self.pad = 0 if self.same else int(padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.same:
            x = F.pad(x, _same_padding(x.shape[3], self.kernel_size[1],
                                       self.stride[1])
                      + _same_padding(x.shape[2], self.kernel_size[0],
                                      self.stride[0]))
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.pad, 1, self.groups)


def _same_padding(size: int, kernel: int, stride: int) -> tuple:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return (total // 2, total - total // 2)


class LayerNorm(nn.LayerNorm):
    """Flax ``nn.LayerNorm`` over the last axis, computed in float32 (a
    bf16 input promotes with the float32 parameters, as in Flax)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class Embed(nn.Embedding):
    """Flax ``nn.Embed(dtype=...)``: the table's rows cast to ``dtype``."""

    def __init__(self, num: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num, features)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.weight).to(self.compute_dtype)


class MultiHeadSelfAttention(nn.Module):
    """Multi-head self-attention with separate q/k/v/out projections
    (HF weight layout: each [hidden, hidden] + bias)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.query = Dense(hidden_size, hidden_size, dtype)
        self.key = Dense(hidden_size, hidden_size, dtype)
        self.value = Dense(hidden_size, hidden_size, dtype)
        self.out = Dense(hidden_size, hidden_size, dtype)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, T, H). bias: additive, broadcastable to (B, heads, T, T):
        padding masks, causal masks, MPNet's relative position bias."""
        B, T, H = x.shape
        d = H // self.num_heads

        def heads(t):
            return t.reshape(B, T, self.num_heads, d).transpose(1, 2)
        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        # As in JAX: the scale is an array of x's dtype, so a bf16 product
        # of a float32 input promotes to float32 there.
        wide = torch.promote_types(q.dtype, x.dtype)
        scores = torch.matmul(q, k.transpose(-1, -2)).to(wide) / math.sqrt(d)
        if bias is not None:
            scores = scores + bias
        weights = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        wide = torch.promote_types(x.dtype, v.dtype)
        out = torch.matmul(weights.to(wide), v.to(wide))
        return self.out(out.transpose(1, 2).reshape(B, T, H))


def padding_attention_bias(attention_mask: torch.Tensor,
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """(B, T) 1/0 mask -> additive bias (B, 1, 1, T): MASK_BIAS on pads."""
    bias = (1.0 - attention_mask.to(dtype)) * MASK_BIAS
    return bias[:, None, None, :]


def causal_attention_bias(T: int, dtype: torch.dtype = torch.float32,
                          device=None) -> torch.Tensor:
    """(1, 1, T, T) lower-triangular causal bias."""
    keep = torch.tril(torch.ones((T, T), dtype=torch.bool, device=device))
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(keep, zero, zero + MASK_BIAS)[None, None]


def create_position_ids_from_input_ids(input_ids: torch.Tensor,
                                       padding_idx: int) -> torch.Tensor:
    """RoBERTa/MPNet position ids: pads keep ``padding_idx``, real tokens
    count from ``padding_idx + 1``."""
    mask = (input_ids != padding_idx).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + padding_idx


# Bare parameters of the towers drawn like HF's embeddings at random init.
_EMBEDDING_PARAMS = ('class_embedding', 'position_embedding', 'cls_token',
                     'position_embeddings')


def random_init_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill ``model`` with random weights from ``torch.Generator(seed)``,
    drawn on the host in the order of ``named_modules``, so the same seed
    gives the same weights on any device: products and convolutions
    normal with variance 1/fan_in, their biases 0; embeddings, class and
    position tokens normal(0, 0.02); LayerNorms and frozen BatchNorms the
    identity. Layer scales keep their configured initial values."""
    gen = torch.Generator().manual_seed(seed)

    def fill(t: torch.Tensor, std: float):
        t.copy_(torch.randn(t.shape, generator=gen) * std)

    with torch.no_grad():
        for _, mod in model.named_modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fill(mod.weight, 1.0 / math.sqrt(mod.weight[0].numel()))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                fill(mod.weight, 0.02)
            elif isinstance(mod, nn.LayerNorm) or hasattr(mod,
                                                          'running_var'):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if hasattr(mod, 'running_var'):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
            for name, p in mod.named_parameters(recurse=False):
                if name in _EMBEDDING_PARAMS:
                    fill(p, 0.02)
    return model


@contextlib.contextmanager
def no_tf32():
    """float32 products and convolutions in full float32 on the card for
    the scope of the block: cuDNN's convolutions run in TF32 by default,
    which puts a tower about 1e-3 from the CPU."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
