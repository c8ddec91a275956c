# pixelrec_multimodal_tpu_torch/models/layers.py
"""Layer building blocks of the port's model, in PyTorch.

Counterpart of ``pixelrec_multimodal_tpu/models/layers.py``: the gated
and attention fusion layers, ``CrossModalAttention`` (a library module the
recommender does not use, as in JAX), dropout, and the Flax-style Dense
helpers the model's modules share.

Every layer takes ``train`` (Flax's ``train=``, not ``nn.Module.training``:
the scorer's towers run in eval mode whatever mode the module is in) and a
``generator`` for its dropout masks. Dropout follows Flax's: a rate of 0
is the identity, otherwise a kept entry is ``x / keep_prob`` with
``keep_prob = 1 - rate``. The masks come from torch's generator, so they
differ from JAX's for the same seed; tests compare at dropout 0 and hold
the mask rate. In a data-parallel step (``parallel/mesh.data_parallel``)
a per-example mask is drawn for the global batch and each rank keeps its
rows, so the ranks draw one process's masks. A Dense whose kernel is
sharded over the mesh's 'model' axis (``parallel/tensor_parallel.py``)
computes through its shard.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import data_shard


def dropout_mask(shape, rate: float, generator: Optional[torch.Generator],
                 device, per_example: bool = False) -> torch.Tensor:
    """A bool keep-mask of ``shape``: each entry kept with probability
    ``1 - rate``, drawn from ``generator`` (torch's default one when
    None) on ``device``. A ``per_example`` mask (rows = the batch) inside
    a data-parallel step is drawn for the global batch, and this rank's
    rows are kept."""
    shard = data_shard() if per_example else None
    if shard is None:
        return torch.rand(shape, generator=generator,
                          device=device) < 1.0 - rate
    full = torch.rand((shard.total,) + tuple(shape[1:]), generator=generator,
                      device=device)
    return full[shard.rows] < 1.0 - rate


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flax ``nn.Dropout(rate, deterministic=not train)``: the identity out
    of training or at rate 0, else ``where(keep, x / keep_prob, 0)``."""
    if not train or rate == 0.0:
        return x
    keep = dropout_mask(x.shape, rate, generator, x.device, per_example=True)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


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
    tp = getattr(layer, 'tp', None)
    if tp is not None:
        return tp.linear(layer, x, dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class CrossModalAttention(nn.Module):
    """Single-head scaled dot-product attention, vision queries text:
    pooled (B, D) or token-level (B, T, D) features, the output shaped as
    the query. A library module: like the JAX package's, the recommender
    does not use it. The projections carry the Flax names
    (``query_projection``, ``key_projection``, ``value_projection``) and
    compute in float32."""

    def __init__(self, vision_dim: int, text_dim: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = dim
        self.query_projection = dense(vision_dim, dim, generator)
        self.key_projection = dense(text_dim, dim, generator)
        self.value_projection = dense(text_dim, dim, generator)

    def forward(self, vision_features: torch.Tensor,
                text_features: torch.Tensor) -> torch.Tensor:
        q = self.query_projection(vision_features)
        k = self.key_projection(text_features)
        v = self.value_projection(text_features)
        squeeze_out = q.dim() == 2
        q, k, v = (t[:, None, :] if t.dim() == 2 else t for t in (q, k, v))
        scores = torch.einsum('bqd,bkd->bqk', q, k) / math.sqrt(self.dim)
        out = torch.einsum('bqk,bkd->bqd', torch.softmax(scores, dim=-1), v)
        if squeeze_out and out.shape[1] == 1:
            out = out[:, 0, :]
        return out


class GatedFusionLayer(nn.Module):
    """Softmax-gated weighted sum of the modalities, with dropout on the
    concatenated modalities before the gate in training. The child Linear
    is named ``gating`` as the Flax Dense is, so
    ``params/fusion_layer/gating/{kernel,bias}`` converts by name."""

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

    def forward(self, features: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """features: (B, num_modalities, D) -> (B, D)."""
        concat = features.reshape(features.shape[0],
                                  self.num_modalities * self.embedding_dim)
        concat = dropout(concat, self.dropout_rate, train, generator)
        gates = torch.softmax(apply_dense(self.gating, concat, self.dtype),
                              dim=-1)
        return (features * gates[:, :, None]).sum(dim=1)


class MultiHeadAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` called as ``(x, x)``: queries,
    keys and values all come from the same tokens. The query is scaled by
    1/sqrt(dh) before the logits, and the softmax runs over the keys; in
    training, dropout at ``dropout_rate`` on the attention weights with one
    [T, T] mask broadcast over the batch and the heads (Flax's
    ``broadcast_dropout``). ``query``, ``key``, ``value`` and ``out`` are
    the Flax names; the heads of each projection are flattened heads-major
    (``utils/flax_convert.py`` reshapes Flax's [D, H, dh] kernels)."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        if embedding_dim % num_heads:
            raise ValueError(f'embedding_dim {embedding_dim} is not a '
                             f'multiple of num_heads {num_heads}')
        self.num_heads = num_heads
        self.head_dim = embedding_dim // num_heads
        self.dtype = dtype
        for name in ('query', 'key', 'value'):
            setattr(self, name, dense(embedding_dim, embedding_dim,
                                      generator))
        self.out = dense(embedding_dim, embedding_dim, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T, D) -> (B, T, D)."""
        B, T, _ = x.shape
        H, dh = self.num_heads, self.head_dim

        def heads(layer):
            return apply_dense(layer, x, self.dtype).reshape(B, T, H, dh)

        q = heads(self.query) / math.sqrt(dh)
        k, v = heads(self.key), heads(self.value)
        w = torch.softmax(torch.einsum('bqhd,bkhd->bhqk', q, k), dim=-1)
        if train and self.dropout_rate > 0.0:
            keep_prob = 1.0 - self.dropout_rate
            keep = dropout_mask((1, 1, T, T), self.dropout_rate, generator,
                                x.device)
            w = w * (keep.to(w.dtype) / torch.tensor(keep_prob, dtype=w.dtype))
        o = torch.einsum('bhqk,bkhd->bqhd', w, v).reshape(B, T, H * dh)
        return apply_dense(self.out, o, self.dtype)


class AttentionFusionLayer(nn.Module):
    """Self-attention fusion over the modality tokens: multi-head
    self-attention (attention dropout at ``dropout_rate`` in training),
    dropout on its output, the residual,
    LayerNorm with Flax's eps 1e-6 (torch's default is 1e-5) in float32,
    then the mean over tokens. The children are named ``attention`` and
    ``norm`` as in Flax, so ``params/fusion_layer/{attention,norm}``
    convert by name."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 dropout_rate: float, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.attention = MultiHeadAttention(embedding_dim, num_heads, dtype,
                                            generator, dropout_rate)
        self.norm = nn.LayerNorm(embedding_dim, eps=1e-6)

    def forward(self, features: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """features: (B, T, D) -> (B, D) float32."""
        attn = dropout(self.attention(features, train, generator),
                       self.dropout_rate, train, generator)
        x = (features + attn).float()
        return F.layer_norm(x, (self.embedding_dim,), self.norm.weight,
                            self.norm.bias, self.norm.eps).mean(dim=1)
