# pixelrec_multimodal_tpu_torch/models/multimodal.py
"""The multimodal recommender scoring network, in PyTorch.

Counterpart of ``pixelrec_multimodal_tpu/models/multimodal.py``: ID
embeddings (user, item, tag), per-modality projection MLPs over
precomputed encoder features, fusion, and the prediction MLP with
BatchNorm. Submodules carry the Flax names (``Dense_0``, ``BatchNorm_0``,
``user_embedding``, ...) so ``utils/flax_convert.load_flax_variables``
maps a Flax variables tree onto the state dict name by name.

Semantics kept from the JAX model:

* parameters are float32; ``dtype`` is the compute type of embeddings,
  projections and the hidden prediction layers, while the last Dense and
  the scores are float32;
* ``gelu`` is the tanh approximation (Flax ``nn.gelu``), not torch's
  exact default;
* BatchNorm is eps 1e-5 (torch momentum 0.1 is Flax momentum 0.9);
* Dense kernels start from Flax's default init (LeCun normal, zero bias)
  and embeddings from ``embedding_init``, drawn from an explicit
  ``torch.Generator``. The numbers differ from JAX's for the same seed;
  parity tests convert Flax weights instead.

This slice ports eval mode of ``concatenate`` fusion: the module is built
in eval mode and its forward raises in train mode until training is
ported. ``gated`` and ``attention`` fusion raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

MODALITY_ORDER = ('user', 'item', 'tag', 'vision', 'language', 'numerical')

ACTIVATIONS = {
    'relu': F.relu,
    'gelu': partial(F.gelu, approximate='tanh'),
    'tanh': torch.tanh,
    'leaky_relu': partial(F.leaky_relu, negative_slope=0.01),
    'silu': F.silu,
}


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation by name; unknown names fall back to relu, as in JAX."""
    return ACTIVATIONS.get(name.lower(), F.relu)


def final_activation_fn(x: torch.Tensor, name: str) -> torch.Tensor:
    """The score head's last activation: sigmoid, tanh, or none for any
    other name."""
    if name == 'sigmoid':
        return torch.sigmoid(x)
    if name == 'tanh':
        return torch.tanh(x)
    return x


def _variance_scaling(shape: Tuple[int, int], scale: float, mode: str,
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


_EMBEDDING_INITS = {
    'xavier_uniform': (1.0, 'fan_avg', 'uniform'),
    'xavier_normal': (1.0, 'fan_avg', 'truncated_normal'),
    'kaiming_uniform': (2.0, 'fan_in', 'uniform'),
    'kaiming_normal': (2.0, 'fan_in', 'truncated_normal'),
}


def embedding_init(method: str):
    """Embedding-table initializer by name (Flax semantics: the vocabulary
    axis is fan-in); unknown names fall back to xavier_uniform. Returns
    ``init(shape, generator) -> tensor``."""
    scale, mode, dist = _EMBEDDING_INITS.get(
        method.lower(), _EMBEDDING_INITS['xavier_uniform'])
    return partial(_init_with, scale=scale, mode=mode, distribution=dist)


def _init_with(shape, generator, *, scale, mode, distribution):
    return _variance_scaling(shape, scale, mode, distribution, generator)


def _dense(in_dim: int, out_dim: int,
           generator: Optional[torch.Generator]) -> nn.Linear:
    """nn.Linear with Flax Dense's default init (LeCun normal kernel,
    zero bias)."""
    layer = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        layer.weight.copy_(_variance_scaling(
            (in_dim, out_dim), 1.0, 'fan_in', 'truncated_normal',
            generator).T)
        layer.bias.zero_()
    return layer


def _apply_dense(layer: nn.Linear, x: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Flax Dense with ``dtype``: input, kernel and bias cast to dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=dim, keepdim=True),
                           min=eps)


def nan_guard(out: torch.Tensor) -> torch.Tensor:
    """NaN/Inf guard on scores (JAX ``jnp.nan_to_num(nan=0, posinf=10,
    neginf=-10)``)."""
    return torch.nan_to_num(out, nan=0.0, posinf=10.0, neginf=-10.0)


class ProjectionMLP(nn.Module):
    """Per-modality projection into the embedding space: one or two Dense
    layers, each followed by the activation."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: Optional[int],
                 activation: str, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.dtype = dtype
        dims = [in_dim] + ([hidden_dim] if hidden_dim else []) + [out_dim]
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            setattr(self, f'Dense_{i}', _dense(dims[i], dims[i + 1], generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = activation_fn(self.activation)
        for i in range(self.n_layers):
            x = act(_apply_dense(getattr(self, f'Dense_{i}'), x, self.dtype))
        return x


class PredictionMLP(nn.Module):
    """Scoring head: Dense -> act -> [BatchNorm] per hidden layer, then a
    float32 Dense(1) and sigmoid / tanh / none."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 activation: str, use_batch_norm: bool,
                 final_activation: str, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        self.activation = activation
        self.use_batch_norm = use_batch_norm
        self.final_activation = final_activation
        self.dtype = dtype
        prev = in_dim
        for i, h in enumerate(self.hidden_dims):
            setattr(self, f'Dense_{i}', _dense(prev, h, generator))
            if use_batch_norm:
                setattr(self, f'BatchNorm_{i}',
                        nn.BatchNorm1d(h, eps=1e-5, momentum=0.1))
            prev = h
        setattr(self, f'Dense_{len(self.hidden_dims)}',
                _dense(prev, 1, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = activation_fn(self.activation)
        x = x.to(self.dtype)
        for i in range(len(self.hidden_dims)):
            x = act(_apply_dense(getattr(self, f'Dense_{i}'), x, self.dtype))
            if self.use_batch_norm:
                bn = getattr(self, f'BatchNorm_{i}')
                # Statistics are float32: normalise in float32, then cast.
                x = F.batch_norm(x.float(), bn.running_mean, bn.running_var,
                                 bn.weight, bn.bias, False, 0.0,
                                 bn.eps).to(self.dtype)
        last = getattr(self, f'Dense_{len(self.hidden_dims)}')
        x = _apply_dense(last, x.float(), torch.float32)
        return final_activation_fn(x, self.final_activation)


class MultimodalRecommender(nn.Module):
    """Fuses ID embeddings with projected encoder features and scores pairs.

    Built on the CPU from ``generator`` (a fresh one seeded 0 when None),
    then moved to ``device``; evaluation mode only in this slice.
    """

    def __init__(self, n_users: int, n_items: int, n_tags: int,
                 num_numerical_features: int, embedding_dim: int = 128,
                 vision_feature_dim: Optional[int] = None,
                 language_feature_dim: Optional[int] = None,
                 clip_text_feature_dim: int = 512,
                 use_contrastive: bool = True, dropout_rate: float = 0.3,
                 num_attention_heads: int = 4, attention_dropout: float = 0.1,
                 fusion_hidden_dims: Sequence[int] = (512, 256, 128),
                 fusion_activation: str = 'relu', use_batch_norm: bool = True,
                 projection_hidden_dim: Optional[int] = None,
                 final_activation: str = 'sigmoid',
                 init_method: str = 'xavier_uniform',
                 contrastive_temperature: float = 0.07,
                 fusion_type: str = 'concatenate',
                 vision_model_name: Optional[str] = None,
                 language_model_name: Optional[str] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device] = 'cuda'):
        super().__init__()
        if fusion_type in ('gated', 'attention'):
            raise NotImplementedError(
                f"fusion_type={fusion_type!r} is not ported yet: gated fusion "
                "is ROADMAP item A8, attention fusion item A9")
        if fusion_type != 'concatenate':
            raise ValueError(f"Unknown fusion type: '{fusion_type}'")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.n_users, self.n_items, self.n_tags = n_users, n_items, n_tags
        self.num_numerical_features = num_numerical_features
        self.embedding_dim = embedding_dim
        self.vision_feature_dim = vision_feature_dim
        self.language_feature_dim = language_feature_dim
        self.clip_text_feature_dim = clip_text_feature_dim
        self.use_contrastive = use_contrastive
        self.dropout_rate = dropout_rate
        self.num_attention_heads = num_attention_heads
        self.attention_dropout = attention_dropout
        self.fusion_hidden_dims = tuple(fusion_hidden_dims)
        self.fusion_activation = fusion_activation
        self.use_batch_norm = use_batch_norm
        self.projection_hidden_dim = projection_hidden_dim
        self.final_activation = final_activation
        self.init_method = init_method
        self.contrastive_temperature = contrastive_temperature
        self.fusion_type = fusion_type
        self.vision_model_name = vision_model_name
        self.language_model_name = language_model_name
        self.dtype = dtype

        init = embedding_init(init_method)
        d = embedding_dim
        for name, n in (('user_embedding', n_users),
                        ('item_embedding', n_items),
                        ('tag_embedding', n_tags)):
            emb = nn.Embedding(n, d)
            with torch.no_grad():
                emb.weight.copy_(init((n, d), generator))
            setattr(self, name, emb)

        def projection(in_dim):
            return ProjectionMLP(in_dim, d, projection_hidden_dim,
                                 fusion_activation, dtype, generator)

        if vision_feature_dim:
            self.vision_projection = projection(vision_feature_dim)
        if language_feature_dim:
            self.language_projection = projection(language_feature_dim)
        if num_numerical_features > 0:
            self.numerical_projection = projection(num_numerical_features)
        if self.contrastive_active:
            self.vision_contrastive_projection = _dense(
                vision_feature_dim, d, generator)
            self.text_contrastive_projection = _dense(
                clip_text_feature_dim, d, generator)
            self.temperature = nn.Parameter(
                torch.tensor(contrastive_temperature, dtype=torch.float32))
        self.prediction_network = PredictionMLP(
            self.num_modalities * d, self.fusion_hidden_dims,
            fusion_activation, use_batch_norm, final_activation, dtype,
            generator)
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.user_embedding.weight.device

    @property
    def contrastive_active(self) -> bool:
        return bool(self.use_contrastive and self.vision_feature_dim)

    @property
    def num_modalities(self) -> int:
        return (3 + int(self.vision_feature_dim is not None)
                + int(self.language_feature_dim is not None)
                + int(self.num_numerical_features > 0))

    def _embed(self, table: nn.Embedding, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx.long(), table.weight).to(self.dtype)

    def _item_side(self, vision_features, language_features,
                   numerical_features) -> List[torch.Tensor]:
        feats = []
        if self.vision_feature_dim and vision_features is not None:
            feats.append(self.vision_projection(vision_features))
        if self.language_feature_dim and language_features is not None:
            feats.append(self.language_projection(language_features))
        if self.num_numerical_features > 0 and numerical_features is not None:
            feats.append(self.numerical_projection(numerical_features))
        return feats

    # ------------------------------------------------------------------ towers
    def modality_features(self, user_idx: torch.Tensor, item_idx: torch.Tensor,
                          tag_idx: torch.Tensor,
                          vision_features: Optional[torch.Tensor] = None,
                          language_features: Optional[torch.Tensor] = None,
                          numerical_features: Optional[torch.Tensor] = None
                          ) -> List[torch.Tensor]:
        """Per-modality embeddings in fusion order, each (B, D)."""
        return [self._embed(self.user_embedding, user_idx),
                self._embed(self.item_embedding, item_idx),
                self._embed(self.tag_embedding, tag_idx),
                *self._item_side(vision_features, language_features,
                                 numerical_features)]

    def fuse(self, feats: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat(feats, dim=-1)

    def _check_eval(self):
        if self.training:
            raise NotImplementedError(
                'training mode is not ported yet (ROADMAP item A6); call '
                '.eval()')

    def forward(self, user_idx: torch.Tensor, item_idx: torch.Tensor,
                tag_idx: torch.Tensor,
                vision_features: Optional[torch.Tensor] = None,
                language_features: Optional[torch.Tensor] = None,
                numerical_features: Optional[torch.Tensor] = None,
                clip_text_features: Optional[torch.Tensor] = None,
                return_embeddings: bool = False):
        """Eval-mode scores (B, 1); with ``return_embeddings`` the tuple
        (scores, vision_contrastive, text_contrastive, projected_vision)."""
        self._check_eval()
        feats = self.modality_features(user_idx, item_idx, tag_idx,
                                       vision_features, language_features,
                                       numerical_features)
        out = nan_guard(self.prediction_network(self.fuse(feats)))
        if not return_embeddings:
            return out
        vis_contr = txt_contr = proj_vis = None
        if self.contrastive_active and vision_features is not None:
            vis_contr = l2_normalize(
                self.vision_contrastive_projection(vision_features.float()))
            if clip_text_features is not None:
                txt_contr = l2_normalize(self.text_contrastive_projection(
                    clip_text_features.float()))
            proj_vis = self.vision_projection(vision_features)
        return out, vis_contr, txt_contr, proj_vis

    # -------------------------------------------------------------- inference
    def item_tower(self, item_idx: torch.Tensor, tag_idx: torch.Tensor,
                   vision_features: Optional[torch.Tensor] = None,
                   language_features: Optional[torch.Tensor] = None,
                   numerical_features: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """Item-side modality embeddings stacked: (N, M_item, D)."""
        feats = [self._embed(self.item_embedding, item_idx),
                 self._embed(self.tag_embedding, tag_idx),
                 *self._item_side(vision_features, language_features,
                                  numerical_features)]
        return torch.stack(feats, dim=1)

    def user_tower(self, user_idx: torch.Tensor) -> torch.Tensor:
        return self._embed(self.user_embedding, user_idx)

    def score_from_towers(self, user_emb: torch.Tensor,
                          item_feats: torch.Tensor) -> torch.Tensor:
        """Score (B, D) users against (B, M_item, D) item stacks -> (B, 1),
        as ``forward`` in eval mode given precomputed towers."""
        self._check_eval()
        feats = [user_emb] + list(item_feats.unbind(dim=1))
        return nan_guard(self.prediction_network(self.fuse(feats)))
