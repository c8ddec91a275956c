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
* BatchNorm is eps 1e-5; in training it normalises by the batch's
  statistics in float32, the variance Flax's fast biased one (E[x^2] -
  E[x]^2, clipped at 0), and moves the running statistics as Flax's
  momentum 0.9 does, ``r = 0.9 r + 0.1 b`` (``F.batch_norm`` would move the
  variance by the unbiased one);
* dropout follows ``models/layers.py:dropout``, its masks drawn from the
  ``generator`` the caller passes to ``forward``;
* in a data-parallel step (``parallel/mesh.data_parallel``) BatchNorm's
  training statistics are the global batch's: the sums of x and x^2 are
  summed over 'data' before they divide; an embedding sharded over
  'model' (``parallel/tensor_parallel.py``) looks up through its shard;
* Dense kernels start from Flax's default init (LeCun normal, zero bias)
  and embeddings from ``embedding_init``, drawn from an explicit
  ``torch.Generator``. The numbers differ from JAX's for the same seed;
  parity tests convert Flax weights instead.

``forward`` runs in training mode when the module is (``model.train()``,
Flax's ``train=True``); the towers the scorer calls (``item_tower``,
``user_tower``, ``score_from_towers``) always run in eval mode, as in JAX.
The module is built in eval mode. ``build_model`` builds one from a
``config.ModelConfig``.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..config import MODEL_CONFIGS, ModelConfig
from ..device import resolve_device
from .layers import (
    AttentionFusionLayer,
    GatedFusionLayer,
    apply_dense,
    dense,
    dropout,
    variance_scaling,
)
from ..parallel.mesh import data_shard, sum_data
from .losses import l2_normalize

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
    return variance_scaling(shape, scale, mode, distribution, generator)


def nan_guard(out: torch.Tensor) -> torch.Tensor:
    """NaN/Inf guard on scores (JAX ``jnp.nan_to_num(nan=0, posinf=10,
    neginf=-10)``)."""
    return torch.nan_to_num(out, nan=0.0, posinf=10.0, neginf=-10.0)


class ProjectionMLP(nn.Module):
    """Per-modality projection into the embedding space: one or two Dense
    layers, each followed by the activation and dropout."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: Optional[int],
                 activation: str, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        dims = [in_dim] + ([hidden_dim] if hidden_dim else []) + [out_dim]
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            setattr(self, f'Dense_{i}', dense(dims[i], dims[i + 1], generator))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        act = activation_fn(self.activation)
        for i in range(self.n_layers):
            x = act(apply_dense(getattr(self, f'Dense_{i}'), x, self.dtype))
            x = dropout(x, self.dropout_rate, train, generator)
        return x


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm1d,
                     momentum: float = 0.9) -> torch.Tensor:
    """Flax ``nn.BatchNorm(use_running_average=False)`` on x [B, C]: the
    batch's mean and fast biased variance in float32, the running
    statistics moved to ``momentum * r + (1 - momentum) * b`` in place, and
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32."""
    xf = x.float()
    shard = data_shard()
    if shard is None:
        mean = xf.mean(dim=0)
        var = torch.clamp((xf * xf).mean(dim=0) - mean * mean, min=0.0)
    else:
        sums = sum_data(shard.mesh, torch.cat([xf.sum(dim=0),
                                               (xf * xf).sum(dim=0)]))
        mean, msq = (sums / shard.total).chunk(2)
        var = torch.clamp(msq - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.copy_(momentum * bn.running_mean
                              + (1.0 - momentum) * mean)
        bn.running_var.copy_(momentum * bn.running_var
                             + (1.0 - momentum) * var)
    return (xf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


class PredictionMLP(nn.Module):
    """Scoring head: Dense -> act -> [BatchNorm] -> dropout per hidden
    layer, then a float32 Dense(1) and sigmoid / tanh / none."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 activation: str, use_batch_norm: bool,
                 final_activation: str, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.hidden_dims = tuple(hidden_dims)
        self.activation = activation
        self.use_batch_norm = use_batch_norm
        self.final_activation = final_activation
        self.dtype = dtype
        prev = in_dim
        for i, h in enumerate(self.hidden_dims):
            setattr(self, f'Dense_{i}', dense(prev, h, generator))
            if use_batch_norm:
                setattr(self, f'BatchNorm_{i}',
                        nn.BatchNorm1d(h, eps=1e-5, momentum=0.1))
            prev = h
        setattr(self, f'Dense_{len(self.hidden_dims)}',
                dense(prev, 1, generator))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        act = activation_fn(self.activation)
        x = x.to(self.dtype)
        for i in range(len(self.hidden_dims)):
            x = act(apply_dense(getattr(self, f'Dense_{i}'), x, self.dtype))
            if self.use_batch_norm:
                bn = getattr(self, f'BatchNorm_{i}')
                # Statistics are float32: normalise in float32, then cast.
                if train:
                    x = batch_norm_train(x, bn).to(self.dtype)
                else:
                    x = F.batch_norm(x.float(), bn.running_mean,
                                     bn.running_var, bn.weight, bn.bias,
                                     False, 0.0, bn.eps).to(self.dtype)
            x = dropout(x, self.dropout_rate, train, generator)
        last = getattr(self, f'Dense_{len(self.hidden_dims)}')
        x = apply_dense(last, x.float(), torch.float32)
        return final_activation_fn(x, self.final_activation)


class MultimodalRecommender(nn.Module):
    """Fuses ID embeddings with projected encoder features and scores pairs.

    Built on the CPU from ``generator`` (a fresh one seeded 0 when None),
    then moved to ``device``, in eval mode.
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
        if fusion_type not in ('concatenate', 'gated', 'attention'):
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
                                 fusion_activation, dtype, generator,
                                 dropout_rate)

        if vision_feature_dim:
            self.vision_projection = projection(vision_feature_dim)
        if language_feature_dim:
            self.language_projection = projection(language_feature_dim)
        if num_numerical_features > 0:
            self.numerical_projection = projection(num_numerical_features)
        if self.contrastive_active:
            self.vision_contrastive_projection = dense(
                vision_feature_dim, d, generator)
            self.text_contrastive_projection = dense(
                clip_text_feature_dim, d, generator)
            self.temperature = nn.Parameter(
                torch.tensor(contrastive_temperature, dtype=torch.float32))
        if fusion_type == 'gated':
            self.fusion_layer = GatedFusionLayer(
                d, self.num_modalities, dropout_rate, dtype, generator)
        elif fusion_type == 'attention':
            self.fusion_layer = AttentionFusionLayer(
                d, num_attention_heads, attention_dropout, dtype, generator)
        self.prediction_network = PredictionMLP(
            self.num_modalities * d if fusion_type == 'concatenate' else d,
            self.fusion_hidden_dims,
            fusion_activation, use_batch_norm, final_activation, dtype,
            generator, dropout_rate)
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
        tp = getattr(table, 'tp', None)
        if tp is not None:
            return tp.embedding(table, idx).to(self.dtype)
        return F.embedding(idx.long(), table.weight).to(self.dtype)

    def _item_side(self, vision_features, language_features,
                   numerical_features, train: bool = False,
                   generator: Optional[torch.Generator] = None
                   ) -> List[torch.Tensor]:
        feats = []
        for dim, name, x in (
                (self.vision_feature_dim, 'vision', vision_features),
                (self.language_feature_dim, 'language', language_features),
                (self.num_numerical_features, 'numerical',
                 numerical_features)):
            if dim and x is not None:
                feats.append(getattr(self, f'{name}_projection')(
                    x, train, generator))
        return feats

    # ------------------------------------------------------------------ towers
    def modality_features(self, user_idx: torch.Tensor, item_idx: torch.Tensor,
                          tag_idx: torch.Tensor,
                          vision_features: Optional[torch.Tensor] = None,
                          language_features: Optional[torch.Tensor] = None,
                          numerical_features: Optional[torch.Tensor] = None,
                          train: bool = False,
                          generator: Optional[torch.Generator] = None
                          ) -> List[torch.Tensor]:
        """Per-modality embeddings in fusion order, each (B, D)."""
        return [self._embed(self.user_embedding, user_idx),
                self._embed(self.item_embedding, item_idx),
                self._embed(self.tag_embedding, tag_idx),
                *self._item_side(vision_features, language_features,
                                 numerical_features, train, generator)]

    def fuse(self, feats: List[torch.Tensor], train: bool = False,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.fusion_type == 'concatenate':
            return torch.cat(feats, dim=-1)
        return self.fusion_layer(torch.stack(feats, dim=1),  # (B, M, D)
                                 train, generator)

    def forward(self, user_idx: torch.Tensor, item_idx: torch.Tensor,
                tag_idx: torch.Tensor,
                vision_features: Optional[torch.Tensor] = None,
                language_features: Optional[torch.Tensor] = None,
                numerical_features: Optional[torch.Tensor] = None,
                clip_text_features: Optional[torch.Tensor] = None,
                return_embeddings: bool = False,
                generator: Optional[torch.Generator] = None):
        """Scores (B, 1); with ``return_embeddings`` the tuple (scores,
        vision_contrastive, text_contrastive, projected_vision). In training
        mode (``self.training``) dropout draws its masks from ``generator``
        (on the model's device; torch's default one when None) and
        BatchNorm uses the batch's statistics and moves its running
        ones."""
        train = self.training
        feats = self.modality_features(user_idx, item_idx, tag_idx,
                                       vision_features, language_features,
                                       numerical_features, train, generator)
        out = nan_guard(self.prediction_network(
            self.fuse(feats, train, generator), train, generator))
        if not return_embeddings:
            return out
        vis_contr = txt_contr = proj_vis = None
        if self.contrastive_active and vision_features is not None:
            vis_contr = l2_normalize(
                self.vision_contrastive_projection(vision_features.float()))
            if clip_text_features is not None:
                txt_contr = l2_normalize(self.text_contrastive_projection(
                    clip_text_features.float()))
            proj_vis = self.vision_projection(vision_features, train,
                                              generator)
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
        feats = [user_emb] + list(item_feats.unbind(dim=1))
        return nan_guard(self.prediction_network(self.fuse(feats)))


def build_model(model_config: ModelConfig, n_users: int, n_items: int,
                n_tags: int, num_numerical_features: int,
                dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None,
                device: Union[str, torch.device] = 'cuda'
                ) -> MultimodalRecommender:
    """The recommender of a ``ModelConfig``: the backbones' output widths
    from ``MODEL_CONFIGS``, and contrastive learning only with CLIP vision
    (the JAX package's and the reference's gate)."""
    v = model_config.vision_model
    lang = model_config.language_model
    return MultimodalRecommender(
        n_users=n_users, n_items=n_items, n_tags=n_tags,
        num_numerical_features=num_numerical_features,
        embedding_dim=model_config.embedding_dim,
        vision_feature_dim=MODEL_CONFIGS['vision'][v]['dim'] if v else None,
        language_feature_dim=(MODEL_CONFIGS['language'][lang]['dim']
                              if lang else None),
        clip_text_feature_dim=MODEL_CONFIGS['vision']['clip'].get(
            'text_dim', 512),
        use_contrastive=model_config.use_contrastive and v == 'clip',
        dropout_rate=model_config.dropout_rate,
        num_attention_heads=model_config.num_attention_heads,
        attention_dropout=model_config.attention_dropout,
        fusion_hidden_dims=tuple(model_config.fusion_hidden_dims),
        fusion_activation=model_config.fusion_activation,
        use_batch_norm=model_config.use_batch_norm,
        projection_hidden_dim=model_config.projection_hidden_dim,
        final_activation=model_config.final_activation,
        init_method=model_config.init_method,
        contrastive_temperature=model_config.contrastive_temperature,
        fusion_type=model_config.fusion_type,
        vision_model_name=v, language_model_name=lang,
        dtype=dtype, generator=generator, device=device)
