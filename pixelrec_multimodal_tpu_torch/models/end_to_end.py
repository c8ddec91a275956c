"""End-to-end model: the encoder towers and the multimodal scorer, in
PyTorch.

Counterpart of ``pixelrec_multimodal_tpu/models/end_to_end.py``, the
unfrozen-backbone path: the towers of ``encoders/`` run inside the
scorer's forward on raw pixels and tokens, optionally with gradients.
Freezing is expressed through the optimizer (``trainable_mask`` and
``training/optimizers.with_frozen``), so frozen towers receive neither
updates nor weight decay; ``training/e2e_steps.py`` also takes no
gradient for them.

The children carry the Flax tree's top-level names, ``vision_encoder``,
``language_encoder``, ``clip_text_encoder`` and ``scorer``, so a
parameter's name starts with its subtree, a mask selects a tower by that
prefix, and ``scorer.state_dict()`` is a ``MultimodalRecommender``'s,
ready for ``inference/scorer.CatalogScorer`` after training.

With ``remat_encoders`` each tower's whole forward runs under
``torch.utils.checkpoint.checkpoint`` (``use_reentrant=False``) while
gradients are on: its activations are recomputed in the backward instead
of stored, about one more tower forward of work for much less memory,
the counterpart of JAX's ``nn.remat``. The towers have no dropout, so the
recompute draws nothing and sees the same values.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..encoders.common import random_init_
from ..encoders.registry import (
    build_clip_text_encoder,
    build_language_encoder,
    build_vision_encoder,
)
from .multimodal import MultimodalRecommender, build_model

TOWERS = ('vision_encoder', 'language_encoder', 'clip_text_encoder')


class EndToEndRecommender(nn.Module):
    """Encoders-in-the-graph variant of the recommender.

    Takes raw pixels (B, 3, H, W) and token ids with their masks, pools
    each tower's feature and feeds the scorer. A tower that is None (or
    an input that is None) leaves its modality to the scorer's own
    handling, as in JAX. The towers move to the scorer's device.
    """

    def __init__(self, scorer: MultimodalRecommender,
                 vision_encoder: Optional[nn.Module] = None,
                 language_encoder: Optional[nn.Module] = None,
                 clip_text_encoder: Optional[nn.Module] = None,
                 remat_encoders: bool = False):
        super().__init__()
        self.remat_encoders = remat_encoders
        for name, tower in zip(TOWERS, (vision_encoder, language_encoder,
                                        clip_text_encoder)):
            if tower is not None:
                self.add_module(name, tower.to(scorer.device))
        self.scorer = scorer
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.scorer.device

    @property
    def use_clip_text(self) -> bool:
        return hasattr(self, 'clip_text_encoder')

    def _pooled(self, name: str, *inputs) -> Optional[torch.Tensor]:
        tower = getattr(self, name, None)
        if tower is None or inputs[0] is None:
            return None
        if self.remat_encoders and torch.is_grad_enabled():
            return checkpoint(tower, *inputs, use_reentrant=False,
                              preserve_rng_state=False)[1]
        return tower(*inputs)[1]

    def forward(self, user_idx: torch.Tensor, item_idx: torch.Tensor,
                tag_idx: torch.Tensor,
                image: Optional[torch.Tensor] = None,
                text_input_ids: Optional[torch.Tensor] = None,
                text_attention_mask: Optional[torch.Tensor] = None,
                numerical_features: Optional[torch.Tensor] = None,
                clip_text_input_ids: Optional[torch.Tensor] = None,
                clip_text_attention_mask: Optional[torch.Tensor] = None,
                return_embeddings: bool = False,
                generator: Optional[torch.Generator] = None):
        """The scorer's output on the towers' pooled features: scores
        (B, 1), or with ``return_embeddings`` its 4-tuple. Training mode
        (``model.train()``) reaches the scorer's dropout, which draws from
        ``generator``, and its BatchNorm."""
        return self.scorer(
            user_idx, item_idx, tag_idx,
            vision_features=self._pooled('vision_encoder', image),
            language_features=self._pooled('language_encoder',
                                           text_input_ids,
                                           text_attention_mask),
            numerical_features=numerical_features,
            clip_text_features=self._pooled('clip_text_encoder',
                                            clip_text_input_ids,
                                            clip_text_attention_mask),
            return_embeddings=return_embeddings, generator=generator)


def build_end_to_end_model(model_config: ModelConfig, n_users: int,
                           n_items: int, n_tags: int,
                           num_numerical_features: int,
                           encoder_dtype: torch.dtype = torch.float32,
                           remat_encoders: bool = False, seed: int = 0,
                           device: Union[str, torch.device] = 'cuda'
                           ) -> EndToEndRecommender:
    """The config's scorer (``build_model``, float32, drawn from a
    generator seeded ``seed``) behind the towers its vision and language
    models name, and the CLIP text tower when contrastive learning is
    active. The towers compute in ``encoder_dtype`` on float32
    parameters, drawn by ``encoders.common.random_init_(seed)``; load
    pretrained ones into them by name."""
    scorer = build_model(model_config, n_users, n_items, n_tags,
                         num_numerical_features,
                         generator=torch.Generator().manual_seed(seed),
                         device=device)
    towers = {}
    if model_config.vision_model:
        towers['vision_encoder'] = build_vision_encoder(
            model_config.vision_model, dtype=encoder_dtype)
    if model_config.language_model:
        towers['language_encoder'] = build_language_encoder(
            model_config.language_model, dtype=encoder_dtype)
    if scorer.contrastive_active:
        towers['clip_text_encoder'] = build_clip_text_encoder(
            dtype=encoder_dtype)
    for tower in towers.values():
        random_init_(tower, seed)
    return EndToEndRecommender(scorer, remat_encoders=remat_encoders,
                               **towers)


def trainable_mask(model_or_names: Union[nn.Module, Iterable[str]],
                   freeze_vision: bool = True,
                   freeze_language: bool = True) -> Dict[str, bool]:
    """Parameter name -> trainable: False under a frozen tower, for
    ``training/optimizers.with_frozen``. The CLIP text tower follows
    ``freeze_vision`` (the reference freezes it with the vision model,
    multimodal.py:234-236)."""
    names = ([n for n, _ in model_or_names.named_parameters()]
             if isinstance(model_or_names, nn.Module) else model_or_names)
    frozen = {'vision_encoder': freeze_vision,
              'clip_text_encoder': freeze_vision,
              'language_encoder': freeze_language}
    return {n: not frozen.get(n.split('.', 1)[0], False) for n in names}
