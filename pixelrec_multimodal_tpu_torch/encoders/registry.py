# pixelrec_multimodal_tpu_torch/encoders/registry.py
"""Encoder registry: the towers by ``MODEL_CONFIGS`` key.

Counterpart of ``pixelrec_multimodal_tpu/encoders/registry.py``. Every
tower has a ``pooled`` method giving the feature the recommender consumes
and a ``dtype`` (float32 by default, bfloat16 allowed) in which its
products and convolutions run.
"""
from __future__ import annotations

import torch

from ..config import MODEL_CONFIGS
from .clip import CLIPTextTower, CLIPVisionTower
from .convnext import ConvNextTower
from .dinov2 import Dinov2Tower
from .resnet import ResNetTower
from .text_models import TextTransformer, build_text_encoder

_VISION = {'clip': CLIPVisionTower, 'dino': Dinov2Tower,
           'resnet': ResNetTower, 'convnext': ConvNextTower}


def build_vision_encoder(model_key: str, dtype: torch.dtype = torch.float32):
    """Vision tower for a ``MODEL_CONFIGS['vision']`` key."""
    if model_key not in _VISION:
        raise ValueError(f"Unknown vision model key: {model_key}")
    return _VISION[model_key](dtype=dtype)


def build_language_encoder(model_key: str,
                           dtype: torch.dtype = torch.float32
                           ) -> TextTransformer:
    """Language tower for a ``MODEL_CONFIGS['language']`` key."""
    return build_text_encoder(model_key, dtype=dtype)


def build_clip_text_encoder(dtype: torch.dtype = torch.float32
                            ) -> CLIPTextTower:
    """The CLIP text tower of the contrastive stream."""
    return CLIPTextTower(dtype=dtype)


def pooled_dim(modality: str, model_key: str) -> int:
    """Width of the pooled feature, as registered in MODEL_CONFIGS."""
    if modality == 'clip_text':
        return MODEL_CONFIGS['vision']['clip']['text_dim']
    return MODEL_CONFIGS[modality][model_key]['dim']
