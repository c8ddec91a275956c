"""What the generators share: the port's model built from a configuration and
loaded with the benchmark's weights, and freeing the device."""
from __future__ import annotations

import gc
import time

import torch

from .. import inputs

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def port_model(cfg: dict, weights: dict, device):
    """The port's ``MultimodalRecommender`` of ``cfg`` (``build_model``),
    its weights replaced by the benchmark's, name by name."""
    from pixelrec_multimodal_tpu_torch.config import ModelConfig
    from pixelrec_multimodal_tpu_torch.models.multimodal import build_model
    model = build_model(
        ModelConfig(**cfg['model']), n_users=cfg['n_users'],
        n_items=cfg['n_items'], n_tags=cfg['n_tags'],
        num_numerical_features=cfg['num_numerical_features'],
        dtype=DTYPES[cfg['compute_dtype']], device=device)
    model.load_state_dict(weights, strict=True)
    if set(inputs.feature_widths(cfg)) != {
            k for k in ('vision', 'language', 'numerical')
            if hasattr(model, f'{k}_projection')}:
        raise ValueError('the configuration and the port disagree on the '
                         'item features')
    return model


def free_device(device):
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


class Phases:
    """Host seconds of each phase of a set-up: ``lap(name)`` books the
    seconds since the last lap (or since the object was made)."""

    def __init__(self):
        self.seconds, self._t = {}, time.perf_counter()

    def lap(self, name: str):
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now
