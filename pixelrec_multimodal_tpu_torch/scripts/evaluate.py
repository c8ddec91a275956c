# pixelrec_multimodal_tpu_torch/scripts/evaluate.py
"""The evaluate entry point's helpers: checkpoint and encoder discovery,
and the ``--cascade`` argument type.

Counterparts of ``find_model_checkpoint``, ``find_encoders`` and
``cascade_arg`` in the repo's ``scripts/evaluate.py``, which the
generate entry point imports from here as the JAX script does. The
entry point itself (``main``, ``create_recommender``) lands with the
evaluation tasks and the baselines, in the evaluate slice.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Optional

from ..config import Config
from ..utils.checkpointing import (
    STATE_FILE,
    find_checkpoint,
    normalize_checkpoint_name,
)


def _refuse_orbax(path: Path):
    """A checkpoint directory the JAX package wrote (an Orbax ``state/``
    directory, no ``state.pt``) raises: the port reads only its own."""
    if (path / 'state').is_dir() and not (path / STATE_FILE).exists():
        raise ValueError(
            f'{path} holds a JAX-package checkpoint (an Orbax state/ '
            f'directory) and no {STATE_FILE}: the port cannot read it; '
            'train with pixelrec_multimodal_tpu_torch.scripts.train')


def find_model_checkpoint(config: Config,
                          checkpoint_name: str = 'best_model'
                          ) -> Optional[Path]:
    """Locate a checkpoint directory: the name, ``best_model`` and
    ``last_model`` under the model's directory, then the name under the
    checkpoint root, then any checkpoint under either. A named candidate
    that holds only a JAX-package checkpoint raises."""
    name = normalize_checkpoint_name(checkpoint_name)
    model_dir = Path(config.model_specific_checkpoint_dir)
    root = Path(config.checkpoint_dir)
    for c in (model_dir / name, model_dir / 'best_model',
              model_dir / 'last_model', root / name):
        _refuse_orbax(c)
        if (c / STATE_FILE).exists():
            return c
    found = find_checkpoint(model_dir)
    return found if found is not None else find_checkpoint(root)


def find_encoders(config: Config) -> Optional[Dict[str, object]]:
    """Load the pickled user, item (and tag) encoders from the shared
    encoders directory, the checkpoint root or the model's directory;
    None unless both the user and the item encoder are found. An encoder
    the JAX package pickled (scikit-learn's class) raises: the port's
    ``extract_encoders`` rewrites the encoders in the port's classes."""
    search_dirs = [Path(config.shared_encoders_dir),
                   Path(config.checkpoint_dir),
                   Path(config.model_specific_checkpoint_dir)]
    encoders = {}
    for name in ('user_encoder', 'item_encoder', 'tag_encoder'):
        for d in search_dirs:
            p = d / f'{name}.pkl'
            if p.exists():
                try:
                    encoders[name] = pickle.loads(p.read_bytes())
                except ImportError as e:
                    if not (e.name or '').startswith('sklearn'):
                        raise
                    raise ImportError(
                        f'{p} needs scikit-learn to unpickle (the JAX '
                        'package wrote it); rewrite the encoders in the '
                        "port's classes with `python -m "
                        'pixelrec_multimodal_tpu_torch.scripts.'
                        'extract_encoders --config <config>`') from e
                break
    if 'user_encoder' not in encoders or 'item_encoder' not in encoders:
        return None
    return encoders


def cascade_arg(v: str):
    """--cascade accepts an explicit candidate count or 'auto'."""
    return 'auto' if v == 'auto' else int(v)
