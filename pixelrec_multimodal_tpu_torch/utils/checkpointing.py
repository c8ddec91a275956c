# pixelrec_multimodal_tpu_torch/utils/checkpointing.py
"""Checkpoint save and restore: torch tensors for the state, JSON for the
metadata.

Counterpart of ``pixelrec_multimodal_tpu/utils/checkpointing.py`` with the
same directory contract, ``<checkpoint_dir>/<vision>_<language>/
{best_model,last_model}`` beside a shared ``encoders/`` directory, each
checkpoint a directory:

    <name>/state.pt      torch.save of a dict of CPU tensors (parameters,
                         BatchNorm statistics, the optimizer state by
                         field, the step), where the JAX package writes
                         an Orbax ``state/`` directory
    <name>/meta.json     epoch, best score, metric and direction, history,
                         best_metrics, scheduler_state, trial_info,
                         model_config

The state loads with ``weights_only=True`` (tensors, dicts, lists and
numbers; no pickled code) onto the device the caller names. The
reference's ``.pth`` names map to the ``best_model`` / ``last_model``
directories; the discovery helpers accept both spellings.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from .logging import NumpyJSONEncoder

STATE_FILE = 'state.pt'
META_FILE = 'meta.json'


def normalize_checkpoint_name(filename: str) -> str:
    """'best_model.pth' -> 'best_model' (keeps reference CLI args working)."""
    for ext in ('.pth', '.ckpt', '.pt'):
        if filename.endswith(ext):
            return filename[: -len(ext)]
    return filename


def _on_cpu(tree):
    """``tree`` (dicts, lists, tensors, numbers) with every tensor a
    detached CPU copy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    if isinstance(tree, dict):
        return {k: _on_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_on_cpu(v) for v in tree]
    return tree


def save_checkpoint(directory: Union[str, Path], name: str,
                    state: Dict[str, Any], meta: Dict[str, Any]) -> Path:
    """Write ``state`` (tensors, on any device) to ``state.pt`` and ``meta``
    to ``meta.json`` under directory/name/; each file is written beside its
    place and then renamed over it, so a reader never sees half a file."""
    root = Path(directory).absolute() / normalize_checkpoint_name(name)
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / (STATE_FILE + '.tmp')
    torch.save(_on_cpu(state), tmp)
    os.replace(tmp, root / STATE_FILE)
    tmp = root / (META_FILE + '.tmp')
    with open(tmp, 'w') as f:
        json.dump(meta, f, indent=2, cls=NumpyJSONEncoder)
    os.replace(tmp, root / META_FILE)
    return root


def load_checkpoint(directory: Union[str, Path], name: str,
                    device: Union[str, torch.device] = 'cpu'
                    ) -> Optional[Dict[str, Any]]:
    """{'state': ..., 'meta': ...} with the state's tensors on ``device``;
    None when the checkpoint is absent."""
    root = Path(directory).absolute() / normalize_checkpoint_name(name)
    path = root / STATE_FILE
    if not path.exists():
        return None
    state = torch.load(path, map_location=device, weights_only=True)
    meta = {}
    if (root / META_FILE).exists():
        with open(root / META_FILE) as f:
            meta = json.load(f)
    return {'state': state, 'meta': meta}


@torch.no_grad()
def load_model_state(model: torch.nn.Module, state: Dict[str, Any]) -> None:
    """Copy a checkpoint's parameters and BatchNorm statistics into
    ``model``'s own tensors, in place: a model under training holds its
    trainable parameters as views of the optimizer's flat buffer, which
    rebinding them (``load_state_dict(assign=True)``, ``.data =``) would
    cut."""
    params = state['params']
    for name, p in model.named_parameters():
        if name not in params:
            raise KeyError(f'checkpoint lacks parameter {name!r}')
        p.copy_(params[name])
    buffers = dict(model.named_buffers())
    for name, value in state.get('batch_stats', {}).items():
        buffers[name].copy_(value)


def checkpoint_exists(directory: Union[str, Path], name: str) -> bool:
    return (Path(directory).absolute() / normalize_checkpoint_name(name)
            / STATE_FILE).exists()


def find_checkpoint(base_dir: Union[str, Path],
                    preferred: tuple = ('best_model', 'last_model')
                    ) -> Optional[Path]:
    """Locate a checkpoint directory under base_dir with fallback names
    (the reference's discovery order)."""
    base = Path(base_dir)
    if not base.exists():
        return None
    for name in preferred:
        cand = base / normalize_checkpoint_name(name)
        if (cand / STATE_FILE).exists():
            return cand
    # Any checkpoint directory at all.
    for cand in sorted(base.iterdir()):
        if cand.is_dir() and (cand / STATE_FILE).exists():
            return cand
    return None
