# pixelrec_multimodal_tpu_torch/utils/logging.py
"""Observability: wandb-gated metric logging and JSON artifact helpers.

Counterpart of ``pixelrec_multimodal_tpu/utils/logging.py``. wandb is
optional: without it (or without an active run) every ``maybe_wandb_*``
call does nothing, and results go to prints and local JSON. The JSON
encoder takes numpy scalars and arrays and 0-d torch tensors.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

try:
    import wandb  # type: ignore
    _HAS_WANDB = True
except ImportError:
    wandb = None
    _HAS_WANDB = False


def wandb_available() -> bool:
    return _HAS_WANDB


def maybe_wandb_init(**kwargs) -> bool:
    """wandb.init when the library is present; False otherwise."""
    if not _HAS_WANDB:
        return False
    try:
        wandb.init(**kwargs)
        return True
    except Exception as e:
        print(f"Warning: Failed to initialize wandb: {e}")
        return False


def maybe_wandb_log(train_metrics: Dict[str, float],
                    val_metrics: Dict[str, float], epoch: int, lr: float):
    """Per-epoch train/val metric + LR logging (reference trainer.py:539-558)."""
    if not _HAS_WANDB or wandb.run is None:
        return
    try:
        data = {f'train/{k}': v for k, v in train_metrics.items()}
        for k, v in val_metrics.items():
            if not (isinstance(v, float) and math.isnan(v)):
                data[f'val/{k}'] = v
        data['train/learning_rate'] = lr
        data['epoch'] = epoch
        wandb.log(data, step=epoch)
    except Exception as e:
        print(f"Warning: Failed to log to wandb: {e}")


def maybe_wandb_save_checkpoint(path) -> bool:
    """Upload a best-model checkpoint to the active wandb run (reference
    trainer.py:666-671 wandb.save of the .pth files on best save).
    Checkpoints are directories, so the upload is a glob over the
    checkpoint dir with base_path at its parent (preserving the
    ``<name>/...`` layout in the run files)."""
    if not _HAS_WANDB or wandb.run is None:
        return False
    try:
        p = Path(path)
        wandb.save(str(p / '**'), base_path=str(p.parent))
        return True
    except Exception as e:
        print(f"Warning: Failed to save checkpoint to wandb: {e}")
        return False


def maybe_wandb_finish():
    if _HAS_WANDB and wandb.run is not None:
        try:
            wandb.finish()
        except Exception:
            pass


class NumpyJSONEncoder(json.JSONEncoder):
    """JSON encoder tolerating numpy scalars and arrays and 0-d torch
    tensors."""

    def default(self, o: Any):
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.bool_,)):
            return bool(o)
        if isinstance(o, torch.Tensor) and o.dim() == 0:
            return o.item()
        return super().default(o)


def dump_json(obj: Any, path: str | Path, indent: int = 2):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, 'w') as f:
        json.dump(obj, f, indent=indent, cls=NumpyJSONEncoder)
