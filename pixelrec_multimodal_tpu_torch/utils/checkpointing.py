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

On a mesh (``parallel/mesh.py``) the file is the one a single process
writes, with the same names: the shards of parameters split over 'model'
(``parallel/tensor_parallel.py``), and of their optimizer moments, are
gathered by name into the whole tensors first (``gather_state``), rank 0
writes, and the others wait at a barrier. Loading onto a mesh reads the
whole file on every rank and keeps the rank's slices (``shard_state``),
so a checkpoint written on any mesh loads in one process bit for bit, and
the other way round.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Union

import torch

from ..parallel.mesh import MODEL_AXIS, barrier, is_main_rank, param_shard
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


# The optimizer state's fields that lie over the flat parameter buffer.
_FLAT_FIELDS = ('mu', 'nu', 'trace', 'acc')


def _flat_parts(state: Dict[str, Any], field: str) -> List[torch.Tensor]:
    """``state['opt_state'][field]`` split into one tensor per trainable
    parameter, each in its parameter's shape."""
    opt = state['opt_state']
    flat, out, offset = opt[field], [], 0
    for n in opt['names']:
        shape = state['params'][n].shape
        k = int(torch.Size(shape).numel())
        out.append(flat[offset:offset + k].view(shape))
        offset += k
    return out


def _remap(state: Dict[str, Any], fn) -> Dict[str, Any]:
    """``state`` with ``fn(name, tensor)`` applied to every parameter and
    to each parameter's part of the flat optimizer fields."""
    out = dict(state)
    out['params'] = {n: fn(n, t) for n, t in state['params'].items()}
    opt = state.get('opt_state')
    if opt is not None:
        out['opt_state'] = dict(opt)
        for field in _FLAT_FIELDS:
            if field in opt:
                parts = [fn(n, t) for n, t in zip(
                    opt['names'], _flat_parts(state, field))]
                out['opt_state'][field] = torch.cat(
                    [t.reshape(-1) for t in parts])
    return out


def gather_state(state: Dict[str, Any], mesh,
                 shardings: Mapping[str, Optional[int]]) -> Dict[str, Any]:
    """A train state (``Trainer._state_tensors``' layout) whose sharded
    parameters and flat optimizer fields hold this rank's shards, as the
    whole tensors a single process holds: each shard gathered over
    'model' by name. Collective over the mesh."""
    from ..parallel.tensor_parallel import gather_parameter
    return _remap(state, lambda n, t: gather_parameter(
        mesh, t, shardings.get(n)))


def shard_state(state: Dict[str, Any], mesh,
                shardings: Mapping[str, Optional[int]]) -> Dict[str, Any]:
    """A whole train state cut to this rank's shards, by name: the
    inverse of ``gather_state``."""
    return _remap(state, lambda n, t: param_shard(
        mesh, t, shardings.get(n)).clone())


def save_checkpoint(directory: Union[str, Path], name: str,
                    state: Dict[str, Any], meta: Dict[str, Any],
                    mesh=None, shardings: Optional[Mapping[str, Optional[
                        int]]] = None) -> Path:
    """Write ``state`` (tensors, on any device) to ``state.pt`` and ``meta``
    to ``meta.json`` under directory/name/; each file is written beside its
    place and then renamed over it, so a reader never sees half a file.

    On a ``mesh`` every rank calls this: the shards of ``shardings``
    (``param_shardings``) are gathered into whole tensors, rank 0 writes
    and all ranks meet at a barrier before it returns."""
    root = Path(directory).absolute() / normalize_checkpoint_name(name)
    if mesh is not None:
        if shardings and mesh.shape[MODEL_AXIS] > 1:
            state = gather_state(state, mesh, shardings)
        if not is_main_rank():
            barrier(mesh)
            return root
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / (STATE_FILE + '.tmp')
    torch.save(_on_cpu(state), tmp)
    os.replace(tmp, root / STATE_FILE)
    tmp = root / (META_FILE + '.tmp')
    with open(tmp, 'w') as f:
        json.dump(meta, f, indent=2, cls=NumpyJSONEncoder)
    os.replace(tmp, root / META_FILE)
    if mesh is not None:
        barrier(mesh)
    return root


def load_checkpoint(directory: Union[str, Path], name: str,
                    device: Union[str, torch.device] = 'cpu',
                    mesh=None, shardings: Optional[Mapping[str, Optional[
                        int]]] = None) -> Optional[Dict[str, Any]]:
    """{'state': ..., 'meta': ...} with the state's tensors on ``device``;
    None when the checkpoint is absent. With a ``mesh`` and
    ``shardings``, the state holds this rank's shards."""
    root = Path(directory).absolute() / normalize_checkpoint_name(name)
    path = root / STATE_FILE
    if not path.exists():
        return None
    state = torch.load(path, map_location=device, weights_only=True)
    if mesh is not None and shardings and mesh.shape[MODEL_AXIS] > 1:
        state = shard_state(state, mesh, shardings)
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
