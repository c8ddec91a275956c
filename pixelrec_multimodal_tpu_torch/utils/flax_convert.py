# pixelrec_multimodal_tpu_torch/utils/flax_convert.py
"""Load a Flax variables tree into a port module's state dict.

The port's modules carry the Flax submodule names, so a leaf at Flax path
``('prediction_network', 'Dense_0', 'kernel')`` lands in state-dict key
``prediction_network.Dense_0.weight``. Layouts differ only for Dense
kernels: Flax ``kernel [in, out]`` becomes torch ``weight [out, in]``.

The tree comes in as nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, variables)``; this module imports no JAX.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# Flax leaf name -> torch tensor name, per collection.
_PARAM_NAMES = {'kernel': 'weight', 'bias': 'bias', 'embedding': 'weight',
                'scale': 'weight'}
_STAT_NAMES = {'mean': 'running_mean', 'var': 'running_var'}

# Torch tensors a Flax tree may lack: BatchNorm's step counter has no Flax
# counterpart, and Flax creates the contrastive projections' parameters
# only when ``model.init`` runs with ``return_embeddings=True``.
_OPTIONAL_SUFFIXES = ('num_batches_tracked',)
_OPTIONAL_PREFIXES = ('vision_contrastive_projection.',
                      'text_contrastive_projection.')


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), np.asarray(value)


def _torch_key(path: Tuple[str, ...], names: Dict[str, str]) -> str:
    if len(path) == 1:  # a bare parameter on the root module (temperature)
        return path[0]
    leaf = names.get(path[-1])
    if leaf is None:
        raise KeyError(f"no torch counterpart for Flax leaf {'/'.join(path)}")
    return '.'.join(path[:-1] + (leaf,))


def load_flax_variables(model: nn.Module, variables: Mapping) -> List[str]:
    """Copy ``{'params': ..., 'batch_stats': ...}`` into ``model``.

    Raises when a Flax leaf has no tensor of that name and shape, or when a
    tensor the model computes with is left unset. Returns the names of the
    optional tensors the tree did not hold.
    """
    state = model.state_dict()
    filled = set()
    for collection, names in (('params', _PARAM_NAMES),
                              ('batch_stats', _STAT_NAMES)):
        for path, value in _leaves(variables.get(collection, {})):
            key = _torch_key(path, names)
            if key not in state:
                raise KeyError(f"Flax leaf {collection}/{'/'.join(path)} "
                               f"has no torch tensor {key!r}")
            if path[-1] == 'kernel':
                value = value.T
            target = state[key]
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f'{key}: Flax shape {value.shape} != torch '
                                 f'shape {tuple(target.shape)}')
            with torch.no_grad():
                target.copy_(torch.from_numpy(np.array(value)))
            filled.add(key)
    missing = [k for k in state if k not in filled]
    required = [k for k in missing if not k.endswith(_OPTIONAL_SUFFIXES)
                and not k.startswith(_OPTIONAL_PREFIXES)]
    if required:
        raise KeyError(f'Flax variables do not set {required}')
    return missing
