# pixelrec_multimodal_tpu_torch/utils/flax_convert.py
"""Load a Flax variables tree into a port module's state dict.

The port's modules carry the Flax submodule names, so a leaf at Flax path
``('prediction_network', 'Dense_0', 'kernel')`` lands in state-dict key
``prediction_network.Dense_0.weight``. Layouts differ only for Dense
kernels and the attention projections:

* a Dense ``kernel [in, out]`` becomes torch ``weight [out, in]``;
* Flax ``MultiHeadDotProductAttention`` keeps heads on their own axis:
  ``query``, ``key`` and ``value`` kernels are ``[D, H, dh]`` with biases
  ``[H, dh]``, the ``out`` kernel is ``[H, dh, D]``. The port's
  projections are ``nn.Linear(D, H*dh)`` and ``nn.Linear(H*dh, D)``, so
  the heads flatten into one axis (heads major) before the transpose. A
  3-D kernel under any other name raises instead of being guessed at.

The tree comes in as nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, variables)``; this module imports no JAX.

``encoder_state_dict`` does the same for a frozen encoder tower's Flax
``params`` (``encoders/``): Dense ``[in, out]`` -> ``[out, in]``, Conv
HWIO -> OIHW (the depthwise ``[kh, kw, 1, dim]`` kernels too), LayerNorm
and frozen BatchNorm ``scale`` -> ``weight``, frozen BatchNorm
``mean``/``var`` -> the ``running_mean``/``running_var`` parameters, Embed
tables (MPNet's
``relative_attention_bias`` among them) -> ``weight``; bare parameters
(class and position tokens, layer scales) keep their names.
``end_to_end_state_dict`` carries an end-to-end model's tree: its towers
that way and its ``scorer`` subtree as a model's.

``flax_leaves`` runs the map the other way, from a built module's
parameters to their Flax leaf names and shapes (the tensor-parallel rule
of ``parallel/mesh.param_shardings`` reads them).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

# Flax leaf name -> torch tensor name, per collection.
_PARAM_NAMES = {'kernel': 'weight', 'bias': 'bias', 'embedding': 'weight',
                'scale': 'weight'}
_STAT_NAMES = {'mean': 'running_mean', 'var': 'running_var'}
# Flax attention projections whose kernels are [D, H, dh].
_QKV = ('query', 'key', 'value')

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


def _to_torch_layout(path: Tuple[str, ...], value: np.ndarray) -> np.ndarray:
    """A Flax parameter in the layout of its torch tensor."""
    name, owner = path[-1], path[-2] if len(path) > 1 else ''
    if name == 'kernel':
        if value.ndim == 2:
            return value.T
        if value.ndim == 3 and owner in _QKV:
            d, h, dh = value.shape
            return value.reshape(d, h * dh).T
        if value.ndim == 3 and owner == 'out':
            h, dh, d = value.shape
            return value.reshape(h * dh, d).T
        raise ValueError(f"no torch layout for the {value.ndim}-D Flax kernel "
                         f"{'/'.join(path)} {value.shape}")
    if name == 'bias' and owner in _QKV and value.ndim == 2:
        return value.reshape(-1)
    return value


def _model_tensors(variables: Mapping
                   ) -> Iterator[Tuple[str, str, np.ndarray]]:
    """(Flax leaf path, torch key, value in the torch layout) of each leaf
    of a model's ``params`` and ``batch_stats``."""
    for collection, names in (('params', _PARAM_NAMES),
                              ('batch_stats', _STAT_NAMES)):
        for path, value in _leaves(variables.get(collection, {})):
            yield (f"{collection}/{'/'.join(path)}", _torch_key(path, names),
                   _to_torch_layout(path, value))


def load_flax_variables(model: nn.Module, variables: Mapping) -> List[str]:
    """Copy ``{'params': ..., 'batch_stats': ...}`` into ``model``.

    Raises when a Flax leaf has no tensor of that name and shape, or when a
    tensor the model computes with is left unset. Returns the names of the
    optional tensors the tree did not hold.
    """
    state = model.state_dict()
    filled = set()
    for leaf, key, value in _model_tensors(variables):
        if key not in state:
            raise KeyError(f"Flax leaf {leaf} has no torch tensor {key!r}")
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


def _flax_leaf(owner: nn.Module, parent: Optional[nn.Module], pname: str,
               p: torch.Tensor) -> Tuple[str, Tuple[int, ...]]:
    """The Flax leaf name and shape of parameter ``pname`` of ``owner``
    (``parent`` the module holding ``owner``)."""
    from ..models.layers import MultiHeadAttention
    shape = tuple(p.shape)
    if pname == 'weight':
        if isinstance(owner, nn.Embedding):
            return 'embedding', shape
        if isinstance(owner, nn.Linear):
            if isinstance(parent, MultiHeadAttention):
                h = parent.num_heads  # DenseGeneral: [D, H, dh] / [H, dh, D]
                if owner is parent.out:
                    return 'kernel', (h, shape[1] // h, shape[0])
                return 'kernel', (shape[1], h, shape[0] // h)
            return 'kernel', shape[::-1]
        if isinstance(owner, nn.Conv2d):
            return 'kernel', (shape[2], shape[3], shape[1], shape[0])
        return 'scale', shape
    if pname in ('running_mean', 'running_var'):
        return pname[len('running_'):], shape
    return pname, shape


def flax_leaves(model: nn.Module
                ) -> Iterator[Tuple[str, str, Tuple[int, ...]]]:
    """(state-dict name, Flax leaf name, Flax shape) of each parameter of
    ``model``: a Linear's weight is the ``kernel`` [in, out] (the fusion
    attention's projections the 3-D DenseGeneral kernels), an Embedding's
    the ``embedding``, a convolution's the HWIO ``kernel``, a norm's the
    ``scale``; biases, frozen BatchNorm statistics and bare parameters
    keep their names."""
    parents = {}
    for name, mod in model.named_modules():
        for child_name, child in mod.named_children():
            parents[f'{name}.{child_name}' if name else child_name] = mod
    for name, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            leaf, shape = _flax_leaf(mod, parents.get(name), pname, p)
            yield (f'{name}.{pname}' if name else pname), leaf, shape


# Flax leaf name -> tensor name in the encoder towers.
_ENCODER_NAMES = {'kernel': 'weight', 'embedding': 'weight',
                  'scale': 'weight', 'mean': 'running_mean',
                  'var': 'running_var'}


def encoder_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """An encoder tower's Flax ``params`` as the port tower's state dict
    (float32 tensors)."""
    out = {}
    for path, value in _leaves(params):
        if path[-1] == 'kernel':
            if value.ndim == 2:
                value = value.T
            elif value.ndim == 4:  # HWIO -> OIHW
                value = value.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"no torch layout for the {value.ndim}-D "
                                 f"kernel {'/'.join(path)} {value.shape}")
        key = '.'.join(path[:-1] + (_ENCODER_NAMES.get(path[-1], path[-1]),))
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


def load_encoder_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy an encoder tower's Flax ``params`` into ``model``; raises
    unless every tensor of the model is set, by a leaf of its shape."""
    model.load_state_dict(encoder_state_dict(params), strict=True)
    return model


# The encoder subtrees of an end-to-end model's Flax tree.
_E2E_TOWERS = ('vision_encoder', 'language_encoder', 'clip_text_encoder')


def end_to_end_state_dict(params: Mapping,
                          batch_stats: Optional[Mapping] = None
                          ) -> Dict[str, torch.Tensor]:
    """A JAX ``EndToEndRecommender``'s ``params`` (and the scorer's
    ``batch_stats``) as the port's ``models/end_to_end.py`` state dict:
    each tower's subtree through ``encoder_state_dict`` (ResNet's frozen
    BatchNorm ``mean``/``var`` to its ``running_mean``/``running_var``
    parameters), the ``scorer`` subtree as ``load_flax_variables`` lays
    out a ``MultimodalRecommender``, each under its subtree's name. Load
    it with ``strict=False``: the scorer's BatchNorm step counters have
    no Flax counterpart."""
    out = {}
    for top, sub in params.items():
        if top == 'scorer':
            scorer = {'params': sub,
                      'batch_stats': (batch_stats or {}).get('scorer', {})}
            for _, key, value in _model_tensors(scorer):
                out[f'scorer.{key}'] = torch.from_numpy(
                    np.array(value, dtype=np.float32))
        elif top in _E2E_TOWERS:
            out.update({f'{top}.{k}': v
                        for k, v in encoder_state_dict(sub).items()})
        else:
            raise KeyError(f'no end-to-end subtree {top!r}')
    return out
