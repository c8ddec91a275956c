# pixelrec_multimodal_tpu_torch/parallel/tensor_parallel.py
"""Tensor-parallel layers over the mesh's 'model' axis.

Counterpart of JAX's ``param_shardings`` put to work (``device_put`` of a
Flax tree, GSPMD inserting the collectives): ``shard_module`` applies
``parallel/mesh.param_shardings`` to a built module and leaves each rank
with its shard of every sharded parameter and nothing else of it. The
layers that own one compute with it exactly:

* a Dense whose output features are sharded computes its columns and
  all-gathers them over 'model' (the reduction over the input features is
  the whole one), then adds its bias, which stays replicated; its input
  sums its gradient over 'model' (``copy_to_model``);
* an embedding whose vocabulary rows are sharded looks up the rows it
  owns, writes zeros for the others and sums over 'model'.

Every other computation is replicated over 'model', under the gradient
convention of ``parallel/mesh.py``. The layers are found by their
modules: ``models/layers.apply_dense`` and the recommender's embedding
lookup ask a module for its ``tp`` shard, and a sharded module's own
``forward`` (a ``nn.Linear`` called directly, the towers' ``Dense`` and
``Embed``) is swapped for the sharded one. An unsharded module is
unchanged. Parameter names stay; only their shapes become the shards'.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .mesh import (
    MODEL_AXIS,
    Mesh,
    all_gather,
    copy_to_model,
    gather_model,
    owned_rows,
    param_shard,
    param_shardings,
)


@dataclasses.dataclass(frozen=True)
class TPShard:
    """A parameter's shard: its rows ``start``..``start + n`` of ``full``
    on ``dim`` (torch dim 0, the output features of a Linear weight or the
    vocabulary of an Embedding)."""
    mesh: Mesh
    dim: int
    start: int
    full: int

    def linear(self, layer: nn.Linear, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
        """Flax Dense in ``dtype`` on the sharded kernel: this rank's
        output columns, gathered over 'model', plus the whole bias."""
        x = copy_to_model(self.mesh, x)
        y = gather_model(self.mesh, F.linear(x.to(dtype),
                                             layer.weight.to(dtype)), dim=-1)
        if layer.bias is not None:
            y = y + layer.bias.to(dtype)
        return y

    def embedding(self, table: nn.Embedding,
                  ids: torch.Tensor) -> torch.Tensor:
        """The rows of ``ids`` from the sharded table: the owned ones
        looked up, zeros for the others, summed over 'model'."""
        return owned_rows(self.mesh, table.weight, ids, self.start,
                          differentiable=True)


def _tp_forward(self, x: torch.Tensor) -> torch.Tensor:
    if isinstance(self, nn.Embedding):
        out = self.tp.embedding(self, x)
        dt = getattr(self, 'compute_dtype', None)
        return out if dt is None else out.to(dt)
    return self.tp.linear(self, x, getattr(self, 'compute_dtype', x.dtype))


_SHARDED_CLASSES: Dict[type, type] = {}


def _sharded_class(cls: type) -> type:
    if cls not in _SHARDED_CLASSES:
        _SHARDED_CLASSES[cls] = type(f'Sharded{cls.__name__}', (cls,),
                                     {'forward': _tp_forward})
    return _SHARDED_CLASSES[cls]


@torch.no_grad()
def shard_module(model: nn.Module, mesh: Mesh,
                 shardings: Optional[Dict[str, Optional[int]]] = None
                 ) -> Dict[str, Optional[int]]:
    """Cut ``model``'s sharded parameters to this rank's shards, in place
    (``shardings``: ``param_shardings(model, mesh)`` by default), and make
    their layers compute as sharded ones. Returns the shardings; they are
    also kept as ``model.tp_shardings``. Do this before binding an
    optimizer to the parameters (``Optimizer.init``)."""
    if shardings is None:
        shardings = param_shardings(model, mesh)
    for name, dim in shardings.items():
        if dim is None:
            continue
        owner_name, _, pname = name.rpartition('.')
        owner = model.get_submodule(owner_name)
        if pname != 'weight' or not isinstance(owner,
                                               (nn.Linear, nn.Embedding)):
            raise ValueError(f'{name}: only a Linear or Embedding weight is '
                             'sharded over the model axis')
        p = getattr(owner, pname)
        full = p.shape[dim]
        p.data = param_shard(mesh, p.data, dim).clone()
        shard = TPShard(mesh, dim, mesh.index(MODEL_AXIS) * p.shape[dim],
                        full)
        owner.tp = shard
        p.tp = shard
        owner.__class__ = _sharded_class(type(owner))
    model.tp_shardings = dict(shardings)
    return shardings


def gather_parameter(mesh: Mesh, t: torch.Tensor,
                     dim: Optional[int]) -> torch.Tensor:
    """The whole parameter of which ``t`` is this rank's shard on ``dim``
    (``t`` itself where ``dim`` is None): the shards gathered over
    'model'. Collective over the rank's model line."""
    if dim is None or mesh.shape[MODEL_AXIS] == 1:
        return t
    return all_gather(mesh, MODEL_AXIS, t.detach().contiguous(), dim=dim)
