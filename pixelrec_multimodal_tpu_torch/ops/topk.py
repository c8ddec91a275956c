# pixelrec_multimodal_tpu_torch/ops/topk.py
"""Top-K selection for catalog-scale ranking: row-wise top-k and the
streaming merge that carries a running top-k across a chunked catalog
scan, so the [users, items] matrix is never held whole; and the merge of
a catalog sharded over the mesh's 'model' axis, which all-gathers k
candidates per shard instead of the shard's scores.

The JAX package selects with ``lax.approx_max_k(recall_target=1.0)``, which
is exact; ``torch.topk`` is exact too. Tie order may differ between them:
scores are continuous, and callers compare value sets, not the order of
tied entries.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from ..parallel.mesh import MODEL_AXIS, Mesh, all_gather

NEG_INF = -1e30


def topk_2d(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k of a [B, N] score matrix -> (values, int32 indices)."""
    v, i = torch.topk(scores, k, dim=-1)
    return v, i.to(torch.int32)


def merge_topk(values_a: torch.Tensor, idx_a: torch.Tensor,
               values_b: torch.Tensor, idx_b: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two per-row candidate sets into the row-wise top-k (values
    descending, indices carried from the inputs)."""
    cat_v = torch.cat([values_a, values_b], dim=-1)
    cat_i = torch.cat([idx_a, idx_b], dim=-1)
    v, pos = torch.topk(cat_v, k, dim=-1)
    return v, torch.gather(cat_i, -1, pos)


def init_topk(batch: int, k: int,
              device: Union[str, torch.device] = 'cpu'
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neutral running-top-k carry: NEG_INF scores, -1 indices."""
    return (torch.full((batch, k), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.full((batch, k), -1, dtype=torch.int32, device=device))


def gather_topk(values: torch.Tensor, idx: torch.Tensor, k: int,
                mesh: Mesh, axis: str = MODEL_AXIS
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge every shard's per-row candidates (``values`` [B, k_local],
    global ``idx``) over ``axis``: all-gather them in shard order, then one
    final row-wise top-k. Communication is O(shards x k_local) a row."""
    all_v = all_gather(mesh, axis, values, dim=-1)
    all_i = all_gather(mesh, axis, idx, dim=-1)
    v, pos = torch.topk(all_v, k, dim=-1)
    return v, torch.gather(all_i, -1, pos)


def sharded_topk(scores: torch.Tensor, k: int, mesh: Mesh,
                 axis: str = MODEL_AXIS
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact global top-k over an item axis sharded across ``axis``.

    ``scores`` is this rank's [B, n_local] slice, shard s holding items
    [s * n_local, (s + 1) * n_local). Each shard takes its local top-k over
    min(k, n_local) items and offsets the ids by its base; the candidates
    then merge through ``gather_topk``. Ids of NEG_INF entries stay -1,
    never -1 + base. Returned ids are int32 and global."""
    n_local = scores.shape[-1]
    base = mesh.index(axis) * n_local
    local_v, local_i = torch.topk(scores, min(k, n_local), dim=-1)
    local_i = (local_i + base).to(torch.int32)
    local_i = local_i.masked_fill(local_v <= NEG_INF / 2, -1)
    return gather_topk(local_v, local_i, k, mesh, axis)
