# pixelrec_multimodal_tpu_torch/ops/topk.py
"""Top-K selection for catalog-scale ranking: row-wise top-k and the
streaming merge that carries a running top-k across a chunked catalog
scan, so the [users, items] matrix is never held whole.

The JAX package selects with ``lax.approx_max_k(recall_target=1.0)``, which
is exact; ``torch.topk`` is exact too. Tie order may differ between them:
scores are continuous, and callers compare value sets, not the order of
tied entries.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

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
