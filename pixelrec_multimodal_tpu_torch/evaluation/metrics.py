# pixelrec_multimodal_tpu_torch/evaluation/metrics.py
"""Standard ranking metric functions.

Counterpart of ``pixelrec_multimodal_tpu/evaluation/metrics.py``, the same
numpy arithmetic: precision, recall, NDCG (IDCG from the realized top-k
relevance list, not ``min(k, |relevant|)``) and MAP over one list, and
their vectorized forms over hit matrices. Neither package's evaluators
call them (the retrieval evaluator keeps its own NDCG); they are the
library functions the JAX package's ``evaluation`` exports, ported so
that the port's ``evaluation`` exports the same names.
"""
from __future__ import annotations

from typing import List, Set

import numpy as np


def calculate_precision_at_k(recommended: List, relevant: Set, k: int) -> float:
    """Fraction of the top-k that is relevant."""
    if not recommended or k == 0:
        return 0.0
    hits = sum(1 for item in recommended[:k] if item in relevant)
    return hits / k


def calculate_recall_at_k(recommended: List, relevant: Set, k: int) -> float:
    """Fraction of relevant items retrieved in the top-k."""
    if not relevant or k == 0:
        return 0.0
    hits = sum(1 for item in recommended[:k] if item in relevant)
    return hits / len(relevant)


def calculate_ndcg(recommended: List, relevant: Set, k: int) -> float:
    """Binary-relevance NDCG@k with log2 position discounting."""
    rel = np.asarray([1.0 if item in relevant else 0.0
                      for item in recommended[:k]])
    if rel.sum() == 0:
        return 0.0
    discounts = 1.0 / np.log2(np.arange(len(rel)) + 2)
    dcg = float((rel * discounts).sum())
    ideal = np.sort(rel)[::-1]
    idcg = float((ideal * discounts).sum())
    return dcg / idcg if idcg > 0 else 0.0


def calculate_map(recommended: List, relevant: Set) -> float:
    """Average precision over the recommended list."""
    if not relevant:
        return 0.0
    hits = 0
    precisions = []
    for i, item in enumerate(recommended):
        if item in relevant:
            hits += 1
            precisions.append(hits / (i + 1))
    return sum(precisions) / len(relevant) if precisions else 0.0


# --------------------------------------------------------------------------
# Vectorized variants over hit matrices. A "hit matrix" is bool
# [n_users, k]: whether the item at each rank is relevant.
# --------------------------------------------------------------------------

def precision_at_k_batch(hits: np.ndarray, k: int) -> np.ndarray:
    return hits[:, :k].sum(axis=1) / k


def recall_at_k_batch(hits: np.ndarray, n_relevant: np.ndarray,
                      k: int) -> np.ndarray:
    return hits[:, :k].sum(axis=1) / np.maximum(n_relevant, 1)


def ndcg_at_k_batch(hits: np.ndarray, k: int) -> np.ndarray:
    """Vectorized NDCG (IDCG from the realized top-k)."""
    h = hits[:, :k].astype(np.float64)
    discounts = 1.0 / np.log2(np.arange(h.shape[1]) + 2)
    dcg = (h * discounts).sum(axis=1)
    ideal = np.sort(h, axis=1)[:, ::-1]
    idcg = (ideal * discounts).sum(axis=1)
    return np.where(idcg > 0, dcg / np.maximum(idcg, 1e-12), 0.0)


def mrr_batch(hits: np.ndarray) -> np.ndarray:
    """Reciprocal rank of the first hit per row (0 when no hit)."""
    any_hit = hits.any(axis=1)
    first = np.argmax(hits, axis=1)
    return np.where(any_hit, 1.0 / (first + 1), 0.0)


def hit_rate_batch(hits: np.ndarray, k: int) -> np.ndarray:
    return hits[:, :k].any(axis=1).astype(np.float64)
