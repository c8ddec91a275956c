# pixelrec_multimodal_tpu_torch/evaluation/novelty.py
"""Novelty and diversity metrics.

Counterpart of ``pixelrec_multimodal_tpu/evaluation/novelty.py``, the same
numpy arithmetic: self-information over interaction probability, IIF,
catalog coverage, popularity-rank statistics (ranks by a stable sort over
the order of ``item_popularity``, so the caller's dict order decides
ties), the bottom-80% long-tail share, Ziegler intra-list similarity and
personalized novelty (``NoveltyMetrics``, which the retrieval evaluator
calls per user), and embedding-based diversity (``DiversityCalculator``,
a library class that no evaluator calls, exported as in the JAX package).
"""
from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


def _pairwise_cosine_mean(embs: np.ndarray) -> float:
    """Mean pairwise cosine similarity over rows (upper triangle)."""
    norms = np.linalg.norm(embs, axis=1, keepdims=True)
    normed = embs / np.maximum(norms, 1e-12)
    sim = normed @ normed.T
    iu = np.triu_indices(sim.shape[0], k=1)
    if iu[0].size == 0:
        return 0.0
    return float(np.mean(sim[iu]))


class NoveltyMetrics:
    """Per-list novelty/diversity metrics over global interaction statistics."""

    def __init__(self, item_popularity: Dict[str, float],
                 user_history: List[Tuple[str, str]],
                 item_embeddings: Optional[Dict[str, np.ndarray]] = None):
        self.item_popularity = item_popularity
        self.user_history = user_history
        self.item_embeddings = item_embeddings

        self.total_interactions = sum(item_popularity.values())
        self.n_users = len({u for u, _ in user_history})
        self.item_user_counts = Counter(item for _, item in user_history)
        ordered = sorted(item_popularity.items(), key=lambda x: x[1],
                         reverse=True)
        self.popularity_ranks = {item: r for r, (item, _) in enumerate(ordered)}
        # Index history once for personalized novelty.
        self._user_items: Dict[str, set] = defaultdict(set)
        for u, i in user_history:
            self._user_items[u].add(i)

    def calculate_metrics(self, recommendations: List[str],
                          user_id: Optional[str] = None) -> Dict[str, float]:
        """All metrics for one recommendation list."""
        if not recommendations:
            return {}
        metrics = {
            'avg_self_information': self.calculate_self_information(recommendations),
            'avg_iif': self.calculate_iif(recommendations),
            'catalog_coverage': self.calculate_coverage(recommendations),
        }
        metrics.update(self.calculate_popularity_stats(recommendations))
        metrics['long_tail_percentage'] = \
            self.calculate_long_tail_percentage(recommendations)
        if self.item_embeddings:
            metrics['intra_list_similarity'] = \
                self.calculate_diversity(recommendations)
        else:
            metrics['intra_list_similarity'] = np.nan
        if user_id:
            metrics['personalized_novelty'] = \
                self.calculate_personalized_novelty(recommendations, user_id)
        return metrics

    def calculate_self_information(self, items: List[str]) -> float:
        """Mean -log2 p(item) over items with known popularity."""
        if self.total_interactions <= 0:
            return 0.0
        scores = [-np.log2(max(self.item_popularity[i] / self.total_interactions,
                               1e-10))
                  for i in items if i in self.item_popularity]
        return float(np.mean(scores)) if scores else 0.0

    def calculate_iif(self, items: List[str]) -> float:
        """Mean log(N_users / users(item))."""
        if self.n_users <= 0:
            return 0.0
        scores = [np.log(self.n_users / (self.item_user_counts[i] + 1e-10))
                  for i in items
                  if self.item_user_counts.get(i, 0) > 0]
        return float(np.mean(scores)) if scores else 0.0

    def calculate_coverage(self, items: List[str]) -> float:
        """|unique recommended| / |catalog|."""
        if not self.item_popularity:
            return 0.0
        return len(set(items)) / len(self.item_popularity)

    def calculate_popularity_stats(self, items: List[str]) -> Dict[str, float]:
        """avg/std/min/max popularity rank of the list."""
        ranks = [self.popularity_ranks.get(i, len(self.popularity_ranks))
                 for i in items]
        if not ranks:
            return {'avg_popularity_rank': np.nan,
                    'popularity_rank_std': np.nan,
                    'min_popularity_rank': np.nan,
                    'max_popularity_rank': np.nan}
        arr = np.asarray(ranks, dtype=np.float64)
        return {'avg_popularity_rank': float(arr.mean()),
                'popularity_rank_std': float(arr.std()),
                'min_popularity_rank': float(arr.min()),
                'max_popularity_rank': float(arr.max())}

    def calculate_long_tail_percentage(self, items: List[str]) -> float:
        """Share of items below the top-20% popularity ranks."""
        if not self.popularity_ranks or not items:
            return 0.0
        threshold = int(len(self.popularity_ranks) * 0.2)
        tail = sum(1 for i in items
                   if self.popularity_ranks.get(i, len(self.popularity_ranks))
                   >= threshold)
        return tail / len(items)

    def calculate_diversity(self, items: List[str]) -> float:
        """Ziegler intra-list similarity: mean pairwise cosine of item
        embeddings. Lower = more diverse."""
        if not self.item_embeddings or len(items) < 2:
            return 0.0
        embs = [self.item_embeddings[i] for i in items
                if i in self.item_embeddings]
        if len(embs) < 2:
            return 0.0
        return _pairwise_cosine_mean(np.asarray(embs, dtype=np.float64))

    def calculate_personalized_novelty(self, items: List[str],
                                       user_id: str) -> float:
        """Fraction of the list unseen by this user."""
        if not items:
            return 0.0
        seen = self._user_items.get(user_id, set())
        novel = sum(1 for i in items if i not in seen)
        return novel / len(items)


class DiversityCalculator:
    """Embedding-based diversity metrics."""

    def __init__(self, item_embeddings: Dict[str, np.ndarray]):
        self.item_embeddings = item_embeddings

    def calculate_pairwise_diversity(self, items: List[str],
                                     metric: str = 'cosine') -> float:
        """Mean pairwise distance (cosine distance or euclidean)."""
        if len(items) < 2:
            return 0.0
        embs = [self.item_embeddings[i] for i in items
                if i in self.item_embeddings]
        if len(embs) < 2:
            return 0.0
        x = np.asarray(embs, dtype=np.float64)
        if metric == 'cosine':
            norms = np.linalg.norm(x, axis=1)
            zero = norms < 1e-10
            normed = x / np.maximum(norms[:, None], 1e-10)
            sim = np.clip(normed @ normed.T, -1.0, 1.0)
            dist = 1.0 - sim
            # Zero vectors get maximum distance to every partner.
            dist[zero, :] = 1.0
            dist[:, zero] = 1.0
        else:
            diff = x[:, None, :] - x[None, :, :]
            dist = np.linalg.norm(diff, axis=-1)
        iu = np.triu_indices(len(x), k=1)
        return float(np.mean(dist[iu])) if iu[0].size else 0.0

    def calculate_coverage_diversity(
            self, recommendations_per_user: Dict[str, List[str]]) -> float:
        """|unique items across users| / total recommendations."""
        unique = set()
        total = 0
        for items in recommendations_per_user.values():
            unique.update(items)
            total += len(items)
        return len(unique) / total if total else 0.0
