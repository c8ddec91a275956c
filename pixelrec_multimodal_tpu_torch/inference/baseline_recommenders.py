# pixelrec_multimodal_tpu_torch/inference/baseline_recommenders.py
"""Baseline recommenders: random, popularity, ItemKNN, UserKNN.

Counterpart of ``pixelrec_multimodal_tpu/inference/baseline_recommenders.py``
with the same interfaces and scores: popularity from the dataset's
interactions, history from an optional override table (a dict of numpy
columns or a DataFrame), the popularity fallback for unknown users, and
cosine-similarity aggregation. Host code, as in the JAX package: the
evaluators take their per-user path for them.

The KNN baselines build their sparse matrices with ``scipy.sparse``,
imported inside the functions that build them, so that importing this
module loads no scipy. Their similarity is scikit-learn's
``cosine_similarity(X, dense_output=False)`` as scikit-learn 1.9 computes
it (``cosine_similarity`` below), to the bit: binary histories give many
equal similarities, and the top-K keeps their order.

``RandomRecommender`` draws from numpy's global generator, seeded at
construction and reseeded by the retrieval evaluator, as in the JAX
package, so that two evaluations in a row draw the same lists.
"""
from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..data.columns import as_columns, group_rows, n_rows, value_counts


def _pair_seed(user_id: str, item_id: str, random_seed: int) -> int:
    """Deterministic 31-bit seed for a (user, item) pair: builtin ``hash``
    where ``PYTHONHASHSEED`` is pinned, blake2b otherwise."""
    s = f"{user_id}_{item_id}_{random_seed}"
    if os.environ.get('PYTHONHASHSEED') not in (None, 'random'):
        return hash(s) % (2 ** 31)
    digest = hashlib.blake2b(s.encode('utf-8'), digest_size=8).digest()
    return int.from_bytes(digest, 'little') % (2 ** 31)


def cosine_similarity(X):
    """scikit-learn's ``cosine_similarity(X, dense_output=False)`` of a
    scipy sparse matrix, as scikit-learn 1.9 computes it: X as a float64
    csr matrix, each nonzero row divided by its L2 norm (the float64 sum
    of its squares in stored order, then ``sqrt``), then ``Xn @ Xn.T``."""
    Xn = X.tocsr().astype(np.float64)
    per_row = np.diff(Xn.indptr)
    sq = np.bincount(np.repeat(np.arange(Xn.shape[0]), per_row),
                     weights=Xn.data * Xn.data, minlength=Xn.shape[0])
    norms = np.repeat(np.sqrt(sq), per_row)
    nz = norms != 0.0
    Xn.data[nz] /= norms[nz]
    return Xn @ Xn.T


def _str_ids(table) -> Dict[str, np.ndarray]:
    """``table`` as columns, its ``user_id`` and ``item_id`` as strings."""
    cols = as_columns(table)
    for key in ('user_id', 'item_id'):
        if key in cols:
            cols[key] = cols[key].astype(str)
    return cols


class BaselineRecommender:
    """Shared state for the baseline family."""

    def __init__(self, dataset: Any, device: Optional[Any] = None,
                 history_interactions_df=None):
        self.dataset = dataset
        override = (as_columns(history_interactions_df)
                    if history_interactions_df is not None else None)
        if override is not None and n_rows(override):
            self.interactions_for_model = _str_ids(override)
        else:
            self.interactions_for_model = dict(
                as_columns(dataset.interactions))
            if override is not None:
                print("Warning: Provided history_interactions_df is empty. "
                      "Falling back to dataset.interactions.")

        # Global popularity always comes from the dataset's interactions,
        # history from the override.
        self.item_popularity = self._calculate_item_popularity(
            dataset.interactions)
        self.user_items = self._build_user_item_dict(self.interactions_for_model)
        self.all_items = self._get_all_item_ids()

    def _get_all_item_ids(self) -> List[str]:
        classes = getattr(self.dataset.item_encoder, 'classes_', None)
        if classes is not None:
            return [str(i) for i in classes]
        return []

    @staticmethod
    def _calculate_item_popularity(interactions) -> Dict[str, int]:
        cols = as_columns(interactions)
        if 'item_id' not in cols or not n_rows(cols):
            return {}
        return value_counts(cols['item_id'].astype(str))

    @staticmethod
    def _build_user_item_dict(interactions) -> Dict[str, set]:
        """Each user's items as a set, filled in row order."""
        cols = as_columns(interactions)
        if 'user_id' not in cols or 'item_id' not in cols or \
                not n_rows(cols):
            return {}
        users, rows = group_rows(cols['user_id'].astype(str))
        items = cols['item_id'].astype(str)
        return {u: set(items[r].tolist())
                for u, r in zip(users.tolist(), rows)}

    def get_user_history(self, user_id: str) -> set:
        return self.user_items.get(str(user_id), set())

    def get_recommendations(self, user_id: str, top_k: int = 10,
                            filter_seen: bool = True,
                            candidates: Optional[List[str]] = None
                            ) -> List[Tuple[str, float]]:
        raise NotImplementedError

    def get_item_score(self, user_id: str, item_id: str) -> float:
        """Default: the item's score in a large recommendation list."""
        recs = self.get_recommendations(user_id=str(user_id), top_k=1000,
                                        filter_seen=False, candidates=None)
        item_id = str(item_id)
        for rec_item, score in recs:
            if str(rec_item) == item_id:
                return score
        return 0.0

    # ------------------------------------------------------- shared plumbing
    def _encoder_maps(self):
        user_classes = getattr(self.dataset.user_encoder, 'classes_', None)
        item_classes = getattr(self.dataset.item_encoder, 'classes_', None)
        user_to_idx = ({str(u): i for i, u in enumerate(user_classes)}
                       if user_classes is not None else {})
        item_to_idx = ({str(it): i for i, it in enumerate(item_classes)}
                       if item_classes is not None else {})
        return user_to_idx, item_to_idx

    def _interaction_matrix(self, user_to_idx, item_to_idx):
        """User-item csr matrix of the encoder-known interactions, a
        repeated pair summed."""
        from scipy.sparse import csr_matrix
        cols = self.interactions_for_model
        rows = np.asarray([user_to_idx.get(u, -1) for u in
                           cols['user_id'].astype(str).tolist()], np.int64)
        items = np.asarray([item_to_idx.get(i, -1) for i in
                            cols['item_id'].astype(str).tolist()], np.int64)
        keep = (rows >= 0) & (items >= 0)
        shape = (len(user_to_idx), len(item_to_idx))
        if not keep.any():
            return csr_matrix(shape)
        return csr_matrix((np.ones(int(keep.sum())),
                           (rows[keep], items[keep])), shape=shape)


class RandomRecommender(BaselineRecommender):
    """Uniformly random recommendations; deterministic per-pair scores."""

    def __init__(self, dataset: Any, device: Optional[Any] = None,
                 random_seed: int = 42, history_interactions_df=None):
        super().__init__(dataset, device,
                         history_interactions_df=history_interactions_df)
        self.random_seed = random_seed
        self._catalog = set(self.all_items)
        np.random.seed(random_seed)

    def get_recommendations(self, user_id: str, top_k: int = 10,
                            filter_seen: bool = True,
                            candidates: Optional[List[str]] = None
                            ) -> List[Tuple[str, float]]:
        pool = ([str(i) for i in candidates] if candidates is not None
                else [str(i) for i in self.all_items])
        if not pool:
            return []
        if filter_seen:
            seen = self.get_user_history(str(user_id))
            pool = [i for i in pool if i not in seen]
        n = min(top_k, len(pool))
        if n == 0:
            return []
        picked = np.random.choice(pool, n, replace=False)
        return [(str(i), float(np.random.random())) for i in picked]

    def get_item_score(self, user_id: str, item_id: str) -> float:
        item_id = str(item_id)
        if item_id not in self._catalog:
            return 0.0
        seed = _pair_seed(str(user_id), item_id, self.random_seed)
        return float(np.random.RandomState(seed).random())


class PopularityRecommender(BaselineRecommender):
    """Global-popularity ranking with max-normalized scores."""

    def __init__(self, dataset: Any, device: Optional[Any] = None,
                 history_interactions_df=None):
        super().__init__(dataset, device,
                         history_interactions_df=history_interactions_df)
        self._precompute_popularity_ranking()

    def _precompute_popularity_ranking(self):
        scored = [(str(i), self.item_popularity.get(str(i), 0))
                  for i in self.all_items]
        scored.sort(key=lambda x: x[1], reverse=True)
        self.sorted_items = scored
        if scored:
            max_score = scored[0][1] if scored[0][1] > 0 else 1.0
            self.sorted_items_normalized = [(i, s / max_score)
                                            for i, s in scored]
            self.item_score_lookup = dict(self.sorted_items_normalized)
        else:
            self.sorted_items_normalized = []
            self.item_score_lookup = {}
        self._rank_of = {i: r for r, (i, _) in enumerate(scored)}

    def get_recommendations(self, user_id: str, top_k: int = 10,
                            filter_seen: bool = True,
                            candidates: Optional[List[str]] = None
                            ) -> List[Tuple[str, float]]:
        """The most popular items, unseen ones where ``filter_seen``; with
        ``candidates``, the known candidates in popularity order (the JAX
        package scans the whole ranked catalog for them: the same items in
        the same order)."""
        seen = self.get_user_history(str(user_id)) if filter_seen else set()
        if candidates is not None:
            ranks = sorted({self._rank_of[i] for i in map(str, candidates)
                            if i in self._rank_of})
            pool = [self.sorted_items_normalized[r] for r in ranks]
        else:
            pool = self.sorted_items_normalized
        out = []
        for item, score in pool:
            if item in seen:
                continue
            out.append((item, score))
            if len(out) >= top_k:
                break
        return out

    def get_item_score(self, user_id: str, item_id: str) -> float:
        return self.item_score_lookup.get(str(item_id), 0.0)


class ItemKNNRecommender(BaselineRecommender):
    """Item-based CF: score = mean cosine similarity to the user's
    history."""

    def __init__(self, dataset: Any, device: Optional[Any] = None,
                 k_neighbors: int = 50, history_interactions_df=None):
        super().__init__(dataset, device,
                         history_interactions_df=history_interactions_df)
        self.k_neighbors = k_neighbors
        self._build_item_similarity_matrix()

    def _build_item_similarity_matrix(self):
        from scipy.sparse import csr_matrix
        print("Building item similarity matrix for ItemKNN...")
        self.user_to_idx, self.item_to_idx = self._encoder_maps()
        ui = self._interaction_matrix(self.user_to_idx, self.item_to_idx)
        print("Calculating item similarities for ItemKNN...")
        if ui.nnz > 0 and ui.shape[1] > 0:
            self.item_similarities = cosine_similarity(ui.T)
        else:
            n = len(self.item_to_idx)
            self.item_similarities = csr_matrix((n, n))
            if ui.nnz == 0:
                print("Warning: No interactions available for ItemKNN model "
                      "building after filtering.")

    def _history_rows(self, history: set) -> List[int]:
        return [self.item_to_idx[i] for i in map(str, history)
                if i in self.item_to_idx
                and self.item_to_idx[i] < self.item_similarities.shape[0]]

    def _user_scores(self, user_id: str) -> Optional[np.ndarray]:
        """Mean similarity of every catalog item to the user's history."""
        history = self.get_user_history(user_id)
        if not history:
            return None
        hist_idx = self._history_rows(history)
        scores = np.zeros(len(self.item_to_idx))
        if hist_idx:
            scores = np.asarray(
                self.item_similarities[hist_idx].sum(axis=0)).ravel()
        # Divided by |history|, unmapped items included.
        return scores / len(history)

    def get_recommendations(self, user_id: str, top_k: int = 10,
                            filter_seen: bool = True,
                            candidates: Optional[List[str]] = None
                            ) -> List[Tuple[str, float]]:
        user_id = str(user_id)
        if user_id not in self.user_to_idx:
            return PopularityRecommender(
                self.dataset,
                history_interactions_df=self.interactions_for_model
            ).get_recommendations(user_id, top_k, filter_seen, candidates)
        scores = self._user_scores(user_id)
        if scores is None:
            return []
        seen = self.get_user_history(user_id)
        pool = ([str(i) for i in candidates] if candidates is not None
                else self.all_items)
        recs = []
        for item in pool:
            item = str(item)
            idx = self.item_to_idx.get(item)
            if idx is None:
                continue
            if filter_seen and item in seen:
                continue
            recs.append((item, float(scores[idx])))
        recs.sort(key=lambda x: x[1], reverse=True)
        return recs[:top_k]

    def get_item_score(self, user_id: str, item_id: str) -> float:
        user_id, item_id = str(user_id), str(item_id)
        if user_id not in self.user_to_idx or item_id not in self.item_to_idx:
            return 0.0
        target = self.item_to_idx[item_id]
        if target >= self.item_similarities.shape[0]:
            return 0.0
        history = self.get_user_history(user_id)
        if not history:
            return 0.0
        hist_idx = self._history_rows(history)
        if not hist_idx:
            return 0.0
        sims = np.asarray(
            self.item_similarities[hist_idx, target].todense()).ravel()
        # Averaged over the mapped history items only.
        return float(sims.sum() / len(hist_idx))


class UserKNNRecommender(BaselineRecommender):
    """User-based CF: similarity-weighted aggregation over the top-k
    positive neighbors."""

    def __init__(self, dataset: Any, device: Optional[Any] = None,
                 k_neighbors: int = 50, history_interactions_df=None):
        super().__init__(dataset, device,
                         history_interactions_df=history_interactions_df)
        self.k_neighbors = k_neighbors
        self._build_user_item_matrix()

    def _build_user_item_matrix(self):
        from scipy.sparse import csr_matrix
        print("Building user-item matrix for UserKNN...")
        self.user_to_idx, self.item_to_idx = self._encoder_maps()
        self.user_item_matrix = self._interaction_matrix(self.user_to_idx,
                                                         self.item_to_idx)
        print("Calculating user similarities for UserKNN...")
        if self.user_item_matrix.nnz > 0 and self.user_item_matrix.shape[0] > 0:
            self.user_similarities = cosine_similarity(self.user_item_matrix)
        else:
            n = len(self.user_to_idx)
            self.user_similarities = csr_matrix((n, n))
            if self.user_item_matrix.nnz == 0:
                print("Warning: No interactions available for UserKNN model "
                      "building after filtering.")

    def _neighbors(self, target_user_idx: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(neighbor indices, similarity weights): top-k by similarity
        (numpy's default argsort, as the JAX package), positive
        similarities only, self excluded."""
        sims = np.asarray(
            self.user_similarities[target_user_idx].todense()).ravel()
        sims[target_user_idx] = 0
        order = np.argsort(sims)[-self.k_neighbors:][::-1]
        order = order[sims[order] > 1e-9]
        return order, sims[order]

    def get_recommendations(self, user_id: Any, top_k: int = 10,
                            filter_seen: bool = True,
                            candidates: Optional[List[str]] = None
                            ) -> List[Tuple[str, float]]:
        user_id = str(user_id)
        if user_id not in self.user_to_idx:
            print(f"User {user_id} not in encoder. Falling back to "
                  "PopularityRecommender.")
            return PopularityRecommender(
                self.dataset,
                history_interactions_df=self.interactions_for_model
            ).get_recommendations(user_id, top_k, filter_seen, candidates)
        target = self.user_to_idx[user_id]
        if target >= self.user_similarities.shape[0]:
            return []
        neighbors, weights = self._neighbors(target)
        if len(neighbors) == 0:
            print("No similar users found with positive similarity.")
            return []

        # weights @ neighbor interaction rows, normalized by weight sum.
        item_scores = np.asarray(
            (weights[None, :] @ self.user_item_matrix[neighbors])).ravel()
        total = weights.sum()
        if total > 1e-9:
            item_scores /= total

        seen = self.get_user_history(user_id)
        pool = ([str(i) for i in candidates] if candidates is not None
                else self.all_items)
        recs = []
        for item in pool:
            item = str(item)
            idx = self.item_to_idx.get(item)
            if idx is None:
                continue
            if filter_seen and item in seen:
                continue
            recs.append((item, float(item_scores[idx])))
        recs.sort(key=lambda x: x[1], reverse=True)
        return recs[:top_k]

    def get_item_score(self, user_id: str, item_id: str) -> float:
        user_id, item_id = str(user_id), str(item_id)
        if user_id not in self.user_to_idx or item_id not in self.item_to_idx:
            return 0.0
        target_user = self.user_to_idx[user_id]
        target_item = self.item_to_idx[item_id]
        if (target_user >= self.user_similarities.shape[0]
                or target_item >= self.user_item_matrix.shape[1]):
            return 0.0
        neighbors, weights = self._neighbors(target_user)
        if len(neighbors) == 0:
            return 0.0
        interactions = np.asarray(
            self.user_item_matrix[neighbors, target_item].todense()).ravel()
        total = weights.sum()
        return float((weights * interactions).sum() / total) if total > 1e-9 \
            else 0.0
