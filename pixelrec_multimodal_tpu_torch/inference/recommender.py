# pixelrec_multimodal_tpu_torch/inference/recommender.py
"""User-facing recommendation interface over the catalog scorer.

Counterpart of ``pixelrec_multimodal_tpu/inference/recommender.py``: top-K
for one user or many, with unknown-user handling, candidate validation and
the seen filter; pair scores; maximal-marginal-relevance (MMR) diversity;
and the attention cascade's routing (an explicit candidate count, or
``'auto'``: a calibrated plan installed once per k). Every call goes
through ``CatalogScorer``, so on the card the top-K runs the head's kernel
(K1 for concatenate fusion, K1q with ``precision='int8'``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .scorer import CatalogScorer


def mmr_select(rel: np.ndarray, sim: np.ndarray, top_k: int,
               diversity_weight: float) -> List[int]:
    """Greedy MMR over one user's pool, most relevant first.

    ``rel`` [n] float32 relevance in pool order (rel[0] the largest),
    ``sim`` [n, n] float32 cosine similarities. The pool's first item
    leads; each next pick maximizes ``(1 - w) * rel_norm - w * penalty``
    over the items not yet picked, where ``penalty`` is an item's largest
    similarity to a picked one. The JAX package recomputes every penalty
    in a Python loop over ``set(range(1, n))``; here a running maximum is
    updated once per pick and ``argmax`` takes the first largest score.
    The picks are the same: a set of small ints iterates in ascending
    order and the loop keeps its first strict maximum, as ``argmax`` does;
    and the arithmetic is the same float32 arithmetic, since NumPy 2
    (held with 2.0.2) promotes a Python float against a float32 scalar to
    float32, which ``np.float32`` of the weights reproduces.
    """
    n = len(rel)
    span = float(rel.max() - rel.min()) or 1.0
    rel_norm = (rel - rel.min()) / span
    w = diversity_weight
    gain = np.float32(1.0 - w) * rel_norm
    w32 = np.float32(w)
    selected = [0]
    taken = np.zeros(n, dtype=bool)
    taken[0] = True
    penalty = sim[:, 0].copy()
    for _ in range(min(top_k, n) - 1):
        score = gain - w32 * penalty
        score[taken] = -np.inf
        j = int(np.argmax(score))
        selected.append(j)
        taken[j] = True
        np.maximum(penalty, sim[:, j], out=penalty)
    return selected


class Recommender:
    """Wraps a trained model + dataset for top-K generation and pair
    scoring.

    The JAX package's constructor takes the model's ``variables``; here
    the weights live in ``model`` itself, which ``CatalogScorer`` reads
    (and moves to ``device``). ``mesh`` (``parallel/mesh.py:Mesh``) goes
    to the scorer, which shards the catalog over it; every rank of the
    mesh then makes the same calls and gets the same lists.
    ``cascade_candidates`` (an int C or
    ``'auto'``) applies to attention fusion only; ``cascade_recall`` is the
    recall target of ``'auto'`` and lies in (0, 1].
    """

    def __init__(self, model, dataset,
                 item_chunk: Optional[int] = None,
                 user_chunk: Optional[int] = None,
                 mesh=None, precision: str = 'bf16',
                 cascade_candidates: Optional[Union[int, str]] = None,
                 cascade_screen: str = 'additive',
                 cascade_recall: float = 1.0,
                 cascade_c1: Optional[int] = None,
                 device: Union[str, torch.device] = 'cuda'):
        if cascade_candidates is not None and model.fusion_type != 'attention':
            raise ValueError('cascade_candidates applies to attention '
                             f'fusion only (got {model.fusion_type!r})')
        if not 0.0 < cascade_recall <= 1.0:
            raise ValueError(
                f"cascade_recall must be in (0, 1], got {cascade_recall}")
        self.model = model
        self.dataset = dataset
        self.scorer = CatalogScorer(model, dataset.feature_store,
                                    item_chunk=item_chunk,
                                    user_chunk=user_chunk, mesh=mesh,
                                    precision=precision, device=device)
        self.cascade_auto = cascade_candidates == 'auto'
        self.cascade_candidates = (None if self.cascade_auto
                                   else cascade_candidates)
        self.cascade_screen = cascade_screen
        self.cascade_c1 = cascade_c1
        self.cascade_recall = cascade_recall
        self._auto_failed_k: Optional[int] = None
        self._user_classes = set(
            map(str, getattr(dataset.user_encoder, 'classes_', [])))
        self._item_classes = set(
            map(str, getattr(dataset.item_encoder, 'classes_', [])))
        # CSR history for the seen masks.
        self._hist_indptr, self._hist_items = dataset.user_history_matrix()

    # ------------------------------------------------------------ single-user
    def get_recommendations(self, user_id: str, top_k: int = 10,
                            filter_seen: bool = True,
                            candidates: Optional[List[str]] = None
                            ) -> List[Tuple[str, float]]:
        """Top-K (item_id, score) for one user; [] for an unknown user, or
        when no candidate is known (or every one is seen)."""
        user_id = str(user_id)
        if user_id not in self._user_classes:
            print(f"Warning: User '{user_id}' not found in the trained "
                  "user encoder.")
            return []
        uidx = int(self.dataset.user_encoder.transform([user_id])[0])

        if candidates is not None:
            valid = [str(c) for c in candidates if str(c) in self._item_classes]
            if not valid:
                return []
            cand_idx = self.dataset.item_encoder.transform(valid)
            if filter_seen:
                seen = self._seen_set(uidx)
                keep = [j for j, ci in enumerate(cand_idx) if ci not in seen]
                if not keep:
                    return []
                valid = [valid[j] for j in keep]
                cand_idx = cand_idx[keep]
            scores = self.scorer.score_candidates(
                np.asarray([uidx]), np.asarray(cand_idx)[None, :])[0]
            order = np.argsort(-scores)[:top_k]
            return [(valid[j], float(scores[j])) for j in order]

        recs = self.get_recommendations_batch([user_id], top_k=top_k,
                                              filter_seen=filter_seen)
        return recs[user_id]

    def get_diverse_recommendations(self, user_id: str, top_k: int = 10,
                                    diversity_weight: float = 0.3,
                                    filter_seen: bool = True,
                                    pool_size: Optional[int] = None
                                    ) -> List[Tuple[str, float]]:
        """Diversity-aware top-K by MMR for one user
        (``get_diverse_recommendations_batch``)."""
        if not 0.0 <= diversity_weight <= 1.0:
            raise ValueError(
                f"diversity_weight must be in [0, 1], got {diversity_weight}")
        if str(user_id) not in self._user_classes:
            print(f"Warning: User '{user_id}' not found in the trained "
                  "user encoder.")
            return []
        return self.get_diverse_recommendations_batch(
            [user_id], top_k=top_k, diversity_weight=diversity_weight,
            filter_seen=filter_seen, pool_size=pool_size)[str(user_id)]

    def get_diverse_recommendations_batch(
            self, user_ids: List[str], top_k: int = 10,
            diversity_weight: float = 0.3, filter_seen: bool = True,
            pool_size: Optional[int] = None
            ) -> Dict[str, List[Tuple[str, float]]]:
        """MMR reranking for many users: one batched top-K retrieves every
        user's relevance-ranked pool (``max(5 top_k, 100)`` items, at most
        the catalog), one gather brings the pooled items' representations
        (the scorer's item tower, flattened and L2-normalized) to the host,
        and ``mmr_select`` picks each user's list. Returned scores are the
        model's relevance scores, in MMR order."""
        if not 0.0 <= diversity_weight <= 1.0:
            raise ValueError(
                f"diversity_weight must be in [0, 1], got {diversity_weight}")
        if diversity_weight == 0.0:  # pure relevance: skip the pool retrieval
            return self.get_recommendations_batch(user_ids, top_k=top_k,
                                                  filter_seen=filter_seen)
        pool = pool_size or max(top_k * 5, 100)
        pool = min(pool, self.dataset.n_items)
        ranked = self.get_recommendations_batch(user_ids, top_k=pool,
                                                filter_seen=filter_seen)

        # One gather for the union of pooled items across all users.
        all_items = sorted({iid for recs in ranked.values()
                            for iid, _ in recs})
        if not all_items:
            return {u: recs[:top_k] for u, recs in ranked.items()}
        all_idx = np.asarray(self.dataset.item_encoder.transform(all_items))
        feats = self.scorer.item_rows(all_idx)
        emb = feats.float().cpu().numpy().reshape(len(all_idx), -1)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12
        row_of = {iid: r for r, iid in enumerate(all_items)}

        out: Dict[str, List[Tuple[str, float]]] = {}
        for u, recs in ranked.items():
            if len(recs) <= 1:
                out[u] = recs[:top_k]
                continue
            item_ids = [iid for iid, _ in recs]
            rel = np.asarray([s for _, s in recs], dtype=np.float32)
            rows = emb[[row_of[iid] for iid in item_ids]]
            picks = mmr_select(rel, rows @ rows.T, top_k, diversity_weight)
            out[u] = [(item_ids[j], float(rel[j])) for j in picks]
        return out

    def get_item_score(self, user_id: str, item_id: str) -> float:
        """Predicted score for one pair; 0.0 for an unknown user or item."""
        user_id, item_id = str(user_id), str(item_id)
        if user_id not in self._user_classes or item_id not in self._item_classes:
            return 0.0
        uidx = int(self.dataset.user_encoder.transform([user_id])[0])
        iidx = int(self.dataset.item_encoder.transform([item_id])[0])
        s = self.scorer.score_candidates(np.asarray([uidx]),
                                         np.asarray([[iidx]]))
        return float(s[0, 0])

    # ---------------------------------------------------------------- batched
    def get_recommendations_batch(self, user_ids: List[str], top_k: int = 10,
                                  filter_seen: bool = True
                                  ) -> Dict[str, List[Tuple[str, float]]]:
        """Top-K for many users in one scorer pass; unknown users get []."""
        known = [u for u in map(str, user_ids) if u in self._user_classes]
        out: Dict[str, List[Tuple[str, float]]] = {
            str(u): [] for u in user_ids}
        if not known:
            return out
        uidx = self.dataset.user_encoder.transform(known).astype(np.int32)
        seen_mask = self._seen_mask(uidx) if filter_seen else None
        if self.cascade_candidates is not None:
            values, idx = self.scorer.top_k_cascade(
                uidx, top_k, n_candidates=self.cascade_candidates,
                seen_mask=seen_mask, screen=self.cascade_screen,
                funnel_c1=self.cascade_c1)
        else:
            if self.cascade_auto:
                self._ensure_auto_cascade(top_k)
            values, idx = self.scorer.top_k(uidx, top_k, seen_mask=seen_mask)
        item_classes = np.asarray(self.dataset.item_encoder.classes_).astype(str)
        for u, vs, ids in zip(known, values, idx):
            out[u] = [(str(item_classes[i]), float(v))
                      for v, i in zip(vs, ids) if i >= 0]
        return out

    def score_candidates_batch(self, user_indices: np.ndarray,
                               candidate_idx: np.ndarray,
                               candidate_mask: Optional[np.ndarray] = None
                               ) -> np.ndarray:
        """[B] users x [B, C] candidate positions -> [B, C] scores (indices
        are encoder positions, not raw ids)."""
        return self.scorer.score_candidates(user_indices, candidate_idx,
                                            candidate_mask)

    # --------------------------------------------------------- auto cascade
    def _ensure_auto_cascade(self, k: int) -> None:
        """Install the measured-recall cascade plan once per k increase,
        calibrated on the whole trained user range; when no screen tier
        reaches the recall target the scorer keeps the exact scan, and the
        failed k is remembered so that a later call with k no larger does
        not calibrate again."""
        plan = self.scorer._cascade_plan
        if plan is not None and plan['k'] >= k:
            return
        if self._auto_failed_k is not None and k <= self._auto_failed_k:
            return
        n_users = len(self.dataset.user_encoder.classes_)
        res = self.scorer.auto_cascade(
            np.arange(n_users, dtype=np.int32), k,
            recall_target=self.cascade_recall)
        if res is None:
            self._auto_failed_k = max(k, self._auto_failed_k or 0)

    # ----------------------------------------------------------------- history
    def _seen_set(self, uidx: int) -> set:
        lo, hi = self._hist_indptr[uidx], self._hist_indptr[uidx + 1]
        return set(self._hist_items[lo:hi].tolist())

    def _seen_mask(self, user_indices: np.ndarray) -> np.ndarray:
        """[B, n_items] bool mask of the items each user interacted with."""
        mask = np.zeros((len(user_indices), self.dataset.n_items), dtype=bool)
        for row, uidx in enumerate(user_indices):
            lo, hi = self._hist_indptr[uidx], self._hist_indptr[uidx + 1]
            mask[row, self._hist_items[lo:hi]] = True
        return mask

    def _get_user_interactions(self, user_id: str) -> set:
        """The user's history as original item ids."""
        return self.dataset.get_user_history(str(user_id))

    # -------------------------------------------------------------- cache API
    def print_cache_stats(self):
        """The feature store's image-tier statistics and its tables."""
        stats = self.dataset.feature_store.get_stats()
        print(f"Feature store image tier: {stats['memory_items']} items, "
              f"hit rate {stats['hit_rate']:.2f}")
        print(f"Packed tables: {sorted(self.dataset.feature_store.tables)}")

    def clear_cache(self):
        """Clear the lazy image tier (the tables stay)."""
        self.dataset.feature_store._image_cache.clear()
        print("Feature cache cleared")
