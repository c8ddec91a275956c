# pixelrec_multimodal_tpu_torch/evaluation/tasks.py
"""Retrieval and ranking evaluators.

Counterpart of ``pixelrec_multimodal_tpu/evaluation/tasks.py``: the
``EvaluationTask`` enum, ``TopKRetrievalEvaluator`` (per-user seeded
negative sampling, candidate-set or full-catalog ranking, the accuracy
metrics, then the novelty, diversity and personalization pass) and
``TopKRankingEvaluator``, the factory and the string mapping, whose
removed legacy tasks raise.

Test data is a dict of numpy columns or a DataFrame
(``data/columns.as_columns``), its ids read as strings. Users are taken
as pandas' ``groupby('user_id')`` takes them: sorted string ids, each
user's rows in row order. That order is the order of the results and of
the predictions, and the order in which the random baseline draws.

A learned recommender (one with ``score_candidates_batch``) scores every
user's candidates in one batched call on its device, and a failure there
raises: the JAX package logs a warning and falls back to the per-user
path. Recommenders without it (the baselines, host code) take the
per-user path, where an error is printed and the user scored empty, as in
the JAX package.

Seeds: ``stable_user_seed`` hashes the user id with builtin ``hash`` where
``PYTHONHASHSEED`` is pinned and with blake2b otherwise, as the JAX
package does, so both draw the same negatives. No pandas and no scipy:
personalization sums its sparse indicator matrix with numpy in the order
scipy sums it.
"""
from __future__ import annotations

import hashlib
import logging
import os
import random
from abc import ABC, abstractmethod
from enum import Enum
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from ..data.columns import as_columns, group_rows, n_rows, value_counts
from ..data.splitting import unique_in_order
from .novelty import NoveltyMetrics

# (user id, the user's test item ids in row order)
UserGroups = List[Tuple[str, List[str]]]
# (user id, [(item id, score)], positives, recommended item ids)
Ranked = List[Tuple[str, List[Tuple[str, float]], List[str], List[str]]]


class EvaluationTask(Enum):
    """Available evaluation tasks."""
    TOP_K_RETRIEVAL = "top_k_retrieval"
    TOP_K_RANKING = "top_k_ranking"


def stable_user_seed(user_id: str, suffix: str = '') -> int:
    """Per-user 31-bit seed: builtin ``hash`` where ``PYTHONHASHSEED`` is
    pinned, blake2b otherwise."""
    s = str(user_id) + suffix
    if os.environ.get('PYTHONHASHSEED') not in (None, 'random'):
        return hash(s) % (2 ** 31)
    digest = hashlib.blake2b(s.encode('utf-8'), digest_size=8).digest()
    return int.from_bytes(digest, 'little') % (2 ** 31)


class BaseEvaluator(ABC):
    """Shared evaluator state and reporting."""

    def __init__(self, recommender, test_data, config, task_name: str,
                 **kwargs):
        self.recommender = recommender
        self.config = config
        self.task_name = task_name
        self.top_k = getattr(config.recommendation, 'top_k', 20)
        self.filter_seen = kwargs.get('filter_seen', True)
        self.test_data = as_columns(test_data)
        self.test_data['user_id'] = self.test_data['user_id'].astype(str)
        self.test_data['item_id'] = self.test_data['item_id'].astype(str)
        logging.basicConfig(level=logging.INFO)
        self.logger = logging.getLogger(self.__class__.__name__)

    @abstractmethod
    def evaluate(self) -> Dict[str, Any]:
        ...

    def _user_groups(self) -> UserGroups:
        """Each test user's items, users in ``groupby('user_id')`` order."""
        users, rows = group_rows(self.test_data['user_id'])
        items = self.test_data['item_id']
        return [(u, items[r].tolist()) for u, r in zip(users.tolist(), rows)]

    def print_summary(self, results: Dict[str, Any]):
        print(f"\n=== {self.task_name} Results ===")
        for metric, value in results.items():
            if metric in ('evaluation_metadata', 'predictions'):
                continue
            if isinstance(value, float):
                print(f"{metric}: {value:.4f}")
            else:
                print(f"{metric}: {value}")


def _ndcg_min_relevant(ranked_items: List[str], relevant_items: set,
                       k: int) -> float:
    """The evaluators' NDCG: IDCG over ``min(|relevant|, k)`` hits (the
    library ``metrics.calculate_ndcg`` takes it from the realized list)."""
    if not relevant_items:
        return 0.0
    dcg = sum(1.0 / np.log2(i + 1)
              for i, item in enumerate(ranked_items[:k], 1)
              if item in relevant_items)
    num_rel = min(len(relevant_items), k)
    idcg = sum(1.0 / np.log2(i + 2) for i in range(num_rel))
    return dcg / idcg if idcg > 0 else 0.0


class TopKRetrievalEvaluator(BaseEvaluator):
    """Candidate-set retrieval evaluation with sampled negatives.

    ``full_catalog`` ranks each user's top-K over the whole catalog (the
    scorer's blocked top-K: the concat head's kernel K1, or K1q in int8,
    on the card); ``use_sampling=False`` ranks the positives alone."""

    def __init__(self, recommender, test_data, config,
                 use_sampling: bool = True, num_negatives: int = 100,
                 sampling_strategy: str = 'random',
                 full_catalog: bool = False, **kwargs):
        super().__init__(recommender, test_data, config, "Top-K Retrieval",
                         **kwargs)
        self.use_sampling = use_sampling
        self.num_negatives = num_negatives
        self.sampling_strategy = sampling_strategy
        self.full_catalog = full_catalog
        self.num_workers = kwargs.get('num_workers', 1)  # kept, unused

    # ----------------------------------------------------------- candidates
    def _get_all_item_ids(self) -> List[str]:
        """The catalog from the recommender's item encoder, else the test
        data's items in order of appearance."""
        ds = getattr(self.recommender, 'dataset', None)
        enc = getattr(ds, 'item_encoder', None) if ds is not None else None
        classes = getattr(enc, 'classes_', None)
        if classes is not None:
            return [str(i) for i in classes]
        return unique_in_order(self.test_data['item_id']).tolist()

    def _catalog_arrays(self):
        """Catalog id list, id->position map and test-count weights (a
        catalog item's count in the test data, 1.0 where it has none),
        built once per evaluator."""
        cache = getattr(self, '_catalog_cache', None)
        if cache is None:
            all_items = self._get_all_item_ids()
            pos_of = {item: i for i, item in enumerate(all_items)}
            counts = value_counts(self.test_data['item_id'])
            counts_arr = np.asarray([float(counts.get(i, 1.0))
                                     for i in all_items], dtype=np.float64)
            cache = self._catalog_cache = (all_items, pos_of, counts_arr)
        return cache

    def _sample_negatives(self, user_id: str,
                          positive_items: List[str]) -> List[str]:
        """Seeded per-user negatives, drawn as the JAX package draws them:
        positions into the virtual candidate list (the catalog less this
        user's positives, in order), ``random.Random(seed).sample`` for
        'random', ``RandomState(seed).choice(..., replace=False, p=p)``
        over the test-count weights for 'popularity' (inverse weights for
        'popularity_inverse')."""
        all_items, pos_of, counts_arr = self._catalog_arrays()
        pos = {str(i) for i in positive_items}
        pos_positions = sorted(pos_of[p] for p in pos if p in pos_of)
        n_candidates = len(all_items) - len(pos_positions)

        def virt(j: int) -> str:
            # j-th element of the catalog with positives skipped.
            for q in pos_positions:
                if q <= j:
                    j += 1
                else:
                    break
            return all_items[j]

        if n_candidates < self.num_negatives:
            return [virt(j) for j in range(n_candidates)]
        if not n_candidates:
            return []

        seed = stable_user_seed(user_id)
        n = min(self.num_negatives, n_candidates)

        if self.sampling_strategy == 'random':
            idxs = random.Random(seed).sample(range(n_candidates), n)
            return [virt(j) for j in idxs]

        raw = (np.delete(counts_arr, pos_positions) if pos_positions
               else counts_arr.copy())
        if self.sampling_strategy == 'popularity_inverse':
            raw = 1.0 / raw
        if raw.sum() == 0:
            raw = np.ones_like(raw)
        p = raw / raw.sum()
        rng = np.random.RandomState(seed)
        try:
            picked = rng.choice(n_candidates, size=n, replace=False, p=p)
            return [virt(int(j)) for j in picked]
        except ValueError as e:
            print(f"Warning: {self.sampling_strategy} sampling failed for "
                  f"user {user_id}: {e}. Using random sampling.")
            idxs = random.Random(seed).sample(range(n_candidates), n)
            return [virt(j) for j in idxs]

    def _candidate_set(self, user_id: str,
                       positive_items: List[str]) -> List[str]:
        """Positives + sampled negatives, deduplicated and seed-shuffled."""
        candidates = list(positive_items)
        if self.use_sampling:
            candidates.extend(self._sample_negatives(user_id, positive_items))
        candidates = list(dict.fromkeys(candidates))
        random.Random(stable_user_seed(user_id, 'shuffle')).shuffle(candidates)
        return candidates

    # -------------------------------------------------------------- scoring
    def _rank_all_users(self, user_groups: UserGroups) -> Ranked:
        """Per user (user_id, recommendations, positives, recommended ids):
        a learned recommender's candidates padded into one [U, C_max]
        index matrix and scored in one batched call."""
        users, candidates, positives = [], [], []
        for user_id, pos in user_groups:
            users.append(user_id)
            positives.append(pos)
            if not self.full_catalog:
                candidates.append(
                    self._candidate_set(user_id, pos) if pos else [])

        if self.full_catalog:
            return self._rank_full_catalog(users, positives)
        if hasattr(self.recommender, 'score_candidates_batch'):
            return self._rank_batched(users, candidates, positives)
        return self._rank_sequential(users, candidates, positives)

    def _rank_full_catalog(self, users, positives) -> Ranked:
        """Top-K over the whole catalog per user, with ``filter_seen=False``
        so that every test positive stays rankable: one batched scorer
        pass for a learned recommender, the per-user full-catalog ranking
        for a baseline."""
        rec = self.recommender
        if hasattr(rec, 'get_recommendations_batch'):
            out = rec.get_recommendations_batch(
                users, top_k=self.top_k, filter_seen=False)
        else:
            out = {}
            for u in users:
                try:
                    out[u] = rec.get_recommendations(
                        u, top_k=self.top_k, filter_seen=False)
                except Exception as e:
                    print(f"Error evaluating user {u}: {e}")
                    out[u] = []
        results = []
        for u, pos in zip(users, positives):
            recs = [(str(i), float(s)) for i, s in out.get(u, [])]
            results.append((u, recs, pos, [i for i, _ in recs]))
        return results

    def _rank_batched(self, users, candidates, positives) -> Ranked:
        ds = self.recommender.dataset
        known_users = set(map(str, ds.user_encoder.classes_))
        known_items = set(map(str, ds.item_encoder.classes_))

        rows = [i for i, u in enumerate(users)
                if u in known_users and candidates[i]]
        results = [(u, [], positives[i], []) for i, u in enumerate(users)]
        if not rows:
            return results

        c_max = max(len(candidates[i]) for i in rows)
        uidx = ds.user_encoder.transform([users[i] for i in rows])
        cand_idx = np.zeros((len(rows), c_max), dtype=np.int32)
        cand_mask = np.zeros((len(rows), c_max), dtype=bool)
        cand_ids: List[List[str]] = [
            [c for c in candidates[i] if c in known_items] for i in rows]
        flat = [c for valid in cand_ids for c in valid]
        if flat:
            flat_enc = ds.item_encoder.transform(flat)
            pos = 0
            for r, valid in enumerate(cand_ids):
                n = len(valid)
                if n:
                    cand_idx[r, :n] = flat_enc[pos:pos + n]
                    cand_mask[r, :n] = True
                pos += n

        scores = self.recommender.score_candidates_batch(
            np.asarray(uidx, np.int32), cand_idx, cand_mask)

        for r, i in enumerate(rows):
            valid = cand_ids[r]
            if not valid:
                continue
            s = scores[r, :len(valid)]
            order = np.argsort(-s)[: self.top_k]
            recs = [(valid[j], float(s[j])) for j in order]
            results[i] = (users[i], recs, positives[i],
                          [it for it, _ in recs])
        return results

    def _rank_sequential(self, users, candidates, positives) -> Ranked:
        """The duck-typed per-user path (the baselines)."""
        out = []
        for u, cands, pos in zip(users, candidates, positives):
            if not pos:
                out.append((u, [], [], []))
                continue
            try:
                recs = self.recommender.get_recommendations(
                    user_id=u, top_k=self.top_k, filter_seen=False,
                    candidates=cands)
                recs = [(str(i), s) for i, s in recs] if recs else []
                out.append((u, recs, pos, [i for i, _ in recs]))
            except Exception as e:
                print(f"Error evaluating user {u}: {e}")
                out.append((u, [], pos, []))
        return out

    # ---------------------------------------------------------------- metrics
    @staticmethod
    def _calculate_personalization(predicted_lists: List[list]) -> float:
        """1 - mean pairwise cosine of the users' recommendation sets.

        The users x recommended-items indicator matrix (columns in order of
        first appearance, duplicates summed), rows normalized (a zero row
        stays zero); the sum of cos(u, v) over all ordered pairs is then
        ``||sum_u u_hat||^2``, of which the nonzero rows' own pairs are 1
        each. The JAX package builds the matrix in ``scipy.sparse``; here
        its entries are summed in row-major order (``np.bincount``), the
        order in which scipy's column sum accumulates them, so the result
        is the same to the bit.
        """
        if not predicted_lists:
            return 0.0
        n = len(predicted_lists)
        if n <= 1:
            return 1.0
        col_of: Dict[str, int] = {}
        rows, cols = [], []
        for uidx, recs in enumerate(predicted_lists):
            for item in recs:
                rows.append(uidx)
                cols.append(col_of.setdefault(item, len(col_of)))
        width = max(len(col_of), 1)
        flat, value = np.unique(
            np.asarray(rows, np.int64) * width + np.asarray(cols, np.int64),
            return_counts=True)
        row, value = flat // width, value.astype(np.float64)
        norms = np.sqrt(np.bincount(row, weights=value * value, minlength=n))
        nz = norms > 0
        inv = np.zeros_like(norms)
        inv[nz] = 1.0 / norms[nz]
        colsum = np.bincount(flat % width, weights=inv[row] * value,
                             minlength=width)
        total = float(colsum @ colsum)           # sum over ordered pairs
        mean_cos = (total - int(nz.sum())) / (n * (n - 1))
        return 1 - mean_cos

    def _item_input_embeddings(self, item_ids: Set[str]
                               ) -> Optional[Dict[str, np.ndarray]]:
        """Each recommended item's input features concatenated, for
        intra-list similarity: the tag index, the numerical features and
        the vision and language embedding tables the feature store holds,
        in float64, from one encoder transform and one gather."""
        ds = getattr(self.recommender, 'dataset', None)
        store = getattr(ds, 'feature_store', None) if ds is not None else None
        if store is None:
            return None
        enc = ds.item_encoder
        known = set(map(str, enc.classes_))
        ids = [str(i) for i in item_ids if str(i) in known]
        if not ids:
            return None
        pos = np.asarray(enc.transform(ids), np.int64)
        cols = [np.asarray(store.tables['tag_idx'], np.float64)[pos, None]]
        if 'numerical' in store.tables:
            cols.append(store.tables['numerical'][pos].astype(np.float64))
        for key in ('vision_emb', 'language_emb'):
            if key in store.tables:
                cols.append(store.tables[key][pos].astype(np.float64))
        mat = np.concatenate(cols, axis=1)
        return {i: mat[j] for j, i in enumerate(ids)}

    def _accuracy_metrics(self, raw: Ranked) -> Dict[str, Any]:
        """Precision, recall, F1, hit rate, NDCG and MRR at K, averaged
        over the users, with the predictions."""
        num_users = len(raw)
        all_predictions = {r[0]: r[1] for r in raw}
        all_pos = [r[2] for r in raw]
        all_rec = [r[3] for r in raw]

        hits_at_k = np.zeros(num_users)
        prec_den = np.asarray([len(r) for r in all_rec], dtype=np.float32)
        rec_den = np.asarray([len(p) for p in all_pos], dtype=np.float32)
        mrr = np.zeros(num_users)
        ndcg = np.zeros(num_users)

        for i in range(num_users):
            pos_set = set(all_pos[i])
            if not pos_set:
                continue
            rec_list = all_rec[i]
            hits_at_k[i] = len(set(rec_list) & pos_set)
            for j, item in enumerate(rec_list, 1):
                if item in pos_set:
                    mrr[i] = 1.0 / j
                    break
            ndcg[i] = _ndcg_min_relevant(rec_list, pos_set, self.top_k)

        with np.errstate(divide='ignore', invalid='ignore'):
            precision = hits_at_k / prec_den
            recall = hits_at_k / rec_den
        precision[np.isnan(precision)] = 0.0
        recall[np.isnan(recall)] = 0.0
        with np.errstate(divide='ignore', invalid='ignore'):
            f1 = 2 * precision * recall / (precision + recall)
        f1[np.isnan(f1)] = 0.0
        hit_rate = (hits_at_k > 0).astype(float)

        return {
            'avg_precision_at_k': float(np.mean(precision)) if num_users else 0.0,
            'avg_recall_at_k': float(np.mean(recall)) if num_users else 0.0,
            'avg_f1_at_k': float(np.mean(f1)) if num_users else 0.0,
            'avg_hit_rate_at_k': float(np.mean(hit_rate)) if num_users else 0.0,
            'avg_ndcg_at_k': float(np.mean(ndcg)) if num_users else 0.0,
            'avg_mrr': float(np.mean(mrr)) if num_users else 0.0,
            'num_users_evaluated': num_users,
            'evaluation_method': (
                'full_catalog' if self.full_catalog
                else 'negative_sampling' if self.use_sampling
                else 'full_evaluation'),
            'predictions': all_predictions,
        }

    def _novelty_metrics(self, all_predictions: Dict[str, list]
                         ) -> Dict[str, float]:
        """Self-information, IIF, coverage, personalization, intra-list
        similarity and personalized novelty over the recommender's dataset
        interactions; empty where the dataset has none."""
        print("\nCalculating Novelty and Diversity Metrics...")
        ds = getattr(self.recommender, 'dataset', None)
        inter = getattr(ds, 'interactions', None) if ds is not None else None
        inter = as_columns(inter) if inter is not None else None
        if inter is None or not n_rows(inter):
            self.logger.warning(
                "Recommender's dataset does not have 'interactions' or it's "
                "empty. Skipping novelty metrics.")
            return {}

        users = inter['user_id'].astype(str)
        items = inter['item_id'].astype(str)
        item_popularity = value_counts(items)
        history = list(zip(users.tolist(), items.tolist()))

        recommended_ids = {i for recs in all_predictions.values()
                           for i, _ in recs}
        item_embeddings = (self._item_input_embeddings(recommended_ids)
                           if recommended_ids else None)
        calc = NoveltyMetrics(item_popularity=item_popularity,
                              user_history=history,
                              item_embeddings=item_embeddings)

        per_user = {}
        for user_id, recs in all_predictions.items():
            per_user[user_id] = calc.calculate_metrics(
                recommendations=[i for i, _ in recs], user_id=user_id)

        def collect(key, drop_nan=False):
            vals = [m[key] for m in per_user.values() if key in m]
            if drop_nan:
                vals = [v for v in vals if not np.isnan(v)]
            return float(np.mean(vals)) if vals else 0.0

        return {
            'avg_self_information': collect('avg_self_information'),
            'avg_iif': collect('avg_iif'),
            'avg_catalog_coverage': collect('catalog_coverage'),
            'avg_personalization': self._calculate_personalization(
                [[i for i, _ in recs] for recs in all_predictions.values()]),
            'avg_intra_list_similarity': collect('intra_list_similarity',
                                                 drop_nan=True),
            'avg_personalized_novelty': collect('personalized_novelty'),
        }

    # -------------------------------------------------------------- evaluate
    def evaluate(self) -> Dict[str, Any]:
        """Rank every test user, then the accuracy and novelty passes."""
        print(f"Evaluating Top-K Retrieval (K={self.top_k})")
        if self.full_catalog:
            print("Full-catalog mode: ranking every user's top-K over the "
                  "entire catalog")
        elif self.use_sampling:
            print(f"Using negative sampling: {self.num_negatives} negatives "
                  f"per user, strategy: {self.sampling_strategy}")

        user_groups = self._user_groups()
        np.random.seed(42)
        random.seed(42)

        results = self._accuracy_metrics(self._rank_all_users(user_groups))
        results.update(self._novelty_metrics(results['predictions']))
        return results


class TopKRankingEvaluator(BaseEvaluator):
    """Ranks each user's test items by model score."""

    def __init__(self, recommender, test_data, config, **kwargs):
        super().__init__(recommender, test_data, config, "Top-K Ranking",
                         **kwargs)

    def evaluate(self) -> Dict[str, Any]:
        print(f"Evaluating Top-K Ranking (K={self.top_k})")
        metrics = {'avg_rank': [], 'median_rank': [], 'mrr': [],
                   'hit_rate_at_k': [], 'ndcg_at_k': []}
        all_predictions: Dict[str, List[Tuple[str, float]]] = {}
        user_groups = self._user_groups()

        batched = self._batched_scores(user_groups)

        for user_id, test_items in user_groups:
            try:
                if batched is not None and user_id in batched:
                    item_scores = batched[user_id]
                else:
                    item_scores = []
                    for item_id in test_items:
                        try:
                            s = self.recommender.get_item_score(user_id,
                                                                item_id)
                        except Exception as e:
                            print(f"Error getting score for user {user_id}, "
                                  f"item {item_id}: {e}")
                            s = 0.0
                        item_scores.append((item_id, s))
                if not item_scores:
                    for v in metrics.values():
                        v.append(0.0)
                    continue
                all_predictions[user_id] = list(item_scores)
                item_scores = sorted(item_scores, key=lambda x: x[1],
                                     reverse=True)
                ranked_items = [i for i, _ in item_scores]
                ranks = list(range(1, len(item_scores) + 1))
                metrics['avg_rank'].append(float(np.mean(ranks)))
                metrics['median_rank'].append(float(np.median(ranks)))
                metrics['mrr'].append(1.0 / ranks[0] if ranks else 0.0)
                hits = sum(1 for r in ranks if r <= self.top_k)
                metrics['hit_rate_at_k'].append(
                    hits / len(test_items) if test_items else 0.0)
                metrics['ndcg_at_k'].append(_ndcg_min_relevant(
                    ranked_items, set(test_items), self.top_k))
            except Exception as e:
                print(f"Error evaluating ranking for user {user_id}: {e}")
                metrics['avg_rank'].append(float('inf'))
                metrics['median_rank'].append(float('inf'))
                metrics['mrr'].append(0.0)
                metrics['hit_rate_at_k'].append(0.0)
                metrics['ndcg_at_k'].append(0.0)

        results: Dict[str, Any] = {}
        for name, values in metrics.items():
            if values:
                if name in ('avg_rank', 'median_rank'):
                    finite = [v for v in values if np.isfinite(v)]
                    if finite:
                        results[f'avg_{name}'] = float(np.mean(finite))
                        results[f'std_{name}'] = float(np.std(finite))
                    else:
                        results[f'avg_{name}'] = float('inf')
                        results[f'std_{name}'] = 0.0
                else:
                    results[f'avg_{name}'] = float(np.mean(values))
                    results[f'std_{name}'] = float(np.std(values))
            else:
                results[f'avg_{name}'] = 0.0
                results[f'std_{name}'] = 0.0
        results['num_users_evaluated'] = len(user_groups)
        results['predictions'] = all_predictions
        return results

    def _batched_scores(self, user_groups: UserGroups
                        ) -> Optional[Dict[str, List[Tuple[str, float]]]]:
        """Every known user's test items scored in one batched call where
        the recommender has ``score_candidates_batch``; unknown items score
        0.0. None for a recommender without it."""
        if not hasattr(self.recommender, 'score_candidates_batch'):
            return None
        ds = self.recommender.dataset
        known_users = set(map(str, ds.user_encoder.classes_))
        known_items = set(map(str, ds.item_encoder.classes_))
        users, item_lists = [], []
        for user_id, items in user_groups:
            if user_id not in known_users:
                continue
            users.append(user_id)
            item_lists.append(items)
        if not users:
            return {}
        c_max = max(len(it) for it in item_lists)
        uidx = ds.user_encoder.transform(users).astype(np.int32)
        cand = np.zeros((len(users), c_max), dtype=np.int32)
        mask = np.zeros((len(users), c_max), dtype=bool)
        for r, items in enumerate(item_lists):
            valid = [c for c, item in enumerate(items) if item in known_items]
            if valid:
                cand[r, valid] = ds.item_encoder.transform(
                    [items[c] for c in valid])
                mask[r, valid] = True
        scores = self.recommender.score_candidates_batch(uidx, cand, mask)
        return {u: [(item, float(scores[r, c]) if mask[r, c] else 0.0)
                    for c, item in enumerate(items)]
                for r, (u, items) in enumerate(zip(users, item_lists))}


def create_evaluator(task: EvaluationTask, recommender, test_data, config,
                     **kwargs) -> BaseEvaluator:
    """The evaluator of ``task``."""
    if task == EvaluationTask.TOP_K_RETRIEVAL:
        return TopKRetrievalEvaluator(recommender=recommender,
                                      test_data=test_data, config=config,
                                      **kwargs)
    if task == EvaluationTask.TOP_K_RANKING:
        return TopKRankingEvaluator(recommender=recommender,
                                    test_data=test_data, config=config,
                                    **kwargs)
    raise ValueError(f"Unknown evaluation task: {task}")


# String task names, the removed legacy tasks kept as explicit Nones.
TASK_MAPPING = {
    'retrieval': EvaluationTask.TOP_K_RETRIEVAL,
    'ranking': EvaluationTask.TOP_K_RANKING,
    'next_item': None,
    'cold_user': None,
    'cold_item': None,
    'beyond_accuracy': None,
    'session_based': None,
}


def get_task_from_string(task_name: str) -> EvaluationTask:
    """Resolve a CLI task string; a removed legacy task raises."""
    if task_name in TASK_MAPPING:
        task = TASK_MAPPING[task_name]
        if task is None:
            raise ValueError(
                f"Task '{task_name}' has been removed in the simplified "
                f"evaluation framework. Available tasks: "
                f"{list(EvaluationTask.__members__.keys())}")
        return task
    try:
        return EvaluationTask(task_name)
    except ValueError:
        raise ValueError(
            f"Unknown task '{task_name}'. Available tasks: "
            f"{list(EvaluationTask.__members__.keys())}")
