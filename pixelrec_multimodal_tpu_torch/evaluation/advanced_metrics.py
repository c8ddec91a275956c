# pixelrec_multimodal_tpu_torch/evaluation/advanced_metrics.py
"""Advanced and fairness metrics.

Counterpart of ``pixelrec_multimodal_tpu/evaluation/advanced_metrics.py``,
the same numpy arithmetic: MRR, hit rate, the Gini coefficient,
serendipity, temporal diversity and a satisfaction proxy
(``AdvancedMetrics``), demographic parity and provider fairness
(``FairnessMetrics``). Library components with no caller: neither
package's evaluate entry point or evaluators reach them; the JAX package
exports them from ``evaluation``, and the port exports the same names.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Set

import numpy as np


class AdvancedMetrics:
    """Static ranking/distribution metrics beyond precision/recall."""

    @staticmethod
    def calculate_mrr(recommendations: List[List[str]],
                      relevant_items: List[Set[str]]) -> float:
        """Mean reciprocal rank of the first relevant item per user."""
        rr = []
        for recs, relevant in zip(recommendations, relevant_items):
            for i, item in enumerate(recs):
                if item in relevant:
                    rr.append(1.0 / (i + 1))
                    break
            else:
                rr.append(0.0)
        return float(np.mean(rr)) if rr else 0.0

    @staticmethod
    def calculate_hit_rate(recommendations: List[List[str]],
                           relevant_items: List[Set[str]]) -> float:
        """Fraction of users with at least one relevant recommendation."""
        if not recommendations:
            return 0.0
        hits = sum(1 for recs, relevant in zip(recommendations, relevant_items)
                   if any(item in relevant for item in recs))
        return hits / len(recommendations)

    @staticmethod
    def calculate_gini_coefficient(item_recommendations: Dict[str, int]) -> float:
        """Gini of the recommendation-count distribution over items."""
        if not item_recommendations:
            return 0.0
        counts = np.sort(np.asarray(list(item_recommendations.values())))
        n = len(counts)
        total = counts.sum()
        if n == 0 or total == 0:
            return 0.0
        index = np.arange(1, n + 1)
        return float((2 * np.sum(index * counts)) / (n * total) - (n + 1) / n)

    @staticmethod
    def calculate_serendipity(recommendations: List[List[str]],
                              expected_items: List[Set[str]],
                              relevant_items: List[Set[str]]) -> float:
        """Mean fraction of recs that are relevant AND unexpected."""
        scores = []
        for recs, expected, relevant in zip(recommendations, expected_items,
                                            relevant_items):
            hit = sum(1 for item in recs
                      if item in relevant and item not in expected)
            scores.append(hit / len(recs) if recs else 0)
        return float(np.mean(scores)) if scores else 0.0

    @staticmethod
    def calculate_temporal_diversity(recommendations: List[List[str]],
                                     item_timestamps: Dict[str, float]) -> float:
        """Mean per-user std of recommended items' timestamps."""
        scores = []
        for recs in recommendations:
            if len(recs) < 2:
                scores.append(0.0)
                continue
            ts = [item_timestamps.get(item, 0) for item in recs]
            scores.append(float(np.std(ts)))
        return float(np.mean(scores)) if scores else 0.0

    @staticmethod
    def calculate_user_satisfaction_proxy(
            recommendations: List[List[str]],
            item_features: Dict[str, Dict[str, float]],
            user_preferences: Dict[int, Dict[str, float]]) -> float:
        """Mean cosine alignment of item features with user preference vectors
        over shared feature keys."""
        sat = []
        for user_id, recs in enumerate(recommendations):
            if user_id not in user_preferences:
                continue
            pref = user_preferences[user_id]
            aligns = []
            for item in recs:
                feat = item_features.get(item)
                if not feat:
                    continue
                common = sorted(set(pref) & set(feat))
                if not common:
                    continue
                u = np.asarray([pref[f] for f in common])
                v = np.asarray([feat[f] for f in common])
                aligns.append(float(
                    np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v) + 1e-8)))
            if aligns:
                sat.append(float(np.mean(aligns)))
        return float(np.mean(sat)) if sat else 0.0


class FairnessMetrics:
    """Group- and provider-level fairness metrics."""

    @staticmethod
    def calculate_demographic_parity(
            recommendations: Dict[str, List[str]],
            user_demographics: Dict[str, Dict[str, str]],
            demographic_attribute: str = 'gender') -> Dict[str, float]:
        """Unique-item rate of recommendations per demographic group."""
        group_recs = defaultdict(list)
        for user_id, recs in recommendations.items():
            group = user_demographics.get(user_id, {}).get(
                demographic_attribute, 'unknown')
            group_recs[group].extend(recs)
        return {group: (len(set(recs)) / len(recs) if recs else 0)
                for group, recs in group_recs.items()}

    @staticmethod
    def calculate_provider_fairness(
            recommendations: List[List[str]],
            item_providers: Dict[str, str]) -> Dict[str, object]:
        """Per-provider exposure rates + Gini of the exposure
        distribution."""
        provider_counts: Dict[str, int] = defaultdict(int)
        total = 0
        for recs in recommendations:
            for item in recs:
                provider_counts[item_providers.get(item, 'unknown')] += 1
                total += 1
        if total == 0:
            return {'provider_exposure': {}, 'provider_gini': 0.0}
        rates = {p: c / total for p, c in provider_counts.items()}
        gini = AdvancedMetrics.calculate_gini_coefficient(
            {str(i): c for i, c in enumerate(provider_counts.values())})
        return {'provider_exposure': rates, 'provider_gini': gini}
