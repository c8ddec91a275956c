# pixelrec_multimodal_tpu_torch/data/negative_sampling.py
"""Vectorized negative sampling for implicit-feedback training: a copy
of the JAX package's ``data/negative_sampling.py`` (numpy alone).

Per user, ``ratio * |positives|`` items the user has not interacted with,
without replacement, under 'random', 'popularity' or 'popularity_inverse'
weighting, drawn by whole-population rejection sampling over encoded
(user, item) keys. With the same ``np.random.Generator`` it draws the same
pairs as the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_MAX_ROUNDS = 64


def item_popularity_weights(item_idx: np.ndarray, n_items: int,
                            strategy: str) -> Optional[np.ndarray]:
    """Normalized sampling weights per catalog item, or None for uniform.

    'popularity' weights by interaction count, 'popularity_inverse' by 1/count
    (items never interacted with get weight 0, as in the reference
    dataset.py:346-365 where only observed items receive weight).
    """
    if strategy not in ('popularity', 'popularity_inverse'):
        return None
    counts = np.bincount(item_idx, minlength=n_items).astype(np.float64)
    if strategy == 'popularity':
        w = counts
    else:
        with np.errstate(divide='ignore'):
            w = np.where(counts > 0, 1.0 / np.maximum(counts, 1), 0.0)
    total = w.sum()
    if total <= 0:
        return None
    return w / total


def sample_negatives(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    n_items: int,
    ratio: float = 1.0,
    strategy: str = 'random',
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample negative (user, item) pairs for all users at once.

    Returns (neg_user_idx, neg_item_idx). Per user u with p_u positives, draws
    ``min(n_items - p_u, int(p_u * ratio))`` distinct non-interacted items.

    Algorithm: encode pairs as ``u * n_items + i`` keys; iteratively draw
    candidates for every unfilled slot, rejecting positives, duplicates, and
    already-accepted pairs via sorted-key membership tests. Uniform draws use
    randint; weighted draws sample the catalog distribution with replacement
    and rely on the rejection loop for distinctness. Falls back to exact
    per-user sampling for stragglers after _MAX_ROUNDS.
    """
    rng = rng or np.random.default_rng()
    user_idx = np.asarray(user_idx, dtype=np.int64)
    item_idx = np.asarray(item_idx, dtype=np.int64)
    if len(user_idx) == 0 or n_items == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64))

    pos_keys = np.unique(user_idx * n_items + item_idx)
    users, pos_counts = np.unique(user_idx, return_counts=True)
    needed = np.minimum(n_items - pos_counts,
                        (pos_counts * ratio).astype(np.int64))
    needed = np.maximum(needed, 0)

    weights = item_popularity_weights(item_idx, n_items, strategy)

    accepted_keys = np.empty(0, dtype=np.int64)
    remaining_users = users
    remaining = needed

    for _ in range(_MAX_ROUNDS):
        active = remaining > 0
        if not active.any():
            break
        draw_users = np.repeat(remaining_users[active], remaining[active])
        if weights is None:
            draw_items = rng.integers(0, n_items, size=len(draw_users))
        else:
            draw_items = rng.choice(n_items, size=len(draw_users), p=weights)
        keys = draw_users * n_items + draw_items

        # Reject duplicates within this draw and collisions with positives or
        # previously accepted pairs.
        uniq_keys, first = np.unique(keys, return_index=True)
        ok = ~_in_sorted(uniq_keys, pos_keys)
        if len(accepted_keys):
            ok &= ~_in_sorted(uniq_keys, accepted_keys)
        new_keys = uniq_keys[ok]
        if len(new_keys):
            accepted_keys = np.sort(np.concatenate([accepted_keys, new_keys]))
            got_users, got = np.unique(new_keys // n_items, return_counts=True)
            pos_in_remaining = np.searchsorted(remaining_users, got_users)
            remaining = remaining.copy()
            remaining[pos_in_remaining] -= got
            remaining = np.maximum(remaining, 0)

    # Exact fallback for any stragglers (pathological weighted cases).
    if (remaining > 0).any():
        extra = []
        pos_sorted = pos_keys
        for u, r in zip(remaining_users[remaining > 0], remaining[remaining > 0]):
            lo = np.searchsorted(pos_sorted, u * n_items)
            hi = np.searchsorted(pos_sorted, (u + 1) * n_items)
            u_pos = pos_sorted[lo:hi] - u * n_items
            lo_a = np.searchsorted(accepted_keys, u * n_items)
            hi_a = np.searchsorted(accepted_keys, (u + 1) * n_items)
            u_acc = accepted_keys[lo_a:hi_a] - u * n_items
            taken = np.union1d(u_pos, u_acc)
            candidates = np.setdiff1d(np.arange(n_items), taken,
                                      assume_unique=True)
            if weights is not None:
                w = weights[candidates]
                s = w.sum()
                choice = (rng.choice(candidates, size=min(r, len(candidates)),
                                     replace=False, p=w / s) if s > 0 else
                          rng.choice(candidates, size=min(r, len(candidates)),
                                     replace=False))
            else:
                choice = rng.choice(candidates, size=min(r, len(candidates)),
                                    replace=False)
            extra.append(u * n_items + choice)
        if extra:
            accepted_keys = np.sort(np.concatenate([accepted_keys] + extra))

    return accepted_keys // n_items, accepted_keys % n_items


def _in_sorted(values: np.ndarray, sorted_arr: np.ndarray) -> np.ndarray:
    """Membership test of ``values`` against a sorted array."""
    pos = np.searchsorted(sorted_arr, values)
    pos = np.minimum(pos, len(sorted_arr) - 1) if len(sorted_arr) else pos
    if len(sorted_arr) == 0:
        return np.zeros(len(values), dtype=bool)
    return sorted_arr[pos] == values
