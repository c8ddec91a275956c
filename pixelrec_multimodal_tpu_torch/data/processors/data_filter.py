# pixelrec_multimodal_tpu_torch/data/processors/data_filter.py
"""Static interaction and item filtering.

Counterpart of ``pixelrec_multimodal_tpu/data/processors/data_filter.py``
on numpy columns (``data/columns.py``): the same rows, in the same order,
as the JAX package's pandas filters. The activity filter is one pass,
items first, then users (not an iterative k-core), as there.
"""
from __future__ import annotations

from typing import Dict, Set

import numpy as np

from ..columns import (
    as_columns,
    fill_str,
    is_missing,
    n_rows,
    take,
    text_as_str,
)


def _kept_by_count(col: np.ndarray, minimum: int) -> np.ndarray:
    """Rows whose value occurs at least ``minimum`` times in ``col``
    (``value_counts`` then ``isin``: a missing value is kept never)."""
    present = ~is_missing(col)
    keep = np.zeros(len(col), dtype=bool)
    _, inverse, counts = np.unique(col[present], return_inverse=True,
                                   return_counts=True)
    keep[present] = counts[inverse.reshape(-1)] >= minimum
    return keep


def n_unique(col: np.ndarray) -> int:
    """pandas' ``nunique``: distinct values, missing ones not counted."""
    col = np.asarray(col)
    return len(np.unique(col[~is_missing(col)]))


def _str_isin(col: np.ndarray, wanted: np.ndarray) -> np.ndarray:
    """pandas' ``col.astype(str).isin(wanted)``: a missing cell stays
    missing under ``astype(str)`` and matches nothing."""
    return np.isin(fill_str(col, ''), wanted) & ~is_missing(col)


class DataFilter:
    """Stateless filtering operations over interaction and item tables."""

    @staticmethod
    def filter_interactions_by_valid_items(interactions_df,
                                           valid_item_ids: Set[str]
                                           ) -> Dict[str, np.ndarray]:
        cols = as_columns(interactions_df)
        before = n_rows(cols)
        valid = np.array(sorted({str(x) for x in valid_item_ids}), dtype=str)
        out = take(cols, _str_isin(cols['item_id'], valid))
        print(f"Interaction filtering: {n_rows(out)} interactions remaining "
              f"out of {before} after filtering by valid items")
        return out

    @staticmethod
    def filter_by_activity(interactions_df, min_user_interactions: int = 5,
                           min_item_interactions: int = 3
                           ) -> Dict[str, np.ndarray]:
        out = text_as_str(as_columns(interactions_df))
        if min_item_interactions > 0:
            out = take(out, _kept_by_count(out['item_id'],
                                           min_item_interactions))
            print(f"Filtered by item activity (min {min_item_interactions}): "
                  f"{n_rows(out)} interactions, "
                  f"{n_unique(out['item_id'])} items remain")
        if min_user_interactions > 0:
            out = take(out, _kept_by_count(out['user_id'],
                                           min_user_interactions))
            print(f"Filtered by user activity (min {min_user_interactions}): "
                  f"{n_rows(out)} interactions, "
                  f"{n_unique(out['user_id'])} users remain")
        return out

    @staticmethod
    def align_item_info_with_interactions(item_info_df, interactions_df
                                          ) -> Dict[str, np.ndarray]:
        items = as_columns(item_info_df)
        before = n_rows(items)
        ids = as_columns(interactions_df)['item_id']
        keep = np.unique(fill_str(ids[~is_missing(ids)], ''))
        out = take(items, _str_isin(items['item_id'], keep))
        print(f"Item info alignment: {n_rows(out)} items remaining "
              f"out of {before} after filtering by interactions")
        return out

    @staticmethod
    def get_filtering_stats(original_interactions, filtered_interactions,
                            original_items, filtered_items) -> dict:
        oi, fi = as_columns(original_interactions), \
            as_columns(filtered_interactions)
        n_oi, n_fi = n_rows(oi), n_rows(fi)
        n_items, n_fitems = n_rows(as_columns(original_items)), \
            n_rows(as_columns(filtered_items))
        return {
            'interactions': {
                'original': n_oi,
                'filtered': n_fi,
                'retention_rate': n_fi / n_oi,
            },
            'users': {
                'original': n_unique(oi['user_id']),
                'filtered': n_unique(fi['user_id']),
                'retention_rate': (n_unique(fi['user_id'])
                                   / n_unique(oi['user_id'])),
            },
            'items': {
                'original': n_items,
                'filtered': n_fitems,
                'retention_rate': n_fitems / n_items,
            },
        }
