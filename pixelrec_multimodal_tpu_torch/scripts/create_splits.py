# pixelrec_multimodal_tpu_torch/scripts/create_splits.py
"""Data splitting entry point.

    python -m pixelrec_multimodal_tpu_torch.scripts.create_splits --config X.yaml

Counterpart of the repo's ``scripts/create_splits.py`` with no pandas,
scikit-learn or PyYAML: load the processed interactions, filter them by
activity, merge the stratification column from the item table when the
interactions lack it (a left merge: a repeated ``item_id`` in the item
table repeats the interaction, a missing one leaves the value missing),
split with ``create_robust_splits``, write ``train.csv``, ``val.csv`` (and
``test.csv``) into the split directory as the JAX script's pandas writes
them, and print the overlap statistics as YAML.

Where the JAX script prints a message and carries on or stops quietly (a
missing interactions or item file, a failed merge, no rows left after
the filter), this one raises.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np

from ..config import Config
from ..data.columns import (
    is_missing,
    n_rows,
    read_csv,
    text_as_str,
    write_csv,
)
from ..data.processors import DataFilter
from ..data.splitting import DataSplitter, create_robust_splits
from ..utils import yaml_io


def _take_or_missing(col: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``col[rows]``, missing where ``rows`` is -1 (an int or bool column
    with a missing value turns float or object, as pandas' merge does)."""
    if not (rows < 0).any():
        return col[rows]
    if col.dtype.kind in 'iuf':
        out = col.astype(np.float64)[rows]
    else:
        out = col.astype(object)[rows]
    out[rows < 0] = np.nan
    return out


def left_merge(left: Dict[str, np.ndarray], right: Dict[str, np.ndarray],
               on: str) -> Dict[str, np.ndarray]:
    """pandas' ``merge(left, right, on=on, how='left')``: the left rows in
    their order, each repeated once per matching right row (in the right
    table's order), or kept once with the right columns missing."""
    lk, rk = (text_as_str({on: t[on]})[on] for t in (left, right))
    if (lk.dtype.kind in 'iuf') != (rk.dtype.kind in 'iuf'):
        raise ValueError(f"cannot merge on '{on}': a {lk.dtype} column "
                         f"against a {rk.dtype} one")
    order = np.argsort(rk, kind='stable')
    ordered = rk[order]
    lo = np.searchsorted(ordered, lk, side='left')
    count = np.searchsorted(ordered, lk, side='right') - lo
    reps = np.maximum(count, 1)
    left_rows = np.repeat(np.arange(len(lk)), reps)
    right_rows = np.full(len(left_rows), -1, dtype=np.int64)
    matched = np.repeat(count, reps) > 0
    within = np.arange(len(left_rows)) - np.repeat(np.cumsum(reps) - reps,
                                                   reps)
    right_rows[matched] = order[(np.repeat(lo, reps) + within)[matched]]
    out = {k: v[left_rows] for k, v in left.items()}
    for k, v in right.items():
        if k != on:
            out[k] = _take_or_missing(v, right_rows)
    return out


def main(config_path: str) -> Dict[str, Any]:
    """Split the configured interactions and write the CSV files; returns
    the statistics, the rows of each split and each step's seconds."""
    seconds: Dict[str, float] = {}
    cfg = Config.from_yaml(config_path)
    t0 = time.time()
    interactions = read_csv(cfg.data.processed_interactions_path)
    seconds['read_csv'] = time.time() - t0

    min_user = cfg.data.splitting.min_interactions_per_user
    min_item = cfg.data.splitting.min_interactions_per_item
    print("Filtering data by minimum interactions...")
    t0 = time.time()
    filtered = DataFilter.filter_by_activity(
        interactions, min_user_interactions=min_user,
        min_item_interactions=min_item)
    seconds['filter'] = time.time() - t0
    if n_rows(filtered) == 0:
        raise ValueError("No data left after filtering. Please check your "
                         "interaction thresholds.")

    # Merge the stratification column from the item table when missing.
    stratify_col = cfg.data.splitting.stratify_by
    if stratify_col and stratify_col not in filtered:
        print(f"Stratification column '{stratify_col}' not in interactions, "
              "attempting to merge from item info.")
        t0 = time.time()
        item_info_path = Path(cfg.data.processed_item_info_path)
        if not item_info_path.exists():
            raise FileNotFoundError(
                f"Processed item info file not found at {item_info_path}")
        item_info = read_csv(item_info_path)
        seconds['read_csv'] += time.time() - t0
        if stratify_col in item_info:
            t0 = time.time()
            filtered = left_merge(
                filtered, {'item_id': item_info['item_id'],
                           stratify_col: item_info[stratify_col]},
                on='item_id')
            seconds['merge'] = time.time() - t0
            print(f"Successfully merged '{stratify_col}' from item info "
                  "for stratification.")
            if is_missing(filtered[stratify_col]).any():
                print(f"Warning: Null values are present in "
                      f"'{stratify_col}' after merge.")
        else:
            print(f"Warning: Stratification column '{stratify_col}' not "
                  f"in '{item_info_path}'. Proceeding without "
                  "stratification.")
            cfg.data.splitting.stratify_by = None

    t0 = time.time()
    splits = create_robust_splits(
        filtered,
        split_strategy=cfg.data.splitting.strategy,
        random_state=cfg.data.splitting.random_state,
        train_ratio=cfg.data.splitting.train_final_ratio,
        val_ratio=cfg.data.splitting.val_final_ratio,
        test_ratio=cfg.data.splitting.test_final_ratio,
        stratify_by=cfg.data.splitting.stratify_by,
        min_interactions_per_user=min_user,
        min_interactions_per_item=min_item)
    seconds['split'] = time.time() - t0

    output_dir = Path(cfg.data.split_data_path)
    output_dir.mkdir(parents=True, exist_ok=True)
    splitter = DataSplitter(random_state=cfg.data.splitting.random_state)

    t0 = time.time()
    names = ('train', 'val', 'test')[:len(splits)]
    for name, table in zip(names[::-1], splits[::-1]):
        write_csv(table, output_dir / f'{name}.csv')
    seconds['write_csv'] = time.time() - t0
    stats = splitter.get_split_statistics(*splits)

    print("\nSplit Statistics:")
    print(yaml_io.dump(stats))
    return {'stats': stats, 'seconds': seconds,
            'rows': {name: n_rows(t) for name, t in zip(names, splits)}}


if __name__ == '__main__':
    parser = argparse.ArgumentParser(
        description="Create data splits for the recommender system.")
    parser.add_argument('--config', type=str, required=True,
                        help='Path to the configuration file.')
    args = parser.parse_args()
    main(args.config)
