# pixelrec_multimodal_tpu_torch/scripts/create_training_subsets.py
"""Nested stratified training subsets for a progressive hyperparameter
search.

    python -m pixelrec_multimodal_tpu_torch.scripts.create_training_subsets --config X.yaml

Counterpart of the repo's ``scripts/create_training_subsets.py`` with no
pandas or scikit-learn: read the split's ``train.csv``, read its
timestamps as datetimes (``data/timestamps.to_datetime``), bin them into
ten quantile bins (``qcut_codes``), draw the 50% subset from the full
file, the 20% from the 50% and the 5% from the 20%, each stratified on
the bins with scikit-learn's ``train_test_split``
(``data/splitting.train_test_split``) and a random split where the
stratified one raises, and write ``train_{50,20,05}_percent.csv`` beside
``train.csv`` as the JAX script's pandas writes them (the timestamp
column now as datetimes). Then print the monthly-share drift of the 5%
subset against the full file.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..config import Config
from ..data.columns import n_rows, read_csv, take, write_csv
from ..data.splitting import train_test_split
from ..data.timestamps import monthly_drift, qcut_codes, to_datetime


def create_subsets(config_path: str) -> Optional[dict]:
    """Write the three subsets; returns their row counts, the drift and
    the host seconds by step, or None (after the JAX script's message)
    where the full training file is missing."""
    print("--- Creating Stratified Training Subsets for Hyperparameter "
          "Optimization ---")
    cfg = Config.from_yaml(config_path)
    full_train_path = Path(cfg.data.train_data_path)
    if not full_train_path.exists():
        print(f"Error: Full training file not found at {full_train_path}")
        print("Please run scripts/create_splits.py first.")
        return None

    seconds = {}
    t0 = time.time()
    print(f"Loading full training data from: {full_train_path}")
    df_full = read_csv(full_train_path)
    seconds['read_csv'] = time.time() - t0

    t0 = time.time()
    print("Binning timestamps for stratification...")
    df_full['timestamp'] = to_datetime(df_full['timestamp'])
    time_bin = qcut_codes(df_full['timestamp'], 10)
    seed = cfg.data.splitting.random_state
    seconds['bins'] = time.time() - t0

    def strat_split(rows, test_size):
        """The test side's rows (positions into the full file) of a
        stratified split of ``rows``, or of a random one where the
        stratified split raises (bins too sparse)."""
        try:
            _, test = train_test_split(len(rows), test_size=test_size,
                                       random_state=seed,
                                       stratify=time_bin[rows])
        except ValueError as e:
            print(f"Warning: stratified split failed ({e}); "
                  "falling back to random split.")
            _, test = train_test_split(len(rows), test_size=test_size,
                                       random_state=seed)
        return rows[test]

    # Nested subsets: each smaller subset is drawn FROM the previous one so
    # 5% ⊂ 20% ⊂ 50%.
    t0 = time.time()
    everything = np.arange(n_rows(df_full))
    print("Creating 50% subset...")
    rows_50 = strat_split(everything, 0.5)
    print("Creating 20% subset (from the 50% subset)...")
    rows_20 = strat_split(rows_50, 0.4)
    print("Creating 5% subset (from the 20% subset)...")
    rows_05 = strat_split(rows_20, 0.25)
    seconds['splits'] = time.time() - t0

    t0 = time.time()
    splits_dir = full_train_path.parent
    paths, sizes = {}, {}
    for frac, rows in (('50', rows_50), ('20', rows_20), ('05', rows_05)):
        path = splits_dir / f"train_{frac}_percent.csv"
        write_csv(take(df_full, rows), path)
        paths[frac], sizes[frac] = path, len(rows)
    seconds['write_csv'] = time.time() - t0

    print("\n--- Subsets Created Successfully ---")
    print(f"Full training set size: {n_rows(df_full)}")
    print(f"50% subset saved to: {paths['50']} (size: {sizes['50']})")
    print(f"20% subset saved to: {paths['20']} (size: {sizes['20']})")
    print(f"5% subset saved to: {paths['05']} (size: {sizes['05']})")

    # Monthly timestamp distribution drift of the 5% subset, read back.
    t0 = time.time()
    print("\n--- Verifying Timestamp Stratification ---")
    sub = to_datetime(read_csv(paths['05'])['timestamp'])
    diff = monthly_drift(df_full['timestamp'], sub)
    seconds['drift'] = time.time() - t0
    print(f"Absolute sum of differences in monthly timestamp distribution: "
          f"{diff:.4f}")
    if diff < 0.1:
        print("Timestamp stratification appears to be working correctly "
              "(difference is small).")
    else:
        print("Warning: Large difference in timestamp distribution, "
              "stratification might not be effective.")
    return {'rows': {'full': n_rows(df_full), **sizes}, 'drift': diff,
            'seconds': seconds,
            'paths': {frac: str(p) for frac, p in paths.items()}}


def main(cli_args: Optional[List[str]] = None) -> Optional[dict]:
    parser = argparse.ArgumentParser(
        description="Create training data subsets for HPO.")
    parser.add_argument('--config', type=str, required=True,
                        help='Path to the main configuration file.')
    args = parser.parse_args(cli_args)
    return create_subsets(args.config)


if __name__ == '__main__':
    main()
