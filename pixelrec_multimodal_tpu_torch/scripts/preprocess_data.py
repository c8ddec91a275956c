# pixelrec_multimodal_tpu_torch/scripts/preprocess_data.py
"""Offline preprocessing entry point.

    python -m pixelrec_multimodal_tpu_torch.scripts.preprocess_data --config X.yaml [--device cpu]

Counterpart of the repo's ``scripts/preprocess_data.py`` with no pandas,
scikit-learn, PyYAML or JAX, in the same eleven steps: load the raw item
and interaction files and fill NaN in the numerical columns; clean the
text columns; validate, compress or copy the images (the image processor's
offline mode); keep the items whose image passed, and their interactions;
filter by activity; align the item table with the interactions; group
the rare tags; fit (or load) the scaler; write the processed CSV files
(``data/columns.write_csv``, as pandas' ``to_csv(index=False)``); pack the
feature tables into the cache (``ItemFeatureStore``, the port's
``LabelEncoder``) when ``cache_config`` asks for it; print the summary.

It takes the JAX script's flags (``--force-reprocess`` is parsed and
unused, as there) and ``--device``: ``cuda`` (the default) or ``cpu``. The
device only chooses the image decoder where PIL is missing: nvJPEG on the
card for ``cuda``; for ``cpu`` the image step raises naming ROADMAP item
A12 (``data/image_codecs.py``). Any other device raises. Where the JAX
script prints a message and carries on after a failure of the packing
step, this one raises; it exits with status 1 where JAX's does (no valid
item after the image step, no interaction after the activity filter).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..config import Config
from ..data.columns import (
    fill_str,
    is_missing,
    n_rows,
    read_csv,
    take,
    value_counts,
    write_csv,
)
from ..data.feature_store import ItemFeatureStore
from ..data.label_encoder import LabelEncoder
from ..data.processors import (
    DataFilter,
    ImageProcessor,
    NumericalProcessor,
    TextProcessor,
)
from ..data.processors.data_filter import n_unique

TEXT_COLUMNS = ['title', 'tag', 'description']


class PreprocessingPipeline:
    """The offline preprocessing workflow; ``seconds`` holds each step's
    host seconds after ``run_full_pipeline``."""

    def __init__(self, config: Config, device: str = 'cuda'):
        self.config = config
        self.data_config = config.data
        self.image_processor = ImageProcessor(
            compression_config=config.data.image_compression_config,
            validation_config=config.data.image_validation_config,
            device=device)
        self.text_processor = TextProcessor(
            cleaning_config=config.data.text_cleaning_config)
        self.numerical_processor = NumericalProcessor()
        self.data_filter = DataFilter()
        self.text_columns = list(TEXT_COLUMNS)
        self.seconds: Dict[str, float] = {}

    def _timed(self, name: str, fn, *args):
        t0 = time.time()
        try:
            return fn(*args)
        finally:
            self.seconds[name] = time.time() - t0

    def run_full_pipeline(self) -> Dict[str, np.ndarray]:
        """The eleven steps; returns the processed item table."""
        print("=" * 60)
        print("Starting Preprocessing Pipeline")
        print("=" * 60)

        print("\n1. Loading raw data...")
        item_info, interactions = self._timed('load', self._load_raw_data)

        print("\n2. Cleaning text data...")
        item_info = self._timed('clean_text', self._clean_text_data,
                                item_info)

        print("\n3. Processing and validating images...")
        valid_item_ids = self._timed('images', self._process_images,
                                     item_info)
        if not valid_item_ids:
            print("ERROR: No valid items after image processing!")
            sys.exit(1)

        print("\n4. Filtering data by valid items...")
        item_info, interactions = self._timed(
            'valid_items', self._filter_by_valid_items, item_info,
            interactions, valid_item_ids)

        print("\n5. Filtering by activity levels...")
        splitting = self.data_config.splitting
        interactions = self._timed(
            'activity', self.data_filter.filter_by_activity, interactions,
            splitting.min_interactions_per_user,
            splitting.min_interactions_per_item)
        if n_rows(interactions) == 0:
            print("ERROR: No interactions remaining after filtering!")
            sys.exit(1)

        print("\n6. Aligning item info with interactions...")
        item_info = self._timed(
            'align', self.data_filter.align_item_info_with_interactions,
            item_info, interactions)

        print("\n7. Grouping rare tags...")
        item_info = self._timed('rare_tags', self._group_rare_tags,
                                item_info)

        print("\n8. Processing numerical features...")
        self._timed('scaler', self._process_numerical_features, item_info)

        print("\n9. Saving processed data...")
        self._timed('write_csv', self._save_processed_data, item_info,
                    interactions)

        print("\n10. Packing feature tables...")
        self._timed('pack', self._pack_feature_tables_if_enabled, item_info)

        self._print_summary(item_info, interactions)
        print("\n" + "=" * 60)
        print("Preprocessing Pipeline Completed Successfully!")
        print("=" * 60)
        return item_info

    # ------------------------------------------------------------------ steps
    def _load_raw_data(self):
        item_info = read_csv(self.data_config.item_info_path)
        item_info['item_id'] = fill_str(item_info['item_id'], 'nan')
        interactions = read_csv(self.data_config.interactions_path)
        for col in ('item_id', 'user_id'):
            interactions[col] = fill_str(interactions[col], 'nan')

        print("\nChecking for NaN values in numerical columns...")
        for col in self.data_config.numerical_features_cols:
            if col in item_info:
                nan_count = int(is_missing(item_info[col]).sum())
                if nan_count > 0:
                    print(f"WARNING: {nan_count} NaN values found in "
                          f"column '{col}'")
                    item_info[col] = _fill_zero(item_info[col])
                    print(f"Filled NaN values in '{col}' with 0")
        print(f"Loaded {n_rows(item_info)} items and "
              f"{n_rows(interactions)} interactions")
        return item_info, interactions

    def _clean_text_data(self, item_info):
        if 'tag' in item_info:
            print("Cleaning 'tag' column: Filling NaN with 'unknown'.")
            item_info['tag'] = fill_str(item_info['tag'], 'unknown')
        return self.text_processor.clean_dataframe_text_columns(
            item_info, self.text_columns)

    def _process_images(self, item_info) -> set:
        return self.image_processor.process_items_images(
            fill_str(item_info['item_id'], 'nan').tolist(),
            Path(self.data_config.image_folder),
            Path(self.data_config.processed_image_destination_folder))

    def _filter_by_valid_items(self, item_info, interactions,
                               valid_item_ids):
        before = n_rows(item_info)
        ids = fill_str(item_info['item_id'], 'nan')
        item_info = take(item_info, np.isin(ids, sorted(valid_item_ids)))
        print(f"Item info filtering: {n_rows(item_info)} items remaining "
              f"out of {before}")
        interactions = self.data_filter.filter_interactions_by_valid_items(
            interactions, valid_item_ids)
        return item_info, interactions

    def _group_rare_tags(self, item_info):
        """Tags seen fewer times than the configured threshold become
        'rare_tag'."""
        threshold = getattr(self.data_config.splitting,
                            'tag_grouping_threshold', None)
        if threshold is None:
            print("tag_grouping_threshold not set in config. "
                  "Skipping tag grouping.")
            return item_info
        threshold = int(threshold)
        print(f"Grouping tags that appear less than {threshold} times.")
        tags = item_info['tag']
        counts = value_counts(tags[~is_missing(tags)])
        rare = [t for t, n in counts.items() if n < threshold]
        if rare:
            tags = tags.astype(object)
            tags[np.isin(fill_str(item_info['tag'], ''), rare)
                 & ~is_missing(item_info['tag'])] = 'rare_tag'
            item_info['tag'] = tags
            print(f"Grouped {len(rare)} rare tags into a single "
                  "'rare_tag' category.")
        else:
            print("No rare tags found below the threshold.")
        return item_info

    def _process_numerical_features(self, item_info):
        cols = self.data_config.numerical_features_cols
        method = self.data_config.numerical_normalization_method
        scaler_path = Path(self.data_config.scaler_path)
        if not cols:
            print("No numerical columns specified. Skipping scaler "
                  "processing.")
            return
        for col in cols:
            if col in item_info:
                item_info[col] = _fill_zero(item_info[col])
        if method != 'none':
            if scaler_path.exists():
                print(f"Loading existing scaler from {scaler_path}")
                self.numerical_processor.load_scaler(scaler_path)
            else:
                print(f"Fitting new scaler with method: {method}")
                present = [c for c in cols if c in item_info]
                self.numerical_processor.fit_scaler(item_info, present,
                                                    method)
                self.numerical_processor.save_scaler(scaler_path)
        print(f"Scaler info: {self.numerical_processor.get_scaler_info()}")

    def _save_processed_data(self, item_info, interactions):
        item_path = Path(self.data_config.processed_item_info_path)
        inter_path = Path(self.data_config.processed_interactions_path)
        print(f"Saving processed item info to: {item_path}")
        write_csv(item_info, item_path)
        print(f"Saving processed interactions to: {inter_path}")
        write_csv(interactions, inter_path)

    def _pack_feature_tables_if_enabled(self, item_info):
        """The catalog-aligned tag, numerical and token tables written to
        the cache directory as one ``feature_tables.npz``, when the cache
        is enabled on disk. A failure raises (JAX's prints and carries
        on)."""
        cache = self.data_config.cache_config
        if not cache.enabled or not cache.use_disk:
            print("Feature table packing not enabled "
                  "(cache_config.use_disk=False). Skipping.")
            return
        ids = fill_str(item_info['item_id'], 'nan')
        item_encoder = LabelEncoder().fit(np.unique(ids))
        tag_encoder = None
        if 'tag' in item_info:
            tag_encoder = LabelEncoder().fit(fill_str(item_info['tag'],
                                                      'unknown'))
        store = ItemFeatureStore.build(
            item_info, item_encoder, tag_encoder=tag_encoder,
            vision_model=self.config.model.vision_model,
            language_model=self.config.model.language_model,
            image_folder=str(
                self.data_config.processed_image_destination_folder),
            numerical_processor=self.numerical_processor)
        store.save(cache.cache_directory)
        print(f"Feature tables packed to {cache.cache_directory}")

    def _print_summary(self, item_info, interactions):
        scaler_type = (self.numerical_processor.get_scaler_info()
                       ['scaler_type'] if self.numerical_processor.scaler
                       else 'None')
        print(f"""
            Preprocessing Summary:
            ---------------------
            Final item count: {n_rows(item_info)}
            Final interaction count: {n_rows(interactions)}
            Unique users: {n_unique(interactions['user_id'])}
            Unique items in interactions: {n_unique(interactions['item_id'])}
            Processed images directory: {self.data_config.processed_image_destination_folder}
            Numerical scaler: {scaler_type}
        """)


def _fill_zero(col: np.ndarray) -> np.ndarray:
    """pandas' ``fillna(0)``: NaN becomes 0.0 in a float column, 0 in an
    object column; other columns have nothing to fill."""
    missing = is_missing(col)
    if not missing.any():
        return col
    out = col.copy()
    out[missing] = 0.0 if col.dtype.kind == 'f' else 0
    return out


def main(cli_args: Optional[List[str]] = None) -> PreprocessingPipeline:
    parser = argparse.ArgumentParser(
        description="Modular data preprocessing pipeline")
    parser.add_argument('--config', type=str,
                        default='configs/simple_config.yaml',
                        help='Path to configuration file')
    parser.add_argument('--skip-caching', action='store_true',
                        help='Skip feature caching step')
    parser.add_argument('--force-reprocess', action='store_true',
                        help='Force reprocessing of all images and features')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (the default) or 'cpu': where PIL is "
                             "missing, 'cuda' validates the images with "
                             "nvJPEG on the card")
    args = parser.parse_args(cli_args)
    if args.device.split(':')[0] not in ('cuda', 'cpu'):
        raise ValueError(f"--device must be 'cuda' or 'cpu', got "
                         f"{args.device!r}")

    config = Config.from_yaml(args.config)
    print(f"Loaded configuration from: {args.config}")
    if args.skip_caching:
        config.data.cache_config.use_disk = False
        print("Feature caching disabled by --skip-caching flag")
    pipeline = PreprocessingPipeline(config, device=args.device)
    pipeline.run_full_pipeline()
    return pipeline


if __name__ == '__main__':
    main()
