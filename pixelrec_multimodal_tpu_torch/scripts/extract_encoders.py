# pixelrec_multimodal_tpu_torch/scripts/extract_encoders.py
"""Rebuild and pickle the user, item (and tag) encoders without training.

    python -m pixelrec_multimodal_tpu_torch.scripts.extract_encoders --config X.yaml

Counterpart of the repo's ``scripts/extract_encoders.py``: fits the
encoders on the full processed data, as the train script does, and
writes them to the shared encoders directory in the port's classes
(``data/label_encoder.py``). It also rewrites encoders the JAX package
pickled (scikit-learn's class), which the port cannot unpickle.
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path
from typing import List, Optional

from ..config import Config
from ..data.columns import read_csv
from ..data.dataset import MultimodalDataset


def main(cli_args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description='Extract user/item encoders from processed data')
    parser.add_argument('--config', type=str, required=True,
                        help='Path to the configuration file.')
    args = parser.parse_args(cli_args)
    config = Config.from_yaml(args.config)

    print("Loading processed data...")
    interactions = read_csv(config.data.processed_interactions_path)
    item_info = read_csv(config.data.processed_item_info_path)

    print("Fitting encoders on the full dataset...")
    dataset = MultimodalDataset(
        interactions_df=interactions,
        item_info_df=item_info,
        image_folder=(config.data.processed_image_destination_folder
                      or config.data.image_folder),
        vision_model_name=None,
        language_model_name=None,
        create_negative_samples=False,
        numerical_feat_cols=[],
        categorical_feat_cols=config.data.categorical_features_cols,
        cache_features=False)

    encoders_dir = Path(config.shared_encoders_dir)
    encoders_dir.mkdir(parents=True, exist_ok=True)
    with open(encoders_dir / 'user_encoder.pkl', 'wb') as f:
        pickle.dump(dataset.user_encoder, f)
    with open(encoders_dir / 'item_encoder.pkl', 'wb') as f:
        pickle.dump(dataset.item_encoder, f)
    if dataset.tag_encoder is not None:
        with open(encoders_dir / 'tag_encoder.pkl', 'wb') as f:
            pickle.dump(dataset.tag_encoder, f)

    print(f"Encoders saved to {encoders_dir}")
    print(f"  users: {dataset.n_users:,}  items: {dataset.n_items:,}  "
          f"tags: {dataset.n_tags:,}")


if __name__ == '__main__':
    main()
