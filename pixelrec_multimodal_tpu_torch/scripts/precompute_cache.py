# pixelrec_multimodal_tpu_torch/scripts/precompute_cache.py
"""Feature and embedding precompute entry point.

    python -m pixelrec_multimodal_tpu_torch.scripts.precompute_cache --config X.yaml [--device cpu]

Counterpart of the repo's ``scripts/precompute_cache.py`` with no JAX,
pandas or PyYAML: it packs the catalog's input tables (tags, numerical
features, tokens) and, unless ``--skip_encoders``, runs the frozen
encoder towers over the catalog (``encoders/precompute.py``) for
``vision_emb``, ``language_emb`` and ``clip_text_emb``, then writes them
all to the same ``feature_tables.npz`` under the same cache
sub-directory (``ItemFeatureStore.save``). The vision table needs the
config's image folder and an image decoder (PIL).

It takes the JAX script's flags. Where it differs: ``--device`` defaults
to ``cuda`` and any device but ``cuda`` or ``cpu`` raises; and a failed
encoder forward raises, where the JAX script prints a warning and saves
the input tables alone.

Over several devices (``torchrun --nproc_per_node N -m
pixelrec_multimodal_tpu_torch.scripts.precompute_cache ...
--data_parallel N``, one rank a card), each data rank runs its share of
every encoder batch and the pooled rows are all-gathered in item order;
rank 0 alone prints and saves the store, and all ranks pass a closing
barrier.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..config import Config
from ..data.columns import n_rows, read_csv, take
from ..data.dataset import MultimodalDataset
from ..data.processors import NumericalProcessor
from ..encoders.precompute import precompute_embedding_tables
from ..parallel import (
    barrier,
    init_distributed,
    is_main_rank,
    main_rank_stdout,
    mesh_from_flags,
)
from .train import setup_device


def precompute_features_cache(config: Config, force_recompute: bool = False,
                              max_items: int = None,
                              skip_encoders: bool = False,
                              device: str = 'cuda', mesh=None):
    """Pack the feature tables and the encoder embedding tables (the
    forwards' batches split over the ``mesh``'s 'data' axis); returns the
    ``ItemFeatureStore``, saved by rank 0."""
    start = time.time()
    item_info = read_csv(config.data.processed_item_info_path)
    if max_items:
        item_info = take(item_info, np.arange(min(max_items,
                                                  n_rows(item_info))))
        print(f"Limiting to first {max_items} items (--max_items)")

    # One dummy interaction: the dataset needs only the catalog.
    dummy = {'user_id': np.array(['precompute_user']),
             'item_id': np.array([str(item_info['item_id'][0])])}

    numerical_processor = NumericalProcessor()
    scaler = None
    feature_cols = [c for c in config.data.numerical_features_cols
                    if c in item_info]
    if Path(config.data.scaler_path).exists():
        numerical_processor.load_scaler(Path(config.data.scaler_path))
        scaler = numerical_processor.scaler

    cache_dir = config.data.cache_config.cache_directory
    dataset = MultimodalDataset(
        interactions_df=dummy,
        item_info_df=item_info,
        image_folder=(config.data.processed_image_destination_folder
                      or config.data.image_folder),
        vision_model_name=config.model.vision_model,
        language_model_name=config.model.language_model,
        create_negative_samples=False,
        numerical_feat_cols=feature_cols,
        categorical_feat_cols=config.data.categorical_features_cols,
        numerical_scaler=scaler,
        numerical_normalization_method=config.data.numerical_normalization_method,
        cache_features=True,
        cache_dir=cache_dir,
        cache_to_disk=False)

    store = dataset.feature_store
    if not force_recompute and store.load_tables(cache_dir):
        print("Existing packed tables found and loaded "
              "(--force_recompute to rebuild).")
    print(f"Packed {len(store.tables)} input tables for {store.n_items} "
          f"items in {time.time() - start:.1f}s: {sorted(store.tables)}")

    if not skip_encoders and (config.model.vision_model
                              or config.model.language_model):
        t0 = time.time()
        added = precompute_embedding_tables(store, config, device=device,
                                            mesh=mesh)
        if added:
            print(f"Computed embedding tables {added} in "
                  f"{time.time() - t0:.1f}s")

    if is_main_rank():
        store.save(cache_dir)
    rate = store.n_items / max(time.time() - start, 1e-9)
    print(f"Done: {store.n_items} items in {time.time() - start:.1f}s "
          f"({rate:,.0f} items/sec)")
    return store


def main(cli_args=None):
    parser = argparse.ArgumentParser(
        description='Precompute the item feature/embedding tables')
    parser.add_argument('--config', type=str, required=True,
                        help='Path to the configuration file.')
    parser.add_argument('--force_recompute', action='store_true',
                        help='Force recomputation of all items, overwriting '
                             'existing cache.')
    parser.add_argument('--max_items', type=int, default=None,
                        help='Limit the number of items to process '
                             '(for testing).')
    parser.add_argument('--skip_encoders', action='store_true',
                        help='Pack input tables only; skip encoder forwards.')
    parser.add_argument('--data_parallel', type=int, default=None,
                        help='Mesh data-axis size for the batched encoder '
                             'forwards (default: all ranks)')
    parser.add_argument('--model_parallel', type=int, default=1,
                        help='Mesh model-axis size')
    parser.add_argument('--device', type=str, default='cuda',
                        help="Torch device: 'cuda' (the default) or 'cpu'")
    args = parser.parse_args(cli_args)
    if args.device.split(':')[0] not in ('cuda', 'cpu'):
        raise ValueError(f"--device must be 'cuda' or 'cpu', got "
                         f"{args.device!r}")
    device = init_distributed(args.device)
    mesh = mesh_from_flags(args.data_parallel, args.model_parallel)
    with main_rank_stdout():
        device = setup_device(device)
        if mesh is not None:
            print(f"Device mesh: {mesh.shape}")
        config = Config.from_yaml(args.config)
        store = precompute_features_cache(
            config, force_recompute=args.force_recompute,
            max_items=args.max_items, skip_encoders=args.skip_encoders,
            device=device, mesh=mesh)
    barrier(mesh)
    return store


if __name__ == '__main__':
    main()
