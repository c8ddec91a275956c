# pixelrec_multimodal_tpu_torch/data/feature_store.py
"""Catalog-aligned item feature tables, indexed by the item encoder's
integer ids:

    tag_idx        int32  [n_items]
    numerical      float32[n_items, F]
    vision_emb     float32[n_items, Dv]   (precomputed encoder outputs)
    language_emb   float32[n_items, Dl]
    clip_text_emb  float32[n_items, 512]

This slice ports what the catalog scorer reads: the host tables, the
precomputed-embedding install, and the ``.npz`` disk tier under
``<cache_dir>/vision_<v>_lang_<l>/`` (the same file the JAX package
writes). Building tables from item metadata, token tables and the image
tier come with later slices.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np


def cache_subdir_name(vision_model: Optional[str],
                      language_model: Optional[str]) -> str:
    """Model-combo cache directory name."""
    return f"vision_{vision_model or 'none'}_lang_{language_model or 'none'}"


class ItemFeatureStore:
    """Host-side item feature tables (numpy), read by the scorer."""

    def __init__(self, n_items: int, item_ids: np.ndarray,
                 vision_model: Optional[str] = None,
                 language_model: Optional[str] = None):
        self.n_items = n_items
        self.item_ids = np.asarray(item_ids).astype(str)  # idx -> original id
        self.vision_model = vision_model
        self.language_model = language_model
        self.tables: Dict[str, np.ndarray] = {}

    def set_embedding_table(self, name: str, table: np.ndarray):
        """Install a precomputed encoder-output table
        ('vision_emb' | 'language_emb' | 'clip_text_emb')."""
        if table.shape[0] != self.n_items:
            raise ValueError(
                f"table rows {table.shape[0]} != n_items {self.n_items}")
        self.tables[name] = np.asarray(table)

    def has(self, name: str) -> bool:
        return name in self.tables

    def save(self, cache_dir: str):
        """Persist the tables as one .npz under the model-combo subdir."""
        d = Path(cache_dir) / cache_subdir_name(self.vision_model,
                                                self.language_model)
        d.mkdir(parents=True, exist_ok=True)
        np.savez(d / 'feature_tables.npz', item_ids=self.item_ids, **self.tables)

    def load_tables(self, cache_dir: str) -> bool:
        """Load previously saved tables if present and catalog-compatible."""
        path = Path(cache_dir) / cache_subdir_name(
            self.vision_model, self.language_model) / 'feature_tables.npz'
        if not path.exists():
            return False
        with np.load(path, allow_pickle=False) as z:
            if 'item_ids' not in z or len(z['item_ids']) != self.n_items or \
                    not np.array_equal(z['item_ids'].astype(str), self.item_ids):
                return False
            for k in z.files:
                if k != 'item_ids':
                    self.tables[k] = z[k]
        return True
