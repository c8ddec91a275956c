# pixelrec_multimodal_tpu_torch/data/simple_cache.py
"""SimpleFeatureCache: a bounded LRU of per-item feature dicts.

Counterpart of ``pixelrec_multimodal_tpu/data/simple_cache.py``: the same
get/set/stats surface over an in-memory dict, thread-safe, with the same
optional disk tier (one ``<item_id>.npz`` per item) under the model-combo
directory ``<base>/vision_<v>_lang_<l>/`` (``feature_store.
cache_subdir_name``), and pickling without its lock. The port's training
path gathers from catalog-aligned tables (``data/feature_store.py``)
instead; this class serves code written against the per-item API.

One divergence: a disk entry that cannot be read raises here, where the
JAX package counts it as a miss.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .feature_store import cache_subdir_name


class SimpleFeatureCache:
    """Thread-safe bounded LRU of per-item feature dicts."""

    def __init__(self, vision_model: Optional[str] = None,
                 language_model: Optional[str] = None,
                 base_cache_dir: str = 'cache',
                 max_memory_items: int = 1000,
                 use_disk: bool = False):
        self.vision_model = vision_model
        self.language_model = language_model
        self.base_cache_dir = Path(base_cache_dir)
        self.max_memory_items = max_memory_items
        self.use_disk = use_disk
        self.cache_dir = self.base_cache_dir / cache_subdir_name(
            vision_model, language_model)
        if use_disk:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
        self._store: "OrderedDict[str, Dict[str, np.ndarray]]" = OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0

    # ------------------------------------------------------------- get / set
    def get(self, item_id: str) -> Optional[Dict[str, np.ndarray]]:
        item_id = str(item_id)
        with self._lock:
            if item_id in self._store:
                self._hits += 1
                self._store.move_to_end(item_id)
                return self._store[item_id]
        if self.use_disk:
            path = self.cache_dir / f'{item_id}.npz'
            if path.exists():
                with np.load(path, allow_pickle=False) as z:
                    features = {k: z[k] for k in z.files}
                with self._lock:
                    self._hits += 1
                    self._insert(item_id, features)
                return features
        with self._lock:
            self._misses += 1
        return None

    def set(self, item_id: str, features: Dict[str, np.ndarray],
            force_recompute: bool = False):
        item_id = str(item_id)
        with self._lock:
            if item_id in self._store and not force_recompute:
                return
            self._insert(item_id, features)
        if self.use_disk:
            path = self.cache_dir / f'{item_id}.npz'
            if force_recompute or not path.exists():
                np.savez(path, **{k: np.asarray(v)
                                  for k, v in features.items()})

    def _insert(self, item_id: str, features: Dict[str, np.ndarray]):
        self._store[item_id] = features
        self._store.move_to_end(item_id)
        while len(self._store) > self.max_memory_items:
            self._store.popitem(last=False)

    def clear(self):
        with self._lock:
            self._store.clear()

    # ----------------------------------------------------------------- stats
    def get_stats(self) -> Dict[str, float]:
        with self._lock:
            total = self._hits + self._misses
            return {
                'memory_items': len(self._store),
                'max_memory_items': self.max_memory_items,
                'hits': self._hits,
                'misses': self._misses,
                'hit_rate': self._hits / total if total else 0.0,
                'use_disk': self.use_disk,
                'cache_dir': str(self.cache_dir),
            }

    def print_stats(self):
        for k, v in self.get_stats().items():
            print(f"  {k}: {v}")

    # ----------------------------------------------------- pickle (workers)
    def __getstate__(self):
        """Drop the lock for pickling across process boundaries
        (reference simple_cache.py:79-92)."""
        state = self.__dict__.copy()
        del state['_lock']
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
