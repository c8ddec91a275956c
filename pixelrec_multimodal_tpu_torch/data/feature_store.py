# pixelrec_multimodal_tpu_torch/data/feature_store.py
"""Catalog-aligned item feature tables, indexed by the item encoder's
integer ids:

    tag_idx        int32  [n_items]
    numerical      float32[n_items, F]
    text tokens    int32  [n_items, L] (+ attention mask)
    clip tokens    int32  [n_items, 77] (+ mask, when vision == 'clip')
    vision_emb     float32[n_items, Dv]   (precomputed encoder outputs)
    language_emb   float32[n_items, Dl]
    clip_text_emb  float32[n_items, 512]
    images         uint8  [n_items, H, W, 3] (lazy decode, bounded cache)

Counterpart of ``pixelrec_multimodal_tpu/data/feature_store.py``: the
tables built from item metadata (a dict of numpy columns or a DataFrame),
the precomputed-embedding install, the ``.npz`` disk tier under
``<cache_dir>/vision_<v>_lang_<l>/`` (the same file the JAX package
writes), ``device_tables``, which puts the tables on the card
(pinned host memory, then asynchronous copies), packed into one row
table if asked, and the image tier: raw pixels decoded on demand (an LRU
bounded cache of normalized frames, misses decoded concurrently on a
thread pool, as in JAX), which the vision encoders' precompute reads as
uint8 frames. Decoding needs PIL and raises without it. With a mesh,
``device_tables`` gives each rank its rows of the item axis
(``shard_items``) or the whole tables.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..config import MODEL_CONFIGS
from ..device import resolve_device
from ..parallel.mesh import item_table_sharding
from .columns import as_columns, fill_str, n_rows, take
from .processors.image_processor import ImageProcessor, PREPROCESS_SPECS
from .processors.numerical_processor import NumericalProcessor
from .tokenization import (
    CLIP_TEXT_MAX_LENGTH,
    batch_encode,
    get_clip_tokenizer,
    get_tokenizer,
)

# The float tables ``device_tables(pack=True)`` concatenates, in order.
PACKED_ORDER = ('vision_emb', 'language_emb', 'numerical', 'clip_text_emb')

def cache_subdir_name(vision_model: Optional[str],
                      language_model: Optional[str]) -> str:
    """Model-combo cache directory name."""
    return f"vision_{vision_model or 'none'}_lang_{language_model or 'none'}"


class ItemFeatureStore:
    """Host-side item feature tables (numpy), built once, plus a lazy
    image tier."""

    def __init__(self, n_items: int, item_ids: np.ndarray,
                 vision_model: Optional[str] = None,
                 language_model: Optional[str] = None,
                 image_folder: Optional[str] = None,
                 max_image_cache_items: int = 1000):
        self.n_items = n_items
        self.item_ids = np.asarray(item_ids).astype(str)  # idx -> original id
        self.vision_model = vision_model
        self.language_model = language_model
        self.image_folder = image_folder
        self.tables: Dict[str, np.ndarray] = {}
        self._image_processor = (
            ImageProcessor(model_name=vision_model) if vision_model else None)
        self._image_cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._max_image_cache_items = max_image_cache_items
        self._hits = 0
        self._misses = 0
        # PIL releases the GIL while it decodes, so a thread pool overlaps
        # the decodes of a batch's misses.
        self._decode_workers = min(8, os.cpu_count() or 1)
        self._image_lock = threading.Lock()
        self._decode_pool = None

    # -------------------------------------------------------- pickling/threads
    def __getstate__(self):
        state = self.__dict__.copy()
        state['_image_lock'] = None
        state['_decode_pool'] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._image_lock = threading.Lock()
        self._decode_pool = None

    def _get_decode_pool(self):
        if self._decode_workers < 2:
            return None
        if self._decode_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._decode_pool = ThreadPoolExecutor(
                max_workers=self._decode_workers,
                thread_name_prefix='pixelrec-decode')
        return self._decode_pool

    # ----------------------------------------------------------------- build
    @classmethod
    def build(cls, item_info, item_encoder, tag_encoder=None,
              vision_model: Optional[str] = None,
              language_model: Optional[str] = None,
              image_folder: Optional[str] = None,
              numerical_processor: Optional[NumericalProcessor] = None,
              text_column: str = 'description',
              tokenize_text: bool = True,
              max_text_length: Optional[int] = None,
              max_image_cache_items: int = 1000) -> 'ItemFeatureStore':
        """The cheap modalities' tables, aligned to the item encoder.

        ``item_info`` holds one row per item (the first of duplicate ids
        counts). Items in the encoder but missing from it get placeholder
        rows: tag 0, zero numerical features, empty text.
        """
        item_ids = np.asarray(item_encoder.classes_).astype(str)
        n_items = len(item_ids)
        store = cls(n_items, item_ids, vision_model, language_model,
                    image_folder, max_image_cache_items)

        info = as_columns(item_info)
        ids = info['item_id'].astype(str)
        _, first = np.unique(ids, return_index=True)
        keep = np.sort(first)
        info = take(info, keep)
        info['item_id'] = ids[keep]
        rows = _positions(info['item_id'], item_ids)
        valid = rows >= 0

        # --- tag table
        tag_idx = np.zeros(n_items, dtype=np.int32)
        if tag_encoder is not None and 'tag' in info:
            tags = fill_str(info['tag'], 'unknown')
            known = np.isin(tags, np.asarray(tag_encoder.classes_).astype(str))
            enc = np.zeros(len(tags), dtype=np.int64)
            if known.any():
                enc[known] = tag_encoder.transform(tags[known])
            tag_idx[valid] = enc[rows[valid]].astype(np.int32)
        store.tables['tag_idx'] = tag_idx

        # --- numerical table
        if numerical_processor is not None and \
                numerical_processor.numerical_cols:
            mat = numerical_processor.transform_matrix(info)
            table = np.zeros((n_items, mat.shape[1]), dtype=np.float32)
            table[valid] = mat[rows[valid]]
            store.tables['numerical'] = table

        # --- token tables
        if language_model and tokenize_text:
            tok = get_tokenizer(language_model, max_length=max_text_length)
            enc = batch_encode(tok, cls._texts_for(info, rows, text_column))
            store.tables['text_input_ids'] = enc['input_ids']
            store.tables['text_attention_mask'] = enc['attention_mask']
        if vision_model == 'clip' and tokenize_text:
            enc = batch_encode(get_clip_tokenizer(),
                               cls._texts_for(info, rows, text_column),
                               CLIP_TEXT_MAX_LENGTH)
            store.tables['clip_text_input_ids'] = enc['input_ids']
            store.tables['clip_text_attention_mask'] = enc['attention_mask']
        return store

    @staticmethod
    def _texts_for(info, rows: np.ndarray, text_column: str) -> List[str]:
        """Each catalog position's text: ``text_column`` of its row of
        ``info`` (missing values as ''), '' where it has none."""
        info = as_columns(info)
        col = (fill_str(info[text_column], '') if text_column in info
               else np.full(n_rows(info), '', dtype=object))
        return ['' if r < 0 else str(col[r]) for r in rows]

    # ------------------------------------------------------------ embeddings
    def set_embedding_table(self, name: str, table: np.ndarray):
        """Install a precomputed encoder-output table
        ('vision_emb' | 'language_emb' | 'clip_text_emb')."""
        if table.shape[0] != self.n_items:
            raise ValueError(
                f"table rows {table.shape[0]} != n_items {self.n_items}")
        self.tables[name] = np.asarray(table)

    def has(self, name: str) -> bool:
        return name in self.tables

    # ---------------------------------------------------------------- images
    def _image_path(self, item_pos: int) -> str:
        return f"{self.image_folder}/{self.item_ids[item_pos]}.jpg"

    def get_image(self, item_pos: int) -> np.ndarray:
        """Normalized float32 CHW pixels for one catalog position (lazy,
        LRU-bounded). Zero placeholder when missing or undecodable."""
        if self._image_processor is None:
            raise RuntimeError("No vision model configured for this store.")
        with self._image_lock:
            if item_pos in self._image_cache:
                self._hits += 1
                self._image_cache.move_to_end(item_pos)
                return self._image_cache[item_pos]
            self._misses += 1
        img = self._image_processor.load_and_transform_image(
            self._image_path(item_pos))
        self._cache_put(item_pos, img)
        return img

    def _cache_put(self, item_pos: int, img: np.ndarray):
        with self._image_lock:
            self._image_cache[item_pos] = img
            if len(self._image_cache) > self._max_image_cache_items:
                self._image_cache.popitem(last=False)

    def _ensure_images_cached(self, positions: List[int]):
        """Decode the cache-missing positions concurrently."""
        with self._image_lock:
            missing = sorted({p for p in positions
                              if p not in self._image_cache})
        pool = self._get_decode_pool()
        if pool is None or len(missing) < 2:
            return

        def decode(p):
            return p, self._image_processor.load_and_transform_image(
                self._image_path(p))

        for p, img in pool.map(decode, missing):
            self._misses += 1
            self._cache_put(p, img)

    def image_batch(self, item_pos: np.ndarray) -> np.ndarray:
        """Stacked normalized pixels for a batch of catalog positions; the
        misses decode in parallel before the (cache-hitting) stack."""
        positions = [int(i) for i in item_pos]
        self._ensure_images_cached(positions)
        return np.stack([self.get_image(i) for i in positions])

    def image_batch_uint8(self, item_pos: np.ndarray) -> np.ndarray:
        """Raw uint8 HWC frames for the device-side normalization path
        (zeros for a missing or undecodable file), decoded concurrently;
        not cached."""
        spec = PREPROCESS_SPECS[self.vision_model]
        positions = [int(i) for i in item_pos]
        out = np.zeros((len(positions), spec.crop_size, spec.crop_size, 3),
                       dtype=np.uint8)

        def decode(i):
            return self._image_processor.load_image_uint8(
                self._image_path(i))

        pool = self._get_decode_pool()
        frames = (pool.map(decode, positions) if pool is not None
                  else map(decode, positions))
        for j, frame in enumerate(frames):
            if frame is not None:
                out[j] = frame
        return out

    def get_stats(self) -> Dict[str, float]:
        """Image-tier hit/miss statistics."""
        total = self._hits + self._misses
        return {
            'memory_items': len(self._image_cache),
            'hits': self._hits,
            'misses': self._misses,
            'hit_rate': self._hits / total if total else 0.0,
        }

    # ------------------------------------------------------------- per-item
    def item_features(self, item_pos: int, include_image: bool = True
                      ) -> Dict[str, np.ndarray]:
        """One item's features in the reference's batch schema (the image
        only when the store has a vision model and ``include_image``)."""
        out: Dict[str, np.ndarray] = {}
        if self.vision_model and include_image:
            out['image'] = self.get_image(item_pos)
        for key in ('text_input_ids', 'text_attention_mask',
                    'clip_text_input_ids', 'clip_text_attention_mask'):
            if key in self.tables:
                out[key] = self.tables[key][item_pos]
        if 'numerical' in self.tables:
            out['numerical_features'] = self.tables['numerical'][item_pos]
        out['tag_idx'] = self.tables['tag_idx'][item_pos]
        return out

    # ------------------------------------------------------------------ disk
    def save(self, cache_dir: str):
        """Persist the tables as one .npz under the model-combo subdir,
        written beside its place and renamed over it, so that a reader
        (another rank building the same dataset) never sees half a
        file."""
        d = Path(cache_dir) / cache_subdir_name(self.vision_model,
                                                self.language_model)
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f'feature_tables.{os.getpid()}.tmp.npz'
        np.savez(tmp, item_ids=self.item_ids, **self.tables)
        os.replace(tmp, d / 'feature_tables.npz')

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

    # ---------------------------------------------------------------- device
    def device_tables(self, keys: Optional[List[str]] = None,
                      device: Union[str, torch.device] = 'cuda',
                      pack: bool = False, dtype: Optional[torch.dtype] = None,
                      mesh=None, shard_items: bool = False
                      ) -> Dict[str, torch.Tensor]:
        """The requested tables (all by default) as tensors on ``device``.

        ``pack=True`` concatenates the float feature tables present (in
        ``PACKED_ORDER``) into one ``packed::<name>=<width>+...`` table,
        the layout in its key (``training/steps.py:gather_feature_kwargs``
        reads it), so a batch gathers one row per item. ``dtype`` casts the
        float32 tables after the upload; for a bf16 model, bf16 tables give
        the same values, as its first Dense casts the gathered rows to bf16
        anyway. On a CUDA device each table goes through pinned host memory
        and an asynchronous copy on the current stream.

        With a ``mesh`` (``parallel/mesh.py``) and ``shard_items``, each
        rank gets only its rows of the item axis, split over 'model' (the
        rows must divide evenly, as JAX's ``device_put`` requires);
        otherwise every rank gets the whole tables (and without a mesh,
        ``shard_items`` changes nothing, as in the JAX package).
        """
        dev = resolve_device(device)
        keys = keys if keys is not None else list(self.tables)
        host = {k: self.tables[k] for k in keys}
        if pack:
            float_keys = [k for k in PACKED_ORDER
                          if k in host and host[k].ndim == 2]
            if len(float_keys) > 1:
                layout = '+'.join(
                    f'{k}={host[k].shape[1]}' for k in float_keys)
                host['packed::' + layout] = np.concatenate(
                    [host.pop(k).astype(np.float32) for k in float_keys],
                    axis=1)
        out = {}
        for k, arr in host.items():
            if shard_items and mesh is not None:
                arr = arr[item_table_sharding(mesh, arr.shape[0])]
            t = torch.from_numpy(np.ascontiguousarray(arr))
            t = (t.pin_memory().to(dev, non_blocking=True)
                 if dev.type == 'cuda' else t.clone())
            if dtype is not None and t.dtype == torch.float32:
                t = t.to(dtype)
            out[k] = t
        return out


def _positions(ids: np.ndarray, wanted: np.ndarray) -> np.ndarray:
    """For each of ``wanted``, its row in ``ids`` (unique), or -1."""
    if len(ids) == 0:
        return np.full(len(wanted), -1, dtype=np.int64)
    order = np.argsort(ids, kind='stable')
    at = np.minimum(np.searchsorted(ids[order], wanted), len(ids) - 1)
    return np.where(ids[order][at] == wanted, order[at], -1).astype(np.int64)


def model_feature_dims(vision_model: Optional[str],
                       language_model: Optional[str]) -> Dict[str, int]:
    """Raw encoder output dims for a model combo."""
    out = {}
    if vision_model:
        out['vision'] = MODEL_CONFIGS['vision'][vision_model]['dim']
    if language_model:
        out['language'] = MODEL_CONFIGS['language'][language_model]['dim']
    return out
