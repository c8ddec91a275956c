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

Counterpart of ``pixelrec_multimodal_tpu/data/feature_store.py``: the
tables built from item metadata (a dict of numpy columns or a DataFrame),
the precomputed-embedding install, the ``.npz`` disk tier under
``<cache_dir>/vision_<v>_lang_<l>/`` (the same file the JAX package
writes), and ``device_tables``, which puts the tables on the card
(pinned host memory, then asynchronous copies), packed into one row
table if asked. The image tier (raw pixels for the unfrozen encoders)
is not ported yet and raises (ROADMAP item A12); sharding the tables
over several devices raises too (A11).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..config import MODEL_CONFIGS
from ..device import resolve_device
from .columns import as_columns, fill_str, n_rows, take
from .processors.numerical_processor import NumericalProcessor
from .tokenization import (
    CLIP_TEXT_MAX_LENGTH,
    batch_encode,
    get_clip_tokenizer,
    get_tokenizer,
)

# The float tables ``device_tables(pack=True)`` concatenates, in order.
PACKED_ORDER = ('vision_emb', 'language_emb', 'numerical', 'clip_text_emb')

_NO_IMAGES = ('the image tier (raw pixels for the unfrozen encoders) is not '
              'ported yet (ROADMAP item A12)')


def cache_subdir_name(vision_model: Optional[str],
                      language_model: Optional[str]) -> str:
    """Model-combo cache directory name."""
    return f"vision_{vision_model or 'none'}_lang_{language_model or 'none'}"


class ItemFeatureStore:
    """Host-side item feature tables (numpy), built once."""

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
    def get_image(self, item_pos: int) -> np.ndarray:
        raise NotImplementedError(_NO_IMAGES)

    def image_batch(self, item_pos: np.ndarray) -> np.ndarray:
        raise NotImplementedError(_NO_IMAGES)

    def image_batch_uint8(self, item_pos: np.ndarray) -> np.ndarray:
        raise NotImplementedError(_NO_IMAGES)

    def get_stats(self) -> Dict[str, float]:
        raise NotImplementedError(_NO_IMAGES)

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
        """
        if mesh is not None or shard_items:
            raise NotImplementedError(
                'sharding the item tables over several devices is not '
                'ported yet (ROADMAP item A11)')
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
