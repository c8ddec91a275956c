# pixelrec_multimodal_tpu_torch/data/dataset.py
"""The multimodal interaction dataset.

Counterpart of ``pixelrec_multimodal_tpu/data/dataset.py``: it drops
interactions without item metadata, fits or accepts the user, item and
tag encoders, builds the item feature tables (``ItemFeatureStore``),
draws the negative samples, and serves batches of (user, item, tag,
label, weight) indices and the users' histories, with the same samples
in the same order as the JAX package.

Its inputs are dicts of numpy columns or DataFrames (``data/columns.py``)
and it never imports pandas or scikit-learn: ``interactions`` and
``all_samples`` are dicts of numpy columns, and the encoders are
``data/label_encoder.LabelEncoder`` unless fitted ones are passed in
(any object with ``classes_`` and ``transform``, a scikit-learn one
included).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from .columns import as_columns, fill_str, n_rows, take
from .feature_store import ItemFeatureStore
from .label_encoder import LabelEncoder
from .negative_sampling import sample_negatives
from .processors.numerical_processor import NumericalProcessor

# The seed of the final shuffle of positives and negatives, as in the JAX
# package (the negatives themselves come from ``sample_seed``).
SHUFFLE_SEED = 42


class MultimodalDataset:
    """Interactions + catalog feature tables + encoders."""

    def __init__(
        self,
        interactions_df,
        item_info_df,
        image_folder: str,
        vision_model_name: Optional[str] = 'clip',
        language_model_name: Optional[str] = 'sentence-bert',
        create_negative_samples: bool = True,
        numerical_feat_cols: Optional[List[str]] = None,
        categorical_feat_cols: Optional[List[str]] = None,
        cache_features: bool = True,
        cache_max_items: int = 1000,
        cache_dir: Optional[str] = None,
        cache_to_disk: bool = False,
        user_encoder=None,
        item_encoder=None,
        tag_encoder=None,
        **kwargs,
    ):
        self.image_folder = image_folder
        self.vision_enabled = vision_model_name is not None
        self.language_enabled = language_model_name is not None
        self.vision_model_name = vision_model_name
        self.language_model_name = language_model_name
        self.numerical_feat_cols = numerical_feat_cols or []
        self.numerical_enabled = len(self.numerical_feat_cols) > 0
        self.categorical_feat_cols = categorical_feat_cols or []

        self.negative_sampling_strategy = kwargs.get(
            'negative_sampling_strategy', 'random')
        self.negative_sampling_ratio = float(
            kwargs.get('negative_sampling_ratio', 1.0))
        self.numerical_normalization_method = kwargs.get(
            'numerical_normalization_method', 'none')
        self.numerical_scaler = kwargs.get('numerical_scaler', None)
        self.is_train_mode = kwargs.get('is_train_mode', False)
        self.text_augmentation_config = kwargs.get('text_augmentation_config')
        self.image_augmentation_config = kwargs.get('image_augmentation_config')
        self.max_text_length = kwargs.get('max_text_length')
        self.sample_seed = int(kwargs.get('sample_seed', 42))

        items = as_columns(item_info_df)
        items['item_id'] = items['item_id'].astype(str)
        self.item_info_df_original = items
        self.item_info = items

        # Drop interactions lacking item metadata.
        inter = as_columns(interactions_df)
        inter['item_id'] = inter['item_id'].astype(str)
        inter['user_id'] = inter['user_id'].astype(str)
        before = n_rows(inter)
        inter = take(inter, np.isin(inter['item_id'], items['item_id']))
        if n_rows(inter) < before:
            print(f"INFO: Dropped {before - n_rows(inter)} interactions "
                  "that had no corresponding item metadata.")
        self.interactions = inter

        # --- label encoders
        self.user_encoder = (user_encoder if user_encoder is not None
                             else LabelEncoder())
        self.item_encoder = (item_encoder if item_encoder is not None
                             else LabelEncoder())
        if not hasattr(self.user_encoder, 'classes_'):
            self.user_encoder.fit(inter['user_id'])
        if not hasattr(self.item_encoder, 'classes_'):
            self.item_encoder.fit(np.unique(items['item_id']))

        self.tag_encoder = None
        self.n_tags = 1
        if 'tag' in self.categorical_feat_cols:
            items['tag'] = fill_str(items['tag'], 'unknown')
            self.tag_encoder = (tag_encoder if tag_encoder is not None
                                else LabelEncoder())
            if not hasattr(self.tag_encoder, 'classes_'):
                self.tag_encoder.fit(items['tag'])
            self.n_tags = len(self.tag_encoder.classes_)

        self.n_users = len(getattr(self.user_encoder, 'classes_', []))
        self.n_items = len(getattr(self.item_encoder, 'classes_', []))

        # --- numerical processor
        self.numerical_processor = None
        if self.numerical_enabled:
            self.numerical_processor = NumericalProcessor(
                numerical_cols=self.numerical_feat_cols,
                normalization_method=self.numerical_normalization_method,
                scaler=self.numerical_scaler)
            if self.numerical_processor.scaler is not None and \
                    not hasattr(self.numerical_processor.scaler, 'scale_'):
                self.numerical_processor.fit_scaler(
                    items, self.numerical_feat_cols,
                    self.numerical_normalization_method)

        # --- item feature tables
        self.feature_store = ItemFeatureStore.build(
            items, self.item_encoder, tag_encoder=self.tag_encoder,
            vision_model=vision_model_name,
            language_model=language_model_name, image_folder=image_folder,
            numerical_processor=self.numerical_processor,
            max_text_length=self.max_text_length,
            max_image_cache_items=cache_max_items)
        self.cache_dir = cache_dir
        if cache_to_disk and cache_dir:
            # Reuse saved tables if present, else persist what was built.
            if not self.feature_store.load_tables(cache_dir):
                self.feature_store.save(cache_dir)

        # --- index columns
        if n_rows(inter):
            inter['user_idx'] = np.asarray(
                self.user_encoder.transform(inter['user_id']), np.int64)
            inter['item_idx'] = np.asarray(
                self.item_encoder.transform(inter['item_id']), np.int64)

        # --- samples (+ negatives)
        if create_negative_samples and n_rows(inter):
            self._build_samples_with_negatives()
        else:
            empty = np.empty(0, np.int64)
            self.samples = {
                'user_idx': np.array(inter.get('user_idx', empty), np.int64),
                'item_idx': np.array(inter.get('item_idx', empty), np.int64),
            }
            self.samples['label'] = (
                np.array(inter['label'], np.float32) if 'label' in inter
                else np.ones(len(self.samples['user_idx']), np.float32))

        # ``all_samples``: the samples with their original ids.
        self.all_samples = {k: self.samples[k]
                            for k in ('user_idx', 'item_idx', 'label')}
        if self.n_users:
            self.all_samples['user_id'] = self.user_encoder.inverse_transform(
                self.samples['user_idx'])
        if self.n_items:
            self.all_samples['item_id'] = self.item_encoder.inverse_transform(
                self.samples['item_idx'])

    # ---------------------------------------------------------------- samples
    def _build_samples_with_negatives(self):
        """Positives labeled 1 + sampled negatives labeled 0, shuffled with a
        fixed seed."""
        pos_u = self.interactions['user_idx']
        pos_i = self.interactions['item_idx']
        rng = np.random.default_rng(self.sample_seed)
        neg_u, neg_i = sample_negatives(
            pos_u, pos_i, self.n_items,
            ratio=self.negative_sampling_ratio,
            strategy=self.negative_sampling_strategy,
            rng=rng)
        u = np.concatenate([pos_u, neg_u])
        i = np.concatenate([pos_i, neg_i])
        y = np.concatenate([np.ones(len(pos_u), np.float32),
                            np.zeros(len(neg_u), np.float32)])
        perm = np.random.default_rng(SHUFFLE_SEED).permutation(len(u))
        self.samples = {'user_idx': u[perm], 'item_idx': i[perm],
                        'label': y[perm]}

    # --------------------------------------------------------------- protocol
    def __len__(self) -> int:
        return len(self.samples['user_idx'])

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        """One sample in the reference's batch schema (with a vision model,
        its image decoded by the feature store's image tier)."""
        item_pos = int(self.samples['item_idx'][idx])
        out = {
            'user_idx': np.int64(self.samples['user_idx'][idx]),
            'item_idx': np.int64(item_pos),
            'label': np.float32(self.samples['label'][idx]),
        }
        out.update(self.feature_store.item_features(
            item_pos, include_image=self.vision_enabled))
        return out

    def _get_item_features(self, item_id: str) -> Dict[str, np.ndarray]:
        """Feature dict by original item id."""
        item_id = str(item_id)
        classes = getattr(self.item_encoder, 'classes_', None)
        if classes is None or item_id not in set(map(str, classes)):
            return self._get_placeholder_features()
        pos = int(self.item_encoder.transform([item_id])[0])
        return self.feature_store.item_features(
            pos, include_image=self.vision_enabled)

    def _get_placeholder_features(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        if self.vision_enabled:
            out['image'] = np.zeros((3, 224, 224), np.float32)
        fs = self.feature_store
        for key in ('text_input_ids', 'text_attention_mask',
                    'clip_text_input_ids', 'clip_text_attention_mask'):
            if key in fs.tables:
                out[key] = np.zeros_like(fs.tables[key][0])
        if 'numerical' in fs.tables:
            out['numerical_features'] = np.zeros_like(fs.tables['numerical'][0])
        out['tag_idx'] = np.int64(0)
        return out

    # ----------------------------------------------------------------- batches
    def batches(self, batch_size: int, shuffle: bool = True,
                seed: int = 0, drop_remainder: bool = False,
                include_raw: tuple = ()
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Index batches for the train step.

        Yields {'user_idx', 'item_idx', 'tag_idx', 'label', 'weight'} with
        ``batch_size`` rows; the last partial batch is padded with sample 0
        and masked by 'weight'. ``include_raw`` adds per-item token inputs
        ('text', 'clip_text') and the decoded 'image' pixels. The frozen
        path needs none of them.
        """
        n = len(self)
        order = (np.random.default_rng(seed).permutation(n) if shuffle
                 else np.arange(n))
        tables = self.feature_store.tables
        tag_table = tables['tag_idx']
        for start in range(0, n, batch_size):
            idx = order[start:start + batch_size]
            valid = len(idx)
            if valid < batch_size:
                if drop_remainder:
                    return
                idx = np.concatenate(
                    [idx, np.zeros(batch_size - valid, dtype=idx.dtype)])
            items = self.samples['item_idx'][idx].astype(np.int32)
            batch = {
                'user_idx': self.samples['user_idx'][idx].astype(np.int32),
                'item_idx': items,
                'tag_idx': tag_table[items].astype(np.int32),
                'label': self.samples['label'][idx].astype(np.float32),
                'weight': (np.arange(batch_size) < valid).astype(np.float32),
            }
            if 'image' in include_raw:
                batch['image'] = self.feature_store.image_batch(items)
            if 'text' in include_raw and 'text_input_ids' in tables:
                batch['text_input_ids'] = tables['text_input_ids'][items]
                batch['text_attention_mask'] = \
                    tables['text_attention_mask'][items]
            if 'clip_text' in include_raw and 'clip_text_input_ids' in tables:
                batch['clip_text_input_ids'] = \
                    tables['clip_text_input_ids'][items]
                batch['clip_text_attention_mask'] = \
                    tables['clip_text_attention_mask'][items]
            yield batch

    def stacked_batches(self, batch_size: int, shuffle: bool = True,
                        seed: int = 0) -> Dict[str, np.ndarray]:
        """All of an epoch's batches stacked: dict of [num_batches, B, ...],
        for ``train_epoch``."""
        batches = list(self.batches(batch_size, shuffle=shuffle, seed=seed))
        return {k: np.stack([b[k] for b in batches]) for k in batches[0]}

    def num_batches(self, batch_size: int, drop_remainder: bool = False) -> int:
        n = len(self)
        return n // batch_size if drop_remainder else -(-n // batch_size)

    # ------------------------------------------------------------------ misc
    def get_user_history(self, user_id: str) -> set:
        """The original ids of the items the user interacted with."""
        classes = getattr(self.user_encoder, 'classes_', None)
        if classes is None or str(user_id) not in set(map(str, classes)):
            return set()
        uidx = int(self.user_encoder.transform([str(user_id)])[0])
        items = self.interactions['item_idx'][
            self.interactions['user_idx'] == uidx]
        return set(self.item_encoder.inverse_transform(items))

    def user_history_matrix(self):
        """CSR-style (indptr, indices) of each user's positive items, for
        the catalog scorer's seen masks."""
        u = np.asarray(self.interactions.get('user_idx', []), np.int64)
        i = np.asarray(self.interactions.get('item_idx', []), np.int64)
        order = np.argsort(u, kind='stable')
        u, i = u[order], i[order]
        indptr = np.searchsorted(u, np.arange(self.n_users + 1))
        return indptr, i

    @property
    def num_numerical_features(self) -> int:
        return len(self.numerical_feat_cols)
