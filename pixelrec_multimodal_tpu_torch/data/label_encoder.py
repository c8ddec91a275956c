# pixelrec_multimodal_tpu_torch/data/label_encoder.py
"""A numpy label encoder with scikit-learn's ``LabelEncoder`` contract.

The JAX package's dataset fits ``sklearn.preprocessing.LabelEncoder`` for
users, items and tags; the machine the port trains on has no
scikit-learn. This encoder gives the same codes: ``classes_`` is
``np.unique`` of the fitted labels (sorted), a label's code is its
position there, and an unseen label raises ``ValueError``. The dataset
accepts any fitted encoder that has ``classes_`` and ``transform``, a
scikit-learn one included.
"""
from __future__ import annotations

import numpy as np


class LabelEncoder:
    """Labels <-> integer codes in ``[0, len(classes_))``."""

    def fit(self, y) -> 'LabelEncoder':
        self.classes_ = np.unique(np.asarray(y))
        return self

    def fit_transform(self, y) -> np.ndarray:
        return self.fit(y).transform(y)

    def transform(self, y) -> np.ndarray:
        y = np.asarray(y)
        if y.size == 0:
            return np.empty(0, dtype=np.int64)
        codes = np.searchsorted(self.classes_, y)
        found = codes < len(self.classes_)
        found[found] = self.classes_[codes[found]] == y[found]
        if not found.all():
            raise ValueError(f'y contains previously unseen labels: '
                             f'{np.unique(y[~found]).tolist()}')
        return codes.astype(np.int64)

    def inverse_transform(self, y) -> np.ndarray:
        y = np.asarray(y, dtype=np.int64)
        if y.size and (y.min() < 0 or y.max() >= len(self.classes_)):
            raise ValueError(f'y contains codes outside [0, '
                             f'{len(self.classes_)})')
        return self.classes_[y]
