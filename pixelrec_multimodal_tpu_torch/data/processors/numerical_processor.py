# pixelrec_multimodal_tpu_torch/data/processors/numerical_processor.py
"""Numerical item features: scaler fitting and the per-item table.

Counterpart of ``pixelrec_multimodal_tpu/data/processors/
numerical_processor.py`` on numpy alone. Its scalers follow
scikit-learn's arithmetic, since the machine the port trains on has no
scikit-learn: statistics in float64 (the mean and the corrected two-pass
population variance; the minimum and the range), a constant feature's
scale or a zero range replaced by 1, and the float32 transform in the
order scikit-learn applies it. Any fitted object with ``.transform``
serves as ``scaler``, a scikit-learn one included.

Tables come in as a mapping of column name to numpy column, or as a
DataFrame (``data/columns.py``).
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..columns import as_columns, n_rows, to_numeric


def numeric_matrix(table, cols: List[str]) -> np.ndarray:
    """[rows, len(cols)] float64 of ``table``'s columns ``cols``, NaN as 0;
    a missing column is zeros."""
    table = as_columns(table)
    out = np.zeros((n_rows(table), len(cols)), dtype=np.float64)
    for j, c in enumerate(cols):
        if c in table:
            x = to_numeric(table[c])
            out[:, j] = np.where(np.isnan(x), 0.0, x)
    return out


class StandardScaler:
    """scikit-learn's ``StandardScaler`` (mean and population variance in
    float64; a constant feature keeps scale 1)."""

    def fit(self, x) -> 'StandardScaler':
        x = np.asarray(x, dtype=np.float64)
        n = x.shape[0]
        self.n_samples_seen_ = n
        self.mean_ = x.sum(axis=0) / n
        temp = x - self.mean_
        correction = temp.sum(axis=0)
        var = ((temp ** 2).sum(axis=0) - correction ** 2 / n) / n
        self.var_ = var
        eps = np.finfo(np.float64).eps
        constant = var <= n * eps * var + (n * self.mean_ * eps) ** 2
        scale = np.sqrt(var)
        scale[constant] = 1.0
        self.scale_ = scale
        return self

    def transform(self, x) -> np.ndarray:
        x = _float_copy(x)
        x -= self.mean_.astype(x.dtype)
        x /= self.scale_.astype(x.dtype)
        return x


class MinMaxScaler:
    """scikit-learn's ``MinMaxScaler`` to [0, 1] (a zero range keeps
    scale 1)."""

    def fit(self, x) -> 'MinMaxScaler':
        x = np.asarray(x, dtype=np.float64)
        self.n_samples_seen_ = x.shape[0]
        self.data_min_ = np.nanmin(x, axis=0)
        self.data_max_ = np.nanmax(x, axis=0)
        self.data_range_ = self.data_max_ - self.data_min_
        rng = self.data_range_.copy()
        rng[rng < 10 * np.finfo(rng.dtype).eps] = 1.0
        self.scale_ = 1.0 / rng
        self.min_ = 0.0 - self.data_min_ * self.scale_
        return self

    def transform(self, x) -> np.ndarray:
        x = _float_copy(x)
        x *= self.scale_
        x += self.min_
        return x


def _float_copy(x) -> np.ndarray:
    x = np.asarray(x)
    return np.array(x, dtype=x.dtype if x.dtype in (np.float32, np.float64)
                    else np.float64)


class NumericalProcessor:
    """Scaler fitting (offline) and feature extraction (online and whole
    table)."""

    def __init__(self, numerical_cols: Optional[List[str]] = None,
                 normalization_method: str = 'none',
                 scaler: Optional[Any] = None):
        self.numerical_cols = numerical_cols or []
        self.normalization_method = normalization_method
        self.scaler = scaler
        self.fitted_columns = getattr(scaler, 'feature_names_in_', None)

    # ------------------------------------------------------------ online mode
    def get_scaler_info(self) -> Dict[str, Any]:
        if not self.scaler:
            return {'scaler_type': 'None', 'fitted_columns': []}
        cols = self.fitted_columns
        if cols is not None and not isinstance(cols, list):
            cols = list(cols)
        return {'scaler_type': type(self.scaler).__name__,
                'fitted_columns': cols or []}

    def _scale(self, x: np.ndarray) -> np.ndarray:
        if self.scaler and self.normalization_method in ('standardization',
                                                         'min_max'):
            x = self.scaler.transform(x)
        elif self.normalization_method == 'log1p':
            x = np.log1p(x)
        return np.asarray(x, dtype=np.float32)

    def get_features(self, item_info_row: Mapping) -> np.ndarray:
        """One item (a mapping of column -> value) -> float32 features,
        NaN as 0, then scaled."""
        if not self.numerical_cols:
            return np.empty(0, dtype=np.float32)
        row = {c: [item_info_row.get(c, 0.0)] for c in self.numerical_cols}
        x = numeric_matrix(row, self.numerical_cols).astype(np.float32)
        return self._scale(x).reshape(-1)

    def get_placeholder_tensor(self) -> np.ndarray:
        return np.zeros(len(self.numerical_cols), dtype=np.float32)

    def transform_matrix(self, item_info) -> np.ndarray:
        """Every row of ``item_info`` at once: [rows, F] float32."""
        if not self.numerical_cols:
            return np.zeros((n_rows(as_columns(item_info)), 0),
                            dtype=np.float32)
        x = numeric_matrix(item_info, self.numerical_cols).astype(np.float32)
        return self._scale(x)

    # ----------------------------------------------------------- offline mode
    def fit_scaler(self, table, numerical_columns: List[str],
                   method: str = 'standardization') -> Optional[Any]:
        """Fit a scaler on the given columns (NaN as 0)."""
        if not numerical_columns or method in ('none', 'log1p'):
            return None
        if method == 'standardization':
            self.scaler = StandardScaler()
        elif method == 'min_max':
            self.scaler = MinMaxScaler()
        else:
            return None
        # column by column, as pandas lays out the ``.values`` JAX fits
        # on: scikit-learn's sums then run along each column's contiguous
        # memory, which rounds otherwise than summing across rows
        self.scaler.fit(np.asfortranarray(numeric_matrix(table,
                                                         numerical_columns)))
        self.fitted_columns = list(numerical_columns)
        return self.scaler

    def transform_features(self, table, numerical_columns: List[str],
                           method: str = 'standardization'
                           ) -> Tuple[Any, np.ndarray]:
        """(table, its columns transformed by the fitted scaler)."""
        x = numeric_matrix(table, numerical_columns)
        if not numerical_columns or method == 'none':
            return table, x
        if method in ('standardization', 'min_max'):
            x = self.scaler.transform(x) if self.scaler else x
        elif method == 'log1p':
            x = np.log1p(x)
        return table, x

    def save_scaler(self, scaler_path: Path) -> bool:
        """Pickle {scaler, columns}, written beside its place and renamed
        over it (a reader never sees half a file)."""
        if self.scaler is None:
            return False
        scaler_path = Path(scaler_path)
        scaler_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = scaler_path.with_name(f'{scaler_path.name}.{os.getpid()}.tmp')
        with open(tmp, 'wb') as f:
            pickle.dump({'scaler': self.scaler,
                         'columns': self.fitted_columns}, f)
        os.replace(tmp, scaler_path)
        return True

    def load_scaler(self, scaler_path: Path) -> bool:
        """Load a scaler this package pickled, as a dict or bare (the
        pickle must come from a trusted writer: unpickling runs code)."""
        scaler_path = Path(scaler_path)
        if not scaler_path.exists():
            return False
        with open(scaler_path, 'rb') as f:
            data = pickle.load(f)
        if isinstance(data, dict):
            self.scaler = data.get('scaler')
            self.fitted_columns = data.get('columns')
        else:
            self.scaler = data
            self.fitted_columns = None
        return True
