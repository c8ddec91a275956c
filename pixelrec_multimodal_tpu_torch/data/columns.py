# pixelrec_multimodal_tpu_torch/data/columns.py
"""Tables as dicts of numpy columns.

The JAX package's data path takes pandas DataFrames; the port's takes a
mapping of column name to numpy column, or a DataFrame, read through
duck typing (``.columns`` and ``table[name]``), so it never imports
pandas. These helpers give pandas' conversions on numpy columns.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def as_columns(table) -> Dict[str, np.ndarray]:
    """``table`` (a mapping of columns or a DataFrame) as a dict of numpy
    columns of equal length."""
    names = list(table.columns) if hasattr(table, 'columns') else list(table)
    cols = {name: np.asarray(table[name]) for name in names}
    if len({len(c) for c in cols.values()}) > 1:
        raise ValueError(f'columns of unequal length: '
                         f'{ {k: len(v) for k, v in cols.items()} }')
    return cols


def n_rows(cols: Dict[str, np.ndarray]) -> int:
    return len(next(iter(cols.values()))) if cols else 0


def take(cols: Dict[str, np.ndarray], rows) -> Dict[str, np.ndarray]:
    """The given rows (an index array or a boolean mask) of every column."""
    return {k: v[rows] for k, v in cols.items()}


def is_missing(col: np.ndarray) -> np.ndarray:
    """pandas' ``isna``: None, and NaN in float or object columns."""
    col = np.asarray(col)
    if col.dtype.kind == 'f':
        return np.isnan(col)
    if col.dtype.kind == 'O':
        return np.array([v is None or (isinstance(v, float) and v != v)
                         for v in col], dtype=bool)
    return np.zeros(len(col), dtype=bool)


def fill_str(col: np.ndarray, fill: str) -> np.ndarray:
    """pandas' ``fillna(fill).astype(str)`` as a numpy string column."""
    col = np.asarray(col)
    if col.dtype.kind in 'US':
        return col.astype(str)
    missing = is_missing(col)
    out = np.array([fill if m else str(v) for v, m in zip(col, missing)],
                   dtype=str)
    return out if len(out) else np.empty(0, dtype=str)


def to_numeric(col) -> np.ndarray:
    """A column as float64, entries that are not numbers NaN (pandas'
    ``to_numeric(errors='coerce')``)."""
    col = np.asarray(col)
    try:
        return col.astype(np.float64)
    except (TypeError, ValueError):
        out = np.empty(len(col), dtype=np.float64)
        for i, v in enumerate(col):
            try:
                out[i] = float(v)
            except (TypeError, ValueError):
                out[i] = np.nan
        return out
