# pixelrec_multimodal_tpu_torch/data/columns.py
"""Tables as dicts of numpy columns.

The JAX package's data path takes pandas DataFrames; the port's takes a
mapping of column name to numpy column, or a DataFrame, read through
duck typing (``.columns`` and ``table[name]``), so it never imports
pandas. These helpers give pandas' conversions on numpy columns, and
``read_csv`` / ``write_csv`` read and write CSV files as pandas'
``read_csv`` (C parser, default options) and ``to_csv(index=False)`` do.
"""
from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

from .timestamps import datetime_cells


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


def value_counts(col) -> Dict[object, int]:
    """pandas' ``value_counts().to_dict()`` of a column with no missing
    value: each distinct value's count, the most frequent first, equal
    counts in order of first appearance (pandas 3 counts in that order,
    then sorts the counts stably, descending)."""
    col = np.asarray(col)
    uniq, first, counts = np.unique(col, return_index=True,
                                    return_counts=True)
    appear = np.argsort(first)
    order = appear[np.argsort(-counts[appear], kind='stable')]
    return dict(zip(uniq[order].tolist(), counts[order].tolist()))


def group_rows(col) -> Tuple[np.ndarray, List[np.ndarray]]:
    """pandas' ``groupby(col)`` with its default sort: the distinct values,
    sorted, and each one's row positions in row order."""
    keys, inverse = np.unique(np.asarray(col), return_inverse=True)
    order = np.argsort(inverse.reshape(-1), kind='stable')
    ends = np.cumsum(np.bincount(inverse.reshape(-1), minlength=len(keys)))
    return keys, np.split(order, ends[:-1])


def is_missing(col: np.ndarray) -> np.ndarray:
    """pandas' ``isna``: None, and NaN in float or object columns."""
    col = np.asarray(col)
    if col.dtype.kind == 'f':
        return np.isnan(col)
    if col.dtype.kind == 'O':
        return np.array([v is None or (isinstance(v, float) and v != v)
                         for v in col], dtype=bool)
    return np.zeros(len(col), dtype=bool)


def text_as_str(cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The table with each object column whose cells are all strings as a
    numpy str column: the same values and order, but sorted, compared and
    deduplicated in C rather than through Python objects."""
    return {k: (v.astype(str) if v.dtype.kind == 'O' and len(v)
                and all(type(x) is str for x in v) else v)
            for k, v in cols.items()}


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


# ---------------------------------------------------------------- CSV files
# pandas' default missing-value strings (read_csv ``na_values``).
NA_STRINGS = frozenset((
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
    '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
    'nan', 'null'))
_TRUE, _FALSE = frozenset(('True', 'TRUE', 'true')), \
    frozenset(('False', 'FALSE', 'false'))
_INF = {'inf': np.inf, '+inf': np.inf, '-inf': -np.inf,
        'infinity': np.inf, '+infinity': np.inf, '-infinity': -np.inf}
_SPACE = ' \t\n\v\f\r'
_INT_RE = re.compile(r'[+-]?[0-9]+')
# What the C parser's float reader takes whole: sign, digits, a point,
# digits, an exponent of at most 17 digits.
_FLOAT_RE = re.compile(r'([+-]?)([0-9]*)(?:\.([0-9]*))?(?:[eE]([+-]?[0-9]{1,17}))?')
# A decimal literal that strtod reads whole (the fallback's syntax).
_STRTOD_RE = re.compile(r'[+-]?(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?')
_POW10 = np.array([float(f'1e{k}') for k in range(309)])
_MAX_DIGITS = 17
_INT64 = (-2 ** 63, 2 ** 63 - 1)


def _precise_floats(words: List[str]):
    """pandas' default float reader (the C parser's ``precise_xstrtod``,
    which is not correctly rounded) on stripped words, vectorized: the
    first 17 digits accumulated in float64 (``x * 10 + d``), the rest
    counted into the exponent, then one multiply or divide by a power of
    ten (two below 1e-308). Returns (values, ok): a word it cannot read
    whole, or whose value overflows, is not ok; the caller then tries
    strtod's correctly rounded reading, as pandas does."""
    n = len(words)
    sign = np.ones(n)
    digits, n_int, n_frac, exp10 = [], np.zeros(n, np.int64), \
        np.zeros(n, np.int64), np.zeros(n, np.int64)
    ok = np.zeros(n, bool)
    for k, w in enumerate(words):
        m = _FLOAT_RE.fullmatch(w)
        if m is None:
            digits.append('')
            continue
        s, ip, fp, ex = m.groups()
        fp = fp or ''
        if not ip and not fp:
            digits.append('')
            continue
        ok[k] = True
        sign[k] = -1.0 if s == '-' else 1.0
        digits.append((ip + fp)[:_MAX_DIGITS])
        n_int[k], n_frac[k] = len(ip), len(fp)
        exp10[k] = int(ex) if ex else 0
    width = np.array(digits, dtype=f'<U{_MAX_DIGITS}')
    codes = width.view(np.uint32).reshape(n, _MAX_DIGITS).astype(np.float64) \
        - 48.0
    count = np.char.str_len(width)
    number = np.zeros(n)
    for k in range(_MAX_DIGITS):
        number = np.where(k < count, number * 10.0 + codes[:, k], number)
    used_frac = np.where(n_int >= _MAX_DIGITS, 0,
                         np.minimum(n_frac, _MAX_DIGITS - n_int))
    exponent = np.maximum(n_int - _MAX_DIGITS, 0) - used_frac + exp10
    number = number * sign
    ok &= exponent <= 308
    with np.errstate(over='ignore'):
        up = number * _POW10[np.clip(exponent, 0, 308)]
        down = number / _POW10[np.clip(-exponent, 0, 308)]
        sub = number / _POW10[np.clip(-308 - exponent, 0, 308)] / _POW10[308]
    out = np.where(exponent > 0, up, np.where(exponent >= -308, down,
                                              np.where(exponent < -616, 0.0,
                                                       sub)))
    ok &= np.isfinite(out)
    return out, ok


def _is_number(word: str) -> bool:
    w = word.strip(_SPACE)
    return bool(_FLOAT_RE.fullmatch(w) or _STRTOD_RE.fullmatch(w)) or \
        word.lower() in _INF


def _float_column(words: List[str], missing: np.ndarray):
    """The column as float64 (NaN where missing), or None where a cell is
    not a number to pandas."""
    rows = np.flatnonzero(~missing)
    if not _is_number(words[rows[0]]):
        return None  # a text column, told by its first cell
    out = np.full(len(words), np.nan)
    stripped = [words[r].strip(_SPACE) for r in rows]
    values, ok = _precise_floats(stripped)
    for j in np.flatnonzero(~ok):
        w = stripped[j]
        if _STRTOD_RE.fullmatch(w):
            values[j] = float(w)
        elif words[rows[j]].lower() in _INF:
            values[j] = _INF[words[rows[j]].lower()]
        else:
            return None
    out[rows] = values
    return out


def _infer_column(words: List[str]) -> np.ndarray:
    """One CSV column as the C parser types it: int64 (or uint64) when
    every cell is an integer, float64 when every cell is a number or
    missing (NaN), bool when every cell is a boolean, else an object column
    of the cells' text with NaN where missing."""
    missing = np.array([w in NA_STRINGS for w in words], dtype=bool)
    if missing.all():
        return np.full(len(words), np.nan)
    if not missing.any() and all(_INT_RE.fullmatch(w.strip(_SPACE))
                                 for w in words):
        ints = [int(w) for w in words]
        if _INT64[0] <= min(ints) and max(ints) <= _INT64[1]:
            return np.array(ints, dtype=np.int64)
        if min(ints) >= 0 and max(ints) < 2 ** 64:
            return np.array(ints, dtype=np.uint64)
        return np.array(ints, dtype=object)
    floats = _float_column(words, missing)
    if floats is not None:
        return floats
    present = [w for w, m in zip(words, missing) if not m]
    if all(w in _TRUE or w in _FALSE for w in present):
        if not missing.any():
            return np.array([w in _TRUE for w in words], dtype=bool)
        return np.array([np.nan if m else w in _TRUE
                         for w, m in zip(words, missing)], dtype=object)
    out = np.empty(len(words), dtype=object)
    out[:] = words
    out[missing] = np.nan
    return out


def read_csv(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """A CSV file with a header row as a dict of numpy columns, typed as
    pandas' ``read_csv(path)`` types them (``_infer_column``): ``007`` in an
    integer column reads as 7, an integer column with an empty cell as
    float64 with NaN, text as an object column with NaN for missing
    cells (pandas' missing-value strings, ``NA_STRINGS``, quoted or not).
    Quoted commas and newlines stay in their cells; blank lines and a
    leading byte-order mark are skipped; a short row's missing cells are
    missing. Duplicate column
    names and rows with more cells than the header raise ValueError."""
    with open(path, newline='', encoding='utf-8-sig') as f:
        rows = [r for r in csv.reader(f, strict=True)
                if r and not (len(r) == 1 and not r[0].strip(_SPACE))]
    if not rows:
        raise ValueError(f'{path}: no header row')
    header = [name if name else f'Unnamed: {j}'
              for j, name in enumerate(rows[0])]
    if len(set(header)) != len(header):
        raise ValueError(f'{path}: duplicate column names {header}')
    width = len(header)
    body = rows[1:]
    if not body:
        return {name: np.empty(0, dtype=object) for name in header}
    lengths = [len(r) for r in body]
    if max(lengths) > width:
        k = next(k for k, n in enumerate(lengths) if n > width)
        raise ValueError(f'{path}: row {k + 2} has {lengths[k]} cells, '
                         f'the header {width}')
    if min(lengths) < width:
        body = [r + [''] * (width - len(r)) for r in body]
    return {name: _infer_column(list(c))
            for name, c in zip(header, zip(*body))}


def _cells(col: np.ndarray) -> List[str]:
    """A column's cells as ``to_csv`` writes them: floats as numpy's
    shortest repr (``astype(str)``), datetimes in one format for the
    column (``timestamps.datetime_cells``), missing values empty."""
    col = np.asarray(col)
    if col.dtype.kind == 'f':
        out = col.astype(str)
        out[np.isnan(col)] = ''
        return out.tolist()
    if col.dtype.kind == 'M':
        return datetime_cells(col)
    if col.dtype.kind in 'iubU':
        return col.astype(str).tolist()
    missing = is_missing(col)
    return ['' if m else (repr(v) if isinstance(v, float) else str(v))
            for v, m in zip(col.tolist(), missing)]


def write_csv(cols, path: Union[str, Path]):
    """Write a table (dict of numpy columns or a DataFrame) as pandas'
    ``to_csv(path, index=False)`` does: the header, then one row per
    record, csv's minimal quoting, ``\\n`` line ends."""
    cols = as_columns(cols)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, 'w', newline='', encoding='utf-8') as f:
        writer = csv.writer(f, lineterminator='\n',
                            quoting=csv.QUOTE_MINIMAL)
        writer.writerow(list(cols))
        writer.writerows(zip(*(_cells(c) for c in cols.values())))


# ------------------------------------------------------- JSON records
_MISSING = object()


def _is_null(v) -> bool:
    return v is None or v is _MISSING or (isinstance(v, float) and v != v)


def from_records(rows: List[dict]) -> Dict[str, np.ndarray]:
    """pandas' ``DataFrame(rows)`` of a list of dicts as numpy columns:
    the keys in first-seen order, a key a row lacks missing there; a
    column of ints is int64, of ints or floats with a missing value
    float64 (NaN), of bools bool, anything else (strings, bools with a
    missing value, mixed kinds) an object column with None where
    missing."""
    names: Dict[str, None] = {}
    for row in rows:
        names.update(dict.fromkeys(row))
    cols = {}
    for name in names:
        values = [row.get(name, _MISSING) for row in rows]
        present = [v for v in values if not _is_null(v)]
        nulls = len(present) < len(values)
        is_bool = [isinstance(v, (bool, np.bool_)) for v in present]
        is_int = [isinstance(v, (int, np.integer)) and not b
                  for v, b in zip(present, is_bool)]
        is_num = [isinstance(v, (float, np.floating)) or i
                  for v, i in zip(present, is_int)]
        if present and all(is_int) and not nulls:
            cols[name] = np.array(present, dtype=np.int64)
        elif present and all(is_num) and any(is_num):
            cols[name] = np.array([np.nan if _is_null(v) else float(v)
                                   for v in values], dtype=np.float64)
        elif present and all(is_bool) and not nulls:
            cols[name] = np.array(present, dtype=bool)
        else:
            out = np.empty(len(values), dtype=object)
            out[:] = [None if v is _MISSING else v for v in values]
            cols[name] = out
    return cols


_POW10_INT = [10 ** k for k in range(16)]


def _json_float(value: float, precision: int = 10) -> str:
    """A finite float as pandas' ``to_json`` writes it (ujson's
    ``Buffer_AppendDoubleUnchecked``, ``double_precision=10``): ``%.10g``
    past 1e16 - 1 or below 1e-15, else the whole part, a point and at
    most ``precision`` fractional digits rounded half to odd-or-zero,
    trailing zeros dropped, at least one digit after the point."""
    neg = value < 0
    if neg:
        value = -value
    if value > 1e16 - 1 or (value != 0.0 and value < 1e-15):
        return '%.*g' % (precision, -value if neg else value)
    pow10 = float(_POW10_INT[precision])
    whole = int(value)
    tmp = (value - whole) * pow10
    frac = int(tmp)
    diff = tmp - frac
    if diff > 0.5 or (diff == 0.5 and (frac == 0 or frac & 1)):
        frac += 1
    if frac >= _POW10_INT[precision]:
        frac = 0
        whole += 1
    if frac:
        digits = str(frac).rjust(precision, '0').rstrip('0')
    else:
        digits = '0'
    return f"{'-' if neg else ''}{whole}.{digits}"


def _json_str(s: str) -> str:
    """ujson's string escapes (pandas' ``to_json``): quotes, backslashes,
    forward slashes, control characters, and every non-ASCII character as
    ``\\u`` escapes."""
    out = ['"']
    for ch in s:
        o = ord(ch)
        if ch in '"\\/':
            out.append('\\' + ch)
        elif ch in '\b\f\n\r\t':
            out.append({'\b': '\\b', '\f': '\\f', '\n': '\\n',
                        '\r': '\\r', '\t': '\\t'}[ch])
        elif o < 0x20 or o >= 0x80:
            if o > 0xffff:
                o -= 0x10000
                out.append('\\u%04x\\u%04x' % (0xd800 + (o >> 10),
                                               0xdc00 + (o & 0x3ff)))
            else:
                out.append('\\u%04x' % o)
        else:
            out.append(ch)
    out.append('"')
    return ''.join(out)


def _json_value(v) -> str:
    if _is_null(v):
        return 'null'
    if isinstance(v, (bool, np.bool_)):
        return 'true' if v else 'false'
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return _json_float(float(v)) if np.isfinite(v) else 'null'
    if isinstance(v, str):
        return _json_str(v)
    raise TypeError(f'cannot write {type(v).__name__} as JSON')


def write_json_records(cols, path: Union[str, Path], indent: int = 2):
    """Write a table (dict of numpy columns or a DataFrame) as pandas'
    ``to_json(path, orient='records', indent=indent)`` does: one object a
    row, no space after a colon, floats at ``double_precision=10``
    (``_json_float``), NaN and infinities as null, no newline at the
    end; a table with no row as ``[``, an empty line, ``]``."""
    cols = as_columns(cols)
    pad, inner = ' ' * indent, ' ' * 2 * indent
    rows = [',\n'.join(f'{inner}{_json_str(k)}:{_json_value(v)}'
                        for k, v in zip(cols, values))
            for values in zip(*(c.tolist() for c in cols.values()))]
    if not rows:
        text = '[\n\n]'
    else:
        text = '[\n' + ',\n'.join(f'{pad}{{\n{r}\n{pad}}}'
                                   for r in rows) + '\n]'
    Path(path).write_text(text, encoding='ascii')
