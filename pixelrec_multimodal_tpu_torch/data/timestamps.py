# pixelrec_multimodal_tpu_torch/data/timestamps.py
"""Timestamps and quantile bins as pandas 3.0.3 computes them, on numpy.

The training-subset entry point bins a timestamp column into quantiles to
stratify on, writes the column back as datetimes and compares monthly
shares. These functions copy pandas' arithmetic, not its API:

  * ``to_datetime``: integers read as nanoseconds since the epoch
    (``datetime64[ns]``); ISO strings in the format of the first value,
    at microseconds unless a value carries more than six fractional
    digits (then nanoseconds), as pandas 3 infers the resolution.
  * ``qcut_codes``: ``qcut(col, q, labels=False, duplicates='drop')``:
    the quantiles of ``np.linspace``, nudged up where ``q * p`` is not
    exact, taken by ``np.quantile`` over the int64 values (through
    float64, then truncated back to the column's unit), duplicate edges
    dropped, ``include_lowest``, ``searchsorted`` on the left; a value
    outside the edges (float64 can round an edge past the extreme value)
    gets NaN, and the codes are then float64.
  * ``datetime_cells``: ``to_csv``'s cells of a datetime column: dates
    alone where every value is midnight, else ``YYYY-MM-DD HH:MM:SS``
    with the fractional digits the column's finest value needs (none,
    3, 6 or 9).
  * ``monthly_drift``: the sum of absolute differences of two columns'
    ``dt.to_period('M').value_counts(normalize=True)``.
"""
from __future__ import annotations

import re

import numpy as np

_PER_SECOND = {'ns': 10 ** 9, 'us': 10 ** 6}
# The ISO shapes a first value may take: date, then optionally a
# separator, hours and minutes, seconds, a fraction of 1 to 9 digits.
_ISO = re.compile(r'(\d{4})-(\d{2})-(\d{2})'
                  r'(?:([ T])(\d{2}):(\d{2})(?::(\d{2})(?:\.(\d{1,9}))?)?)?')


def _shape(m: 're.Match') -> tuple:
    """What a parsed value's format fixes: the separator, and whether it
    has seconds and a fraction."""
    return (m.group(4), m.group(6) is not None, m.group(7) is not None,
            m.group(8) is not None)


def _parse_strings(words) -> np.ndarray:
    first = _ISO.fullmatch(words[0])
    if first is None:
        raise ValueError(f'time data "{words[0]}" is not in an ISO format '
                         'this reader takes (YYYY-MM-DD, optionally '
                         '[ T]HH:MM[:SS[.fraction]])')
    shape = _shape(first)
    dates, seconds, fractions, digits = [], [], [], 0
    for w in words:
        m = _ISO.fullmatch(w)
        if m is None or _shape(m) != shape:
            raise ValueError(f'time data "{w}" doesn\'t match the format of '
                             f'"{words[0]}"')
        y, mo, d, _, hh, mm, ss, frac = m.groups()
        h, mi, s = int(hh or 0), int(mm or 0), int(ss or 0)
        if h > 23 or mi > 59 or s > 59:
            raise ValueError(f'time data "{w}": time out of range')
        dates.append(f'{y}-{mo}-{d}')
        seconds.append(h * 3600 + mi * 60 + s)
        frac = frac or ''
        digits = max(digits, len(frac))
        fractions.append(int(frac.ljust(9, '0')) if frac else 0)
    unit = 'ns' if digits > 6 else 'us'
    days = np.array(dates, dtype='datetime64[D]').astype(np.int64)
    ns = np.array(fractions, dtype=np.int64)
    per = _PER_SECOND[unit]
    values = ((days * 86400 + np.array(seconds, dtype=np.int64)) * per
              + ns // (10 ** 9 // per))
    return values.view(f'datetime64[{unit}]')


def to_datetime(col) -> np.ndarray:
    """pandas' ``to_datetime`` of a column as ``read_csv`` types it:
    integers as nanoseconds since the epoch, strings (or an object column
    of strings) in the ISO format of the first value. Any other column
    raises ValueError, and so does a string in another format."""
    col = np.asarray(col)
    if col.dtype.kind in 'iu':
        return col.astype(np.int64).view('datetime64[ns]')
    if col.dtype.kind in 'UO' and len(col) and \
            all(isinstance(v, str) for v in col.tolist()):
        return _parse_strings(col.tolist())
    raise ValueError(f'to_datetime takes integer or ISO string columns, got '
                     f'{col.dtype}')


def qcut_codes(col, q: int) -> np.ndarray:
    """pandas' ``qcut(col, q, labels=False, duplicates='drop')`` of a
    datetime or numeric column with no missing value: each value's bin
    (int64), or float64 with NaN where a value lies outside the edges."""
    col = np.asarray(col)
    x = col.view(np.int64) if col.dtype.kind == 'M' else col
    quantiles = np.linspace(0, 1, q + 1)
    np.putmask(quantiles, q * quantiles != np.arange(q + 1),
               np.nextafter(quantiles, 1))
    bins = np.quantile(np.atleast_2d(x), quantiles, axis=1,
                       method='linear')[:, 0]
    if col.dtype.kind == 'M':
        bins = bins.astype(col.dtype).view(np.int64)
    _, first = np.unique(bins, return_index=True)
    if len(first) < len(bins) and len(bins) != 2:
        bins = bins[np.sort(first)]
    ids = np.searchsorted(bins, x, side='left').astype(np.intp)
    ids[x == bins[0]] = 1
    outside = (ids == len(bins)) | (ids == 0)
    codes = ids - 1
    if outside.any():
        codes = codes.astype(np.float64)
        codes[outside] = np.nan
    return codes


def datetime_cells(col: np.ndarray) -> list:
    """A datetime64 column's cells as pandas' ``to_csv`` writes them; NaT
    as an empty cell."""
    unit = np.datetime_data(col.dtype)[0]
    if unit not in _PER_SECOND:
        col = col.astype('datetime64[ns]')
        unit = 'ns'
    per = _PER_SECOND[unit]
    nat = np.isnat(col)
    v = col.view(np.int64)[~nat]
    secs, frac = np.divmod(v, per)
    days, tod = np.divmod(secs, 86400)
    day_text = days.astype('datetime64[D]').astype(str)
    if not (tod.any() or frac.any()):
        text = day_text.tolist()
    else:
        hh, rest = np.divmod(tod, 3600)
        mm, ss = np.divmod(rest, 60)
        clock = [f'{d} {h:02d}:{m:02d}:{s:02d}' for d, h, m, s in
                 zip(day_text.tolist(), hh.tolist(), mm.tolist(),
                     ss.tolist())]
        ns = frac * (10 ** 9 // per)
        digits = (9 if (ns % 1000).any() else 6 if (ns % 10 ** 6).any()
                  else 3 if ns.any() else 0)
        if digits:
            scaled = (ns // 10 ** (9 - digits)).tolist()
            clock = [f'{c}.{f:0{digits}d}' for c, f in zip(clock, scaled)]
        text = clock
    out = np.full(len(col), '', dtype=object)
    out[~nat] = text
    return out.tolist()


def monthly_drift(full, subset) -> float:
    """The absolute sum of differences between two datetime columns'
    monthly shares (pandas' ``dt.to_period('M').value_counts(
    normalize=True)``) over the union of their months, as ``reindex(
    months, fill_value=0)``, subtraction, ``abs()`` and ``sum()`` give
    it."""
    months, shares = [], []
    for col in (full, subset):
        m, counts = np.unique(np.asarray(col).astype('datetime64[M]'),
                              return_counts=True)
        months.append(m)
        shares.append(counts / counts.sum())
    union = np.union1d(*months)
    a, b = np.zeros(len(union)), np.zeros(len(union))
    a[np.searchsorted(union, months[0])] = shares[0]
    b[np.searchsorted(union, months[1])] = shares[1]
    return float(np.abs(a - b).sum())
