# pixelrec_multimodal_tpu_torch/data/splitting.py
"""Train/val/test splitting strategies for recommender datasets.

Counterpart of ``pixelrec_multimodal_tpu/data/splitting.py`` on numpy
columns (``data/columns.py``), with no pandas or scikit-learn: the eight
named strategies, the mixed cold-start split, the overlap statistics and
the ``create_robust_splits`` factory give the same rows in the same order
as the JAX package on the same table and seed, so the CSV files the split
entry point writes are the JAX script's. That takes three private copies
of the libraries' arithmetic:

* ``train_test_split``: scikit-learn's (``ShuffleSplit`` and
  ``StratifiedShuffleSplit`` on one ``RandomState``: the sizes, the
  permutations, ``_approximate_mode``, the errors), in permutation order;
* ``sample_rows``: ``DataFrame.sample(frac, random_state)``;
* pandas' sorts: ``sort_values`` on one numeric column is numpy's default
  ``quicksort`` argsort (ties not kept in order; missing values last), on
  a text column a stable sort; sorts on several columns are stable
  lexsorts.

A table has no index here: row positions stand for pandas' index labels,
which the JAX package's tables (read from CSV, filtered, merged) always
hold unique.
"""
from __future__ import annotations

import random
from math import ceil, floor
from typing import Dict, Optional, Tuple, Union

import numpy as np

from .columns import as_columns, is_missing, n_rows, take, text_as_str

_CORE_COLUMNS = ('user_id', 'item_id', 'timestamp')

Table = Dict[str, np.ndarray]


def _table(df) -> Table:
    return text_as_str(as_columns(df))


def _core_cols(cols: Table):
    return [c for c in _CORE_COLUMNS if c in cols]


def _select(cols: Table, names) -> Table:
    return {name: cols[name] for name in names}


# ------------------------------------------------------- pandas' arithmetic
def argsort_values(col: np.ndarray) -> np.ndarray:
    """pandas' ``sort_values`` order on one column: numpy's default
    (quicksort) argsort of the present values of a numeric column, a
    stable sort of a text column's, the missing rows last in their
    order."""
    col = np.asarray(col)
    missing = is_missing(col)
    present = np.flatnonzero(~missing)
    kind = 'stable' if col.dtype.kind in 'OUS' else 'quicksort'
    order = present[np.argsort(col[present], kind=kind)]
    return np.concatenate([order, np.flatnonzero(missing)])


def _codes(col: np.ndarray) -> np.ndarray:
    """The rank of each row's value among the column's sorted distinct
    values (a missing value after every other), as pandas' ordered
    ``Categorical`` codes."""
    col = np.asarray(col)
    missing = is_missing(col)
    codes = np.empty(len(col), dtype=np.int64)
    uniq, inverse = np.unique(col[~missing], return_inverse=True)
    codes[~missing] = inverse.reshape(-1)
    codes[missing] = len(uniq)
    return codes


def lexsort_rows(cols: Table, by) -> np.ndarray:
    """pandas' ``sort_values(by=[...])`` order on several columns: a
    stable lexsort, the first column first."""
    return np.lexsort([_codes(cols[name]) for name in reversed(by)])


def group_rank_and_size(col: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``groupby(col).cumcount()`` and ``transform('size')``: each row's
    position among the rows of its value, in row order, and the count of
    rows of its value."""
    codes = _codes(col)
    order = np.argsort(codes, kind='stable')
    counts = np.bincount(codes)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.empty(len(codes), dtype=np.int64)
    rank[order] = np.arange(len(codes)) - starts[codes[order]]
    return rank, counts[codes]


def value_counts_at_least(col: np.ndarray, minimum: int) -> np.ndarray:
    """The values of ``col`` that occur at least ``minimum`` times
    (``value_counts`` filtered; their order does not matter to ``isin``)."""
    col = np.asarray(col)
    uniq, counts = np.unique(col[~is_missing(col)], return_counts=True)
    return uniq[counts >= minimum]


def unique_in_order(col: np.ndarray) -> np.ndarray:
    """pandas' ``unique``: the distinct values in order of appearance."""
    col = np.asarray(col)
    _, first = np.unique(col, return_index=True)
    return col[np.sort(first)]


def sample_rows(n: int, frac: float, random_state: int) -> np.ndarray:
    """The rows ``DataFrame.sample(frac=frac, random_state=...)`` takes
    from ``n``, in its order: a legacy ``RandomState``'s permutation cut
    to ``round(frac * n)``."""
    size = round(frac * n)
    return np.random.RandomState(random_state).permutation(n)[:size]


# -------------------------------------------------- scikit-learn's splits
def _validate_shuffle_split(n_samples: int, test_size, train_size,
                            default_test_size=None) -> Tuple[int, int]:
    """scikit-learn's ``_validate_shuffle_split``: ceil for a float test
    size, floor for a float train size, the rest to the other side."""
    if test_size is None and train_size is None:
        test_size = default_test_size
    test_kind = np.asarray(test_size).dtype.kind
    train_kind = np.asarray(train_size).dtype.kind
    if (test_kind == 'i' and (test_size >= n_samples or test_size <= 0)) or \
            (test_kind == 'f' and (test_size <= 0 or test_size >= 1)):
        raise ValueError(
            f'test_size={test_size} should be either positive and smaller '
            f'than the number of samples {n_samples} or a float in the '
            '(0, 1) range')
    if (train_kind == 'i' and (train_size >= n_samples or train_size <= 0)) \
            or (train_kind == 'f' and (train_size <= 0 or train_size >= 1)):
        raise ValueError(
            f'train_size={train_size} should be either positive and '
            f'smaller than the number of samples {n_samples} or a float in '
            'the (0, 1) range')
    if train_size is not None and train_kind not in ('i', 'f'):
        raise ValueError(f'Invalid value for train_size: {train_size}')
    if test_size is not None and test_kind not in ('i', 'f'):
        raise ValueError(f'Invalid value for test_size: {test_size}')
    if train_kind == 'f' and test_kind == 'f' and train_size + test_size > 1:
        raise ValueError(
            f'The sum of test_size and train_size = {train_size + test_size}'
            ', should be in the (0, 1) range. Reduce test_size and/or '
            'train_size.')
    if test_kind == 'f':
        n_test = ceil(test_size * n_samples)
    elif test_kind == 'i':
        n_test = float(test_size)
    if train_kind == 'f':
        n_train = floor(train_size * n_samples)
    elif train_kind == 'i':
        n_train = float(train_size)
    if train_size is None:
        n_train = n_samples - n_test
    elif test_size is None:
        n_test = n_samples - n_train
    if n_train + n_test > n_samples:
        raise ValueError(
            f'The sum of train_size and test_size = {int(n_train + n_test)}'
            f', should be smaller than the number of samples {n_samples}. '
            'Reduce test_size and/or train_size.')
    n_train, n_test = int(n_train), int(n_test)
    if n_train == 0:
        raise ValueError(
            f'With n_samples={n_samples}, test_size={test_size} and '
            f'train_size={train_size}, the resulting train set will be '
            'empty. Adjust any of the aforementioned parameters.')
    return n_train, n_test


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """scikit-learn's ``_approximate_mode``: floored shares, the rest to
    the largest remainders, ties drawn from ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _check_labels(y: np.ndarray):
    """scikit-learn's ``check_array`` on the labels: a NaN (or an infinite
    float) is an error."""
    if y.dtype.kind == 'f' and not np.isfinite(y).all():
        raise ValueError('Input y contains NaN.')
    if y.dtype.kind == 'O' and is_missing(y).any():
        raise ValueError('Input y contains NaN.')


def train_test_split(n_samples: int, test_size=None, train_size=None,
                     random_state: Optional[int] = None,
                     stratify: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(train rows, test rows) of ``n_samples``, as scikit-learn 1.9's
    ``train_test_split`` (shuffled) takes them, in its permutation order;
    ``stratify`` keeps the labels' shares (``StratifiedShuffleSplit``).
    Raises its ValueErrors, a label with one member among them."""
    n_train, n_test = _validate_shuffle_split(n_samples, test_size,
                                              train_size, 0.25)
    n_train, n_test = _validate_shuffle_split(n_samples, n_test, n_train,
                                              0.1)
    rng = (np.random.mtrand._rand if random_state is None
           else np.random.RandomState(random_state))
    if stratify is None:
        permutation = rng.permutation(n_samples)
        return (permutation[n_test:n_test + n_train],
                permutation[:n_test])

    y = np.asarray(stratify)
    _check_labels(y)
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    y_indices = y_indices.reshape(-1)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        too_few = classes[class_counts < 2].tolist()
        raise ValueError(
            'The least populated classes in y have only 1 member, which is '
            'too few. The minimum number of groups for any class cannot be '
            f'less than 2. Classes with too few members are: {too_few}')
    if n_train < n_classes:
        raise ValueError(f'The train_size = {n_train} should be greater or '
                         f'equal to the number of classes = {n_classes}')
    if n_test < n_classes:
        raise ValueError(f'The test_size = {n_test} should be greater or '
                         f'equal to the number of classes = {n_classes}')
    class_indices = np.split(np.argsort(y_indices, kind='stable'),
                             np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        permutation = rng.permutation(class_counts[i])
        rows = class_indices[i].take(permutation, mode='clip')
        train.extend(rows[:n_i[i]])
        test.extend(rows[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


# --------------------------------------------------------------- splitter
class DataSplitter:
    """Reproducible splitting strategies, seeded once at construction."""

    def __init__(self, random_state: int = 42):
        self.random_state = random_state
        # The global streams are seeded as in the JAX package.
        np.random.seed(random_state)
        random.seed(random_state)

    # ------------------------------------------------------------------ 3-way
    def column_stratified_split(
        self, interactions_df, train_ratio: float = 0.7,
        val_ratio: float = 0.15, test_ratio: float = 0.15,
        stratify_by: str = None,
    ) -> Tuple[Table, Table, Table]:
        """Random 3-way split keeping the class shares of ``stratify_by``.
        The first split takes the *train* set as its test side, then the
        rest splits into val/test (the JAX package's carve-out order)."""
        cols = _table(interactions_df)
        if not stratify_by or stratify_by not in cols:
            raise ValueError(
                f"Stratification column '{stratify_by}' not found or not provided.")
        if not np.isclose(train_ratio + val_ratio + test_ratio, 1.0):
            raise ValueError(
                "The sum of train, validation, and test ratios must be 1.0.")

        temp_rows, train_rows = train_test_split(
            n_rows(cols), test_size=train_ratio,
            random_state=self.random_state, stratify=cols[stratify_by])
        temp = take(cols, temp_rows)
        rel_test = test_ratio / (val_ratio + test_ratio)
        strat = temp[stratify_by]
        present = strat[~is_missing(strat)]
        val_rows, test_rows = train_test_split(
            n_rows(temp), test_size=rel_test, random_state=self.random_state,
            stratify=None if len(np.unique(present)) < 2 else strat)

        core = _core_cols(cols)
        return (_select(take(cols, train_rows), core),
                _select(take(temp, val_rows), core),
                _select(take(temp, test_rows), core))

    def stratified_temporal_split(
        self, interactions_df, train_ratio: float = 0.7,
        val_ratio: float = 0.15, test_ratio: float = 0.15,
        timestamp_col: str = 'timestamp', stratify_by: Optional[str] = None,
    ) -> Tuple[Table, Table, Table]:
        """Chronological train prefix; stratified val/test over the future,
        restricted to users seen in train."""
        cols = _table(interactions_df)
        if timestamp_col not in cols:
            raise ValueError(f"Timestamp column '{timestamp_col}' not found.")
        if stratify_by and stratify_by not in cols:
            raise ValueError(f"Stratification column '{stratify_by}' not found.")

        ordered = take(cols, argsort_values(cols[timestamp_col]))
        cut = int(n_rows(ordered) * train_ratio)
        train = take(ordered, slice(0, cut))
        future = take(ordered, slice(cut, None))
        future = take(future, np.isin(future['user_id'],
                                      np.unique(train['user_id'])))
        if n_rows(future) == 0:
            raise ValueError(
                "No interactions left for validation/test after ensuring user overlap.")

        rel_test = test_ratio / (val_ratio + test_ratio)
        strat = future[stratify_by] if stratify_by else None
        try:
            val_rows, test_rows = train_test_split(
                n_rows(future), test_size=rel_test,
                random_state=self.random_state, stratify=strat)
        except ValueError as e:
            print(f"Warning: Stratified split failed: {e}. Falling back to random split.")
            val_rows, test_rows = train_test_split(
                n_rows(future), test_size=rel_test,
                random_state=self.random_state)

        core = ['user_id', 'item_id', 'timestamp']
        return (_select(train, core), _select(take(future, val_rows), core),
                _select(take(future, test_rows), core))

    # ----------------------------------------------------------- 2-way splits
    def user_based_split(
        self, interactions_df, train_ratio: float = 0.8,
        min_interactions_per_user: int = 5,
    ) -> Tuple[Table, Table]:
        """Disjoint-user split (user cold-start)."""
        return self._disjoint_split(interactions_df, 'user_id', train_ratio,
                                    min_interactions_per_user, 'users')

    def item_based_split(
        self, interactions_df, train_ratio: float = 0.8,
        min_interactions_per_item: int = 3,
    ) -> Tuple[Table, Table]:
        """Disjoint-item split (item cold-start)."""
        return self._disjoint_split(interactions_df, 'item_id', train_ratio,
                                    min_interactions_per_item, 'items')

    def _disjoint_split(self, interactions_df, key: str, train_ratio: float,
                        minimum: int, noun: str) -> Tuple[Table, Table]:
        cols = _table(interactions_df)
        valid = value_counts_at_least(cols[key], minimum)
        if len(valid) == 0:
            raise ValueError(f"No {noun} have >= {minimum} interactions")
        df = take(cols, np.isin(cols[key], valid))
        ids = unique_in_order(df[key])
        train_rows, val_rows = train_test_split(
            len(ids), train_size=train_ratio, random_state=self.random_state)
        return (take(df, np.isin(df[key], ids[train_rows])),
                take(df, np.isin(df[key], ids[val_rows])))

    def temporal_split(
        self, interactions_df, timestamp_col: str = 'timestamp',
        train_ratio: float = 0.8,
    ) -> Tuple[Table, Table]:
        """Older prefix for train, newer suffix for val."""
        cols = _table(interactions_df)
        if timestamp_col not in cols:
            raise ValueError(f"Timestamp column '{timestamp_col}' not found")
        ordered = take(cols, argsort_values(cols[timestamp_col]))
        cut = int(n_rows(ordered) * train_ratio)
        return take(ordered, slice(0, cut)), take(ordered, slice(cut, None))

    def leave_one_out_split(
        self, interactions_df,
    ) -> Tuple[Table, Table, Table]:
        """Last interaction per user -> test, the one before -> val, the
        rest -> train; users with fewer than 3 go entirely to train."""
        cols = _table(interactions_df)
        if 'timestamp' not in cols:
            raise ValueError(
                "The 'latest' strategy for leave-one-out requires a 'timestamp' column.")

        ordered = take(cols, lexsort_rows(cols, ['user_id', 'timestamp']))
        rank, size = group_rank_and_size(ordered['user_id'])
        rev_rank = size - 1 - rank  # 0 = the user's most recent

        eligible = size >= 3
        test_mask = eligible & (rev_rank == 0)
        val_mask = eligible & (rev_rank == 1)
        train_mask = ~(test_mask | val_mask)
        return (take(ordered, train_mask), take(ordered, val_mask),
                take(ordered, test_mask))

    def stratified_split(
        self, interactions_df, train_ratio: float = 0.8,
        min_interactions_per_user: int = 3,
    ) -> Tuple[Table, Table]:
        """Per-user split: each eligible user's history is divided
        train/val by ratio after a seeded shuffle within the user;
        ineligible users go entirely to train."""
        cols = _table(interactions_df)
        users = cols['user_id']
        _, size = group_rank_and_size(users)
        eligible = size >= min_interactions_per_user
        n_eligible_users = len(np.unique(users[eligible]))
        print(f"Stratified split: Processing "
              f"{len(np.unique(users))} users...")
        print(f"Users with >= {min_interactions_per_user} interactions: "
              f"{n_eligible_users}")

        if n_eligible_users == 0:
            print(f"Warning: No users have >= {min_interactions_per_user} "
                  "interactions. Using simple random split instead.")
            return self.simple_random_split(cols, train_ratio)

        rng = np.random.default_rng(self.random_state)
        keyed = dict(cols, _shuffle_key=rng.random(n_rows(cols)))
        order = take(keyed, lexsort_rows(keyed, ['user_id', '_shuffle_key']))
        del order['_shuffle_key']
        rank, usize = group_rank_and_size(order['user_id'])
        # n_train per user: at least 1, at most size - 1.
        n_train = np.clip((usize * train_ratio).astype(int), 1, usize - 1)
        is_train = rank < n_train
        elig = usize >= min_interactions_per_user
        return (take(order, (elig & is_train) | ~elig),
                take(order, elig & ~is_train))

    def simple_random_split(
        self, interactions_df, train_ratio: float = 0.8,
    ) -> Tuple[Table, Table]:
        """Uniform random split with no disjointness guarantees."""
        cols = _table(interactions_df)
        rows = sample_rows(n_rows(cols), train_ratio, self.random_state)
        rest = np.ones(n_rows(cols), dtype=bool)
        rest[rows] = False
        return take(cols, rows), take(cols, rest)

    # ------------------------------------------------------------- cold-start
    def mixed_split(
        self, interactions_df, cold_user_ratio: float = 0.1,
        cold_item_ratio: float = 0.1, train_ratio: float = 0.8,
    ) -> Dict[str, Table]:
        """Warm/cold x warm/cold validation sets keyed by activity
        quantiles (pandas' linear ``quantile``)."""
        cols = _table(interactions_df)
        u_ids, u_act = np.unique(cols['user_id'], return_counts=True)
        i_ids, i_act = np.unique(cols['item_id'], return_counts=True)
        u_thresh = np.percentile(u_act, cold_user_ratio * 100.0,
                                 method='linear')
        i_thresh = np.percentile(i_act, cold_item_ratio * 100.0,
                                 method='linear')
        cold_u, warm_u = u_ids[u_act <= u_thresh], u_ids[u_act > u_thresh]
        cold_i, warm_i = i_ids[i_act <= i_thresh], i_ids[i_act > i_thresh]

        def subset(users, items):
            return take(cols, np.isin(cols['user_id'], users)
                        & np.isin(cols['item_id'], items))

        warm_warm = subset(warm_u, warm_i)
        if n_rows(warm_warm) > 0:
            train, val_warm = self.stratified_split(warm_warm, train_ratio)
        else:
            train, val_warm = self.simple_random_split(cols, train_ratio)

        return {
            'train': train,
            'val_warm': val_warm,
            'val_cold_user': subset(cold_u, warm_i),
            'val_cold_item': subset(warm_u, cold_i),
            'val_cold_both': subset(cold_u, cold_i),
        }

    # -------------------------------------------------------------- reporting
    def get_split_statistics(self, train_df, val_df, test_df=None
                             ) -> Dict[str, object]:
        """Interaction, user and item counts and the train-val(-test)
        overlap ratios."""
        train, val = _table(train_df), _table(val_df)

        def ids(cols, name):
            return np.unique(cols[name])

        tu, ti = ids(train, 'user_id'), ids(train, 'item_id')
        vu, vi = ids(val, 'user_id'), ids(val, 'item_id')
        u_val = len(np.intersect1d(tu, vu))
        i_val = len(np.intersect1d(ti, vi))
        stats = {
            'train_interactions': n_rows(train),
            'val_interactions': n_rows(val),
            'train_users': len(tu), 'train_items': len(ti),
            'val_users': len(vu), 'val_items': len(vi),
            'user_overlap_val': u_val,
            'item_overlap_val': i_val,
            'user_overlap_ratio_val': u_val / len(vu) if len(vu) else 0,
            'item_overlap_ratio_val': i_val / len(vi) if len(vi) else 0,
        }
        if test_df is not None:
            test = _table(test_df)
            su, si = ids(test, 'user_id'), ids(test, 'item_id')
            u_test = len(np.intersect1d(tu, su))
            i_test = len(np.intersect1d(ti, si))
            stats.update({
                'test_interactions': n_rows(test),
                'test_users': len(su), 'test_items': len(si),
                'user_overlap_test': u_test,
                'item_overlap_test': i_test,
                'user_overlap_ratio_test': u_test / len(su) if len(su) else 0,
                'item_overlap_ratio_test': i_test / len(si) if len(si) else 0,
            })
        return stats


# Strategy name -> (method name, accepted kwargs): each strategy takes only
# its own keyword arguments, as in the JAX package's factory.
_STRATEGIES = {
    'stratified_by_column': ('column_stratified_split',
                             ('train_ratio', 'val_ratio', 'test_ratio', 'stratify_by')),
    'stratified_temporal': ('stratified_temporal_split',
                            ('train_ratio', 'val_ratio', 'test_ratio',
                             'timestamp_col', 'stratify_by')),
    'user': ('user_based_split', ('train_ratio', 'min_interactions_per_user')),
    'item': ('item_based_split', ('train_ratio', 'min_interactions_per_item')),
    'temporal': ('temporal_split', ('timestamp_col', 'train_ratio')),
    'stratified': ('stratified_split', ('train_ratio', 'min_interactions_per_user')),
    'leave_one_out': ('leave_one_out_split', ()),
    'simple_random': ('simple_random_split', ('train_ratio',)),
}


def create_robust_splits(
    interactions_df, split_strategy: str = 'stratified', **kwargs,
) -> Union[Tuple[Table, Table], Tuple[Table, Table, Table]]:
    """Factory dispatching to a named strategy with kwarg whitelisting."""
    if split_strategy not in _STRATEGIES:
        raise ValueError(
            f"Unknown split strategy: {split_strategy}. Available options: "
            "'user', 'item', 'temporal', 'stratified', 'leave_one_out', "
            "'simple_random', 'stratified_temporal'")
    splitter = DataSplitter(random_state=kwargs.get('random_state', 42))
    method_name, allowed = _STRATEGIES[split_strategy]
    call_kwargs = {k: v for k, v in kwargs.items() if k in allowed}
    return getattr(splitter, method_name)(interactions_df, **call_kwargs)
