"""Parity of the port's data modules with no pandas, scikit-learn or PyYAML
against the libraries and the JAX package, on the CPU: the splitting
arithmetic (``train_test_split`` against scikit-learn's, ``sample_rows``
against ``DataFrame.sample``), the eight split strategies and
``mixed_split`` against ``pixelrec_multimodal_tpu.data.splitting`` (the
same rows in the same order, the same statistics), the data filter, the
text processor, the preprocessing helpers and the simple feature cache
against the JAX package's, ``read_csv``/``write_csv`` against pandas, the
left merge of the split entry point against ``pd.merge``, and the YAML
reader and writer against PyYAML.

Inputs come from numpy seeds; every comparison is exact (floats bit for
bit) unless a tolerance is named.
"""
import contextlib
import io
import math
import pickle
import random
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import yaml
from sklearn.model_selection import train_test_split as sk_split

from pixelrec_multimodal_tpu.config import Config as JaxConfig
from pixelrec_multimodal_tpu.config import OfflineTextCleaningConfig as JaxClean
from pixelrec_multimodal_tpu.data import preprocessing as jpre
from pixelrec_multimodal_tpu.data import splitting as jsplit
from pixelrec_multimodal_tpu.data.processors import DataFilter as JaxFilter
from pixelrec_multimodal_tpu.data.processors import TextProcessor as JaxText
from pixelrec_multimodal_tpu.data.simple_cache import (
    SimpleFeatureCache as JaxCache,
)
from pixelrec_multimodal_tpu_torch.config import OfflineTextCleaningConfig
from pixelrec_multimodal_tpu_torch.data import preprocessing as tpre
from pixelrec_multimodal_tpu_torch.data import splitting as tsplit
from pixelrec_multimodal_tpu_torch.data.columns import read_csv, write_csv
from pixelrec_multimodal_tpu_torch.data.processors import (
    DataFilter,
    TextProcessor,
)
from pixelrec_multimodal_tpu_torch.data.simple_cache import SimpleFeatureCache
from pixelrec_multimodal_tpu_torch.scripts.create_splits import left_merge
from pixelrec_multimodal_tpu_torch.utils import yaml_io

ROOT = Path(__file__).resolve().parents[1]
STRATEGIES = sorted(tsplit._STRATEGIES)


def quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def same_cell(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or \
            np.float64(a).tobytes() == np.float64(b).tobytes()
    return a == b and type(a) is type(b)


def assert_table_equal(frame: pd.DataFrame, cols: dict):
    """A DataFrame and a dict of numpy columns: the same column names in
    order, the same rows in order, cell for cell."""
    assert list(frame.columns) == list(cols)
    for name in frame.columns:
        a = frame[name].to_numpy().tolist()
        b = np.asarray(cols[name]).tolist()
        assert len(a) == len(b), name
        bad = [k for k, (x, y) in enumerate(zip(a, b))
               if not same_cell(x, y)]
        assert not bad, (name, bad[:5], [a[k] for k in bad[:5]],
                         [b[k] for k in bad[:5]])


# ------------------------------------------------- scikit-learn's arithmetic
SPLIT_SIZES = [(0.25, None), (None, 0.7), (0.2, 0.5), (0.3, 0.7), (10, None),
               (None, 30), (7, 20), (0.5, 11)]


@pytest.mark.parametrize('test_size,train_size', SPLIT_SIZES)
@pytest.mark.parametrize('seed', [0, 1, 42])
def test_train_test_split_matches_sklearn(test_size, train_size, seed):
    n = 53
    want = sk_split(np.arange(n), test_size=test_size, train_size=train_size,
                    random_state=seed)
    got = tsplit.train_test_split(n, test_size=test_size,
                                  train_size=train_size, random_state=seed)
    assert [w.tolist() for w in want] == [g.tolist() for g in got]


@pytest.mark.parametrize('test_size,train_size', SPLIT_SIZES)
@pytest.mark.parametrize('labels', ['str', 'int'])
@pytest.mark.parametrize('seed', [0, 7])
def test_stratified_train_test_split_matches_sklearn(test_size, train_size,
                                                     labels, seed):
    """Uneven classes (shares that leave remainders, so
    ``_approximate_mode`` breaks ties from the generator)."""
    rng = np.random.default_rng(seed)
    y = rng.choice(4, 53, p=[0.45, 0.3, 0.15, 0.1])
    y[:8] = [0, 0, 1, 1, 2, 2, 3, 3]
    if labels == 'str':
        y = np.array([f'tag{v}' for v in y], dtype=object)
    want = sk_split(np.arange(len(y)), test_size=test_size,
                    train_size=train_size, random_state=seed, stratify=y)
    got = tsplit.train_test_split(len(y), test_size=test_size,
                                  train_size=train_size, random_state=seed,
                                  stratify=y)
    assert [w.tolist() for w in want] == [g.tolist() for g in got]


@pytest.mark.parametrize('case', ['one_member', 'nan_label', 'too_few_test',
                                  'empty_train', 'sizes_too_large'])
def test_train_test_split_raises_as_sklearn(case):
    y = np.array(['a', 'a', 'b', 'b', 'c', 'c', 'c', 'd'], dtype=object)
    kw = dict(test_size=0.25, random_state=0, stratify=y)
    if case == 'nan_label':
        kw['stratify'] = np.array([1.0, 1.0, np.nan, 2.0, 2.0, 3.0, 3.0,
                                   3.0])
    elif case == 'too_few_test':
        kw.update(stratify=y[:7], test_size=2)
    elif case == 'empty_train':
        kw = dict(test_size=0.99, random_state=0)
    elif case == 'sizes_too_large':
        kw = dict(test_size=5, train_size=5, random_state=0)
    n = len(kw['stratify']) if 'stratify' in kw else 8
    with pytest.raises(ValueError) as want:
        sk_split(np.arange(n), **kw)
    with pytest.raises(ValueError) as got:
        tsplit.train_test_split(n, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize('n,frac,seed', [(10, 0.8, 0), (97, 0.6, 42),
                                         (250, 0.35, 3), (5, 0.5, 1)])
def test_sample_rows_matches_pandas(n, frac, seed):
    df = pd.DataFrame({'x': np.arange(n)})
    want = df.sample(frac=frac, random_state=seed)
    assert tsplit.sample_rows(n, frac, seed).tolist() == \
        want.index.tolist()


def test_sorts_match_pandas():
    """``sort_values`` on one numeric column (numpy's quicksort: ties
    reordered past 16 rows), on a text column (stable), with missing
    values last; several columns (stable lexsort); group ranks."""
    rng = np.random.default_rng(0)
    n = 400
    df = pd.DataFrame({
        't': rng.integers(0, 6, n),
        'f': np.where(rng.random(n) < 0.1, np.nan, rng.integers(0, 5, n)),
        's': [f'x{v}' for v in rng.integers(0, 7, n)],
        'u': [f'u{v}' for v in rng.integers(0, 30, n)]})
    cols = {k: df[k].to_numpy(dtype=object if k in 'su' else None)
            for k in df.columns}
    for name in ('t', 'f', 's'):
        assert tsplit.argsort_values(cols[name]).tolist() == \
            df.sort_values(name).index.tolist(), name
    assert tsplit.lexsort_rows(cols, ['u', 't']).tolist() == \
        df.sort_values(['u', 't']).index.tolist()
    rank, size = tsplit.group_rank_and_size(cols['u'])
    grp = df.groupby('u')['u']
    assert rank.tolist() == grp.cumcount().tolist()
    assert size.tolist() == grp.transform('size').tolist()


# ------------------------------------------------------ strategies vs JAX
def interactions_csv(tmp_path, seed: int, int_ids: bool):
    """A seeded interaction table with heavily tied timestamps (600 rows
    over 12 values: every value tied more than 16 times) and a tag, written
    by pandas and read back by each side's reader."""
    rng = np.random.default_rng(seed)
    n = 600
    users = rng.integers(0, 40, n)
    items = rng.integers(0, 70, n)
    df = pd.DataFrame({
        'user_id': [f'{u:04d}' if int_ids else f'u{u}' for u in users],
        'item_id': [f'{i:03d}' if int_ids else f'i{i}' for i in items],
        'timestamp': rng.integers(0, 12, n),
        'tag': [f't{v}' for v in rng.integers(0, 4, n)],
        'rating': rng.random(n)})
    path = tmp_path / f'inter_{seed}_{int_ids}.csv'
    df.to_csv(path, index=False)
    frame = pd.read_csv(path)
    assert (frame['timestamp'].value_counts() > 16).all()
    return frame, read_csv(path)


@pytest.mark.parametrize('strategy', STRATEGIES)
@pytest.mark.parametrize('seed,int_ids', [(3, False), (11, True)])
def test_strategies_match_jax(tmp_path, strategy, seed, int_ids):
    frame, cols = interactions_csv(tmp_path, seed, int_ids)
    kw = dict(random_state=seed + 4, train_ratio=0.6, val_ratio=0.2,
              test_ratio=0.2, stratify_by='tag',
              min_interactions_per_user=5, min_interactions_per_item=3)
    want = quiet(jsplit.create_robust_splits, frame, strategy, **kw)
    got = quiet(tsplit.create_robust_splits, cols, strategy, **kw)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert_table_equal(w.reset_index(drop=True), g)
    assert quiet(tsplit.DataSplitter).get_split_statistics(*got) == \
        quiet(jsplit.DataSplitter).get_split_statistics(*want)


def test_temporal_split_on_text_timestamps_matches_jax(tmp_path):
    """A text timestamp column sorts stably (pandas' string dtype)."""
    frame, cols = interactions_csv(tmp_path, 5, False)
    frame['date'] = [f'2024-01-{d:02d}' for d in frame['timestamp'] % 9 + 1]
    cols['date'] = frame['date'].to_numpy(dtype=object)
    want = jsplit.create_robust_splits(frame, 'temporal',
                                       timestamp_col='date', train_ratio=0.7)
    got = tsplit.create_robust_splits(cols, 'temporal', timestamp_col='date',
                                      train_ratio=0.7)
    for w, g in zip(want, got):
        assert_table_equal(w.reset_index(drop=True), g)


def test_stratified_temporal_fallback_matches_jax(tmp_path):
    """A stratification column with a single-member class: scikit-learn's
    error, caught, then the random split, on both sides."""
    frame, cols = interactions_csv(tmp_path, 8, False)
    frame.loc[frame.index[-1], ['tag', 'timestamp']] = ['lonely', 99]
    cols['tag'] = frame['tag'].to_numpy(dtype=object)
    cols['timestamp'] = frame['timestamp'].to_numpy()
    kw = dict(random_state=1, train_ratio=0.5, val_ratio=0.25,
              test_ratio=0.25, stratify_by='tag')
    out_j, out_t = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out_j):
        want = jsplit.create_robust_splits(frame, 'stratified_temporal', **kw)
    with contextlib.redirect_stdout(out_t):
        got = tsplit.create_robust_splits(cols, 'stratified_temporal', **kw)
    assert 'Falling back to random split' in out_j.getvalue()
    assert out_t.getvalue() == out_j.getvalue()
    for w, g in zip(want, got):
        assert_table_equal(w.reset_index(drop=True), g)


@pytest.mark.parametrize('seed,ratios', [(2, (0.1, 0.1)), (9, (0.3, 0.2))])
def test_mixed_split_matches_jax(tmp_path, seed, ratios):
    frame, cols = interactions_csv(tmp_path, seed, seed % 2 == 1)
    want = quiet(jsplit.DataSplitter(seed).mixed_split, frame, *ratios,
                 train_ratio=0.7)
    got = quiet(tsplit.DataSplitter(seed).mixed_split, cols, *ratios,
                train_ratio=0.7)
    assert list(want) == list(got)
    for key in want:
        assert_table_equal(want[key].reset_index(drop=True), got[key])


def test_strategy_errors_match_jax(tmp_path):
    frame, cols = interactions_csv(tmp_path, 4, False)
    for strategy, kw in (('bogus', {}),
                         ('user', {'min_interactions_per_user': 10 ** 6}),
                         ('item', {'min_interactions_per_item': 10 ** 6}),
                         ('stratified_by_column', {'stratify_by': 'nope'}),
                         ('temporal', {'timestamp_col': 'nope'})):
        with pytest.raises(ValueError) as want:
            jsplit.create_robust_splits(frame, strategy, **kw)
        with pytest.raises(ValueError) as got:
            tsplit.create_robust_splits(cols, strategy, **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------- filter, text, cache
def test_data_filter_matches_jax(tmp_path):
    frame, cols = interactions_csv(tmp_path, 6, False)
    for mins in ((5, 3), (0, 9), (12, 0), (0, 0)):
        want = quiet(JaxFilter.filter_by_activity, frame, *mins)
        got = quiet(DataFilter.filter_by_activity, cols, *mins)
        assert_table_equal(want.reset_index(drop=True), got)
    valid = {f'i{i}' for i in range(0, 70, 3)}
    assert_table_equal(
        quiet(JaxFilter.filter_interactions_by_valid_items, frame,
              valid).reset_index(drop=True),
        quiet(DataFilter.filter_interactions_by_valid_items, cols, valid))
    items = pd.DataFrame({'item_id': [f'i{i}' for i in range(90)],
                          'x': np.arange(90.0)})
    item_cols = {k: items[k].to_numpy(dtype=object if k == 'item_id'
                                      else None) for k in items}
    small = frame.iloc[:100]
    small_cols = {k: v[:100] for k, v in cols.items()}
    assert_table_equal(
        quiet(JaxFilter.align_item_info_with_interactions, items,
              small).reset_index(drop=True),
        quiet(DataFilter.align_item_info_with_interactions, item_cols,
              small_cols))
    assert DataFilter.get_filtering_stats(cols, small_cols, item_cols,
                                          item_cols) == \
        JaxFilter.get_filtering_stats(frame, small, items, items)


TEXTS = ['<p>Hello <b>World</b></p>', 'Ｆｕｌｌ　ｗｉｄｔｈ ①', None, np.nan,
         '  many   spaces\tand\nlines ', 'ﬁ ligature &amp; <br/>', 42, 3.5,
         '']


@pytest.mark.parametrize('flags', [(True, True, True), (False, True, False),
                                   (True, False, True)])
def test_text_processor_matches_jax(flags):
    kw = dict(zip(('remove_html', 'normalize_unicode', 'to_lowercase'),
                  flags))
    jtp = JaxText(cleaning_config=JaxClean(**kw))
    ttp = TextProcessor(cleaning_config=OfflineTextCleaningConfig(**kw))
    frame = pd.DataFrame({'title': pd.Series(TEXTS, dtype=object),
                          'description': pd.Series(TEXTS[::-1],
                                                   dtype=object),
                          'views': np.arange(len(TEXTS), dtype=float)})
    frame.loc[2, 'views'] = np.nan
    for t in TEXTS:
        assert ttp.clean_text_field(t) == jtp.clean_text_field(t)
    cols = {k: frame[k].to_numpy() for k in frame}
    names = ['title', 'description', 'views', 'absent']
    want = jtp.clean_dataframe_text_columns(frame, names)
    got = ttp.clean_dataframe_text_columns(cols, names)
    assert_table_equal(want, got)
    for r in range(len(frame)):
        row = {k: cols[k][r] for k in cols}
        assert ttp.get_combined_text(row, names, ' | ') == \
            jtp.get_combined_text(frame.iloc[r], names, ' | ')


def test_text_processor_online_mode_matches_jax():
    jtp = JaxText(model_name='sentence-bert', max_length=12)
    ttp = TextProcessor(model_name='sentence-bert', max_length=12)
    for text in ('red soft hat', 'a much longer description of an item ' * 3):
        want, got = jtp.process_text(text), ttp.process_text(text)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for k, v in jtp.get_placeholder_tensors().items():
        np.testing.assert_array_equal(ttp.get_placeholder_tensors()[k], v)
    with pytest.raises(ValueError):
        TextProcessor(model_name='nope')
    with pytest.raises(RuntimeError):
        TextProcessor().process_text('x')


def test_preprocessing_matches_jax():
    text = 'the quick brown fox jumps over the lazy dog again and again'
    for kind in ('random_delete', 'random_swap', 'none', 'other'):
        for seed in range(5):
            assert tpre.augment_text(text, kind, 0.3, 0.4,
                                     rng=random.Random(seed)) == \
                jpre.augment_text(text, kind, 0.3, 0.4,
                                  rng=random.Random(seed))
    rng = np.random.default_rng(0)
    x = rng.lognormal(0, 2, (50, 3))
    for method in ('standardization', 'min_max', 'log1p', 'none'):
        for arr in (x, x[:, 0], -x[:5]):
            want, jsc = quiet(jpre.normalize_features, arr, method)
            got, tsc = quiet(tpre.normalize_features, arr, method)
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
            assert (jsc is None) == (tsc is None)
            if tsc is not None:
                np.testing.assert_allclose(
                    tpre.normalize_features(arr * 2, method, tsc)[0],
                    jpre.normalize_features(arr * 2, method, jsc)[0],
                    rtol=1e-12, atol=1e-12)
    for t in ('<i>x</i> y', 'Ｘ', 5, None):
        assert tpre.remove_html_tags(t) == jpre.remove_html_tags(t)
        assert tpre.normalize_unicode_text(t) == \
            jpre.normalize_unicode_text(t)
    # the image checks on a missing file (files are in
    # tests/test_torch_preprocess.py)
    assert tpre.is_image_corrupted('x.jpg') == \
        jpre.is_image_corrupted('x.jpg') is True
    assert tpre.check_image_dimensions('x.jpg', 1, 1) == \
        jpre.check_image_dimensions('x.jpg', 1, 1) is False


def test_simple_feature_cache_matches_jax(tmp_path):
    """get/set, LRU eviction, force_recompute, the disk tier under the
    model-combo directory, stats and pickling, step for step."""
    caches = [cls(vision_model='resnet', language_model=None,
                  base_cache_dir=str(tmp_path / name), max_memory_items=3,
                  use_disk=True)
              for cls, name in ((JaxCache, 'j'), (SimpleFeatureCache, 't'))]
    rng = np.random.default_rng(1)
    feats = {i: {'v': rng.standard_normal(4).astype(np.float32),
                 'tag_idx': np.int64(i)} for i in range(6)}
    ops = [('set', 0), ('set', 1), ('get', 0), ('set', 2), ('set', 3),
           ('get', 1), ('get', 0), ('get', 9), ('set', 4), ('clear', None),
           ('get', 2), ('get', 4), ('force', 2), ('get', 2)]
    for op, i in ops:
        outs = []
        for c in caches:
            if op == 'set':
                outs.append(c.set(i, feats[i]))
            elif op == 'force':
                outs.append(c.set(i, feats[5], force_recompute=True))
            elif op == 'clear':
                outs.append(c.clear())
            else:
                got = c.get(i)
                outs.append(None if got is None else
                            {k: np.asarray(v).tolist()
                             for k, v in got.items()})
        assert outs[0] == outs[1], (op, i)
    stats = [c.get_stats() for c in caches]
    assert stats[0].pop('cache_dir').endswith('j/vision_resnet_lang_none')
    assert stats[1].pop('cache_dir').endswith('t/vision_resnet_lang_none')
    assert stats[0] == stats[1]
    back = pickle.loads(pickle.dumps(caches[1]))
    assert back.get_stats() == caches[1].get_stats()
    assert back.get(2) is not None


# ------------------------------------------------------------------- CSV
def csv_table(seed: int) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    n = 120
    floats = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 9, n)
    floats[::17] = np.nan
    words = np.array(['plain', 'with, comma', 'with "quotes"', 'two\nlines',
                      'NA', '', 'naïve ünïcode', ' padded ', 'True', '1.5'],
                     dtype=object)
    return pd.DataFrame({
        'item_id': [f'{i:05d}' for i in rng.integers(0, 10 ** 5, n)],
        'user_id': [f'u{i}' for i in rng.integers(0, 50, n)],
        'count': rng.integers(-5, 10 ** 6, n),
        'sparse_count': np.where(rng.random(n) < 0.2, np.nan,
                                 rng.integers(0, 100, n)),
        'price': floats,
        'flag': rng.random(n) < 0.5,
        'description': words[rng.integers(0, len(words), n)],
        'all_missing': np.full(n, np.nan)})


@pytest.mark.parametrize('seed', [0, 1])
def test_read_csv_matches_pandas(tmp_path, seed):
    path = tmp_path / 't.csv'
    csv_table(seed).to_csv(path, index=False)
    want = pd.read_csv(path)
    got = read_csv(path)
    assert [str(want[c].dtype) for c in want] == \
        ['int64', 'str', 'int64', 'float64', 'float64', 'bool', 'str',
         'float64']
    kinds = {'int64': 'i', 'float64': 'f', 'bool': 'b', 'str': 'O'}
    assert [got[c].dtype.kind for c in got] == \
        [kinds[str(want[c].dtype)] for c in want]
    assert_table_equal(want, got)
    # leading zeros read as integers; the encoders then see '7', not '007'
    assert got['item_id'].dtype == np.int64


def test_read_csv_floats_in_pandas_arithmetic(tmp_path):
    """pandas' default float reader is not correctly rounded: 17-digit
    reprs, long mantissas, leading zeros, huge and subnormal exponents
    read bit for bit as pandas reads them (not as ``float()`` would)."""
    rng = np.random.default_rng(3)
    words = [repr(float(v)) for v in
             rng.standard_normal(3000) * 10.0 ** rng.integers(-300, 300,
                                                              3000)]
    words += ['%.25g' % v for v in rng.standard_normal(500)]
    words += ['0' * int(k) + '123.' + '9' * 20 for k in range(25)]
    words += ['1e309', '-1e309', '0e400', '1e-400', '4e-324', '.5', '5.',
              '1E5', ' 7.25 ', '+3', '-0', 'inf', '-Infinity',
              '1.7976931348623159e308', '1e00000000000000000000000005']
    path = tmp_path / 'f.csv'
    path.write_text('x,y\n' + ''.join(f'{w},1\n' for w in words))
    want = pd.read_csv(path)['x'].to_numpy()
    got = read_csv(path)['x']
    assert got.dtype == want.dtype == np.float64
    assert got.tobytes() == want.tobytes()
    assert sum(float(w) != v for w, v in zip(words[:3000], want)) > 100


@pytest.mark.parametrize('text', [
    'a,b\n', 'a,b\n1,2\n3\n', 'a,,b\n1,2,3\n', 'x\r\n1\r\n"a\r\nb"\r\n',
    'k,z\nTrue,1\n,2\n', 'k,z\n9223372036854775808,1\n1,2\n',
    'k,z\n99999999999999999999999,1\n1,2\n', 'k,z\n1_000,1\n0x10,2\n',
    'k,z\n1.5e,1\n.,2\n', 'k,z\n"5",1\n" 6 ",2\n', 'k,z\nNULL,1\nn/a,2\n',
    '\ufeffa,b\n1,x\n'])
def test_read_csv_edge_cases_match_pandas(tmp_path, text):
    path = tmp_path / 'e.csv'
    path.write_bytes(text.encode())
    want = pd.read_csv(path)
    got = read_csv(path)
    assert_table_equal(want, got)
    assert [want[c].dtype.kind if str(want[c].dtype) != 'str' else 'O'
            for c in want] == [got[c].dtype.kind for c in got]


def test_read_csv_refuses_what_it_cannot_type(tmp_path):
    path = tmp_path / 'bad.csv'
    path.write_text('a,a\n1,2\n')
    with pytest.raises(ValueError, match='duplicate'):
        read_csv(path)
    path.write_text('a,b\n1,2,3\n')
    with pytest.raises(ValueError, match='row 2'):
        read_csv(path)


@pytest.mark.parametrize('seed', [0, 1])
def test_write_csv_bytes_equal_to_csv(tmp_path, seed):
    """The same table written by ``to_csv(index=False)`` and by
    ``write_csv``: the same bytes, whether the table is pandas' frame or
    the port's columns read back from the file."""
    frame = csv_table(seed)
    frame.to_csv(tmp_path / 'p.csv', index=False)
    write_csv({k: frame[k].to_numpy() for k in frame}, tmp_path / 'q.csv')
    assert (tmp_path / 'q.csv').read_bytes() == \
        (tmp_path / 'p.csv').read_bytes()
    back = pd.read_csv(tmp_path / 'p.csv')
    back.to_csv(tmp_path / 'p2.csv', index=False)
    write_csv(read_csv(tmp_path / 'p.csv'), tmp_path / 'q2.csv')
    assert (tmp_path / 'q2.csv').read_bytes() == \
        (tmp_path / 'p2.csv').read_bytes()
    one = pd.DataFrame({'x': [1.5, np.nan, 1e-05, 1e16, -0.0]})
    one.to_csv(tmp_path / 'p3.csv', index=False)
    write_csv({'x': one['x'].to_numpy()}, tmp_path / 'q3.csv')
    assert (tmp_path / 'q3.csv').read_bytes() == \
        (tmp_path / 'p3.csv').read_bytes()


@pytest.mark.parametrize('kind', ['str', 'int', 'bool'])
def test_left_merge_matches_pandas(kind):
    """Left rows in order, each repeated per matching right row, missing
    where unmatched (an int or bool column then turns float or object)."""
    rng = np.random.default_rng(2)
    left = pd.DataFrame({'user_id': rng.integers(0, 5, 40),
                         'item_id': [f'i{v}' for v in rng.integers(0, 12, 40)],
                         'timestamp': rng.integers(0, 9, 40)})
    tags = {'str': [f't{v}' for v in range(10)], 'int': list(range(10)),
            'bool': [v % 2 == 0 for v in range(10)]}[kind]
    right = pd.DataFrame({'item_id': [f'i{v}' for v in
                                      (0, 1, 2, 3, 3, 4, 5, 7, 7, 7)],
                          'tag': tags})
    want = pd.merge(left, right, on='item_id', how='left')
    got = left_merge({k: left[k].to_numpy(dtype=object if k == 'item_id'
                                          else None) for k in left},
                     {k: right[k].to_numpy(dtype=object if k == 'item_id'
                                           else None) for k in right},
                     on='item_id')
    assert_table_equal(want, got)


# ------------------------------------------------------------------ YAML
def same_yaml(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same_yaml(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same_yaml(x, y)
                                        for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize('name', ['simple_config_example.yaml',
                                  'advanced_config_example.yaml'])
def test_yaml_reader_matches_pyyaml_on_the_configs(name, tmp_path):
    text = (ROOT / 'configs' / name).read_text()
    assert same_yaml(yaml_io.load(text), yaml.safe_load(text))
    # and on what the JAX package's Config.to_yaml writes of it
    path = tmp_path / 'dumped.yaml'
    JaxConfig.from_yaml(str(ROOT / 'configs' / name)).to_yaml(str(path))
    dumped = path.read_text()
    assert same_yaml(yaml_io.load(dumped), yaml.safe_load(dumped))
    # the port's writer writes PyYAML's text for it
    assert yaml_io.dump(yaml.safe_load(dumped)) == dumped


QUIRKS = ['1e-4', '1.0e-06', '1.5e5', '1.5e+5', 'yes', 'on', 'No', 'OFF',
          'true', 'tRue', '017', '08', '0b101', '0x1F', '1_000', '1_000.5',
          '~', 'null', 'Null', '', '1:30', '-1:30', '1:30.5', '.5', '1.',
          '.inf', '-.Inf', '.NaN', '+12', '0', '-0', '0.', '"quoted 1"',
          "'it''s'", '"tab\\there \\u00e9"', 'a#b', 'x # comment',
          'foo bar', '[1, 2.5, yes, [a, "b, c"]]', '{}', '[]',
          '{a: 1, b: [x]}', 'optimizer_type in ["adam", "adamw"]',
          'use_lr_scheduler == True', "http://host:80/x",
          "the 'best item # comment", "a, 'b # c", "a - 'b # c", "x [y # c",
          '["a # b", \'c\'] # c', "{k: 'v # w'} # c"]


@pytest.mark.parametrize('value', QUIRKS)
def test_yaml_plain_scalars_resolve_as_pyyaml(value):
    text = f'k: {value}\nnested:\n  - {value}\n'
    assert same_yaml(yaml_io.load(text), yaml.safe_load(text))


@pytest.mark.parametrize('text', [
    'a:\n- 1\n- - 2\n  - 3\n- k: v\n  k2: [x]\nb: {}\n',
    'top:\n  list:\n    - a\n    - b\n  other: 2 # note\n# full line\n',
    '---\nx: 1\n', "'quoted key': 1\n\"dq\": 2\n3: three\n"])
def test_yaml_block_layouts_match_pyyaml(text):
    assert same_yaml(yaml_io.load(text), yaml.safe_load(text))


@pytest.mark.parametrize('text,line', [
    ('a: &anchor 1\nb: *anchor\n', 1), ('a: !!str 1\n', 1),
    ('a: |\n  block\n', 1), ('a: >\n  folded\n', 1),
    ('a: multi\n  line\n', 2), ('a: [1,\n  2]\n', 1),
    ('a: 2001-12-14\n', 1), ('<<: {a: 1}\n', 1), ('x: 1\n? complex\n', 2),
    ('a: "open\n', 1), ('a:\n\tb: 1\n', 2), ('a: 1\n---\nb: 2\n', 2),
    ('a: [x, , y]\n', 1), ('a: [x #c, y]\n', 1)])
def test_yaml_outside_the_subset_raises(text, line):
    with pytest.raises(ValueError, match=f':{line}:'):
        yaml_io.load(text, 'cfg.yaml')


def test_yaml_writer_round_trips_through_pyyaml():
    """Strings that would read as other types are quoted; the writer's
    text reads back to the same value in PyYAML and in the reader."""
    value = {
        'strings': ['yes', 'null', '1e-4', '1.5', '017', '', ' pad', 'a: b',
                    'x #y', '- dash', "it's", 'line\nbreak', 'tab\t', '~',
                    '2001-12-14', '<<', '=', 'plain text', 'ünï'],
        'numbers': [0, -3, 10 ** 20, 1.0, 1e-06, 1e16, -2.5e-300,
                    float('inf'), float('-inf'), 0.1],
        'flags': [True, False, None],
        'nested': {'empty_list': [], 'empty_map': {},
                   'lists': [[1, 2], [], {'k': 'v', 'l': [3]}]},
        7: 'int key', None: 'null key'}
    text = yaml_io.dump(value)
    assert same_yaml(yaml.safe_load(text), value)
    assert same_yaml(yaml_io.load(text), value)
    nan = yaml.safe_load(yaml_io.dump({'x': float('nan')}))['x']
    assert math.isnan(nan)
