"""Parity of the port's data path with the JAX package's, on the CPU: the
label encoder (against scikit-learn's), the numerical processor, the
tokenizers' offline ids, negative sampling, the item feature store's
tables and device tables, and ``MultimodalDataset`` (samples, batches,
histories), built from DataFrames on the JAX side and from DataFrames
and from dicts of numpy columns on the port's; then the port's
prefetching loader and its JSON helpers.

Inputs come from numpy seeds. Integer tables, ids and samples must be
equal; float tables within 1e-6 (float32 scaling in scikit-learn's
order).
"""
import json
import threading

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.preprocessing import LabelEncoder as SkLabelEncoder
from sklearn.preprocessing import MinMaxScaler as SkMinMax
from sklearn.preprocessing import StandardScaler as SkStandard

from pixelrec_multimodal_tpu.data import negative_sampling as jneg
from pixelrec_multimodal_tpu.data import tokenization as jtok
from pixelrec_multimodal_tpu.data.dataset import MultimodalDataset as JaxDataset
from pixelrec_multimodal_tpu.data.feature_store import (
    ItemFeatureStore as JaxStore,
)
from pixelrec_multimodal_tpu.data.processors.numerical_processor import (
    NumericalProcessor as JaxNumerical,
)
from pixelrec_multimodal_tpu_torch.data import negative_sampling as tneg
from pixelrec_multimodal_tpu_torch.data import tokenization as ttok
from pixelrec_multimodal_tpu_torch.data.dataset import MultimodalDataset
from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.data.label_encoder import LabelEncoder
from pixelrec_multimodal_tpu_torch.data.loader import (
    PrefetchLoader,
    prefetch_to_device,
)
from pixelrec_multimodal_tpu_torch.data.processors.numerical_processor import (
    MinMaxScaler,
    NumericalProcessor,
    StandardScaler,
)
from pixelrec_multimodal_tpu_torch.utils import logging as tlogging
from pixelrec_multimodal_tpu_torch.utils.logging import (
    NumpyJSONEncoder,
    dump_json,
    maybe_wandb_log,
    wandb_available,
)

TOL = 1e-6
N_ITEMS, N_USERS = 48, 15
NUM_COLS = ['price', 'views', 'missing_col']


def items_frame(seed=0, numeric=False):
    """Item metadata with the awkward cases: NaN and (unless ``numeric``)
    non-numeric numbers, missing tags and descriptions, a duplicated item
    id."""
    rng = np.random.default_rng(seed)
    price = rng.normal(10, 3, N_ITEMS)
    price[3] = np.nan
    views = rng.integers(0, 1000, N_ITEMS).astype(object)
    views[5] = np.nan if numeric else 'n/a'
    tags = np.array([f't{j % 6}' for j in range(N_ITEMS)], dtype=object)
    tags[[2, 9]] = None
    desc = np.array([f'Item {j}: red, soft & cheap!' for j in range(N_ITEMS)],
                    dtype=object)
    desc[[1, 4]] = None
    df = pd.DataFrame({'item_id': [f'i{j}' for j in range(N_ITEMS)],
                       'tag': tags, 'price': price, 'views': views,
                       'description': desc})
    return pd.concat([df, df.iloc[[7]].assign(tag='t_dup')],
                     ignore_index=True)


def interactions_frame(seed=1, per_user=6):
    """Interactions, some with items that have no metadata."""
    rng = np.random.default_rng(seed)
    rows = [(f'u{u}', f'i{i}', int(rng.integers(0, 100)))
            for u in range(N_USERS)
            for i in rng.choice(N_ITEMS + 4, per_user, replace=False)]
    return pd.DataFrame(rows, columns=['user_id', 'item_id', 'timestamp'])


def columns_of(df):
    return {c: df[c].to_numpy() for c in df.columns}


# ----------------------------------------------------------- label encoder
@pytest.mark.parametrize('labels', [
    np.array(['b', 'a', 'c', 'a', 'zz', 'b'], dtype=object),
    np.array([7, 3, 3, 11, -2, 7])], ids=['strings', 'ints'])
def test_label_encoder_matches_sklearn(labels):
    sk, port = SkLabelEncoder(), LabelEncoder()
    np.testing.assert_array_equal(port.fit_transform(labels),
                                  sk.fit_transform(labels))
    assert list(port.classes_) == list(sk.classes_)
    probe = labels[::-1]
    np.testing.assert_array_equal(port.transform(probe), sk.transform(probe))
    codes = sk.transform(probe)
    assert list(port.inverse_transform(codes)) == \
        list(sk.inverse_transform(codes))
    unseen = np.array(['nope'], dtype=object) if labels.dtype == object \
        else np.array([5])
    for enc in (sk, port):
        with pytest.raises(ValueError):
            enc.transform(unseen)


# ------------------------------------------------------ numerical processor
@pytest.mark.parametrize('method',
                         ['none', 'log1p', 'standardization', 'min_max'])
def test_numerical_processor_matches_jax(method):
    """The four methods on the whole table and on one row; the port fits
    from numpy columns what JAX fits (scikit-learn) from the DataFrame,
    and takes a fitted scikit-learn scaler as its own. Unscaled methods
    read the raw columns (a NaN, a word, a missing column)."""
    raw = items_frame()
    scaled = method in ('standardization', 'min_max')
    df = (raw.assign(views=pd.to_numeric(raw['views'], errors='coerce'))
          if scaled else raw)
    cols = NUM_COLS[:2] if scaled else NUM_COLS
    jp = JaxNumerical(cols, method)
    tp = NumericalProcessor(cols, method)
    jp.fit_scaler(df, cols, method)
    tp.fit_scaler(columns_of(df), cols, method)
    ref = jp.transform_matrix(df)
    got = tp.transform_matrix(columns_of(df))
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    if not scaled:
        return
    np.testing.assert_allclose(tp.get_features(df.iloc[3].to_dict()),
                               jp.get_features(df.iloc[3]), atol=TOL)
    for name in ('scale_', 'mean_' if method == 'standardization'
                 else 'min_'):
        np.testing.assert_allclose(getattr(tp.scaler, name),
                                   getattr(jp.scaler, name), rtol=1e-12)
    borrowed = NumericalProcessor(cols, method, scaler=jp.scaler)
    np.testing.assert_allclose(borrowed.transform_matrix(df), ref, atol=TOL)


def test_scalers_match_sklearn_on_constant_and_wide_columns():
    """A constant column keeps scale 1 (range 1), as in scikit-learn."""
    rng = np.random.default_rng(3)
    x = np.stack([rng.normal(5, 2, 200), np.full(200, 3.5),
                  rng.uniform(-1e4, 1e4, 200)], axis=1)
    for sk, port in ((SkStandard(), StandardScaler()),
                     (SkMinMax(), MinMaxScaler())):
        sk.fit(x)
        port.fit(x)
        x32 = x.astype(np.float32)
        np.testing.assert_allclose(port.transform(x32), sk.transform(x32),
                                   atol=TOL, rtol=1e-6)
        np.testing.assert_allclose(port.scale_, sk.scale_, rtol=1e-12)


# ----------------------------------------------------------- tokenization
@pytest.mark.parametrize('kind', ['sentence-bert', 'clip'])
def test_offline_tokenizer_ids_bit_equal(kind):
    """Without local Hugging Face files both packages fall back to the hash
    tokenizer; its ids and masks are bit-equal, with truncation."""
    texts = ['Red shoes, size 42!', '', "l'été à Paris", 'word ' * 40,
             'ÜBER café — naïve résumé']
    if kind == 'clip':
        jt, tt = jtok.get_clip_tokenizer(), ttok.get_clip_tokenizer()
    else:
        jt, tt = (jtok.get_tokenizer(kind, max_length=24),
                  ttok.get_tokenizer(kind, max_length=24))
    assert type(tt).__name__ == type(jt).__name__ == 'HashTokenizer'
    ref, got = jtok.batch_encode(jt, texts), ttok.batch_encode(tt, texts)
    for k in ('input_ids', 'attention_mask'):
        assert got[k].dtype == ref[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], ref[k])


# -------------------------------------------------------- negative sampling
@pytest.mark.parametrize('strategy',
                         ['random', 'popularity', 'popularity_inverse'])
def test_sample_negatives_draws_the_same_pairs(strategy):
    rng = np.random.default_rng(4)
    n_items = 30
    users = np.repeat(np.arange(20), rng.integers(1, 25, 20))
    items = np.concatenate([rng.choice(n_items, (users == u).sum(),
                                       replace=False) for u in range(20)])
    ref = jneg.sample_negatives(users, items, n_items, ratio=1.5,
                                strategy=strategy,
                                rng=np.random.default_rng(9))
    got = tneg.sample_negatives(users, items, n_items, ratio=1.5,
                                strategy=strategy,
                                rng=np.random.default_rng(9))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tneg.item_popularity_weights(items, n_items, strategy),
        jneg.item_popularity_weights(items, n_items, strategy))


# ------------------------------------------------------------ feature store
def encoders(df):
    ids = np.unique(df['item_id'].astype(str))
    item = SkLabelEncoder().fit(ids)
    tag = SkLabelEncoder().fit(df['tag'].fillna('unknown').astype(str)[:-5])
    return item, tag


@pytest.fixture(scope='module')
def stores():
    """Both stores built from the same metadata, item encoder (with four
    items the metadata lacks) and tag encoder (missing some tags); CLIP
    vision so the CLIP token tables are built too."""
    df = items_frame()
    item_enc, tag_enc = encoders(df)
    item_enc.classes_ = np.sort(np.concatenate(
        [item_enc.classes_, ['i_x0', 'i_x1', 'zz0', 'a0']])).astype(object)
    jproc = JaxNumerical(NUM_COLS[:2], 'standardization')
    jproc.fit_scaler(df.assign(views=pd.to_numeric(df['views'],
                                                   errors='coerce')),
                     NUM_COLS[:2])
    tproc = NumericalProcessor(NUM_COLS[:2], 'standardization')
    tproc.fit_scaler(columns_of(df), NUM_COLS[:2])
    kw = dict(tag_encoder=tag_enc, vision_model='clip',
              language_model='sentence-bert', max_text_length=20)
    return (JaxStore.build(df, item_enc, numerical_processor=jproc, **kw),
            ItemFeatureStore.build(columns_of(df), item_enc,
                                   numerical_processor=tproc, **kw))


def test_feature_store_build_matches_jax(stores):
    js, ts = stores
    assert ts.n_items == js.n_items == N_ITEMS + 4
    np.testing.assert_array_equal(ts.item_ids, js.item_ids)
    assert sorted(ts.tables) == sorted(js.tables) == sorted(
        ['tag_idx', 'numerical', 'text_input_ids', 'text_attention_mask',
         'clip_text_input_ids', 'clip_text_attention_mask'])
    for k, ref in js.tables.items():
        assert ts.tables[k].dtype == ref.dtype, k
        np.testing.assert_allclose(ts.tables[k], ref, atol=TOL, rtol=0,
                                   err_msg=k)
    missing = [list(ts.item_ids).index(i) for i in ('a0', 'zz0')]
    assert not ts.tables['numerical'][missing].any()
    assert not ts.tables['tag_idx'][missing].any()
    assert (ts.tables['text_attention_mask'][missing].sum(1) == 2).all()
    for pos in (0, missing[0], 9):
        got, ref = ts.item_features(pos, False), js.item_features(pos, False)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], atol=TOL)


@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_device_tables_packed_key_and_values_match_jax(stores, bf16):
    import jax.numpy as jnp
    js, ts = stores
    rng = np.random.default_rng(5)
    for s in (js, ts):
        s.set_embedding_table('vision_emb', rng.standard_normal(
            (s.n_items, 12)).astype(np.float32))
        s.set_embedding_table('language_emb', rng.standard_normal(
            (s.n_items, 5)).astype(np.float32))
        rng = np.random.default_rng(5)
    ref = js.device_tables(pack=True, dtype=jnp.bfloat16 if bf16 else None)
    got = ts.device_tables(device='cpu', pack=True,
                           dtype=torch.bfloat16 if bf16 else None)
    key = 'packed::vision_emb=12+language_emb=5+numerical=2'
    assert sorted(got) == sorted(ref) and key in got
    for k, r in ref.items():
        g = got[k]
        assert str(g.dtype).split('.')[-1] == str(r.dtype), k
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(r.astype(jnp.float32)))
    only = ts.device_tables(['tag_idx', 'numerical'], device='cpu',
                            pack=True)
    assert sorted(only) == ['numerical', 'tag_idx']


def write_jpegs(folder, item_ids, positions, seed=5):
    """Random JPEGs of assorted sizes for ``item_ids[positions]``."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    for k, pos in enumerate(positions):
        Image.fromarray(rng.integers(0, 256, (40 + 9 * k, 60 - 7 * k, 3),
                                     dtype=np.uint8)).save(
            folder / f'{item_ids[pos]}.jpg')


def test_unported_tiers_raise(stores, tmp_path):
    """The image tier against JAX's on the same JPEGs: the same uint8
    frames and normalized pixels (zeros for a missing and for an
    undecodable file), the same LRU statistics after each of the same
    calls; the tables shard over a mesh (one process: a 1x1 mesh, the
    whole tables), and an item's features without its image still
    work."""
    js, ts = stores
    write_jpegs(tmp_path, ts.item_ids, (0, 1, 2, 3, 5))
    (tmp_path / f'{ts.item_ids[6]}.jpg').write_bytes(b'not a jpeg')
    kw = dict(vision_model='resnet', image_folder=str(tmp_path),
              max_image_cache_items=3)
    jimg, timg = JaxStore(js.n_items, js.item_ids, **kw), \
        ItemFeatureStore(ts.n_items, ts.item_ids, **kw)
    jimg.tables, timg.tables = js.tables, ts.tables
    calls = (lambda s: s.get_image(0), lambda s: s.get_image(0),
             lambda s: s.image_batch([1, 2, 3, 1, 6]),
             lambda s: s.image_batch_uint8([0, 4, 2, 6]),
             lambda s: s.get_image(4), lambda s: s.get_image(1),
             lambda s: s.item_features(5)['image'])
    for n, call in enumerate(calls):
        got, ref = call(timg), call(jimg)
        assert got.dtype == ref.dtype and got.shape == ref.shape, n
        np.testing.assert_array_equal(got, ref, err_msg=str(n))
        assert timg.get_stats() == jimg.get_stats(), n
    frames = timg.image_batch_uint8([0, 4, 6])
    assert frames.shape == (3, 224, 224, 3) and frames[0].any()
    assert not frames[1:].any()
    stats = timg.get_stats()
    assert stats['memory_items'] == 3 and stats['hits'] >= 2
    from pixelrec_multimodal_tpu_torch.parallel import make_mesh
    sharded = ts.device_tables(device='cpu', mesh=make_mesh(),
                               shard_items=True)
    for k, v in ts.tables.items():
        np.testing.assert_array_equal(sharded[k].numpy(), v)
    assert 'tag_idx' in ts.item_features(0, include_image=False)


# ---------------------------------------------------------------- dataset
DATASET_KW = dict(image_folder='/nonexistent', vision_model_name=None,
                  language_model_name='sentence-bert', max_text_length=16,
                  numerical_feat_cols=NUM_COLS[:2],
                  categorical_feat_cols=['tag'],
                  numerical_normalization_method='min_max',
                  negative_sampling_ratio=1.5,
                  negative_sampling_strategy='popularity', sample_seed=3)


@pytest.fixture(scope='module')
def datasets():
    """The JAX dataset (DataFrames, a scikit-learn scaler to fit), the
    port's from DataFrames and from numpy columns (its own scaler)."""
    items, inter = items_frame(numeric=True), interactions_frame()
    jd = JaxDataset(inter, items, numerical_scaler=SkMinMax(), **DATASET_KW)
    td = MultimodalDataset(inter, items, numerical_scaler=MinMaxScaler(),
                           **DATASET_KW)
    tn = MultimodalDataset(columns_of(inter), columns_of(items),
                           numerical_scaler=MinMaxScaler(), **DATASET_KW)
    return jd, td, tn


def test_dataset_samples_match_jax(datasets):
    jd, td, _ = datasets
    assert (td.n_users, td.n_items, td.n_tags, len(td)) == \
        (jd.n_users, jd.n_items, jd.n_tags, len(jd))
    assert len(td.interactions['item_id']) == len(jd.interactions)
    for k in ('user_idx', 'item_idx', 'label'):
        np.testing.assert_array_equal(td.samples[k], jd.samples[k])
        np.testing.assert_array_equal(td.all_samples[k],
                                      jd.all_samples[k].to_numpy())
    for k in ('user_id', 'item_id'):
        assert list(td.all_samples[k]) == list(jd.all_samples[k])
    for enc in ('user_encoder', 'item_encoder', 'tag_encoder'):
        assert list(getattr(td, enc).classes_) == \
            list(getattr(jd, enc).classes_)
    for k, ref in jd.feature_store.tables.items():
        np.testing.assert_allclose(td.feature_store.tables[k], ref,
                                   atol=TOL, rtol=0, err_msg=k)
    for idx in (0, 7, len(td) - 1):
        got, ref = td[idx], jd[idx]
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], atol=TOL)


@pytest.mark.parametrize('shuffle', [True, False])
def test_batches_and_stacked_batches_match_jax(datasets, shuffle):
    """Padded, weighted batches (the last one partial) and their stack."""
    jd, td, _ = datasets
    bs = 32
    assert td.num_batches(bs) == jd.num_batches(bs) == -(-len(td) // bs)
    assert td.num_batches(bs, True) == jd.num_batches(bs, True)
    ref = list(jd.batches(bs, shuffle=shuffle, seed=4, include_raw=('text',)))
    got = list(td.batches(bs, shuffle=shuffle, seed=4, include_raw=('text',)))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k])
    assert got[-1]['weight'].sum() == len(td) % bs
    assert len(list(td.batches(bs, drop_remainder=True))) == len(td) // bs
    rs, gs = (d.stacked_batches(bs, shuffle=shuffle, seed=4)
              for d in (jd, td))
    for k in rs:
        np.testing.assert_array_equal(gs[k], rs[k])


def test_histories_match_jax(datasets):
    jd, td, _ = datasets
    for g, r in zip(td.user_history_matrix(), jd.user_history_matrix()):
        np.testing.assert_array_equal(g, r)
    for user in ('u0', 'u3', 'u14', 'nobody'):
        assert td.get_user_history(user) == jd.get_user_history(user)
    assert td.get_user_history('u3')


def test_dataset_from_numpy_columns_equals_dataframe(datasets):
    _, td, tn = datasets
    for k in td.samples:
        np.testing.assert_array_equal(tn.samples[k], td.samples[k])
    for k in td.feature_store.tables:
        np.testing.assert_array_equal(tn.feature_store.tables[k],
                                      td.feature_store.tables[k])
    assert sorted(tn.interactions) == sorted(td.interactions)
    for k in td.interactions:
        assert list(tn.interactions[k]) == list(td.interactions[k]), k


def test_shared_encoders_and_positives_only(datasets):
    """Encoders passed in are used as they are (scikit-learn's or the
    port's), and a dataset without negatives keeps its labels."""
    jd, td, _ = datasets
    inter = interactions_frame(seed=2, per_user=2).assign(label=0.5)
    kw = dict(DATASET_KW, numerical_feat_cols=None)
    ref = JaxDataset(inter, items_frame(True), create_negative_samples=False,
                     user_encoder=jd.user_encoder,
                     item_encoder=jd.item_encoder,
                     tag_encoder=jd.tag_encoder, **kw)
    for encs in ((jd.user_encoder, jd.item_encoder, jd.tag_encoder),
                 (td.user_encoder, td.item_encoder, td.tag_encoder)):
        got = MultimodalDataset(
            columns_of(inter), columns_of(items_frame(True)),
            create_negative_samples=False, user_encoder=encs[0],
            item_encoder=encs[1], tag_encoder=encs[2], **kw)
        assert got.n_users == ref.n_users == N_USERS
        for k in ('user_idx', 'item_idx', 'label'):
            np.testing.assert_array_equal(got.samples[k], ref.samples[k])
        assert (got.samples['label'] == 0.5).all()


def test_disk_tier_round_trip(tmp_path, datasets):
    """``cache_to_disk`` saves the tables on first build and loads them
    on the next; the JAX package reads the same file."""
    _, td, _ = datasets
    items, inter = items_frame(numeric=True), interactions_frame()
    kw = dict(DATASET_KW, cache_dir=str(tmp_path), cache_to_disk=True,
              numerical_scaler=MinMaxScaler())
    first = MultimodalDataset(inter, items, **kw)
    first.feature_store.tables['tag_idx'][:] = 5
    first.feature_store.save(str(tmp_path))
    again = MultimodalDataset(inter, items, **kw)
    assert (again.feature_store.tables['tag_idx'] == 5).all()
    jstore = JaxStore(td.n_items, td.feature_store.item_ids, None,
                      'sentence-bert')
    assert jstore.load_tables(str(tmp_path))
    np.testing.assert_array_equal(jstore.tables['numerical'],
                                  td.feature_store.tables['numerical'])


# ------------------------------------------------------------------ loader
def test_prefetch_loader_keeps_order_on_cpu():
    batches = [{'x': np.full(3, i, np.int32)} for i in range(7)]
    got = [b['x'] for b in PrefetchLoader(iter(batches), prefetch=2,
                                          device='cpu')]
    assert [int(t[0]) for t in got] == list(range(7))
    assert all(isinstance(t, torch.Tensor) and t.device.type == 'cpu'
               for t in got)
    doubled = list(prefetch_to_device(
        ({'x': np.arange(2) * i} for i in range(3)), device='cpu'))
    assert [b['x'].tolist() for b in doubled] == [[0, 0], [0, 1], [0, 2]]
    with pytest.raises(ValueError):
        PrefetchLoader([], prefetch=0, device='cpu')


def test_prefetch_loader_surfaces_errors_after_earlier_batches():
    def gen():
        yield {'x': np.zeros(1)}
        yield {'x': np.ones(1)}
        raise RuntimeError('boom in batch 2')
    seen = []
    with pytest.raises(RuntimeError, match='boom'):
        for b in PrefetchLoader(gen(), device='cpu'):
            seen.append(float(b['x'][0]))
    assert seen == [0.0, 1.0]


def early_exit_produced() -> int:
    """Consume 3 batches of a 1,000-batch iterable, stop, join the
    loader's worker; the number of batches the iterable yielded."""
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield {'x': np.full(1, i)}
    for i, _ in enumerate(PrefetchLoader(gen(), prefetch=2, device='cpu')):
        if i == 2:
            break
    for t in threading.enumerate():
        if t.name == 'pixelrec-prefetch':
            t.join(timeout=5)
            assert not t.is_alive()
    return len(produced)


def test_prefetch_loader_early_exit_stops_the_worker():
    assert early_exit_produced() <= 2 + 2 + 2  # consumed + queue + in flight


def test_prefetch_loader_early_exit_bound_holds_every_time():
    """The worker pulls no batch once the consumer has cancelled, however
    the drain and the worker's last put interleave: the bound holds on
    every one of a few hundred runs."""
    counts = [early_exit_produced() for _ in range(300)]
    assert max(counts) <= 6, sorted(set(counts))


# ----------------------------------------------------------------- logging
def test_json_helpers_take_numpy_and_0d_tensors(tmp_path, monkeypatch):
    obj = {'a': np.float32(1.5), 'b': np.int64(3), 'c': np.arange(2),
           'd': torch.tensor(2.25), 'e': torch.tensor(4), 'f': np.bool_(1)}
    path = tmp_path / 'x' / 'out.json'
    dump_json(obj, path)
    assert json.loads(path.read_text()) == {
        'a': 1.5, 'b': 3, 'c': [0, 1], 'd': 2.25, 'e': 4, 'f': True}
    with pytest.raises(TypeError):
        json.dumps({'t': torch.zeros(2)}, cls=NumpyJSONEncoder)
    # without wandb every maybe_wandb_* call does nothing (another test
    # file may have put a stand-in wandb module in place, so take it away)
    monkeypatch.setattr(tlogging, '_HAS_WANDB', False)
    monkeypatch.setattr(tlogging, 'wandb', None)
    assert not wandb_available()
    maybe_wandb_log({'loss': 1.0}, {'loss': float('nan')}, 0, 1e-3)
    assert not tlogging.maybe_wandb_save_checkpoint(tmp_path)
    assert not tlogging.maybe_wandb_init(project='x')
