"""The slice as a whole: the port's CatalogScorer against the JAX
CatalogScorer on the same converted weights and item tables, on the CPU
(both sides score in float32 there).

Geometry: 1,000 items in 256-item chunks, so the catalog pads to 1,024 and
the padding mask is live; 70 users in 64-user blocks, so the second block
is ragged; k = 10. Scores agree to atol 1e-5 (float32 sums in another
order); top-k index sets are equal row for row.
"""
import numpy as np
import pytest

from pixelrec_multimodal_tpu.data.feature_store import (
    ItemFeatureStore as JaxStore,
)
from pixelrec_multimodal_tpu.inference.scorer import (
    CatalogScorer as JaxScorer,
)
from pixelrec_multimodal_tpu_torch.data.feature_store import (
    ItemFeatureStore,
    cache_subdir_name,
)
from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
from tests._torch_port import N_USERS, item_tables, make_pair

N_ITEMS, ITEM_CHUNK, USER_CHUNK, K = 1000, 256, 64, 10


@pytest.fixture(scope='module')
def scorers():
    jmodel, variables, tmodel = make_pair(N_ITEMS, 'relu', 'sigmoid')
    tables = item_tables(N_ITEMS)
    ids = np.arange(N_ITEMS).astype(str)
    jstore, tstore = JaxStore(N_ITEMS, ids), ItemFeatureStore(N_ITEMS, ids)
    jstore.tables.update(tables)
    tstore.tables.update(tables)
    out = {}
    for fast in (True, False):
        out[fast] = (
            JaxScorer(jmodel, variables, jstore, item_chunk=ITEM_CHUNK,
                      user_chunk=USER_CHUNK, fast_path=fast),
            CatalogScorer(tmodel, tstore, item_chunk=ITEM_CHUNK,
                          user_chunk=USER_CHUNK, fast_path=fast,
                          device='cpu'))
    return out


@pytest.fixture(scope='module')
def users():
    return np.random.default_rng(5).integers(0, N_USERS, 70).astype(np.int32)


@pytest.fixture(scope='module')
def seen():
    return np.random.default_rng(6).random((70, N_ITEMS)) < 0.05


def assert_same_topk(j, t):
    (jv, ji), (tv, ti) = j, t
    assert tv.shape == jv.shape == (70, K) and ti.dtype == np.int32
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    for a, b in zip(ti, ji):
        assert set(a) == set(b)


def test_catalog_tables_match(scorers):
    """Item tower rows (padding rows included) and first-layer rows."""
    js, ts = scorers[True]
    assert ts.n_pad == js.n_pad == 1024 and ts.item_chunk == js.item_chunk
    np.testing.assert_allclose(ts._item_feats.numpy(),
                               np.asarray(js._item_feats), atol=1e-5)
    np.testing.assert_allclose(ts._item_fast[0].numpy(),
                               np.asarray(js._item_fast[0]), atol=1e-5)


@pytest.mark.parametrize('fast', [True, False], ids=['fast', 'generic'])
@pytest.mark.parametrize('with_seen', [False, True], ids=['all', 'seen'])
def test_top_k_matches_jax(scorers, users, seen, fast, with_seen):
    js, ts = scorers[fast]
    mask = seen if with_seen else None
    assert_same_topk(js.top_k(users, K, seen_mask=mask),
                     ts.top_k(users, K, seen_mask=mask))
    if with_seen:
        _, ti = ts.top_k(users, K, seen_mask=mask)
        assert not seen[np.arange(70)[:, None], ti].any()
        assert (ti < N_ITEMS).all()


def test_tf32_off_inside_calls_and_restored(scorers, users, monkeypatch):
    """The scorer turns TF32 off for its own float32 products only: the
    caller's setting holds again after the call, even if it was on."""
    import torch

    from pixelrec_multimodal_tpu_torch.inference import scorer as tsc
    seen_flags = []
    real = tsc.pairwise_scores

    def spy(*args):
        seen_flags.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*args)

    monkeypatch.setattr(tsc, 'pairwise_scores', spy)
    _, ts = scorers[True]
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        ts.top_k(users[:3], K)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen_flags and not any(seen_flags)


def test_top_k_fills_minus_one_past_the_catalog(scorers):
    """k beyond the unmasked items: missing slots are -1, as in JAX."""
    js, ts = scorers[True]
    mask = np.ones((3, N_ITEMS), bool)
    mask[:, :4] = False
    jv, ji = js.top_k(np.arange(3), 6, seen_mask=mask)
    tv, ti = ts.top_k(np.arange(3), 6, seen_mask=mask)
    np.testing.assert_array_equal(ti[:, 4:], -1)
    np.testing.assert_array_equal(ji[:, 4:], -1)
    np.testing.assert_allclose(tv[:, :4], jv[:, :4], atol=1e-5)


@pytest.mark.parametrize('fast', [True, False], ids=['fast', 'generic'])
def test_score_full_matches_jax(scorers, users, fast):
    js, ts = scorers[fast]
    out = ts.score_full(users)
    assert out.shape == (70, N_ITEMS)
    np.testing.assert_allclose(out, js.score_full(users), atol=1e-5)


@pytest.mark.parametrize('fast', [True, False], ids=['fast', 'generic'])
def test_score_candidates_matches_jax(scorers, users, fast):
    js, ts = scorers[fast]
    rng = np.random.default_rng(7)
    cands = rng.integers(0, N_ITEMS, (70, 20)).astype(np.int32)
    valid = rng.random((70, 20)) < 0.8
    out = ts.score_candidates(users, cands, valid)
    np.testing.assert_allclose(out, js.score_candidates(users, cands, valid),
                               atol=1e-5)
    assert (out[~valid] == -1e30).all()


def test_feature_store_reads_jax_cache(tmp_path):
    """The port's store loads the .npz the JAX store writes, and the two
    name the cache directory alike."""
    tables = item_tables(12)
    ids = np.arange(12).astype(str)
    jstore = JaxStore(12, ids, vision_model='resnet',
                      language_model='sentence-bert')
    jstore.tables.update(tables)
    jstore.save(str(tmp_path))
    store = ItemFeatureStore(12, ids, 'resnet', 'sentence-bert')
    assert (tmp_path / cache_subdir_name('resnet', 'sentence-bert')).is_dir()
    assert store.load_tables(str(tmp_path))
    for name, table in tables.items():
        assert store.has(name)
        np.testing.assert_array_equal(store.tables[name], table)
    assert not ItemFeatureStore(12, ids[::-1], 'resnet',
                                'sentence-bert').load_tables(str(tmp_path))
    with pytest.raises(ValueError):
        store.set_embedding_table('vision_emb', np.zeros((3, 2)))
    store.set_embedding_table('clip_text_emb', np.ones((12, 2), np.float32))
    store.save(str(tmp_path / 'again'))
    back = ItemFeatureStore(12, ids, 'resnet', 'sentence-bert')
    assert back.load_tables(str(tmp_path / 'again'))
    np.testing.assert_array_equal(back.tables['clip_text_emb'],
                                  np.ones((12, 2), np.float32))
