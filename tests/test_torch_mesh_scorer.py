"""The port's catalog-sharded CatalogScorer on four gloo ranks against the
JAX package's meshed scorer on four forced CPU devices (the same
``make_mesh`` shapes) and against the port's single-process scorer, on
the same converted weights and item tables (JAX
``tests/unit/test_scorer_sharded.py:62-148, 224-245``).

Concat and gated fusion, top-k at 1x4 and 2x2 (150 items in 64-item
chunks: at 1x4 the last shard holds only padding), 37 users in 16-user
blocks (the last block pads the 'data' axis), a seen mask and k equal to
the catalog (the generic path, ``score_full`` and the candidate paths
are ``tests/test_torch_mesh_serving.py``). Every rank returns the whole
result, the same on all four. Scores agree to
1e-5 (float32; sigmoid scores, so 1e-5 of their scale), ids as sets a
row.
"""
import jax
import numpy as np
import pytest

from pixelrec_multimodal_tpu.data.feature_store import (
    ItemFeatureStore as JaxStore,
)
from pixelrec_multimodal_tpu.inference.scorer import (
    CatalogScorer as JaxScorer,
)
from pixelrec_multimodal_tpu.parallel import make_mesh as jax_make_mesh
from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
from tests._torch_mesh import Ranks
from tests._torch_port import N_USERS, item_tables, make_pair, model_kwargs

WORLD, N_ITEMS, K, TOL = 4, 150, 10, 1e-5
CHUNKS = dict(item_chunk=64, user_chunk=16)
FUSIONS = {'concat': 'concatenate', 'gated': 'gated'}
USERS = np.random.default_rng(5).integers(0, N_USERS, 37).astype(np.int32)
SEEN = np.random.default_rng(6).random((len(USERS), N_ITEMS)) < 0.3
# id: (model, mesh, scorer kw, method, args, kwargs)
CALLS = {
    'concat_1x4': ('concat', (1, 4), {}, 'top_k', (USERS, K), {}),
    'concat_2x2': ('concat', (2, 2), {}, 'top_k', (USERS, K), {}),
    'gated_1x4': ('gated', (1, 4), {}, 'top_k', (USERS, K), {}),
    'gated_2x2': ('gated', (2, 2), {}, 'top_k', (USERS, K), {}),
    'seen_2x2': ('concat', (2, 2), {}, 'top_k', (USERS, 8),
                 {'seen_mask': SEEN}),
    'catalog_1x4': ('concat', (1, 4), {}, 'top_k',
                    (USERS[:2], N_ITEMS), {}),
}


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The ranks, started first; then both packages' models, the job."""
    ranks = Ranks(tmp_path_factory.mktemp('mesh_scorer'), WORLD)
    pairs = {name: make_pair(N_ITEMS, fusion_type=f, jit=True)
             for name, f in FUSIONS.items()}
    tables = item_tables(N_ITEMS)
    ranks.submit({
        'models': {name: {'kw': model_kwargs(N_ITEMS, fusion_type=f),
                          'variables': pairs[name][1]}
                   for name, f in FUSIONS.items()},
        'stores': {'items': tables},
        'calls': [{'id': cid, 'kind': 'scorer', 'model': m, 'store': 'items',
                   'mesh': shape, 'scorer': dict(CHUNKS, **kw),
                   'method': method, 'args': args, 'kwargs': kwargs}
                  for cid, (m, shape, kw, method, args, kwargs)
                  in CALLS.items()]})
    yield pairs, tables, ranks
    ranks.kill()


_scorers = {}


def scorers(world, model, shape, kw):
    """(JAX's meshed scorer, the port's single-process scorer), built once
    each."""
    pairs, tables, _ = world
    key = (model, shape, tuple(sorted(kw.items())))
    if key not in _scorers:
        jmodel, variables, tmodel = pairs[model]
        ids = np.arange(N_ITEMS).astype(str)
        jstore, tstore = JaxStore(N_ITEMS, ids), ItemFeatureStore(N_ITEMS,
                                                                 ids)
        jstore.tables.update(tables)
        tstore.tables.update(tables)
        mesh = jax_make_mesh(jax.devices()[:WORLD], data_parallel=shape[0],
                             model_parallel=shape[1])
        _scorers[key] = (
            JaxScorer(jmodel, variables, jstore, mesh=mesh, **CHUNKS, **kw),
            CatalogScorer(tmodel, tstore, device='cpu', **CHUNKS, **kw))
    return _scorers[key]


def meshed(world, cid):
    """The call's result on every rank, which must all be equal."""
    outs = [out[cid] for out in world[2].results()]
    for other in outs[1:]:
        for a, b in zip(other, outs[0]):
            np.testing.assert_array_equal(a, b)
    return outs[0]


def assert_same_topk(got, ref):
    (gv, gi), (rv, ri) = got, ref
    assert gv.shape == rv.shape and gi.dtype == np.int32
    np.testing.assert_allclose(gv, rv, atol=TOL)
    for a, b in zip(gi, ri):
        assert set(a.tolist()) == set(b.tolist())


@pytest.mark.parametrize('cid', list(CALLS))
def test_meshed_top_k_matches_jax_and_one_process(world, cid):
    model, shape, kw, method, args, kwargs = CALLS[cid]
    jax_scorer, port_scorer = scorers(world, model, shape, kw)
    got = meshed(world, cid)
    assert_same_topk(got, jax_scorer.top_k(*args, **kwargs))
    assert_same_topk(got, port_scorer.top_k(*args, **kwargs))
    v, i = got
    assert (i >= 0).all() and (i < N_ITEMS).all()
    if 'seen_mask' in kwargs:
        for r, row in enumerate(i):
            assert not kwargs['seen_mask'][r][row].any()
    if args[1] == N_ITEMS:
        for row in i:
            assert sorted(row.tolist()) == list(range(N_ITEMS))


def test_meshed_scorer_layout(world):
    """n_pad is a multiple of item_chunk x the model axis; each rank holds
    n_pad / model_size rows; factored gated tables are refused under a
    mesh (the meshed gated path is exact, as JAX's)."""
    from pixelrec_multimodal_tpu_torch.parallel import make_mesh
    pairs, tables, _ = world
    tmodel = pairs['gated'][2]
    store = ItemFeatureStore(N_ITEMS, np.arange(N_ITEMS).astype(str))
    store.tables.update(tables)
    one = make_mesh()
    s = CatalogScorer(tmodel, store, device='cpu', mesh=one, **CHUNKS)
    assert (s.n_pad, s.n_local, s._base) == (192, 192, 0)
    assert s.gated_variant == 'exact'
    assert s._item_fast[0].shape[0] == s.n_local
    with pytest.raises(ValueError, match='factored'):
        CatalogScorer(tmodel, store, device='cpu', mesh=one,
                      gated_variant='factored', **CHUNKS)
    jax_scorer, _ = scorers(world, 'gated', (1, 4), {})
    assert jax_scorer.n_pad == 256
