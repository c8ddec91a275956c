"""The port's catalog-sharded scorer's other paths on four gloo ranks,
against the JAX package's meshed scorer on four forced CPU devices and the
port's single-process scorer (JAX ``tests/unit/test_scorer_sharded.py:
78-91, 184-197, 224-288``), and the item tables sharded by
``ItemFeatureStore.device_tables``.

The generic path (``fast_path=False``) at 1x4; ``score_full`` at 1x4 and
2x2 (5 users: the 'data' axis pads); ``score_candidates`` at 1x4 and, with
a candidate mask, 2x2: each candidate is scored by the rank that holds it
and merged by one max all-reduce over 'model', so the bytes the
collectives take are 4 x users x candidates each, twice that for twice
the candidates, and the same for a catalog padded twice as far. Scores
agree to 1e-5, ids as sets a row.
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
USERS = np.random.default_rng(5).integers(0, N_USERS, 7).astype(np.int32)
B, C = 6, 9
CANDS = np.random.default_rng(2).integers(0, N_ITEMS, (B, 2 * C)).astype(
    np.int32)
VALID = np.random.default_rng(3).random((B, C)) < 0.8
# id: (model, mesh, scorer kw, method, args)
CALLS = {
    'generic_1x4': ('concat', (1, 4), {'fast_path': False}, 'top_k',
                    (USERS, K)),
    'full_1x4': ('concat', (1, 4), {}, 'score_full', (USERS[:5],)),
    'full_2x2': ('gated', (2, 2), {}, 'score_full', (USERS[:5],)),
    'cands_1x4': ('concat', (1, 4), {}, 'score_candidates',
                  (USERS[:B], CANDS[:, :C])),
    'cands2_1x4': ('concat', (1, 4), {}, 'score_candidates',
                   (USERS[:B], CANDS)),
    'cands_wide_1x4': ('concat', (1, 4), {'item_chunk': 128},
                       'score_candidates', (USERS[:B], CANDS[:, :C])),
    'cands_2x2': ('gated', (2, 2), {}, 'score_candidates',
                  (USERS[:B], CANDS[:, :C], VALID)),
}


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The ranks, started first; then both packages' models, the job."""
    ranks = Ranks(tmp_path_factory.mktemp('mesh_serving'), WORLD)
    pairs = {name: make_pair(N_ITEMS, fusion_type=f, jit=True)
             for name, f in FUSIONS.items()}
    tables = item_tables(N_ITEMS)
    calls = [{'id': cid, 'kind': 'scorer', 'model': m, 'store': 'items',
              'mesh': shape, 'scorer': dict(CHUNKS, **kw), 'method': method,
              'args': args, 'traffic': method == 'score_candidates'}
             for cid, (m, shape, kw, method, args) in CALLS.items()]
    calls += [{'id': f'tables_{shard}', 'kind': 'device_tables',
               'store': 'items', 'mesh': (2, 2), 'shard_items': shard}
              for shard in (True, False)]
    ranks.submit({
        'models': {name: {'kw': model_kwargs(N_ITEMS, fusion_type=f),
                          'variables': pairs[name][1]}
                   for name, f in FUSIONS.items()},
        'stores': {'items': tables}, 'calls': calls})
    yield pairs, tables, ranks
    ranks.kill()


_scorers = {}


def scorers(world, model, shape, kw):
    """(JAX's meshed scorer, the port's single-process scorer)."""
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
        chunks = dict(CHUNKS, **kw)
        _scorers[key] = (
            JaxScorer(jmodel, variables, jstore, mesh=mesh, **chunks),
            CatalogScorer(tmodel, tstore, device='cpu', **chunks))
    return _scorers[key]


def meshed(world, cid):
    """The call's result on rank 0, after checking every rank's equals
    it."""
    outs = [out[cid] for out in world[2].results()]
    for other in outs[1:]:
        np.testing.assert_equal(other, outs[0])
    return outs[0]


def test_meshed_generic_top_k(world):
    model, shape, kw, _, args = CALLS['generic_1x4']
    jax_scorer, port_scorer = scorers(world, model, shape, kw)
    assert port_scorer._head is None
    gv, gi = meshed(world, 'generic_1x4')
    for rv, ri in (jax_scorer.top_k(*args), port_scorer.top_k(*args)):
        np.testing.assert_allclose(gv, rv, atol=TOL)
        for a, b in zip(gi, ri):
            assert set(a.tolist()) == set(b.tolist())


@pytest.mark.parametrize('cid', ['full_1x4', 'full_2x2'])
def test_meshed_score_full(world, cid):
    model, shape, kw, _, args = CALLS[cid]
    jax_scorer, port_scorer = scorers(world, model, shape, kw)
    got = meshed(world, cid)
    assert got.shape == (len(args[0]), N_ITEMS)
    np.testing.assert_allclose(got, jax_scorer.score_full(*args), atol=TOL)
    np.testing.assert_allclose(got, port_scorer.score_full(*args), atol=TOL)


@pytest.mark.parametrize('cid', ['cands_1x4', 'cands2_1x4', 'cands_2x2'])
def test_meshed_score_candidates(world, cid):
    model, shape, kw, _, args = CALLS[cid]
    jax_scorer, port_scorer = scorers(world, model, shape, kw)
    got, _ = meshed(world, cid)
    assert got.shape == args[1].shape
    for ref in (jax_scorer.score_candidates(*args),
                port_scorer.score_candidates(*args)):
        np.testing.assert_allclose(got, ref, atol=TOL)
    if len(args) > 2:
        assert (got[~args[2]] == -1e30).all()


def test_candidate_traffic_scales_with_candidates_not_catalog(world):
    """One max all-reduce over 'model' of the [users, candidates] scores
    and one all-gather over 'data' of the same: 4 x B x C bytes each,
    twice that at 2C, the same over a catalog padded to 512 (128-item
    chunks) as to 256; no collective takes a catalog-sized tensor."""
    per = 4 * B * C
    assert meshed(world, 'cands_1x4')[1] == {'all_reduce_max': per,
                                             'all_gather': per}
    assert meshed(world, 'cands2_1x4')[1] == {'all_reduce_max': 2 * per,
                                              'all_gather': 2 * per}
    assert meshed(world, 'cands_wide_1x4')[1] == {'all_reduce_max': per,
                                                  'all_gather': per}
    # 2x2: each data coordinate reduces its 3 users' rows over 'model'
    # and the rows are gathered over 'data'
    got = meshed(world, 'cands_2x2')[1]
    assert got == {'all_reduce_max': per // 2, 'all_gather': per // 2}


def test_device_tables_shard_items(world):
    """With shard_items each rank holds its rows of the item axis (75 of
    150 over a model axis of 2), rank r at model coordinate r % 2; without
    it, the whole tables."""
    _, tables, ranks = world
    outs = ranks.results()
    for rank, out in enumerate(outs):
        rows = slice((rank % 2) * 75, (rank % 2 + 1) * 75)
        assert set(out['tables_True']) == set(tables)
        for k, v in tables.items():
            np.testing.assert_array_equal(out['tables_True'][k], v[rows])
            np.testing.assert_array_equal(out['tables_False'][k], v)
