"""The port's catalog-sharded scorer in int8 and the Recommender over a
mesh, on four gloo ranks, against the JAX package's meshed scorer and
Recommender on four forced CPU devices and against the port on one
process (JAX ``tests/unit/test_scorer_sharded.py:199-222, 291-339``).

int8 (``precision='int8!'``) at 1x4, concat and gated: the calibration
sample's rows are gathered from the ranks that hold them, so the meshed
scorer quantizes as one process does and matches it to 1e-5; against
JAX's meshed int8 the scores hold ``tests/test_torch_int8.py``'s int8
tolerance (at most 1% of the pairs past 1e-5, none past 1e-2) and every
id clear of the k-th score by 1e-2 is found. The Recommender at 2x2:
top-K lists with the seen filter and an unknown user, MMR lists (the
pooled items' tower rows gathered from their ranks) and one pair's score:
the same item sets, scores to 1e-5.
"""
import jax
import numpy as np
import pytest

from pixelrec_multimodal_tpu.data.feature_store import (
    ItemFeatureStore as JaxStore,
)
from pixelrec_multimodal_tpu.inference.recommender import (
    Recommender as JaxRecommender,
)
from pixelrec_multimodal_tpu.inference.scorer import (
    CatalogScorer as JaxScorer,
)
from pixelrec_multimodal_tpu.parallel import make_mesh as jax_make_mesh
from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.inference import Recommender
from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
from tests._torch_mesh import Ranks, StubDataset
from tests._torch_port import N_USERS, item_tables, make_pair, model_kwargs

WORLD, N_ITEMS, K, TOL = 4, 150, 10, 1e-5
AGREE, MAX_FLIPPED, FLIP_TOL = 1e-5, 0.01, 1e-2
CHUNKS = dict(item_chunk=64, user_chunk=16)
FUSIONS = {'concat': 'concatenate', 'gated': 'gated'}
USERS = np.random.default_rng(5).integers(0, N_USERS, 21).astype(np.int32)
CANDS = np.random.default_rng(3).integers(0, N_ITEMS, (6, 9)).astype(
    np.int32)
USER_IDS = [f'u{u:02d}' for u in range(N_USERS)]
ITEM_IDS = [f'i{j:03d}' for j in range(N_ITEMS)]
REC_USERS = USER_IDS[::4] + ['nobody']
INT8 = {'precision': 'int8!'}


def history(seed=4, seen=10):
    rng = np.random.default_rng(seed)
    items = np.concatenate([rng.choice(N_ITEMS, seen, replace=False)
                            for _ in range(N_USERS)])
    return np.arange(0, seen * (N_USERS + 1), seen), items


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The ranks, started first; then both packages' models, the job."""
    ranks = Ranks(tmp_path_factory.mktemp('mesh_int8'), WORLD)
    pairs = {name: make_pair(N_ITEMS, fusion_type=f, jit=True)
             for name, f in FUSIONS.items()}
    tables = item_tables(N_ITEMS)
    calls = []
    for name in FUSIONS:
        for method, args in (('top_k', (USERS, K)),
                             ('score_candidates', (USERS[:6], CANDS))):
            calls.append({'id': f'{name}_{method}', 'kind': 'scorer',
                          'model': name, 'store': 'items', 'mesh': (1, 4),
                          'scorer': dict(CHUNKS, **INT8), 'method': method,
                          'args': args})
    rec = {'kind': 'recommender', 'model': 'concat', 'store': 'items',
           'dataset': 'stub', 'mesh': (2, 2), 'scorer': CHUNKS}
    calls += [
        dict(rec, id='batch', method='get_recommendations_batch',
             args=(REC_USERS, 5)),
        dict(rec, id='diverse', method='get_diverse_recommendations_batch',
             args=(REC_USERS[:-1], 5, 0.5)),
        dict(rec, id='pair', method='get_item_score',
             args=(USER_IDS[3], ITEM_IDS[17]))]
    ranks.submit({
        'models': {name: {'kw': model_kwargs(N_ITEMS, fusion_type=f),
                          'variables': pairs[name][1]}
                   for name, f in FUSIONS.items()},
        'stores': {'items': tables}, 'item_ids': {'items': ITEM_IDS},
        'datasets': {'stub': {'user_ids': USER_IDS, 'item_ids': ITEM_IDS,
                              'history': history()}},
        'calls': calls})
    yield pairs, tables, ranks
    ranks.kill()


def stores(tables):
    ids = np.asarray(ITEM_IDS)
    jstore, tstore = JaxStore(N_ITEMS, ids), ItemFeatureStore(N_ITEMS, ids)
    jstore.tables.update(tables)
    tstore.tables.update(tables)
    return jstore, tstore


def jax_mesh(shape):
    return jax_make_mesh(jax.devices()[:WORLD], data_parallel=shape[0],
                         model_parallel=shape[1])


def meshed(world, cid):
    outs = [out[cid] for out in world[2].results()]
    for other in outs[1:]:
        np.testing.assert_equal(other, outs[0])
    return outs[0]


def assert_int8_close(got, ref):
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert (diff > AGREE).sum() <= MAX_FLIPPED * diff.size
    assert diff.max(initial=0.0) <= FLIP_TOL


@pytest.mark.parametrize('name', list(FUSIONS))
def test_meshed_int8(world, name):
    pairs, tables, _ = world
    jmodel, variables, tmodel = pairs[name]
    jstore, tstore = stores(tables)
    js = JaxScorer(jmodel, variables, jstore, mesh=jax_mesh((1, 4)),
                   **CHUNKS, **INT8)
    ts = CatalogScorer(tmodel, tstore, device='cpu', **CHUNKS, **INT8)
    assert js.precision == ts.precision == 'int8'
    gv, gi = meshed(world, f'{name}_top_k')
    # one process: the same quantization, the same scores
    tv, ti = ts.top_k(USERS, K)
    np.testing.assert_allclose(gv, tv, atol=TOL)
    for a, b in zip(gi, ti):
        assert set(a.tolist()) == set(b.tolist())
    np.testing.assert_allclose(meshed(world, f'{name}_score_candidates'),
                               ts.score_candidates(USERS[:6], CANDS),
                               atol=TOL)
    # JAX's meshed int8: the int8 tolerance
    jv, ji = js.top_k(USERS, K)
    assert_int8_close(gv, jv)
    for a, b, vals in zip(gi, ji, jv):
        clear = vals > vals[-1] + FLIP_TOL
        assert set(b[clear].tolist()) <= set(a.tolist())
    assert_int8_close(meshed(world, f'{name}_score_candidates'),
                      js.score_candidates(USERS[:6], CANDS))


def assert_same_lists(got, ref):
    assert list(got) == list(ref)
    for u in ref:
        assert {i for i, _ in got[u]} == {i for i, _ in ref[u]}, u
        np.testing.assert_allclose([s for _, s in got[u]],
                                   [s for _, s in ref[u]], atol=TOL)


def test_meshed_recommender(world):
    pairs, tables, _ = world
    jmodel, variables, tmodel = pairs['concat']
    jstore, tstore = stores(tables)
    jdata = StubDataset(jstore, USER_IDS, ITEM_IDS, history())
    tdata = StubDataset(tstore, USER_IDS, ITEM_IDS, history())
    jrec = JaxRecommender(jmodel, variables, jdata, mesh=jax_mesh((2, 2)),
                          **CHUNKS)
    trec = Recommender(tmodel, tdata, device='cpu', **CHUNKS)
    got = meshed(world, 'batch')
    assert got['nobody'] == [] and all(len(got[u]) == 5
                                       for u in REC_USERS[:-1])
    for rec in (jrec, trec):
        assert_same_lists(got, rec.get_recommendations_batch(REC_USERS, 5))
        assert_same_lists(meshed(world, 'diverse'),
                          rec.get_diverse_recommendations_batch(
                              REC_USERS[:-1], 5, 0.5))
        assert abs(meshed(world, 'pair') - rec.get_item_score(
            USER_IDS[3], ITEM_IDS[17])) <= TOL
    for u in REC_USERS[:-1]:
        assert not {i for i, _ in got[u]} & tdata.get_user_history(u)
