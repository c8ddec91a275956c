"""The port's catalog-sharded attention scorer and its cascade on four
gloo ranks, against the JAX package's meshed scorer on four forced CPU
devices and the port on one process (JAX ``inference/scorer.py:
1374-1399``, ``__graft_entry__.py:222-282``).

An attention model (2 heads, stream) over 300 items in 64-item chunks:
top-k at 1x4 and 2x2; at 1x4 the three cascades in stages (the sharded
screen scan merged at C over 'model', for the funnel the token-0 screen on
the additive scan's C1 survivors and a host top-C2, then the rescore on
the sharded tables: each candidate scored by its rank and merged by a max
all-reduce), and ``auto_cascade`` with both gates open: the plan every
rank installs (the ranks agree on the slowest rank's times) and ``top_k``
routed through it. Scores to 1e-5, ids as sets a row.
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

WORLD, N_ITEMS, K, TOL = 4, 300, 5, 1e-5
C, C1 = 32, 96
CHUNKS = dict(item_chunk=64, user_chunk=16)
HEADS = 2
USERS = np.random.default_rng(5).integers(0, N_USERS, 19).astype(np.int32)
SEEN = np.random.default_rng(6).random((len(USERS), N_ITEMS)) < 0.1
AUTO = dict(recall_target=0.0, min_speedup=0.0)
# id: (mesh, method, args, kwargs)
CALLS = {
    'top_k_1x4': ((1, 4), 'top_k', (USERS, K), {}),
    'top_k_2x2': ((2, 2), 'top_k', (USERS, K), {'seen_mask': SEEN}),
    'token0': ((1, 4), 'top_k_cascade', (USERS, K),
               {'n_candidates': C, 'screen': 'token0', 'seen_mask': SEEN}),
    'additive': ((1, 4), 'top_k_cascade', (USERS, K),
                 {'n_candidates': C, 'screen': 'additive',
                  '_calibrated': True}),
    'funnel': ((1, 4), 'top_k_cascade', (USERS, K),
               {'n_candidates': C, 'screen': 'funnel', 'funnel_c1': C1}),
}


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The ranks, started first; then both packages' model, the job."""
    ranks = Ranks(tmp_path_factory.mktemp('mesh_cascade'), WORLD)
    pair = make_pair(N_ITEMS, fusion_type='attention', heads=HEADS,
                     jit=True)
    tables = item_tables(N_ITEMS)
    base = {'kind': 'scorer', 'model': 'attention', 'store': 'items',
            'scorer': CHUNKS}
    calls = [dict(base, id=cid, mesh=shape, method=method, args=args,
                  kwargs=kwargs)
             for cid, (shape, method, args, kwargs) in CALLS.items()]
    calls.append(dict(base, id='auto', mesh=(1, 4),
                      method='auto_cascade_routed', args=(USERS, K),
                      kwargs=AUTO, routed_args=(USERS, K)))
    ranks.submit({
        'models': {'attention': {
            'kw': model_kwargs(N_ITEMS, fusion_type='attention',
                               heads=HEADS),
            'variables': pair[1]}},
        'stores': {'items': tables}, 'calls': calls})
    yield pair, tables, ranks
    ranks.kill()


_scorers = {}


def scorers(world, shape):
    """(JAX's meshed scorer, the port's single-process scorer)."""
    (jmodel, variables, tmodel), tables, _ = world
    if shape not in _scorers:
        ids = np.arange(N_ITEMS).astype(str)
        jstore, tstore = JaxStore(N_ITEMS, ids), ItemFeatureStore(N_ITEMS,
                                                                 ids)
        jstore.tables.update(tables)
        tstore.tables.update(tables)
        mesh = jax_make_mesh(jax.devices()[:WORLD], data_parallel=shape[0],
                             model_parallel=shape[1])
        _scorers[shape] = (
            JaxScorer(jmodel, variables, jstore, mesh=mesh, **CHUNKS),
            CatalogScorer(tmodel, tstore, device='cpu', **CHUNKS))
    return _scorers[shape]


def meshed(world, cid):
    outs = [out[cid] for out in world[2].results()]
    for other in outs[1:]:
        np.testing.assert_equal(other, outs[0])
    return outs[0]


def assert_same_topk(got, ref):
    (gv, gi), (rv, ri) = got, ref
    assert gv.shape == rv.shape == (len(USERS), K)
    np.testing.assert_allclose(gv, rv, atol=TOL)
    for a, b in zip(gi, ri):
        assert set(a.tolist()) == set(b.tolist())


@pytest.mark.parametrize('cid', list(CALLS))
def test_meshed_attention_and_cascades(world, cid):
    shape, method, args, kwargs = CALLS[cid]
    jax_scorer, port_scorer = scorers(world, shape)
    got = meshed(world, cid)
    assert (got[1] >= 0).all()
    if 'seen_mask' in kwargs:
        for r, row in enumerate(got[1]):
            assert not kwargs['seen_mask'][r][row].any()
    jkw = dict(kwargs)
    if jkw.get('screen') == 'additive':
        jkw.pop('_calibrated')  # JAX warns below its floor instead
    for scorer, kw in ((jax_scorer, jkw), (port_scorer, kwargs)):
        assert_same_topk(got, getattr(scorer, method)(*args, **kw))


def test_meshed_auto_cascade_installs_and_routes(world):
    """Every rank installs the same plan as JAX's meshed scorer and the
    port on one process (all but the measured speedup), and top_k routed
    through it gives theirs."""
    jax_scorer, port_scorer = scorers(world, (1, 4))
    plan, routed = meshed(world, 'auto')
    assert plan['screen'] == 'additive' and plan['k'] == K
    def fixed(p):
        return {k: v for k, v in p.items() if k != 'measured_speedup'}
    for scorer in (jax_scorer, port_scorer):
        assert fixed(scorer.auto_cascade(USERS, K, **AUTO)) == fixed(plan)
        assert_same_topk(routed, scorer.top_k(USERS, K))
        assert scorer._cascade_plan is not None
        scorer.disable_cascade()
