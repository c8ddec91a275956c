"""The port's ``Recommender`` against the JAX package's, on the CPU.

Both wrap a scorer of the same model (weights converted from Flax by
``tests/_torch_port.make_pair``, concatenate and gated fusion) over the
same item tables, and a small stand-in dataset: the encoders, the feature
store and a seeded history of 10 seen items a user. Top-K lists are held
as value sets with scores to atol 1e-5 (float32 sums in another order),
not in tie order.

MMR is held bit for bit: both packages' ``get_diverse_recommendations_
batch`` are given the same pools and item representations (including
tied items) and must return the same lists. End to end, where the pools
come from each package's own scorer, every step whose JAX MMR margin (the
best score less the runner-up's) exceeds 1e-5 must pick the same item,
up to the first step whose margin does not.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pixelrec_multimodal_tpu.data.feature_store import (
    ItemFeatureStore as JaxStore,
)
from pixelrec_multimodal_tpu.inference.recommender import (
    Recommender as JaxRecommender,
)
from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.data.label_encoder import LabelEncoder
from pixelrec_multimodal_tpu_torch.inference import Recommender
from pixelrec_multimodal_tpu_torch.inference.recommender import mmr_select
from tests._torch_port import N_USERS, item_tables, make_pair

N_ITEMS, ITEM_CHUNK, USER_CHUNK, K, SEEN = 300, 128, 32, 10, 10
TOL, MARGIN = 1e-5, 1e-5
USER_IDS = [f'u{u:02d}' for u in range(N_USERS)]
ITEM_IDS = [f'i{j:03d}' for j in range(N_ITEMS)]


class StubDataset:
    """What the Recommender reads of a dataset: encoders, the feature
    store, the catalog size and the users' histories."""

    def __init__(self, store, history):
        self.feature_store = store
        self.user_encoder = LabelEncoder().fit(USER_IDS)
        self.item_encoder = LabelEncoder().fit(ITEM_IDS)
        self.n_items = N_ITEMS
        self._history = history

    def user_history_matrix(self):
        return self._history

    def get_user_history(self, user_id):
        uidx = int(self.user_encoder.transform([user_id])[0])
        indptr, items = self._history
        return set(self.item_encoder.inverse_transform(
            items[indptr[uidx]:indptr[uidx + 1]]))


def history(seed=4):
    rng = np.random.default_rng(seed)
    items = np.concatenate([rng.choice(N_ITEMS, SEEN, replace=False)
                            for _ in range(N_USERS)])
    return np.arange(0, SEEN * (N_USERS + 1), SEEN), items


@functools.lru_cache(maxsize=None)
def models(fusion, n_items):
    """(JAX model, its variables, port model, JAX dataset, port dataset):
    one converted model over seeded item tables."""
    heads = {'heads': 2} if fusion == 'attention' else {}
    jmodel, variables, tmodel = make_pair(n_items, fusion_type=fusion,
                                          **heads)
    tables = item_tables(n_items)
    ids = np.asarray(ITEM_IDS[:n_items])
    jstore, tstore = JaxStore(n_items, ids), ItemFeatureStore(n_items, ids)
    jstore.tables.update(tables)
    tstore.tables.update(tables)
    hist = history()
    return (jmodel, variables, tmodel, StubDataset(jstore, hist),
            StubDataset(tstore, hist))


@functools.lru_cache(maxsize=None)
def recommenders(fusion='concatenate', n_items=N_ITEMS, **kw):
    """(JAX Recommender, port Recommender) over one converted model."""
    jmodel, variables, tmodel, jdata, tdata = models(fusion, n_items)
    chunks = dict(item_chunk=ITEM_CHUNK, user_chunk=USER_CHUNK)
    return (JaxRecommender(jmodel, variables, jdata, **chunks, **kw),
            Recommender(tmodel, tdata, **chunks, device='cpu', **kw))


def assert_same_lists(got, ref):
    """Lists of (item_id, score): equal item sets, scores in order within
    TOL."""
    assert len(got) == len(ref)
    assert {i for i, _ in got} == {i for i, _ in ref}
    np.testing.assert_allclose([s for _, s in got], [s for _, s in ref],
                               atol=TOL)


def seen_ids(rec, user):
    return rec._get_user_interactions(user)


# ------------------------------------------------------------------ top-K
@pytest.mark.parametrize('filter_seen', [True, False])
@pytest.mark.parametrize('fusion', ['concatenate', 'gated'])
def test_batch_top_k_matches_jax(fusion, filter_seen):
    jrec, trec = recommenders(fusion)
    users = USER_IDS[::3] + ['nobody', 7]
    got = trec.get_recommendations_batch(users, K, filter_seen)
    ref = jrec.get_recommendations_batch(users, K, filter_seen)
    assert list(got) == list(ref)
    assert got['nobody'] == got['7'] == []
    for u in USER_IDS[::3]:
        assert len(got[u]) == K
        assert_same_lists(got[u], ref[u])
        if filter_seen:
            assert not {i for i, _ in got[u]} & seen_ids(trec, u)


@pytest.mark.parametrize('filter_seen', [True, False])
@pytest.mark.parametrize('fusion', ['concatenate', 'gated'])
def test_single_user_top_k_matches_jax(fusion, filter_seen, capsys):
    jrec, trec = recommenders(fusion)
    for u in USER_IDS[:4]:
        got = trec.get_recommendations(u, K, filter_seen)
        assert_same_lists(got, jrec.get_recommendations(u, K, filter_seen))
        assert got == trec.get_recommendations_batch([u], K,
                                                     filter_seen)[u]
    assert trec.get_recommendations('nobody', K) == []
    assert 'not found' in capsys.readouterr().out


@pytest.mark.parametrize('fusion', ['concatenate', 'gated'])
def test_candidates_match_jax(fusion):
    """Candidate lists: unknown ids dropped, seen ones filtered, the rest
    scored and sorted; all-seen and all-unknown lists give []."""
    jrec, trec = recommenders(fusion)
    user = USER_IDS[5]
    seen = sorted(seen_ids(trec, user))
    cands = ITEM_IDS[:40:3] + seen[:3] + ['zzz', 'i999']
    for filter_seen in (True, False):
        got = trec.get_recommendations(user, 6, filter_seen, cands)
        ref = jrec.get_recommendations(user, 6, filter_seen, cands)
        assert_same_lists(got, ref)
        if filter_seen:
            assert not {i for i, _ in got} & set(seen)
    for cands in (seen, ['zzz', 'nope']):
        assert trec.get_recommendations(user, 5, True, cands) == [] == \
            jrec.get_recommendations(user, 5, True, cands)


@pytest.mark.parametrize('fusion', ['concatenate', 'gated'])
def test_item_score_matches_jax(fusion):
    jrec, trec = recommenders(fusion)
    for u, i in [(USER_IDS[0], ITEM_IDS[0]), (USER_IDS[9], ITEM_IDS[77]),
                 (USER_IDS[-1], ITEM_IDS[-1])]:
        got = trec.get_item_score(u, i)
        assert isinstance(got, float)
        assert got == pytest.approx(jrec.get_item_score(u, i), abs=TOL)
        # the pair score is the score the top-K reports for the same pair
        ranked = dict(trec.get_recommendations(u, N_ITEMS, False))
        assert got == pytest.approx(ranked[i], abs=TOL)
    assert trec.get_item_score('nobody', ITEM_IDS[0]) == 0.0
    assert trec.get_item_score(USER_IDS[0], 'zzz') == 0.0


def test_score_candidates_batch_matches_jax():
    jrec, trec = recommenders('concatenate')
    rng = np.random.default_rng(8)
    users = rng.integers(0, N_USERS, 5).astype(np.int32)
    cands = rng.integers(0, N_ITEMS, (5, 7)).astype(np.int32)
    mask = rng.random((5, 7)) < 0.8
    got = trec.score_candidates_batch(users, cands, mask)
    ref = np.asarray(jrec.score_candidates_batch(users, cands, mask))
    assert (got[~mask] == ref[~mask]).all()
    np.testing.assert_allclose(got[mask], ref[mask], atol=TOL)


def test_seen_mask_matches_jax():
    jrec, trec = recommenders('concatenate')
    users = np.asarray([3, 0, 49, 3], np.int32)
    mask = trec._seen_mask(users)
    assert (mask == jrec._seen_mask(users)).all()
    assert mask.sum(1).tolist() == [SEEN] * 4
    assert trec._seen_set(3) == jrec._seen_set(3)


# -------------------------------------------------------------------- MMR
def pools_and_feats(seed=11, n_pool=40, M=3, D=8):
    """Pools for four users (one tied pair, one single item, one empty)
    and the representations of every item, [N_ITEMS, M, D] float32."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((N_ITEMS, M, D)).astype(np.float32)
    # items 5 and 9 share a representation; in u00's pool they also share
    # a relevance, so they tie at every step
    feats[9] = feats[5]
    pools = {}
    others = np.setdiff1d(np.arange(N_ITEMS), [5, 9])
    for u in ('u00', 'u01'):
        idx = rng.choice(others, n_pool, replace=False)
        rel = np.sort(rng.random(n_pool).astype(np.float32))[::-1]
        pools[u] = [(ITEM_IDS[i], float(r)) for i, r in zip(idx, rel)]
    pools['u00'][3] = (ITEM_IDS[5], pools['u00'][3][1])
    pools['u00'][4] = (ITEM_IDS[9], pools['u00'][3][1])
    pools['u02'] = [(ITEM_IDS[1], 0.5)]
    pools['u03'] = []
    return pools, feats


def stub_recommender(cls, pools, feats):
    """A Recommender of ``cls`` whose pools are ``pools`` and whose item
    representations are ``feats``, without a scorer."""
    rec = cls.__new__(cls)
    rec.dataset = SimpleNamespace(item_encoder=LabelEncoder().fit(ITEM_IDS),
                                  n_items=N_ITEMS)
    rec.scorer = SimpleNamespace(
        _item_feats=feats,
        item_rows=lambda idx: torch.from_numpy(np.asarray(feats)[idx]))
    rec._user_classes = set(pools)
    rec.get_recommendations_batch = \
        lambda user_ids, top_k, filter_seen: {u: pools[u] for u in user_ids}
    return rec


@pytest.mark.parametrize('weight', [0.3, 0.5, 0.7, 1.0])
@pytest.mark.parametrize('top_k', [1, 10, 40, 60])
def test_mmr_bit_for_bit_on_the_same_pools(weight, top_k):
    """Given the same pools and representations, the vectorized MMR
    returns exactly JAX's loop's lists, ties included."""
    pools, feats = pools_and_feats()
    users = list(pools)
    ref = stub_recommender(JaxRecommender, pools, feats)\
        .get_diverse_recommendations_batch(users, top_k, weight)
    got = stub_recommender(Recommender, pools, torch.from_numpy(feats))\
        .get_diverse_recommendations_batch(users, top_k, weight)
    assert got == ref
    assert len(got['u00']) == min(top_k, 40) and got['u03'] == []
    assert got['u00'][0] == pools['u00'][0]  # the most relevant leads
    # the tied pair: the lower pool position is taken first
    ids = [i for i, _ in got['u00']]
    if ITEM_IDS[9] in ids:
        assert ids.index(ITEM_IDS[5]) < ids.index(ITEM_IDS[9])


def jax_mmr_with_margins(rel, sim, top_k, w):
    """JAX's greedy loop (inference/recommender.py), also returning each
    step's margin: the best score less the runner-up's."""
    span = float(rel.max() - rel.min()) or 1.0
    rel_norm = (rel - rel.min()) / span
    selected, margins = [0], [float(rel[0] - rel[1])]
    remaining = set(range(1, len(rel)))
    while remaining and len(selected) < top_k:
        scores = []
        for j in remaining:
            penalty = max(sim[j, s] for s in selected)
            scores.append(((1.0 - w) * rel_norm[j] - w * penalty, j))
        best = max(scores, key=lambda t: t[0])
        ranked = sorted(s for s, _ in scores)
        margins.append(float(ranked[-1] - ranked[-2]) if len(ranked) > 1
                       else np.inf)
        selected.append(min(j for s, j in scores if s == best[0]))
        remaining.discard(selected[-1])
    return selected, margins


def test_mmr_select_is_jax_loop():
    """mmr_select against the loop on random pools, exactly."""
    rng = np.random.default_rng(12)
    for n, top_k, w in [(2, 2, 0.3), (50, 10, 0.3), (80, 80, 0.9),
                        (30, 5, 1.0), (25, 25, 0.0001)]:
        rel = np.sort(rng.random(n).astype(np.float32))[::-1]
        rows = rng.standard_normal((n, 6)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True) + 1e-12
        sim = rows @ rows.T
        assert mmr_select(rel, sim, top_k, w) == \
            jax_mmr_with_margins(rel, sim, top_k, w)[0]


@pytest.mark.parametrize('fusion', ['concatenate', 'gated'])
def test_mmr_end_to_end_matches_jax(fusion):
    """Each package's scorer gives its own pools: every step whose JAX
    margin exceeds MARGIN picks the same item, up to the first step whose
    margin does not; the lists lead with the top-relevance item, hold no
    seen item and no duplicate."""
    jrec, trec = recommenders(fusion)
    users = USER_IDS[::4]
    got = trec.get_diverse_recommendations_batch(users, K, 0.3)
    ref = jrec.get_diverse_recommendations_batch(users, K, 0.3)
    pools = jrec.get_recommendations_batch(users, 100)
    feats = np.asarray(jrec.scorer._item_feats).reshape(
        jrec.scorer._item_feats.shape[0], -1)
    compared = 0
    for u in users:
        assert [i for i, _ in ref[u]] and len(got[u]) == K
        ids = [i for i, _ in got[u]]
        assert len(set(ids)) == K and not set(ids) & seen_ids(trec, u)
        assert ids[0] == trec.get_recommendations(u, 1)[0][0]
        pool_ids = [i for i, _ in pools[u]]
        rel = np.asarray([s for _, s in pools[u]], np.float32)
        rows = feats[jrec.dataset.item_encoder.transform(pool_ids)]
        rows = rows / (np.linalg.norm(rows, axis=1, keepdims=True) + 1e-12)
        picks, margins = jax_mmr_with_margins(rel, rows @ rows.T, K, 0.3)
        assert [pool_ids[j] for j in picks] == [i for i, _ in ref[u]]
        for step, (j, margin) in enumerate(zip(picks, margins)):
            if margin <= MARGIN:
                break
            assert ids[step] == pool_ids[j], (u, step)
            compared += 1
    assert compared >= len(users) * K // 2


def test_mmr_single_user_weight_zero_and_range():
    jrec, trec = recommenders('concatenate')
    u = USER_IDS[2]
    assert trec.get_diverse_recommendations(u, K, 0.3) == \
        trec.get_diverse_recommendations_batch([u], K, 0.3)[u]
    assert trec.get_diverse_recommendations_batch([u], K, 0.0) == \
        trec.get_recommendations_batch([u], K)
    assert trec.get_diverse_recommendations('nobody', K) == []
    for w in (-0.1, 1.5):
        with pytest.raises(ValueError, match='diversity_weight'):
            trec.get_diverse_recommendations_batch([u], K, w)
        with pytest.raises(ValueError, match='diversity_weight'):
            jrec.get_diverse_recommendations_batch([u], K, w)


# ---------------------------------------------------------------- cascade
N_ATT = 200


def set_cascade(monkeypatch, recs, **attrs):
    """The cascade settings of both Recommenders of one attention model,
    as their constructors set them from ``cascade_candidates`` & co.;
    restored after the test."""
    for rec in recs:
        for name, value in attrs.items():
            monkeypatch.setattr(rec, name, value)


@pytest.mark.parametrize('screen, n_cand', [('additive', 60),
                                            ('token0', 40),
                                            ('funnel', 30)])
def test_explicit_cascade_matches_jax(screen, n_cand, monkeypatch):
    """An explicit C goes to top_k_cascade with the screen (the funnel with
    its C1) in both packages: the same lists, seen items filtered."""
    recs = jrec, trec = recommenders('attention', N_ATT)
    set_cascade(monkeypatch, recs, cascade_candidates=n_cand,
                cascade_screen=screen,
                cascade_c1=120 if screen == 'funnel' else None)
    users = USER_IDS[::5]
    got = trec.get_recommendations_batch(users, K)
    ref = jrec.get_recommendations_batch(users, K)
    for u in users:
        assert_same_lists(got[u], ref[u])
        assert not {i for i, _ in got[u]} & seen_ids(trec, u)


def auto_recorder(rec, monkeypatch, install):
    """Record the k of each auto_cascade call of ``rec``'s scorer; with
    ``install`` the calibration runs with the speed gate open (so a plan
    is installed), else it fails (returns None, installs nothing)."""
    calls = []
    real = rec.scorer.auto_cascade

    def auto(users, k, recall_target):
        calls.append((len(users), k, recall_target))
        if not install:
            return None
        return real(users, k, recall_target=recall_target, min_speedup=0.0,
                    max_candidate_frac=1.0)
    monkeypatch.setattr(rec.scorer, 'auto_cascade', auto)
    return calls


def test_auto_cascade_remembers_a_failed_k(monkeypatch):
    """'auto' calibrates on the whole user range once per k; a failed k
    is remembered, so no later call with k no larger calibrates again:
    the same calls in both packages."""
    recs = recommenders('attention', N_ATT)
    set_cascade(monkeypatch, recs, cascade_auto=True, cascade_recall=0.9,
                _auto_failed_k=None)
    seqs = []
    for rec in recs:
        calls = auto_recorder(rec, monkeypatch, install=False)
        for k in (10, 10, 4, 12, 11):
            rec.get_recommendations_batch(USER_IDS[:3], k)
        seqs.append(calls)
        assert rec._auto_failed_k == 12 and rec.scorer._cascade_plan is None
    assert seqs[0] == seqs[1] == [(N_USERS, 10, 0.9), (N_USERS, 12, 0.9)]


def test_auto_cascade_installs_a_plan_and_routes(monkeypatch):
    """'auto' installs a plan at recall 1.0, then top_k routes requests
    with k up to the plan's through it: the lists equal the exact scan's;
    a larger k calibrates again."""
    _, trec = recommenders('attention', N_ATT)
    users = USER_IDS[::6]
    ref = trec.get_recommendations_batch(users, K)
    set_cascade(monkeypatch, [trec], cascade_auto=True, _auto_failed_k=None)
    calls = auto_recorder(trec, monkeypatch, install=True)
    routed = []
    real = trec.scorer.top_k_cascade
    monkeypatch.setattr(trec.scorer, 'top_k_cascade',
                        lambda *a, **kw: routed.append(a[1]) or real(*a, **kw))
    try:
        got = trec.get_recommendations_batch(users, K)
        plan = trec.scorer._cascade_plan
        assert plan is not None and plan['k'] == K and routed[-1] == K
        for u in users:
            assert_same_lists(got[u], ref[u])
        routed.clear()
        trec.get_recommendations_batch(users, K - 3)
        assert len(calls) == 1 and routed == [K - 3]
        trec.get_recommendations_batch(users[:1], K + 2)
        assert [k for _, k, _ in calls] == [K, K + 2]
    finally:
        trec.scorer.disable_cascade()


def test_cascade_arguments_set_and_refused():
    """The constructor maps an int C and 'auto' to the settings the
    routing reads; a cascade on a non-attention model and a recall outside
    (0, 1] raise; a 1x1 mesh serves the lists of no mesh."""
    _, _, amodel, _, adata = models('attention', N_ATT)
    rec = Recommender(amodel, adata, cascade_candidates='auto',
                      cascade_recall=0.5, device='cpu')
    assert (rec.cascade_auto, rec.cascade_candidates, rec.cascade_recall,
            rec._auto_failed_k) == (True, None, 0.5, None)
    rec = Recommender(amodel, adata, cascade_candidates=64,
                      cascade_screen='funnel', cascade_c1=256, device='cpu')
    assert (rec.cascade_auto, rec.cascade_candidates, rec.cascade_screen,
            rec.cascade_c1) == (False, 64, 'funnel', 256)
    jmodel, variables, tmodel = make_pair(40)
    store = ItemFeatureStore(40, np.asarray(ITEM_IDS[:40]))
    store.tables.update(item_tables(40))
    data = StubDataset(store, history())
    with pytest.raises(ValueError, match='attention'):
        Recommender(tmodel, data, cascade_candidates=64, device='cpu')
    with pytest.raises(ValueError, match='attention'):
        Recommender(tmodel, data, cascade_candidates='auto', device='cpu')
    for recall in (0.0, 1.5):
        with pytest.raises(ValueError, match='cascade_recall'):
            Recommender(tmodel, data, cascade_recall=recall, device='cpu')
    # a mesh is ported: one process is a 1x1 mesh, served as without one
    from pixelrec_multimodal_tpu_torch.parallel import make_mesh
    users = USER_IDS[:5]
    meshed = Recommender(tmodel, data, mesh=make_mesh(), device='cpu')
    assert meshed.get_recommendations_batch(users, K) == Recommender(
        tmodel, data, device='cpu').get_recommendations_batch(users, K)


# ------------------------------------------------------------- cache API
def test_cache_api_raises_the_image_tier_error(tmp_path, capsys):
    """The cache API over the image tier, against JAX's: after the same
    decodes, the same statistics printed; after ``clear_cache``, the same
    output and an empty tier on both sides."""
    from PIL import Image
    jmodel, variables, tmodel, jdata, tdata = models('concatenate', N_ITEMS)
    rng = np.random.default_rng(6)
    for j in (0, 2, 4):
        Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
                        ).save(tmp_path / f'{ITEM_IDS[j]}.jpg')
    kw = dict(vision_model='clip', image_folder=str(tmp_path))
    jstore = JaxStore(N_ITEMS, np.asarray(ITEM_IDS), **kw)
    tstore = ItemFeatureStore(N_ITEMS, np.asarray(ITEM_IDS), **kw)
    jstore.tables.update(jdata.feature_store.tables)
    tstore.tables.update(tdata.feature_store.tables)
    chunks = dict(item_chunk=ITEM_CHUNK, user_chunk=USER_CHUNK)
    jrec = JaxRecommender(jmodel, variables,
                          StubDataset(jstore, jdata._history), **chunks)
    trec = Recommender(tmodel, StubDataset(tstore, tdata._history),
                       device='cpu', **chunks)
    outputs = []
    for rec in (jrec, trec):
        store = rec.dataset.feature_store
        store.image_batch([0, 1, 2, 3])
        store.get_image(2)
        capsys.readouterr()
        rec.print_cache_stats()
        stats = store.get_stats()
        rec.clear_cache()
        outputs.append((capsys.readouterr().out, stats, store.get_stats()))
    assert outputs[1] == outputs[0]
    assert outputs[1][1]['memory_items'] == 4
    assert outputs[1][2]['memory_items'] == 0
