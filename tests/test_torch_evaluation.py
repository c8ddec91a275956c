"""The port's evaluation modules against the JAX package's, on the CPU.

The metric, novelty and advanced-metric functions and personalization
are held bit for bit on seeded lists and embeddings. The evaluators run
in both packages over one learned recommender each (the same model,
weights converted from Flax by ``tests/_torch_port.make_pair``, over the
same item tables, vision and language included, so that intra-list
similarity reads them) and a small stand-in dataset: JAX's takes the test
data and the interactions as DataFrames, the port's as dicts of numpy
columns. Every metric agrees within 1e-6; the predictions hold the same
items per user (as value sets: tie order may differ) with scores within
1e-5 (float32 sums in another order).
"""
import functools
import hashlib
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from pixelrec_multimodal_tpu.data.feature_store import (
    ItemFeatureStore as JaxStore,
)
from pixelrec_multimodal_tpu.evaluation import advanced_metrics as jadv
from pixelrec_multimodal_tpu.evaluation import metrics as jmetrics
from pixelrec_multimodal_tpu.evaluation import novelty as jnovelty
from pixelrec_multimodal_tpu.evaluation import tasks as jtasks
from pixelrec_multimodal_tpu.inference.recommender import (
    Recommender as JaxRecommender,
)
from pixelrec_multimodal_tpu_torch import evaluation as tevaluation
from pixelrec_multimodal_tpu_torch.data.columns import value_counts
from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.data.label_encoder import LabelEncoder
from pixelrec_multimodal_tpu_torch.evaluation import advanced_metrics as tadv
from pixelrec_multimodal_tpu_torch.evaluation import metrics as tmetrics
from pixelrec_multimodal_tpu_torch.evaluation import novelty as tnovelty
from pixelrec_multimodal_tpu_torch.evaluation import tasks as ttasks
from pixelrec_multimodal_tpu_torch.inference import Recommender
from tests._torch_port import N_USERS, item_tables, make_pair, quiet

N_ITEMS, K, PER_USER = 120, 10, 6
METRIC_TOL, SCORE_TOL = 1e-6, 1e-5
USER_IDS = [f'u{u:02d}' for u in range(N_USERS)]
ITEM_IDS = [f'i{j:03d}' for j in range(N_ITEMS)]
CONFIG = SimpleNamespace(recommendation=SimpleNamespace(top_k=K))


def skewed_items(rng, n):
    """Item ids drawn with a skew, so popularity has ties and a head."""
    p = 1.0 / np.arange(1, N_ITEMS + 1)
    return [ITEM_IDS[j] for j in rng.choice(N_ITEMS, n, replace=False,
                                            p=p / p.sum())]


def interactions(seed=4):
    rng = np.random.default_rng(seed)
    users = [u for u in USER_IDS for _ in range(PER_USER)]
    items = [i for _ in USER_IDS for i in skewed_items(rng, PER_USER)]
    return {'user_id': np.asarray(users), 'item_id': np.asarray(items)}


def eval_rows(seed=5):
    """Three test items for most users, one for some, none for others; an
    unknown user; an unknown item; rows out of user order."""
    rng = np.random.default_rng(seed)
    rows = []
    for u in USER_IDS[:40]:
        n = 1 if u.endswith('3') else 3
        rows += [(u, i) for i in skewed_items(rng, n)]
    rows += [('nobody', ITEM_IDS[3]), ('nobody', ITEM_IDS[4]),
             (USER_IDS[7], 'zzz')]
    order = rng.permutation(len(rows))
    return {'user_id': np.asarray([rows[r][0] for r in order]),
            'item_id': np.asarray([rows[r][1] for r in order])}


class StubDataset:
    """What the recommenders and the evaluators read of a dataset."""

    def __init__(self, store, inter, as_frame):
        self.feature_store = store
        self.user_encoder = LabelEncoder().fit(USER_IDS)
        self.item_encoder = LabelEncoder().fit(ITEM_IDS)
        self.n_items = N_ITEMS
        self.interactions = pd.DataFrame(inter) if as_frame else dict(inter)
        u = self.user_encoder.transform(inter['user_id'])
        i = self.item_encoder.transform(inter['item_id'])
        order = np.argsort(u, kind='stable')
        self._hist = (np.searchsorted(u[order], np.arange(N_USERS + 1)),
                      i[order])

    def user_history_matrix(self):
        return self._hist

    def get_user_history(self, user_id):
        uidx = int(self.user_encoder.transform([user_id])[0])
        indptr, items = self._hist
        return set(self.item_encoder.inverse_transform(
            items[indptr[uidx]:indptr[uidx + 1]]))


@functools.lru_cache(maxsize=None)
def recommenders():
    """(JAX Recommender, port Recommender) over one converted model."""
    jmodel, variables, tmodel = make_pair(N_ITEMS)
    tables = item_tables(N_ITEMS)
    ids = np.asarray(ITEM_IDS)
    jstore, tstore = JaxStore(N_ITEMS, ids), ItemFeatureStore(N_ITEMS, ids)
    jstore.tables.update(tables)
    tstore.tables.update(tables)
    inter = interactions()
    chunks = dict(item_chunk=64, user_chunk=16)
    return (JaxRecommender(jmodel, variables,
                           StubDataset(jstore, inter, True), **chunks),
            Recommender(tmodel, StubDataset(tstore, inter, False), **chunks,
                        device='cpu'))


def evaluate_both(task, jrec, trec, **kw):
    """Both packages' evaluator of ``task`` ('retrieval' or 'ranking') on
    the same test rows: (port's results, JAX's)."""
    rows = eval_rows()
    got = quiet(ttasks.create_evaluator(ttasks.get_task_from_string(task),
                                        trec, rows, CONFIG, **kw).evaluate)
    ref = quiet(jtasks.create_evaluator(jtasks.get_task_from_string(task),
                                        jrec, pd.DataFrame(rows), CONFIG,
                                        **kw).evaluate)
    return got, ref


def assert_same_results(got, ref, ranking=False):
    """Every metric within METRIC_TOL; the same users in the same order;
    each user's predictions the same items with scores within SCORE_TOL
    (ranking: in the same order, the test rows' order)."""
    preds, ref_preds = got.pop('predictions'), ref.pop('predictions')
    assert set(got) == set(ref)
    for key, value in ref.items():
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, abs=METRIC_TOL), key
        else:
            assert got[key] == value, key
    assert list(preds) == list(ref_preds)
    for user, items in ref_preds.items():
        mine = dict(preds[user])
        theirs = dict(items)
        assert set(mine) == set(theirs), user
        if ranking:
            assert [i for i, _ in preds[user]] == [i for i, _ in items]
        np.testing.assert_allclose([mine[i] for i in theirs],
                                   list(theirs.values()), atol=SCORE_TOL)
    return preds


# ---------------------------------------------------------------- metrics
def random_lists(seed=0, n=40):
    rng = np.random.default_rng(seed)
    pool = [f'x{j}' for j in range(30)]
    lists = [list(rng.choice(pool, rng.integers(0, 12), replace=False))
             for _ in range(n)]
    relevant = [set(rng.choice(pool, rng.integers(0, 6), replace=False))
                for _ in range(n)]
    return lists, relevant


def test_metric_functions_bit_for_bit():
    lists, relevant = random_lists()
    for recs, rel in zip(lists, relevant):
        for k in (0, 1, 5, 10):
            for name in ('calculate_precision_at_k', 'calculate_recall_at_k',
                         'calculate_ndcg'):
                assert getattr(tmetrics, name)(recs, rel, k) == \
                    getattr(jmetrics, name)(recs, rel, k), (name, k)
        assert tmetrics.calculate_map(recs, rel) == \
            jmetrics.calculate_map(recs, rel)
    hits = np.random.default_rng(1).random((30, 10)) < 0.3
    n_rel = np.random.default_rng(2).integers(0, 5, 30)
    for k in (1, 4, 10):
        for name in ('precision_at_k_batch', 'ndcg_at_k_batch',
                     'hit_rate_batch'):
            assert (getattr(tmetrics, name)(hits, k) ==
                    getattr(jmetrics, name)(hits, k)).all(), name
        assert (tmetrics.recall_at_k_batch(hits, n_rel, k) ==
                jmetrics.recall_at_k_batch(hits, n_rel, k)).all()
    assert (tmetrics.mrr_batch(hits) == jmetrics.mrr_batch(hits)).all()


def novelty_inputs(seed=3):
    """Interactions with tied counts, the popularity dict in pandas'
    ``value_counts`` order, and float64 embeddings (one zero vector)."""
    rng = np.random.default_rng(seed)
    users = rng.choice([f'u{j}' for j in range(12)], 200)
    items = rng.choice([f'x{j}' for j in range(30)], 200)
    popularity = pd.Series(items).value_counts().to_dict()
    history = list(zip(users.tolist(), items.tolist()))
    embs = {f'x{j}': rng.standard_normal(7) for j in range(28)}
    embs['x3'] = np.zeros(7)
    return users, items, popularity, history, embs


def test_value_counts_is_pandas_order():
    """The popularity dict in the port is pandas' ``value_counts`` dict:
    its order decides the popularity ranks' ties."""
    _, items, popularity, _, _ = novelty_inputs()
    got = value_counts(items)
    assert list(got.items()) == list(popularity.items())
    assert len(set(got.values())) < len(got)  # ties occur


def test_novelty_bit_for_bit():
    _, items, popularity, history, embs = novelty_inputs()
    tcalc = tnovelty.NoveltyMetrics(value_counts(items), history, embs)
    jcalc = jnovelty.NoveltyMetrics(popularity, history, embs)
    assert tcalc.popularity_ranks == jcalc.popularity_ranks
    lists, _ = random_lists(seed=4)
    for n, recs in enumerate(lists):
        user = f'u{n % 14}'  # two users without history
        got = tcalc.calculate_metrics(recs, user_id=user)
        ref = jcalc.calculate_metrics(recs, user_id=user)
        assert got.keys() == ref.keys()
        for key in ref:
            assert np.array_equal(got[key], ref[key], equal_nan=True), key
    plain = tnovelty.NoveltyMetrics(value_counts(items), history)
    assert np.isnan(plain.calculate_metrics(['x1', 'x2'])[
        'intra_list_similarity'])
    tdiv, jdiv = (m.DiversityCalculator(embs) for m in (tnovelty, jnovelty))
    for recs in lists:
        for metric in ('cosine', 'euclidean'):
            assert tdiv.calculate_pairwise_diversity(recs, metric) == \
                jdiv.calculate_pairwise_diversity(recs, metric)
    per_user = {f'u{j}': recs for j, recs in enumerate(lists)}
    assert tdiv.calculate_coverage_diversity(per_user) == \
        jdiv.calculate_coverage_diversity(per_user)


def test_advanced_metrics_bit_for_bit():
    lists, relevant = random_lists(seed=6)
    expected, _ = random_lists(seed=7)
    expected = [set(e) for e in expected]
    rng = np.random.default_rng(8)
    stamps = {f'x{j}': float(rng.integers(0, 1000)) for j in range(25)}
    features = {f'x{j}': {f'f{k}': float(rng.standard_normal())
                          for k in rng.choice(5, 3, replace=False)}
                for j in range(25)}
    prefs = {u: {f'f{k}': float(rng.standard_normal()) for k in range(4)}
             for u in range(0, 40, 2)}
    counts = {f'x{j}': int(rng.integers(0, 9)) for j in range(30)}
    T, J = tadv.AdvancedMetrics, jadv.AdvancedMetrics
    assert T.calculate_mrr(lists, relevant) == J.calculate_mrr(lists,
                                                               relevant)
    assert T.calculate_hit_rate(lists, relevant) == \
        J.calculate_hit_rate(lists, relevant)
    assert T.calculate_gini_coefficient(counts) == \
        J.calculate_gini_coefficient(counts)
    assert T.calculate_serendipity(lists, expected, relevant) == \
        J.calculate_serendipity(lists, expected, relevant)
    assert T.calculate_temporal_diversity(lists, stamps) == \
        J.calculate_temporal_diversity(lists, stamps)
    assert T.calculate_user_satisfaction_proxy(lists, features, prefs) == \
        J.calculate_user_satisfaction_proxy(lists, features, prefs)
    recs = {f'u{j}': r for j, r in enumerate(lists)}
    demo = {f'u{j}': {'gender': 'fm'[j % 2]} for j in range(0, 40, 3)}
    providers = {f'x{j}': f'p{j % 4}' for j in range(20)}
    TF, JF = tadv.FairnessMetrics, jadv.FairnessMetrics
    assert TF.calculate_demographic_parity(recs, demo) == \
        JF.calculate_demographic_parity(recs, demo)
    assert TF.calculate_provider_fairness(lists, providers) == \
        JF.calculate_provider_fairness(lists, providers)


@pytest.mark.parametrize('lists', [
    [['a', 'b', 'c'], ['b', 'c', 'd'], ['e', 'f'], [], ['a', 'a', 'b']],
    [['a'], ['b'], ['c']],
    [['a', 'b'], ['a', 'b'], ['b', 'a']],
    [[], []],
    [['a', 'b']],
    [],
    'seeded',
], ids=['shared', 'disjoint', 'identical', 'empty_rows', 'one_user',
        'no_user', 'seeded'])
def test_personalization_bit_for_bit(lists):
    if lists == 'seeded':
        lists = random_lists(seed=9, n=300)[0]
    got = ttasks.TopKRetrievalEvaluator._calculate_personalization(lists)
    ref = jtasks.TopKRetrievalEvaluator._calculate_personalization(lists)
    assert got == ref


def test_stable_user_seed_both_branches(monkeypatch):
    users = ['u1', '0042', 'ünï', '']
    monkeypatch.delenv('PYTHONHASHSEED', raising=False)
    blake = [ttasks.stable_user_seed(u, s) for u in users for s in ('', 'x')]
    assert blake == [jtasks.stable_user_seed(u, s)
                     for u in users for s in ('', 'x')]
    assert blake[0] == int.from_bytes(hashlib.blake2b(
        b'u1', digest_size=8).digest(), 'little') % 2 ** 31
    monkeypatch.setenv('PYTHONHASHSEED', '0')
    pinned = [ttasks.stable_user_seed(u, s) for u in users for s in ('', 'x')]
    assert pinned == [jtasks.stable_user_seed(u, s)
                      for u in users for s in ('', 'x')]
    assert pinned == [hash(u + s) % 2 ** 31 for u in users for s in ('', 'x')]


# ------------------------------------------------------------- evaluators
@pytest.mark.parametrize('kw', [
    dict(num_negatives=20),
    dict(num_negatives=30, sampling_strategy='popularity'),
    dict(num_negatives=15, sampling_strategy='popularity_inverse'),
    dict(use_sampling=False),
    dict(full_catalog=True),
    dict(num_negatives=200),
], ids=['random', 'popularity', 'popularity_inverse', 'no_sampling',
        'full_catalog', 'negatives_past_catalog'])
def test_retrieval_matches_jax(kw):
    jrec, trec = recommenders()
    got, ref = evaluate_both('retrieval', jrec, trec, **kw)
    preds = assert_same_results(got, ref)
    assert got['num_users_evaluated'] == 41
    assert preds['nobody'] == []
    assert got['avg_intra_list_similarity'] > 0.0
    lengths = {len(v) for u, v in preds.items() if u != 'nobody'}
    assert lengths == ({K} if kw.get('full_catalog') or
                       kw.get('use_sampling', True) else {1, 3})


def test_sampled_candidates_match_jax():
    """The negatives and the shuffled candidate sets are JAX's, id for id,
    in each strategy, for users with positives inside and outside the
    catalog."""
    jrec, trec = recommenders()
    rows = eval_rows()
    for strategy in ('random', 'popularity', 'popularity_inverse'):
        kw = dict(num_negatives=25, sampling_strategy=strategy)
        tev = ttasks.TopKRetrievalEvaluator(trec, rows, CONFIG, **kw)
        jev = jtasks.TopKRetrievalEvaluator(jrec, pd.DataFrame(rows),
                                            CONFIG, **kw)
        for user, items in tev._user_groups()[::5] + [('u07', ['zzz'])]:
            assert tev._candidate_set(user, items) == \
                jev._candidate_set(user, items), (strategy, user)


def test_ranking_matches_jax():
    jrec, trec = recommenders()
    got, ref = evaluate_both('ranking', jrec, trec)
    preds = assert_same_results(got, ref, ranking=True)
    assert preds['nobody'] == [('i003', 0.0), ('i004', 0.0)]
    assert dict(preds['u07'])['zzz'] == 0.0


class Failing:
    """A learned recommender whose batched scoring fails."""

    def __init__(self, rec):
        self.dataset = rec.dataset
        self.get_recommendations = rec.get_recommendations
        self.get_item_score = rec.get_item_score

    def score_candidates_batch(self, *args):
        raise RuntimeError('device lost')


@pytest.mark.parametrize('task', ['retrieval', 'ranking'])
def test_batched_failure_raises_where_jax_falls_back(task):
    """Kept on purpose: a failure of the batched device call raises in
    the port; the JAX package logs it and takes the per-user path."""
    jrec, trec = recommenders()
    enum = ttasks.get_task_from_string(task)
    rows = eval_rows()
    with pytest.raises(RuntimeError, match='device lost'):
        quiet(ttasks.create_evaluator(enum, Failing(trec), rows, CONFIG,
                                      num_negatives=20).evaluate)
    fallback = quiet(jtasks.create_evaluator(
        jtasks.get_task_from_string(task), Failing(jrec),
        pd.DataFrame(rows), CONFIG, num_negatives=20).evaluate)
    assert fallback['num_users_evaluated'] == 41


def test_task_mapping_and_exports():
    assert ttasks.TASK_MAPPING.keys() == jtasks.TASK_MAPPING.keys()
    assert ttasks.get_task_from_string('ranking') == \
        ttasks.EvaluationTask.TOP_K_RANKING
    assert ttasks.get_task_from_string('top_k_retrieval') == \
        ttasks.EvaluationTask.TOP_K_RETRIEVAL
    for name in ('next_item', 'cold_user', 'beyond_accuracy'):
        with pytest.raises(ValueError, match='removed'):
            ttasks.get_task_from_string(name)
    with pytest.raises(ValueError, match='Unknown task'):
        ttasks.get_task_from_string('bogus')
    with pytest.raises(ValueError, match='Unknown evaluation task'):
        ttasks.create_evaluator('bogus', None, eval_rows(), CONFIG)
    import pixelrec_multimodal_tpu.evaluation as jevaluation
    assert {n for n in dir(jevaluation) if not n.startswith('_')} <= \
        set(dir(tevaluation)) | {'advanced_metrics', 'metrics', 'novelty',
                                 'tasks'}
