"""The port's four baseline recommenders against the JAX package's, on the
CPU.

One small dataset with ties (binary histories, so many equal
similarities and popularities; a repeated interaction; a user in the
encoder with no history; items nobody touched), given to JAX's baselines
as DataFrames and to the port's as dicts of numpy columns. The baselines
are host code computing the same float64 arithmetic, so every list,
order and score must equal JAX's exactly; the KNN similarity matrices
equal scikit-learn's ``cosine_similarity`` bit for bit (scikit-learn runs
here, in the test; the port does not import it).
"""
import numpy as np
import pandas as pd
import pytest
from scipy.sparse import csr_matrix
from sklearn.metrics.pairwise import cosine_similarity as sk_cosine

from pixelrec_multimodal_tpu.evaluation import tasks as jtasks
from pixelrec_multimodal_tpu.inference import baseline_recommenders as jbase
from pixelrec_multimodal_tpu_torch.data.label_encoder import LabelEncoder
from pixelrec_multimodal_tpu_torch.evaluation import tasks as ttasks
from pixelrec_multimodal_tpu_torch.inference import (
    baseline_recommenders as tbase,
)
from tests._torch_port import quiet

N_USERS, N_ITEMS = 24, 40
USERS = [f'{u:03d}' for u in range(N_USERS)]
ITEMS = [f'it{j:02d}' for j in range(N_ITEMS)]
KINDS = {'random': 'RandomRecommender',
         'popularity': 'PopularityRecommender',
         'item_knn': 'ItemKNNRecommender',
         'user_knn': 'UserKNNRecommender'}
CONFIG = type('C', (), {'recommendation': type('R', (), {'top_k': 8})})


def interactions(seed=11):
    """Four to nine items a user from the first 34 (six items untouched),
    user 023 with none; one repeated pair."""
    rng = np.random.default_rng(seed)
    rows = [(u, ITEMS[j]) for u in USERS[:-1]
            for j in rng.choice(34, rng.integers(4, 10), replace=False)]
    rows.append(rows[3])
    return {'user_id': np.asarray([u for u, _ in rows]),
            'item_id': np.asarray([i for _, i in rows])}


class Data:
    def __init__(self, inter, as_frame):
        self.user_encoder = LabelEncoder().fit(USERS)
        self.item_encoder = LabelEncoder().fit(ITEMS)
        self.interactions = pd.DataFrame(inter) if as_frame else dict(inter)


def history_rows():
    """An override history: the first two thirds of the interactions."""
    inter = interactions()
    n = 2 * len(inter['user_id']) // 3
    return {k: v[:n] for k, v in inter.items()}


def pair(kind, history=None):
    """(port baseline, JAX baseline) of ``kind``."""
    inter = interactions()
    jhist = pd.DataFrame(history) if history is not None else None
    return (quiet(getattr(tbase, KINDS[kind]), Data(inter, False),
                  history_interactions_df=history),
            quiet(getattr(jbase, KINDS[kind]), Data(inter, True),
                  history_interactions_df=jhist))


def same_calls(fn_t, fn_j, *args, **kw):
    """The two calls' results, numpy's global generator reseeded before
    each so that the random baseline draws alike."""
    np.random.seed(7)
    got = quiet(fn_t, *args, **kw)
    np.random.seed(7)
    return got, quiet(fn_j, *args, **kw)


# ------------------------------------------------------------ similarities
@pytest.mark.parametrize('transpose', [False, True], ids=['users', 'items'])
def test_cosine_similarity_bit_for_bit(transpose):
    inter = interactions()
    rows = np.asarray([USERS.index(u) for u in inter['user_id']])
    cols = np.asarray([ITEMS.index(i) for i in inter['item_id']])
    X = csr_matrix((np.ones(len(rows)), (rows, cols)),
                   shape=(N_USERS, N_ITEMS))
    X = X.T if transpose else X
    got = tbase.cosine_similarity(X)
    ref = sk_cosine(X, dense_output=False)
    assert got.shape == ref.shape
    assert np.array_equal(got.toarray(), ref.toarray())
    assert got.nnz == ref.nnz
    dense = got.toarray()
    assert (np.unique(dense[dense > 0], return_counts=True)[1] > 1).any()


@pytest.mark.parametrize('history', [None, 'override'])
def test_knn_matrices_match_jax(history):
    hist = history_rows() if history else None
    titem, jitem = pair('item_knn', hist)
    tuser, juser = pair('user_knn', hist)
    for got, ref in ((titem.item_similarities, jitem.item_similarities),
                     (tuser.user_similarities, juser.user_similarities),
                     (tuser.user_item_matrix, juser.user_item_matrix)):
        assert np.array_equal(got.toarray(), ref.toarray())
    assert tuser.user_item_matrix.max() == 2.0 or history  # repeated pair


# ------------------------------------------------------------ each baseline
@pytest.mark.parametrize('history', [None, 'override'])
@pytest.mark.parametrize('kind', list(KINDS))
def test_recommendations_match_jax(kind, history):
    """Every user (one without history, one unknown) with and without
    candidates (unknown ids among them) and the seen filter: the same
    items, order and scores."""
    trec, jrec = pair(kind, history_rows() if history else None)
    assert trec.user_items == jrec.user_items
    assert trec.item_popularity == jrec.item_popularity
    cands = ITEMS[::3] + ['nope', ITEMS[5], ITEMS[1]]
    for user in USERS + ['nobody']:
        for candidates in (None, cands):
            for filter_seen in (True, False):
                got, ref = same_calls(trec.get_recommendations,
                                      jrec.get_recommendations, user, 6,
                                      filter_seen, candidates)
                assert got == ref, (user, candidates, filter_seen)
    got, ref = same_calls(trec.get_recommendations,
                          jrec.get_recommendations, USERS[2], top_k=100)
    assert got == ref and len(got) > 6


@pytest.mark.parametrize('kind', list(KINDS))
def test_item_scores_match_jax(kind):
    trec, jrec = pair(kind)
    for user in USERS[::5] + [USERS[-1], 'nobody']:
        for item in ITEMS[::4] + [ITEMS[37], 'nope']:
            got, ref = same_calls(trec.get_item_score, jrec.get_item_score,
                                  user, item)
            assert got == ref and isinstance(got, float), (user, item)


def test_empty_override_falls_back():
    empty = {'user_id': np.asarray([], dtype=str),
             'item_id': np.asarray([], dtype=str)}
    trec = quiet(tbase.PopularityRecommender, Data(interactions(), False),
                 history_interactions_df=empty)
    full = quiet(tbase.PopularityRecommender, Data(interactions(), False))
    assert trec.user_items == full.user_items


# ------------------------------------------------------------- evaluators
def eval_rows(seed=12):
    rng = np.random.default_rng(seed)
    rows = [(u, ITEMS[j]) for u in USERS[::2]
            for j in rng.choice(N_ITEMS, 2, replace=False)]
    rows.append(('nobody', ITEMS[0]))
    return {'user_id': np.asarray([u for u, _ in rows]),
            'item_id': np.asarray([i for _, i in rows])}


@pytest.mark.parametrize('task', ['retrieval', 'ranking'])
@pytest.mark.parametrize('kind', list(KINDS))
def test_evaluators_on_baselines_match_jax(kind, task):
    """The per-user paths of both evaluators: the same results to the
    bit; the random baseline draws the same lists in two evaluations in
    a row (the evaluator reseeds numpy's global generator)."""
    trec, jrec = pair(kind, history_rows())
    rows = eval_rows()
    kw = dict(num_negatives=12)
    tev = ttasks.create_evaluator(ttasks.get_task_from_string(task), trec,
                                  rows, CONFIG, **kw)
    jev = jtasks.create_evaluator(jtasks.get_task_from_string(task), jrec,
                                  pd.DataFrame(rows), CONFIG, **kw)
    first = quiet(tev.evaluate)
    np.random.seed(99)  # draws between the runs change nothing
    second = quiet(tev.evaluate)
    ref = quiet(jev.evaluate)
    assert first == ref == second
    if task == 'retrieval':
        assert first['avg_hit_rate_at_k'] > 0
        assert 'avg_personalization' in first
