"""The attention cascade in the port against the JAX package, on the CPU:
the screen tables (the tail, the additive rows), the token-0 screen's plain
version against the XLA fallback and the Pallas kernel in interpret mode,
the candidate screen and the exact rescore, and the scorer's screened
top-k, cascade in each tier, calibration and auto_cascade against the JAX
scorer. Inputs come from numpy seeds and weights are converted from Flax;
JAX's tables are compared with their lane padding stripped."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelrec_multimodal_tpu.data.feature_store import (
    ItemFeatureStore as JaxStore,
)
from pixelrec_multimodal_tpu.inference.scorer import (
    CatalogScorer as JaxScorer,
)
from pixelrec_multimodal_tpu.ops import attention_cascade as jac
from pixelrec_multimodal_tpu.ops import attention_scorer as jas
from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.inference import scorer as tsc
from pixelrec_multimodal_tpu_torch.ops import attention_cascade as tac
from pixelrec_multimodal_tpu_torch.ops import attention_scorer as tas
from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
from tests._torch_port import EMB, N_USERS, item_tables, make_pair
from tests._torch_smem import hand_count  # noqa: F401 (a fixture)

# (activation, final) pairs covering every activation and final once; each
# distinct pair and head count builds one model in both packages.
ACT_FINAL = [('relu', 'sigmoid'), ('gelu', 'tanh'), ('tanh', 'sigmoid'),
             ('leaky_relu', 'none'), ('silu', 'sigmoid')]
HEADS = [1, 2, 4]
MI = 5


@functools.lru_cache(maxsize=None)
def heads_of(activation='relu', final='sigmoid', heads=4):
    jmodel, variables, tmodel = make_pair(40, activation, final,
                                          fusion_type='attention',
                                          heads=heads)
    return (jas.build_attention_head(variables, jmodel),
            tas.build_attention_head(tmodel))


def strip(a, n):
    """JAX's 128-lane padded [..., n*dp] table -> the port's [..., n*d]."""
    a = np.asarray(a)
    return a.reshape(a.shape[:-1] + (n, -1))[..., :EMB].reshape(
        a.shape[:-1] + (-1,))


def side_rows(jh, th, B=8, C=128, seed=3):
    """Seeded towers through both packages: (JAX user side, JAX item side,
    port user side, port item side)."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((C, MI, EMB)).astype(np.float32)
    users = rng.standard_normal((B, EMB)).astype(np.float32)
    return (jas.compute_user_side_attention(jh, jnp.asarray(users)),
            jas.compute_item_side_attention(jh, jnp.asarray(feats)),
            tas.compute_user_side_attention(th, torch.from_numpy(users)),
            tas.compute_item_side_attention(th, torch.from_numpy(feats)))


def tails(jh, th, ji, ti):
    return (jac.compute_screen_tail(jh, ji),
            tac.compute_screen_tail(th, ti))


# ------------------------------------------------------------ screen tables
@pytest.mark.parametrize('heads', HEADS)
def test_screen_tail_matches_jax(heads):
    """The port reads raw, sexp and dm at its indices 0, 4 and 5 (JAX's 0,
    5 and 6): the tail equals JAX's within 1e-6."""
    jh, th = heads_of('gelu', 'tanh', heads)
    _, ji, _, ti = side_rows(jh, th, B=2, C=9)
    jt, tt = tails(jh, th, ji, ti)
    assert tuple(tt.shape) == (9, EMB)
    np.testing.assert_allclose(tt.numpy(), strip(jt, 1), atol=1e-6)


@pytest.mark.parametrize('heads', HEADS)
def test_additive_rows_match_jax(heads):
    """The additive screen's user rows (b1 folded in) and item rows (the
    tail through w1) within 1e-5, and its K1 head: the chain after w1, its
    own kernel tensors from h1 on."""
    jh, th = heads_of('gelu', 'tanh', heads)
    ju, ji, tu, ti = side_rows(jh, th, B=6, C=9)
    jt, tt = tails(jh, th, ji, ti)
    np.testing.assert_allclose(
        tac.compute_screen_additive_user(th, tu).numpy(),
        np.asarray(jac.compute_screen_additive_user(jh, ju)), atol=1e-5)
    np.testing.assert_allclose(
        tac.compute_screen_additive_items(th, tt).numpy(),
        np.asarray(jac.compute_screen_additive_items(jh, jt)), atol=1e-5)
    shead = tac.screen_additive_head(th)
    assert shead['b1_folded'] and 'w1' not in shead
    assert shead['kernel']['widths'].tolist()[0] == th['h1']
    assert shead['kernel']['n_hidden'] == len(th['layers']) - 1


# ------------------------------------------------------- token-0 screen, K6
@pytest.mark.parametrize('activation, final', ACT_FINAL)
def test_screen_plain_f32_matches_xla(activation, final):
    """attention_screen_scores_plain at float32 == xla_attention_screen_
    scores (atol 1e-5: float32 sums in another order)."""
    jh, th = heads_of(activation, final, 4)
    ju, ji, tu, ti = side_rows(jh, th, B=6, C=20)
    jt, tt = tails(jh, th, ji, ti)
    out = tac.attention_screen_scores_plain(th, tu, ti, tt)
    assert out.shape == (6, 20) and out.dtype == torch.float32
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jac.xla_attention_screen_scores(jh, ju, ji,
                                                                jt)),
        atol=1e-5)


@pytest.mark.parametrize('heads', HEADS)
def test_screen_plain_f32_matches_pallas_interpret(heads):
    """The float32 plain version against JAX's screen kernel in interpret
    mode at float32, one 16 x 128 tile, within 1e-5."""
    jh, th = heads_of('gelu', 'tanh', heads)
    ju, ji, tu, ti = side_rows(jh, th, B=16, C=128)
    jt, tt = tails(jh, th, ji, ti)
    ref = jac.pallas_attention_screen_scores(
        jh, ju, ji, jt, tile_users=16, tile_items=128,
        compute_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(
        tac.attention_screen_scores_plain(th, tu, ti, tt).numpy(),
        np.asarray(ref), atol=1e-5)


# As tests/test_torch_attention.py holds K4's bf16 plain version: with relu
# both sides round at the same points (the fused vector once to bf16, then
# the bf16 chain) and only float32 order differs, so one bf16 value of a
# pair's fused vector or hidden activation may move: atol 3e-4. XLA's CPU
# bf16 arithmetic evaluates the other activations one bf16 operation at a
# time: atol 2e-2.
INTERPRET_TOL = {'relu': 3e-4}


@pytest.mark.parametrize('activation, final', ACT_FINAL[:3])
def test_screen_plain_bf16_matches_pallas_interpret(activation, final):
    jh, th = heads_of(activation, final, 4)
    ju, ji, tu, ti = side_rows(jh, th, B=16, C=128)
    jt, tt = tails(jh, th, ji, ti)
    ref = np.asarray(jac.pallas_attention_screen_scores(
        jh, ju, ji, jt, tile_users=16, tile_items=128, interpret=True))
    out = tac.attention_screen_scores_plain(th, tu, ti, tt, torch.bfloat16)
    np.testing.assert_allclose(out.numpy(), ref,
                               atol=INTERPRET_TOL.get(activation, 2e-2))


def test_screen_wrapper_on_cpu(hand_count):
    """CPU tensors take the float32 plain version and launch nothing;
    other devices, heads and widths the kernel does not take raise; K6's
    block fits wherever K4's does (its coefficients are token 0's only)."""
    jh, th = heads_of()
    _, ji, tu, ti = side_rows(jh, th, B=3, C=5)
    _, tt = tails(jh, th, ji, ti)
    before = tac.attention_screen_scores.launches
    torch.testing.assert_close(
        tac.attention_screen_scores(th, tu, ti, tt),
        tac.attention_screen_scores_plain(th, tu, ti, tt))
    assert tac.attention_screen_scores.launches == before
    with pytest.raises(ValueError, match='cuda or cpu'):
        tac.attention_screen_scores(th, tuple(t.to('meta') for t in tu), ti,
                                    tt.to('meta'))
    with pytest.raises(ValueError, match='build_attention_head'):
        tac.attention_screen_scores({'fusion': 'gated'}, tu, ti, tt)
    for d, heads, widths in ((64, 4, (512, 256, 128)), (128, 8, (64, 32)),
                             (256, 4, (64, 32))):
        layers = [(torch.zeros(k, n), torch.zeros(n))
                  for k, n in zip(widths[:-1], widths[1:])]
        head = {'d': d, 'H': heads, 'n_item_mods': MI,
                'w1': torch.zeros(d, widths[0]),
                'layers': layers + [(torch.zeros(widths[-1], 128),
                                     torch.zeros(128))]}
        full, mode = tpm.chain_widths(head), (heads, MI)
        screen = hand_count('attention_screen_mlp', full, 128, mode)
        assert screen <= hand_count('attention_mlp', full, 128, mode)
        assert tas.check_kernel_fits(head, False, screen=True) == 128
    # d 256, 4 heads, chain (64, 32), by hand, on the wgmma chain: every
    # layer fits a group of 256 columns and writes over its input, so one
    # buffer of 128 x 256 bf16, 65,536 B, then eight 16 KB ring stages and
    # 64 B of barriers, 131,136 B, over which lie 8 user rows of 1,828
    # floats and 128 coefficient rows of 25 (K4: 65) floats, 71,296 B.
    assert hand_count('attention_screen_mlp', full, 128, mode) == 196672


# ----------------------------------------------- per-user candidate lists
@pytest.mark.parametrize('heads', HEADS)
def test_candidate_screen_matches_jax(heads):
    """attention_screen_candidate_scores on gathered (k, vo, tail) rows ==
    xla_attention_screen_candidate_scores within 1e-5, and equals the
    all-pairs screen at the gathered columns."""
    jh, th = heads_of('gelu', 'tanh', heads)
    ju, ji, tu, ti = side_rows(jh, th, B=4, C=28)
    jt, tt = tails(jh, th, ji, ti)
    cands = np.random.default_rng(5).integers(0, 28, (4, 7))
    ref = jac.xla_attention_screen_candidate_scores(
        jh, ju, (ji[2][cands], ji[3][cands]), jt[cands])
    c = torch.from_numpy(cands)
    out = tac.attention_screen_candidate_scores(th, tu, (ti[2][c], ti[3][c]),
                                                tt[c])
    assert out.shape == (4, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    full = tac.attention_screen_scores_plain(th, tu, ti, tt).numpy()
    np.testing.assert_allclose(out.numpy(),
                               np.take_along_axis(full, cands, 1), atol=1e-5)


@pytest.mark.parametrize('heads', HEADS)
def test_candidate_scores_match_jax(heads):
    """The rebuilt exact rescore, attention_candidate_scores on gathered
    (raw, q, k, vo) rows, == xla_attention_candidate_scores within 1e-5
    (both the full T x T softmax; JAX reads its sii table)."""
    jh, th = heads_of('gelu', 'tanh', heads)
    ju, ji, tu, ti = side_rows(jh, th, B=4, C=28)
    cands = np.random.default_rng(5).integers(0, 28, (4, 7))
    ref = jac.xla_attention_candidate_scores(
        jh, ju, tuple(a[cands] for a in ji[:5]))
    out = tac.attention_candidate_scores(
        th, tu, tuple(t[torch.from_numpy(cands)] for t in ti[:4]))
    assert out.shape == (4, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


# ----------------------------------------------------------------- scorer
N_CAT, ITEM_CHUNK, USER_CHUNK, K = 600, 128, 64, 10


@pytest.fixture(scope='module')
def scorers():
    """JAX and port scorers on the same attention weights and items: 600
    items in 128-item chunks (the catalog pads to 640), 64-user blocks."""
    jmodel, variables, tmodel = make_pair(N_CAT, 'relu', 'sigmoid',
                                          fusion_type='attention', heads=4)
    tables = item_tables(N_CAT)
    ids = np.arange(N_CAT).astype(str)
    jstore, tstore = JaxStore(N_CAT, ids), ItemFeatureStore(N_CAT, ids)
    jstore.tables.update(tables)
    tstore.tables.update(tables)
    kw = dict(item_chunk=ITEM_CHUNK, user_chunk=USER_CHUNK)
    js = JaxScorer(jmodel, variables, jstore, **kw)
    js._ensure_screen_additive()  # JAX's top_k(_screen=) needs the tables
    return js, tsc.CatalogScorer(tmodel, tstore, **kw, device='cpu')


@pytest.fixture(scope='module')
def users():
    return np.random.default_rng(5).integers(0, N_USERS, 40).astype(np.int32)


@pytest.fixture(scope='module')
def seen():
    return np.random.default_rng(6).random((40, N_CAT)) < 0.05


def assert_same_topk(tv, ti, jv, ji):
    """Scores within 1e-5, index sets equal row for row."""
    assert tv.shape == jv.shape and ti.dtype == np.int32
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    for a, b in zip(ti, ji):
        assert set(a) == set(b)


@pytest.mark.parametrize('screen, jax_screen', [('token0', True),
                                                ('additive', 'additive')])
def test_screened_top_k_matches_jax(scorers, users, seen, screen,
                                    jax_screen):
    """top_k(_screen=) ranks by the screen: the top-100 (past JAX's
    selection-v2 threshold, exact on the CPU) equals JAX's, seen items
    excluded."""
    js, ts = scorers
    tv, ti = ts.top_k(users, 100, seen, _screen=screen)
    assert_same_topk(tv, ti, *js.top_k(users, 100, seen, _screen=jax_screen))
    assert not seen[np.arange(40)[:, None], ti].any()


@pytest.mark.parametrize('screen, n_cand, c1', [
    ('additive', 100, None), ('token0', 48, None), ('funnel', 32, 200),
    ('token0', 6, None)], ids=['additive', 'token0', 'funnel', 'c_below_k'])
def test_cascade_matches_jax(scorers, users, seen, screen, n_cand, c1):
    """top_k_cascade in each tier with a seen mask, and with C < k (the
    output padded with -inf scores and -1 ids): scores and index sets equal
    JAX's at float32."""
    js, ts = scorers
    kw = dict(n_candidates=n_cand, seen_mask=seen, screen=screen,
              funnel_c1=c1, _calibrated=True)
    tv, ti = ts.top_k_cascade(users, K, **kw)
    jv, ji = js.top_k_cascade(users, K, **kw)
    assert_same_topk(tv, ti, jv, ji)
    rows, cols = np.nonzero(ti >= 0)
    assert not seen[rows, ti[rows, cols]].any()
    assert ((ti == -1) == (tv <= -1e30 / 2)).all()
    if n_cand < K:
        assert (ti[:, n_cand:] == -1).all()


@pytest.mark.parametrize('screen', ['additive', 'token0', 'funnel'])
def test_full_coverage_cascade_equals_exact(scorers, users, seen, screen):
    """At C = n_items (and C1 = n_items) the cascade is the exact top_k:
    the same items, scores within 1e-5 (the rescore takes the full softmax,
    the scan the stream identities)."""
    _, ts = scorers
    ev, ei = ts.top_k(users, K, seen)
    cv, ci = ts.top_k_cascade(users, K, n_candidates=N_CAT, seen_mask=seen,
                              screen=screen, funnel_c1=N_CAT)
    assert_same_topk(cv, ci, ev, ei)


@pytest.mark.parametrize('screen', ['additive', 'token0'])
def test_calibrate_cascade_matches_jax(scorers, users, seen, screen):
    js, ts = scorers
    grid = (16, 64, 200)
    rec = ts.calibrate_cascade(users, K, grid, seen, screen)
    assert rec == js.calibrate_cascade(users, K, grid, seen, screen)
    assert sorted(rec) == list(grid)


def test_calibrate_funnel_matches_jax(scorers, users, seen):
    js, ts = scorers
    kw = dict(c1_grid=(64, 200), c2_grid=(16, 64, 100), seen_mask=seen)
    rec = ts.calibrate_funnel(users, K, **kw)
    assert rec == js.calibrate_funnel(users, K, **kw)
    assert set(rec) == {(64, 16), (64, 64), (200, 16), (200, 64), (200, 100)}


def test_auto_cascade_matches_jax_and_routes(scorers, users, monkeypatch):
    """auto_cascade with the speed gate forced open (min_speedup=0) picks
    the tier, C and C1 JAX picks; top_k then routes through the plan (for
    k up to the plan's), _exact bypasses it and disable_cascade restores
    the exact scan. measured_speedup is a wall time and not compared."""
    js, ts = scorers
    kw = dict(recall_target=0.5, min_speedup=0.0, max_candidate_frac=1.0)
    tp = ts.auto_cascade(users, K, **kw)
    jp = js.auto_cascade(users, K, **kw)
    js.disable_cascade()
    assert tp is not None and jp is not None
    for key in ('screen', 'n_candidates', 'c1', 'calibrated_c', 'recall',
                'k', 'sample_users'):
        assert tp.get(key) == jp.get(key), key
    calls = []
    real = ts.top_k_cascade
    monkeypatch.setattr(ts, 'top_k_cascade',
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    try:
        ev, ei = ts.top_k(users, K, _exact=True)
        assert not calls
        rv, ri = ts.top_k(users, K)
        assert len(calls) == 1 and calls[0]['screen'] == tp['screen'] \
            and calls[0]['n_candidates'] == tp['n_candidates']
        assert_same_topk(rv, ri, ev, ei)  # the plan's recall is 1.0 here
        ts.top_k(users, K + 1)  # past the plan's k: the exact scan
        assert len(calls) == 1
    finally:
        ts.disable_cascade()
    ts.top_k(users, K)
    assert len(calls) == 1 and ts._cascade_plan is None


def test_candidate_paths_call_no_plain_version(scorers, users, monkeypatch):
    """score_candidates, the rescore and the candidate screen run with
    every kernel's plain version made to raise: they are whole-tensor
    PyTorch of their own."""
    _, ts = scorers
    ts._ensure_screen('token0')

    def boom(*a, **k):
        raise AssertionError('a kernel plain version was called')

    for mod, name in ((tas, 'attention_scores_plain'),
                      (tas, 'attention_scores_gram_plain'),
                      (tac, 'attention_screen_scores_plain'),
                      (tpm, 'pairwise_scores_plain')):
        monkeypatch.setattr(mod, name, boom)
    cands = np.random.default_rng(7).integers(0, N_CAT, (40, 12))
    assert ts.score_candidates(users, cands).shape == (40, 12)
    with torch.no_grad():
        emb = ts.model.user_tower(torch.from_numpy(users.astype(np.int64)))
        c = torch.from_numpy(cands)
        assert ts._attention_candidates(emb, c).shape == (40, 12)
        assert ts._screen_candidates(emb, c).shape == (40, 12)
    with pytest.raises(AssertionError, match='plain version'):
        ts.top_k(users[:2], K, _screen='token0')


def test_candidate_sub_blocks(scorers, users, monkeypatch):
    """The gathered-row byte budget splits users into sub-blocks (here one
    user each) without changing a score."""
    _, ts = scorers
    cands = np.random.default_rng(8).integers(0, N_CAT, (40, 12))
    whole = ts.score_candidates(users, cands)
    monkeypatch.setattr(tsc, '_CANDIDATE_BLOCK_BYTES', 1)
    np.testing.assert_allclose(ts.score_candidates(users, cands), whole,
                               atol=1e-6)


def test_additive_floor_warning_and_bad_screen(scorers, users, capsys):
    _, ts = scorers
    ts.top_k_cascade(users[:4], 3, n_candidates=8, screen='additive')
    assert 'operating floor' in capsys.readouterr().err
    ts.top_k_cascade(users[:4], 3, n_candidates=8, screen='token0')
    assert 'operating floor' not in capsys.readouterr().err
    with pytest.raises(ValueError, match='screen'):
        ts.top_k_cascade(users[:2], 3, screen='nope')
    with pytest.raises(ValueError, match='screen'):
        ts.calibrate_cascade(users[:2], 3, screen='funnel')
    with pytest.raises(ValueError, match='screens with'):
        ts.top_k(users[:2], 3, _screen='funnel')


@pytest.mark.parametrize('fusion, fast_path', [
    ('concatenate', True), ('gated', True), ('attention', False)],
    ids=['concat', 'gated', 'generic'])
def test_cascade_needs_the_attention_head(fusion, fast_path):
    """A concat, gated or generic scorer raises ValueError on every cascade
    entry point."""
    _, _, tmodel = make_pair(40, fusion_type=fusion)
    store = ItemFeatureStore(40, np.arange(40).astype(str))
    store.tables.update(item_tables(40))
    ts = tsc.CatalogScorer(tmodel, store, item_chunk=128, device='cpu',
                           fast_path=fast_path)
    u = np.arange(3, dtype=np.int32)
    for call in (lambda: ts.top_k_cascade(u, 3),
                 lambda: ts.calibrate_cascade(u, 3),
                 lambda: ts.calibrate_funnel(u, 3),
                 lambda: ts.auto_cascade(u, 3),
                 lambda: ts.top_k(u, 3, _screen='token0')):
        with pytest.raises(ValueError, match='attention head'):
            call()
