"""Gated fusion in the port against the JAX package, on the CPU: the model
at float32, the gated head tensor for tensor, the per-side rows and the
factored tables, the plain float32 scoring against the XLA fallback, the
plain bf16 versions against the Pallas kernels in interpret mode and
against JAX references that round where the CUDA kernels do, and the
gated CatalogScorer (exact and factored) against the JAX scorer. Inputs
come from numpy seeds and weights are converted from Flax."""
import functools

import jax
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
from pixelrec_multimodal_tpu.models.multimodal import activation_fn
from pixelrec_multimodal_tpu.ops import pairwise_mlp as jpm
from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.inference import scorer as tsc
from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
from tests._torch_port import (
    EMB,
    LANGUAGE,
    N_TAGS,
    N_USERS,
    NUMERICAL,
    VISION,
    item_tables,
    make_pair,
    to_torch,
)

N_ITEMS = 40
ACTIVATIONS = ['relu', 'gelu', 'tanh', 'leaky_relu', 'silu']
FINALS = ['sigmoid', 'tanh', 'none']
MI = 5  # item-side modalities: item, tag, vision, language, numerical


@functools.lru_cache(maxsize=None)
def gated_pair(activation='relu', final='sigmoid', use_batch_norm=True):
    return make_pair(N_ITEMS, activation, final,
                     use_batch_norm=use_batch_norm, fusion_type='gated')


@functools.lru_cache(maxsize=None)
def heads(activation='relu', final='sigmoid', use_batch_norm=True):
    jmodel, variables, tmodel = gated_pair(activation, final, use_batch_norm)
    return (jpm.build_factorized_head(variables, jmodel),
            tpm.build_factorized_head(tmodel))


def sides(B=16, C=128, seed=3):
    """Seeded item tower outputs [C, Mi, d] and user embeddings [B, d]."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((C, MI, EMB)).astype(np.float32)
    users = rng.standard_normal((B, EMB)).astype(np.float32)
    return feats, users


def side_rows(jh, B=16, C=128, seed=3):
    """The JAX per-side rows (user side, item side) of seeded towers, and
    the same arrays as torch tensors."""
    feats, users = sides(B, C, seed)
    ju = jpm.compute_user_side_gated(jh, jnp.asarray(users))
    ji = jpm.compute_item_side_gated(jh, jnp.asarray(feats))
    tu = tuple(torch.from_numpy(np.array(a)) for a in ju)
    ti = tuple(torch.from_numpy(np.array(a)) for a in ji)
    return ju, ji, tu, ti


def batch(B=16, seed=2):
    rng = np.random.default_rng(seed)
    return dict(
        user_idx=rng.integers(0, N_USERS, B).astype(np.int32),
        item_idx=rng.integers(0, N_ITEMS, B).astype(np.int32),
        tag_idx=rng.integers(0, N_TAGS, B).astype(np.int32),
        vision_features=rng.standard_normal((B, VISION)).astype(np.float32),
        language_features=rng.standard_normal(
            (B, LANGUAGE)).astype(np.float32),
        numerical_features=rng.standard_normal(
            (B, NUMERICAL)).astype(np.float32))


FEATS = ('vision_features', 'language_features', 'numerical_features')
IDX = ('user_idx', 'item_idx', 'tag_idx')


# ------------------------------------------------------------------ model
@pytest.mark.parametrize('final', FINALS)
@pytest.mark.parametrize('activation', ACTIVATIONS)
def test_forward_matches_flax(activation, final):
    """float32 forward == model.apply (atol 1e-5: float32 sums in another
    order)."""
    jmodel, variables, tmodel = gated_pair(activation, final)
    b = batch()
    ref = jmodel.apply(variables, *(jnp.asarray(b[k]) for k in IDX),
                       **{k: jnp.asarray(b[k]) for k in FEATS}, train=False)
    with torch.no_grad():
        out = tmodel(*(to_torch(b[k]) for k in IDX),
                     **{k: to_torch(b[k]) for k in FEATS})
    assert out.shape == (16, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize('use_batch_norm', [True, False])
def test_score_from_towers_matches_flax(use_batch_norm):
    jmodel, variables, tmodel = gated_pair('gelu', 'sigmoid', use_batch_norm)
    b = batch(B=12, seed=4)
    j_items = jmodel.apply(variables, jnp.asarray(b['item_idx']),
                           jnp.asarray(b['tag_idx']), method='item_tower',
                           **{k: jnp.asarray(b[k]) for k in FEATS})
    j_users = jmodel.apply(variables, jnp.asarray(b['user_idx']),
                           method='user_tower')
    ref = jmodel.apply(variables, j_users, j_items,
                       method='score_from_towers')
    with torch.no_grad():
        out = tmodel.score_from_towers(to_torch(np.asarray(j_users)),
                                       to_torch(np.asarray(j_items)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    gating = tmodel.fusion_layer.gating
    assert tuple(gating.weight.shape) == (6, 6 * EMB)
    np.testing.assert_array_equal(
        gating.weight.detach().numpy().T,
        variables['params']['fusion_layer']['gating']['kernel'])


# ------------------------------------------------------------------- head
@pytest.mark.parametrize('use_batch_norm', [True, False])
def test_head_matches_jax_tensor_for_tensor(use_batch_norm):
    """Same host-side float32 numpy math: equal to float32 rounding."""
    jh, th = heads('relu', 'sigmoid', use_batch_norm)
    assert set(th) == set(jh) | {'kernel'}
    for key in ('b1', 'w_fused', 'wg_user', 'wg_item', 'bg'):
        assert tuple(th[key].shape) == jh[key].shape
        np.testing.assert_allclose(th[key].numpy(), np.asarray(jh[key]),
                                   rtol=1e-6, atol=1e-6)
    for (tw, tb), (jw, jb) in zip(th['layers'], jh['layers']):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                                   atol=1e-6)
    for key in ('fusion', 'activation', 'final_activation', 'b1_folded',
                'n_item_mods', 'h1'):
        assert th[key] == jh[key]
    assert th['n_item_mods'] == MI
    assert th['kernel']['widths'].tolist() == [128, 128]


def test_sides_match_jax():
    """compute_{item,user}_side_gated: float32 einsums and products, atol
    1e-5."""
    jh, th = heads()
    ju, ji, _, _ = side_rows(jh, B=6, C=9)
    feats, users = sides(6, 9)
    tu = tpm.compute_user_side_gated(th, torch.from_numpy(users))
    ti = tpm.compute_item_side_gated(th, torch.from_numpy(feats))
    assert tuple(ti[0].shape) == (9, MI * 128)
    for t, j in zip(tu + ti, ju + ji):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    assert (ti[1][:, MI + 1:] == 0).all() and (tu[1][:, MI + 1:] == 0).all()


def test_factored_tables_match_jax():
    """factor_gated_user equal to float32 rounding; the item-major tables,
    converted to JAX's T4 layout, equal bit for bit (the same bf16 rounding
    of the same float32 products)."""
    jh, th = heads()
    ju, ji, tu, ti = side_rows(jh, B=6, C=9)
    ja = jpm.factor_gated_user(jh, *ju)[1]
    ta = tpm.factor_gated_user(th, *tu)[1]
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    t4, igb = jpm.factor_gated_tables(jh, *ji)
    T, tigb = tpm.factor_gated_tables(th, *ti)
    assert T.dtype == torch.bfloat16 and tuple(T.shape) == (9, MI, 128)
    assert tuple(tigb.shape) == (9, tpm.GATE_PAD)
    np.testing.assert_allclose(tigb.numpy(), np.asarray(igb).T, rtol=1e-6)
    nblk = 128 // tpm.LANE
    as_t4 = np.zeros(t4.shape, np.float32)
    as_t4[:, 1:MI + 1] = (T.float().numpy().reshape(9, MI, nblk, tpm.LANE)
                          .transpose(2, 1, 0, 3).reshape(nblk, MI, -1))
    np.testing.assert_array_equal(as_t4, np.asarray(t4, np.float32))


# ---------------------------------------------------------- plain scoring
@pytest.mark.parametrize('final', FINALS)
@pytest.mark.parametrize('activation', ACTIVATIONS)
def test_plain_f32_matches_xla(activation, final):
    """Float32 plain path == xla_pairwise_scores_gated (atol 1e-5: float32
    sums in another order)."""
    jh, th = heads(activation, final)
    ju, ji, tu, ti = side_rows(jh, B=6, C=20)
    ref = jpm.xla_pairwise_scores_gated(jh, *ju, *ji)
    out = tpm.pairwise_scores_gated_plain(th, *tu, *ti)
    assert out.shape == (6, 20) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_candidate_scores_match_xla():
    jh, th = heads('gelu', 'tanh')
    ju, ji, tu, ti = side_rows(jh, B=4, C=28)
    rng = np.random.default_rng(5)
    cands = rng.integers(0, 28, (4, 7))
    ref = jpm.xla_candidate_scores_gated(
        jh, ju, ji[0][cands], ji[1][cands])
    out = tpm.candidate_scores_gated(th, tu, ti[0][cands], ti[1][cands])
    assert out.shape == (4, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _bf16_chain(jh, x):
    """JAX's ``_mlp_chain`` on float32 first-layer pre-activations
    [B, C, h1], with every activation evaluated in float32 on its input and
    rounded to bf16 once, as the CUDA kernels and the port's bf16 plain
    versions do (XLA's CPU bf16 arithmetic rounds after each operation)."""
    bf16 = jnp.bfloat16
    f = activation_fn(jh['activation'])

    def act(v):
        return f(v.astype(jnp.float32)).astype(bf16)

    B, C = x.shape[:2]
    refs = [t for layer in jh['layers'] for t in layer]
    return jpm._mlp_chain(act(x).reshape(B * C, -1), refs, len(jh['layers']),
                          act, jh['final_activation'], bf16).reshape(B, C)


def k2_reference(jh, ju, ji):
    """Kernel K2's math in JAX: the XLA fallback's gated assembly in
    float32, then ``_bf16_chain``."""
    (uf, ug), (itf, ig) = ju, ji
    n_mod, h1 = jh['n_item_mods'] + 1, jh['h1']
    g = jax.nn.softmax(ug[:, None, :n_mod] + ig[None, :, :n_mod], axis=-1)
    x = g[:, :, 0, None] * uf[:, None, :]
    for m in range(n_mod - 1):
        x = x + g[:, :, m + 1, None] * itf[None, :, m * h1:(m + 1) * h1]
    return _bf16_chain(jh, x)


def k3_reference(jh, ju, ji):
    """Kernel K3's math in JAX, on JAX's own factored tables (T4 layout):
    Z from the float32 coefficients, the bf16 coefficients contracted
    against the bf16 tables in float32, then ``_bf16_chain``."""
    uf, a = jpm.factor_gated_user(jh, *ju)
    t4, igb = jpm.factor_gated_tables(jh, *ji)
    n_mod, h1 = jh['n_item_mods'] + 1, jh['h1']
    nblk, C = h1 // jpm.LANE, igb.shape[1]
    p0 = a[:, None, 0] * igb[None, 0, :]
    z = p0
    for m in range(1, n_mod):
        z = z + a[:, None, m] * igb[None, m, :]
    r = jnp.einsum('bm,kmcl->bckl',
                   a.astype(jnp.bfloat16).astype(jnp.float32),
                   t4.reshape(nblk, jpm.GATE_PAD, C, jpm.LANE)
                   .astype(jnp.float32)).reshape(a.shape[0], C, h1)
    x = (p0[..., None] * uf[:, None, :] + r) * (
        1.0 / jnp.maximum(z, 1e-30))[..., None]
    return _bf16_chain(jh, x)


def port_factored(th, tu, ti, compute_dtype):
    return tpm.pairwise_scores_gated_factored_plain(
        th, *tpm.factor_gated_user(th, *tu),
        *tpm.factor_gated_tables(th, *ti), compute_dtype)


# The bf16 plain versions against the Pallas kernels in interpret mode, one
# 16 x 128 tile. Relu (the flagship activation) is exact in any precision,
# so the rounding points are the same on both sides and only float32
# arithmetic order differs (and exp, from two libraries, by an ulp); that
# can move an assembled activation to the neighbouring bf16 value, which
# moves a score by ~1e-4 here: atol 2e-4, while the float32 plain versions
# are 8e-4 or more away. The other activations are evaluated by XLA's CPU
# bf16 arithmetic one operation at a time inside the chain, each result
# rounded to bf16, while the port and the CUDA kernels evaluate them in
# float32 and round once: a few bf16 steps carried through the chain,
# atol 2e-2 on scores of order 1. The rounding-reference test below pins
# those activations.
INTERPRET_TOL = {'relu': 2e-4}
# Against a JAX reference that rounds where the kernel does, only float32
# arithmetic order differs. A hidden activation may then land on the
# neighbouring bf16 value, moving its pair's score by up to ~6e-4 here:
# atol 1e-3. Such pairs are rare: at most 1% of the scores may differ by
# more than 1e-6, where the float32 plain version differs at 99% or more.
ROUNDING_TOL, AGREE, MAX_DIFFERING = 1e-3, 1e-6, 0.01


@pytest.mark.parametrize('variant', ['exact', 'factored'])
@pytest.mark.parametrize('final', FINALS)
@pytest.mark.parametrize('activation', ACTIVATIONS)
def test_plain_bf16_matches_pallas_interpret(activation, final, variant):
    jh, th = heads(activation, final)
    ju, ji, tu, ti = side_rows(jh)
    if variant == 'exact':
        ref = jpm.pallas_pairwise_scores_gated(
            jh, *ju, *ji, tile_users=16, tile_items=128, interpret=True)
        out = tpm.pairwise_scores_gated_plain(th, *tu, *ti, torch.bfloat16)
    else:
        ref = jpm.pallas_pairwise_scores_gated_factored(
            jh, *jpm.factor_gated_user(jh, *ju),
            *jpm.factor_gated_tables(jh, *ji), tile_users=16,
            tile_items=128, interpret=True)
        out = port_factored(th, tu, ti, torch.bfloat16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=INTERPRET_TOL.get(activation, 2e-2))


@pytest.mark.parametrize('variant', ['exact', 'factored'])
@pytest.mark.parametrize('final', FINALS)
@pytest.mark.parametrize('activation', ACTIVATIONS)
def test_plain_bf16_rounds_where_the_kernel_does(activation, final, variant):
    """Against a JAX reference with the kernel's rounding points, to
    ROUNDING_TOL, and equal to 1e-6 for all but MAX_DIFFERING of the pairs;
    the float32 plain version fails the second, so the test tells bf16
    from float32."""
    jh, th = heads(activation, final)
    ju, ji, tu, ti = side_rows(jh)
    if variant == 'exact':
        ref = np.asarray(k2_reference(jh, ju, ji))
        out, f32 = (tpm.pairwise_scores_gated_plain(th, *tu, *ti, dt)
                    for dt in (torch.bfloat16, torch.float32))
    else:
        ref = np.asarray(k3_reference(jh, ju, ji))
        out, f32 = (port_factored(th, tu, ti, dt)
                    for dt in (torch.bfloat16, torch.float32))
    np.testing.assert_allclose(out.numpy(), ref, atol=ROUNDING_TOL)
    assert np.mean(np.abs(out.numpy() - ref) > AGREE) <= MAX_DIFFERING
    assert np.mean(np.abs(f32.numpy() - ref) > AGREE) > 0.5


def test_wrappers_on_cpu():
    """CPU tensors take the float32 plain versions and launch nothing;
    other devices, unfolded heads, int8 heads and too many modalities
    raise."""
    jh, th = heads()
    _, _, tu, ti = side_rows(jh, B=3, C=5)
    fu = tpm.factor_gated_user(th, *tu)
    ft = tpm.factor_gated_tables(th, *ti)
    before = (tpm.pairwise_scores_gated.launches,
              tpm.pairwise_scores_gated_factored.launches)
    torch.testing.assert_close(tpm.pairwise_scores_gated(th, *tu, *ti),
                               tpm.pairwise_scores_gated_plain(th, *tu, *ti))
    torch.testing.assert_close(
        tpm.pairwise_scores_gated_factored(th, *fu, *ft),
        tpm.pairwise_scores_gated_factored_plain(th, *fu, *ft))
    assert (tpm.pairwise_scores_gated.launches,
            tpm.pairwise_scores_gated_factored.launches) == before
    meta = [t.to('meta') for t in tu + ti]
    with pytest.raises(ValueError, match='cuda or cpu'):
        tpm.pairwise_scores_gated(th, *meta)
    with pytest.raises(ValueError, match='b1 folded'):
        tpm.pairwise_scores_gated(dict(th, b1_folded=False), *tu, *ti)
    with pytest.raises(ValueError, match='qlayers'):
        tpm.pairwise_scores_gated_factored(dict(th, qlayers=[]), *fu, *ft)
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        tpm.pairwise_scores_gated_plain(th, *tu, *ti, torch.float16)
    with pytest.raises(ValueError, match='at most 8'):
        tpm.compute_user_side_gated(
            dict(th, wg_user=torch.zeros(EMB, 9)), torch.zeros(2, EMB))


# ----------------------------------------------------------------- scorer
N_CAT, ITEM_CHUNK, USER_CHUNK, K = 1000, 256, 64, 10


@pytest.fixture(scope='module')
def scorers():
    """JAX and port scorers on the same gated weights and items: 1,000
    items in 256-item chunks (the catalog pads to 1,024), 64-user blocks."""
    jmodel, variables, tmodel = make_pair(N_CAT, 'relu', 'sigmoid',
                                          fusion_type='gated')
    tables = item_tables(N_CAT)
    ids = np.arange(N_CAT).astype(str)
    jstore, tstore = JaxStore(N_CAT, ids), ItemFeatureStore(N_CAT, ids)
    jstore.tables.update(tables)
    tstore.tables.update(tables)
    kw = dict(item_chunk=ITEM_CHUNK, user_chunk=USER_CHUNK)
    out = {}
    for name, jkw, tkw in (
            ('exact', dict(gated_variant='exact'), {}),
            ('factored', dict(gated_variant='factored'),
             dict(gated_variant='factored')),
            ('generic', dict(fast_path=False), dict(fast_path=False))):
        out[name] = (JaxScorer(jmodel, variables, jstore, **kw, **jkw),
                     tsc.CatalogScorer(tmodel, tstore, **kw, **tkw,
                                       device='cpu'))
    return out


@pytest.fixture(scope='module')
def users():
    return np.random.default_rng(5).integers(0, N_USERS, 70).astype(np.int32)


@pytest.fixture(scope='module')
def seen():
    return np.random.default_rng(6).random((70, N_CAT)) < 0.05


def test_scorer_resolves_the_variant(scorers):
    js, ts = scorers['exact']
    assert ts.gated_variant == 'exact' == js.gated_variant  # CPU default
    assert scorers['factored'][1].gated_variant == 'factored'
    assert scorers['generic'][1].gated_variant is None
    assert ts._scan_tables is ts._item_fast
    T, igb = scorers['factored'][1]._scan_tables
    assert tuple(T.shape) == (1024, MI, 128) and T.dtype == torch.bfloat16
    np.testing.assert_allclose(ts._item_fast[0].numpy(),
                               np.asarray(js._item_fast[0]), atol=1e-5)
    np.testing.assert_allclose(ts._item_fast[1].numpy(),
                               np.asarray(js._item_fast[1]), atol=1e-5)


def test_scorer_variant_budget(scorers, monkeypatch):
    """An explicit 'factored' past the table budget raises at
    construction (no call switches variants later); None is 'exact'; other
    names raise."""
    _, ts = scorers['exact']
    monkeypatch.setattr(tsc.CatalogScorer, '_FACTORED_BYTES', 1024)
    with pytest.raises(ValueError, match='budget'):
        tsc.CatalogScorer(ts.model, ts.store, item_chunk=ITEM_CHUNK,
                          gated_variant='factored', device='cpu')
    assert tsc.CatalogScorer(ts.model, ts.store, item_chunk=ITEM_CHUNK,
                             device='cpu').gated_variant == 'exact'
    with pytest.raises(ValueError, match='gated_variant'):
        tsc.CatalogScorer(ts.model, ts.store, gated_variant='fast',
                          device='cpu')


@pytest.mark.parametrize('name', ['exact', 'generic'])
@pytest.mark.parametrize('with_seen', [False, True], ids=['all', 'seen'])
def test_top_k_matches_jax(scorers, users, seen, name, with_seen):
    """Exact gated (fast and generic paths) at float32 on both sides:
    scores atol 1e-5, top-k sets equal row for row."""
    js, ts = scorers[name]
    mask = seen if with_seen else None
    jv, ji = js.top_k(users, K, seen_mask=mask)
    tv, ti = ts.top_k(users, K, seen_mask=mask)
    assert tv.shape == (70, K) and ti.dtype == np.int32
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    for a, b in zip(ti, ji):
        assert set(a) == set(b)
    assert (ti < N_CAT).all()
    if with_seen:
        assert not seen[np.arange(70)[:, None], ti].any()


# The factored scorers: JAX's runs its Pallas kernel in interpret mode
# (bf16 chain), the port's CPU path the plain float32 chain on the same
# bf16 tables and coefficients. Scores differ by the bf16 chain's rounding,
# under 2e-3 here (the interpret-mode tests above put the two chains
# 8e-4 apart on one tile); the top-10 sets may swap near-tied items at the
# boundary: mean overlap >= 0.95.
FACTORED_TOL = 3e-3


def test_factored_top_k_matches_jax(scorers, users, seen):
    js, ts = scorers['factored']
    jv, ji = js.top_k(users, K, seen_mask=seen)
    tv, ti = ts.top_k(users, K, seen_mask=seen)
    np.testing.assert_allclose(tv, jv, atol=FACTORED_TOL)
    overlap = np.mean([len(set(a) & set(b)) / K for a, b in zip(ti, ji)])
    assert overlap >= 0.95
    assert not seen[np.arange(70)[:, None], ti].any()
    np.testing.assert_allclose(ts.score_full(users[:9]),
                               js.score_full(users[:9]), atol=FACTORED_TOL)


@pytest.mark.parametrize('name', ['exact', 'generic'])
def test_score_full_matches_jax(scorers, users, name):
    js, ts = scorers[name]
    out = ts.score_full(users)
    assert out.shape == (70, N_CAT)
    np.testing.assert_allclose(out, js.score_full(users), atol=1e-5)


@pytest.mark.parametrize('name', ['exact', 'factored', 'generic'])
def test_score_candidates_matches_jax(scorers, users, name):
    """Candidates take the exact float32 math in every variant."""
    js, ts = scorers[name]
    rng = np.random.default_rng(7)
    cands = rng.integers(0, N_CAT, (70, 20)).astype(np.int32)
    valid = rng.random((70, 20)) < 0.8
    out = ts.score_candidates(users, cands, valid)
    np.testing.assert_allclose(out, js.score_candidates(users, cands, valid),
                               atol=1e-5)
    assert (out[~valid] == -1e30).all()
