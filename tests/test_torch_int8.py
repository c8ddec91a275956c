"""int8 scoring in the port against the JAX package, on the CPU:
quantization and calibration, the plain int8 chain in float32 against the
XLA fallback with ``qlayers``, its bf16 mode against the Pallas kernels'
int8 mode in interpret mode (the kernels' rounding points), the int8
``CatalogScorer`` (concat, gated exact, gated factored) against JAX's, the
auto-precision gate, the flagship-width fidelity and the kernels' int8
tensors. Inputs come from numpy seeds and weights are converted from
Flax."""
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
from pixelrec_multimodal_tpu.ops import pairwise_mlp as jpm
from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.inference import scorer as tsc
from pixelrec_multimodal_tpu_torch.models.multimodal import (
    MultimodalRecommender,
)
from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
from tests._torch_port import EMB, item_tables, make_pair

N_ITEMS = 40
ACTIVATIONS = ['relu', 'gelu', 'tanh', 'leaky_relu', 'silu']
FINALS = ['sigmoid', 'tanh', 'none']
MI = 5  # item-side modalities of a gated model

# The port's int8 scores against JAX's on the same codes differ by the
# order of float32 sums (the last dot; the activations' ulps), ~1e-7. Where
# an input lies within an ulp of a code boundary, the two sides may pick
# neighbouring codes, which moves that pair's score by up to a few 1e-4:
# at most MAX_FLIPPED of the pairs may differ by more than AGREE, none by
# more than FLIP_TOL. Each test reports its count.
AGREE, MAX_FLIPPED, FLIP_TOL = 1e-5, 0.01, 1e-2


def assert_int8_close(out, ref, what=''):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    diff = np.abs(out - ref)
    flipped = int((diff > AGREE).sum())
    assert flipped <= MAX_FLIPPED * diff.size, \
        f'{what}: {flipped} of {diff.size} pairs past {AGREE}'
    assert diff.max() <= FLIP_TOL, (f'{what}: max diff {diff.max()} '
                                    f'({flipped} of {diff.size} past '
                                    f'{AGREE})')
    return flipped


@functools.lru_cache(maxsize=None)
def _heads(fusion, use_batch_norm):
    jmodel, variables, tmodel = make_pair(
        N_ITEMS, use_batch_norm=use_batch_norm, fusion_type=fusion)
    return (jpm.build_factorized_head(variables, jmodel),
            tpm.build_factorized_head(tmodel))


def heads(fusion='concatenate', activation='relu', final='sigmoid',
          use_batch_norm=True):
    """(JAX head, port head) of one small model with equal weights. The
    activations are the heads' own entries, so every pair of them shares
    the model's weights."""
    jh, th = _heads(fusion, use_batch_norm)
    acts = dict(activation=activation, final_activation=final)
    return dict(jh, **acts), dict(th, **acts)


def concat_rows(h1, B=16, C=128, seed=3):
    """Seeded (user_first, item_first) as JAX arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    uf = rng.standard_normal((B, h1)).astype(np.float32)
    itf = rng.standard_normal((C, h1)).astype(np.float32)
    return ((jnp.asarray(uf), jnp.asarray(itf)),
            (torch.from_numpy(uf), torch.from_numpy(itf)))


def gated_rows(jh, B=16, C=128, seed=3):
    """The JAX per-side rows ((uf, ug), (itf, ig)) of seeded towers, and
    the same arrays as torch tensors."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((C, MI, EMB)).astype(np.float32)
    users = rng.standard_normal((B, EMB)).astype(np.float32)
    ju = jpm.compute_user_side_gated(jh, jnp.asarray(users))
    ji = jpm.compute_item_side_gated(jh, jnp.asarray(feats))
    return (ju, ji, tuple(torch.from_numpy(np.array(a)) for a in ju),
            tuple(torch.from_numpy(np.array(a)) for a in ji))


def quantized(jh, th, jrows):
    """Both heads in int8 mode on the ranges JAX calibrates on ``jrows``
    (concat: (uf, itf); gated: (user side, item side)): JAX's qlayers from
    its quantize_mlp_chain, the port's from its own."""
    if jh['fusion'] == 'gated':
        ranges = jpm.calibrate_head_ranges_gated(jh, *jrows)
    else:
        ranges = jpm.calibrate_head_ranges(jh, *jrows)
    jq = dict(jh, qlayers=jpm.quantize_mlp_chain(jh, ranges))
    return jq, tpm.quantize_head(dict(th), ranges)


# ---------------------------------------------------------- quantization
@pytest.mark.parametrize('use_batch_norm', [True, False])
@pytest.mark.parametrize('fusion', ['concatenate', 'gated'])
def test_quantize_matches_jax(fusion, use_batch_norm):
    """On equal weights and ranges: wq equal (np.round half to even, then
    the clip), params within 1e-6 relative."""
    jh, th = heads(fusion, use_batch_norm=use_batch_norm)
    ranges = [(-0.37, 5.25)] * (len(jh['layers']) - 1)
    same = dict(th, layers=[(torch.from_numpy(np.array(w)),
                             torch.from_numpy(np.array(b)))
                            for w, b in jh['layers']])
    jq = jpm.quantize_mlp_chain(jh, ranges)
    tq = tpm.quantize_mlp_chain(same, ranges)
    assert len(tq) == len(jq) == 1
    for j, t in zip(jq, tq):
        assert t['wq'].dtype == torch.int8 and t['params'].dtype == \
            torch.float32
        np.testing.assert_array_equal(t['wq'].numpy(), np.asarray(j['wq']))
        np.testing.assert_allclose(t['params'].numpy(),
                                   np.asarray(j['params']), rtol=1e-6)


@pytest.mark.parametrize('fusion', ['concatenate', 'gated'])
def test_calibration_matches_jax(fusion):
    """Each hidden layer's input range through the float32 chain, within
    1e-5 relative (the matmuls and, for gated, the softmax, round in
    another order)."""
    jh, th = heads(fusion)
    if fusion == 'gated':
        ju, ji, tu, ti = gated_rows(jh, B=8, C=64)
        ref = jpm.calibrate_head_ranges_gated(jh, ju, ji)
        out = tpm.calibrate_head_ranges_gated(th, tu, ti)
    else:
        (juf, jitf), (tuf, titf) = concat_rows(jh['b1'].shape[0], 8, 64)
        ref = jpm.calibrate_head_ranges(jh, juf, jitf)
        out = tpm.calibrate_head_ranges(th, tuf, titf)
    assert len(out) == len(ref) == 1
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5)


# ------------------------------------------------ plain int8 chain, float32
@pytest.mark.parametrize('final', FINALS)
@pytest.mark.parametrize('activation', ACTIVATIONS)
def test_int8_f32_matches_xla(activation, final):
    """The float32 plain int8 chain == xla_pairwise_scores with qlayers."""
    jh, th = heads('concatenate', activation, final)
    jrows, trows = concat_rows(jh['b1'].shape[0], B=8, C=40)
    jq, tq = quantized(jh, th, jrows)
    ref = jpm.xla_pairwise_scores(jq, *jrows)
    out = tpm.pairwise_scores_plain(tq, *trows)
    assert out.dtype == torch.float32
    assert_int8_close(out.numpy(), ref, f'{activation}/{final}')


@pytest.mark.parametrize('final', FINALS)
@pytest.mark.parametrize('activation', ACTIVATIONS)
def test_int8_f32_gated_matches_xla(activation, final):
    """The float32 plain int8 chain after the exact gated assembly ==
    xla_pairwise_scores_gated with qlayers."""
    jh, th = heads('gated', activation, final)
    ju, ji, tu, ti = gated_rows(jh, B=8, C=40)
    jq, tq = quantized(jh, th, (ju, ji))
    ref = jpm.xla_pairwise_scores_gated(jq, *ju, *ji)
    out = tpm.pairwise_scores_gated_plain(tq, *tu, *ti)
    assert_int8_close(out.numpy(), ref, f'{activation}/{final}')


@pytest.mark.parametrize('fusion', ['concatenate', 'gated'])
def test_int8_candidates_match_xla(fusion):
    """Candidate scoring runs the int8 chain too (xla_candidate_scores and
    xla_candidate_scores_gated with qlayers)."""
    jh, th = heads(fusion, 'gelu', 'sigmoid')
    cands = np.random.default_rng(5).integers(0, 28, (4, 7))
    if fusion == 'gated':
        ju, ji, tu, ti = gated_rows(jh, B=4, C=28)
        jq, tq = quantized(jh, th, (ju, ji))
        ref = jpm.xla_candidate_scores_gated(jq, ju, ji[0][cands],
                                             ji[1][cands])
        out = tpm.candidate_scores_gated(tq, tu, ti[0][cands], ti[1][cands])
    else:
        (juf, jitf), (tuf, titf) = concat_rows(jh['b1'].shape[0], 4, 28)
        jq, tq = quantized(jh, th, (juf, jitf))
        ref = jpm.xla_candidate_scores(jq, juf, jitf[cands])
        out = tpm.candidate_scores(tq, tuf, titf[cands])
    assert out.shape == (4, 7)
    assert_int8_close(out.numpy(), ref)


# ------------------------------ bf16 mode against the Pallas int8 kernels
# The bf16-mode plain versions round the first-layer activations to bf16
# where K1, K2 and K3 round them, upcast them and quantize, as JAX's kernels
# do in int8 mode with compute_dtype=bfloat16 (one 16 x 128 tile, interpret
# mode); that differs from the float32 chain by ~5e-3 here, so the test
# tells the modes apart. K1 evaluates its activation in bf16 arithmetic in
# JAX and in float32 in the port (test_torch_pairwise_mlp.py), so K1q is
# held at relu, exact in both.
@pytest.mark.parametrize('final', FINALS)
def test_k1q_plain_bf16_matches_pallas_interpret(final):
    jh, th = heads('concatenate', 'relu', final)
    jrows, trows = concat_rows(jh['b1'].shape[0])
    jq, tq = quantized(jh, th, jrows)
    ref = jpm.pallas_pairwise_scores(jq, *jrows, tile_users=16,
                                     tile_items=128,
                                     compute_dtype=jnp.bfloat16,
                                     interpret=True)
    out = tpm.pairwise_scores_plain(tq, *trows, torch.bfloat16)
    assert_int8_close(out.numpy(), ref, final)
    f32 = tpm.pairwise_scores_plain(tq, *trows)
    assert np.abs(f32.numpy() - np.asarray(ref)).max() > 10 * AGREE


@pytest.mark.parametrize('variant', ['exact', 'factored'])
@pytest.mark.parametrize('activation,final', [
    ('relu', 'sigmoid'), ('relu', 'none'), ('gelu', 'tanh'),
    ('tanh', 'sigmoid'), ('leaky_relu', 'none'), ('silu', 'sigmoid')])
def test_gated_plain_bf16_matches_pallas_interpret(activation, final,
                                                   variant):
    """K2q and K3q: the gated assemblies evaluate the activation in float32
    and round once to bf16 on both sides."""
    jh, th = heads('gated', activation, final)
    ju, ji, tu, ti = gated_rows(jh)
    jq, tq = quantized(jh, th, (ju, ji))
    if variant == 'exact':
        ref = jpm.pallas_pairwise_scores_gated(
            jq, *ju, *ji, tile_users=16, tile_items=128,
            compute_dtype=jnp.bfloat16, interpret=True)
        out = tpm.pairwise_scores_gated_plain(tq, *tu, *ti, torch.bfloat16)
    else:
        ref = jpm.pallas_pairwise_scores_gated_factored(
            jq, *jpm.factor_gated_user(jq, *ju),
            *jpm.factor_gated_tables(jq, *ji), tile_users=16,
            tile_items=128, compute_dtype=jnp.bfloat16, interpret=True)
        out = tpm.pairwise_scores_gated_factored_plain(
            tq, *tpm.factor_gated_user(tq, *tu),
            *tpm.factor_gated_tables(tq, *ti), torch.bfloat16)
    assert_int8_close(out.numpy(), ref, f'{activation}/{final}')


# ----------------------------------------------------------------- scorer
N_CAT, ITEM_CHUNK, USER_CHUNK, K = 500, 256, 64, 10
# JAX's factored scan runs its Pallas kernel in interpret mode, in int8
# after a bf16 assembly; the port's CPU scan runs the float32 plain version
# (the CPU path of every wrapper), so the codes of the two differ where the
# bf16 rounding crosses a boundary: scores within FACTORED_TOL (1.2e-3
# measured here), top-10 sets overlapping by at least 0.95.
FACTORED_TOL = 3e-3


@pytest.fixture(scope='module')
def scorers():
    """JAX and port int8 scorers ('int8!') on the same weights and items:
    500 items in 256-item chunks, 64-user blocks; concat, gated exact and
    gated factored."""
    out = {}
    tables = item_tables(N_CAT)
    ids = np.arange(N_CAT).astype(str)
    for name, fusion, variant in (('concat', 'concatenate', None),
                                  ('exact', 'gated', 'exact'),
                                  ('factored', 'gated', 'factored')):
        jmodel, variables, tmodel = make_pair(N_CAT, 'relu', 'sigmoid',
                                              fusion_type=fusion)
        jstore, tstore = JaxStore(N_CAT, ids), ItemFeatureStore(N_CAT, ids)
        jstore.tables.update(tables)
        tstore.tables.update(tables)
        kw = dict(item_chunk=ITEM_CHUNK, user_chunk=USER_CHUNK,
                  precision='int8!')
        if variant:
            kw['gated_variant'] = variant
        out[name] = (JaxScorer(jmodel, variables, jstore, **kw),
                     tsc.CatalogScorer(tmodel, tstore, **kw, device='cpu'))
    return out


@pytest.fixture(scope='module')
def users():
    return np.random.default_rng(5).integers(0, 50, 70).astype(np.int32)


@pytest.mark.parametrize('name', ['concat', 'exact', 'factored'])
def test_scorer_quantizes_like_jax(scorers, name):
    """The same calibration sample and the same quantization: wq equal,
    params within 1e-5 relative (the ranges differ by float32 ulps of the
    matmuls and, for gated, the softmax); head['kernel'] is the int8
    mode's."""
    js, ts = scorers[name]
    assert ts.precision == js.precision == 'int8'
    assert ts._head['kernel']['int8']
    for j, t in zip(js._head['qlayers'], ts._head['qlayers']):
        np.testing.assert_array_equal(t['wq'].numpy(), np.asarray(j['wq']))
        np.testing.assert_allclose(t['params'].numpy(),
                                   np.asarray(j['params']), rtol=1e-5)


@pytest.mark.parametrize('name', ['concat', 'exact', 'factored'])
def test_scorer_score_full_and_top_k_match_jax(scorers, users, name):
    js, ts = scorers[name]
    full = ts.score_full(users)
    assert full.shape == (70, N_CAT)
    jv, ji = js.top_k(users, K)
    tv, ti = ts.top_k(users, K)
    assert ti.dtype == np.int32 and (ti >= 0).all() and (ti < N_CAT).all()
    overlap = np.mean([len(set(a) & set(b)) / K for a, b in zip(ti, ji)])
    if name == 'factored':
        np.testing.assert_allclose(full, js.score_full(users),
                                   atol=FACTORED_TOL)
        np.testing.assert_allclose(tv, jv, atol=FACTORED_TOL)
        assert overlap >= 0.95
    else:
        assert_int8_close(full, js.score_full(users), 'score_full')
        assert_int8_close(tv, jv, 'top_k values')
        for a, b, vals in zip(ti, ji, jv):
            clear = vals > vals[-1] + FLIP_TOL  # not tied with the boundary
            assert set(b[clear]) <= set(a)


@pytest.mark.parametrize('name', ['concat', 'exact', 'factored'])
def test_scorer_score_candidates_match_jax(scorers, users, name):
    """Candidates take the exact float32 int8 math in every variant."""
    js, ts = scorers[name]
    rng = np.random.default_rng(7)
    cands = rng.integers(0, N_CAT, (70, 20)).astype(np.int32)
    valid = rng.random((70, 20)) < 0.8
    out = ts.score_candidates(users, cands, valid)
    ref = js.score_candidates(users, cands, valid)
    assert (out[~valid] == -1e30).all()
    assert_int8_close(out[valid], ref[valid], 'score_candidates')


# ------------------------------------------------------------------- gate
def small_scorer(fusion='concatenate', hidden=(64, 32), **kw):
    model = MultimodalRecommender(
        n_users=20, n_items=64, n_tags=3, num_numerical_features=2,
        embedding_dim=16, vision_feature_dim=8, language_feature_dim=8,
        use_contrastive=False, fusion_hidden_dims=hidden,
        fusion_type=fusion, num_attention_heads=2, dropout_rate=0.0,
        generator=torch.Generator().manual_seed(0), device='cpu')
    rng = np.random.default_rng(1)
    store = ItemFeatureStore(64, np.arange(64).astype(str))
    store.tables.update({
        'tag_idx': rng.integers(0, 3, 64).astype(np.int32),
        'numerical': rng.standard_normal((64, 2), np.float32),
        'vision_emb': rng.standard_normal((64, 8), np.float32),
        'language_emb': rng.standard_normal((64, 8), np.float32)})
    return tsc.CatalogScorer(model, store, device='cpu', **kw)


def test_precision_gate(monkeypatch, capsys):
    """'int8' below the flip point warns on stderr, naming the flip point
    and PERF.md, and serves bf16; at or above it quantizes; 'int8!'
    quantizes whatever the head."""
    rho = tpm.int8_chain_flops_per_lane(small_scorer()._head)
    assert rho == 2 * 128 * 128 / 128  # one hidden layer, 128 -> 128
    monkeypatch.setattr(tsc, 'INT8_MIN_CHAIN_FLOPS_PER_LANE', rho + 1)
    monkeypatch.setattr(tsc, 'INT8_MIN_CHAIN_FLOPS_PER_LANE_CONCAT', rho + 1)
    below = small_scorer(precision='int8')
    err = capsys.readouterr().err
    assert 'flip point' in err and 'PERF.md' in err and 'int8!' in err
    assert below.precision == 'bf16' and 'qlayers' not in below._head
    assert not below._head['kernel']['int8']
    forced = small_scorer(precision='int8!')
    assert forced.precision == 'int8' and forced._head['kernel']['int8']
    assert capsys.readouterr().err == ''
    monkeypatch.setattr(tsc, 'INT8_MIN_CHAIN_FLOPS_PER_LANE', rho)
    engaged = small_scorer('gated', precision='int8')
    assert engaged.precision == 'int8' and engaged._head['qlayers']
    assert capsys.readouterr().err == ''
    v, i = engaged.top_k(np.arange(5), 4)
    assert v.shape == i.shape == (5, 4) and (i >= 0).all()


def test_precision_gate_by_fusion(monkeypatch, capsys):
    """A concatenate head passes the gate at its own flip point
    (``INT8_MIN_CHAIN_FLOPS_PER_LANE_CONCAT``), a gated head at the gated
    one; each is independent of the other. Since K1q, K2q and K3q run the
    s8 wgmma chain, the H100 measured every int8 mode the faster on every
    chain (from 64, the least ratio of any head), the flagship's
    included."""
    flagship = 2 * (512 * 256 + 256 * 128) / 512  # chain [512, 256, 128]
    assert tpm.INT8_MIN_CHAIN_FLOPS_PER_LANE <= 64 < flagship
    assert tpm.INT8_MIN_CHAIN_FLOPS_PER_LANE_CONCAT <= flagship
    rho = tpm.int8_chain_flops_per_lane(small_scorer()._head)
    monkeypatch.setattr(tsc, 'INT8_MIN_CHAIN_FLOPS_PER_LANE', rho)
    monkeypatch.setattr(tsc, 'INT8_MIN_CHAIN_FLOPS_PER_LANE_CONCAT', rho + 1)
    concat = small_scorer(precision='int8')
    err = capsys.readouterr().err
    assert f'< {rho + 1:.0f}' in err and 'flip point' in err
    assert concat.precision == 'bf16' and 'qlayers' not in concat._head
    assert small_scorer('gated', precision='int8').precision == 'int8'
    monkeypatch.setattr(tsc, 'INT8_MIN_CHAIN_FLOPS_PER_LANE', rho + 1)
    monkeypatch.setattr(tsc, 'INT8_MIN_CHAIN_FLOPS_PER_LANE_CONCAT', rho)
    capsys.readouterr()
    assert small_scorer(precision='int8').precision == 'int8'
    assert capsys.readouterr().err == ''
    assert small_scorer('gated', precision='int8').precision == 'bf16'


def test_precision_gate_routes_the_flagship_heads(capsys):
    """With the constants as the code has them, precision='int8' at the
    flagship widths [512, 256, 128] (640 hidden-chain operations per lane)
    quantizes a gated head and a concatenate head, whose int8 kernels the
    H100 measured the faster from 64, with no warning."""
    gated = small_scorer('gated', hidden=(512, 256, 128), precision='int8')
    assert tpm.int8_chain_flops_per_lane(gated._head) == 640
    assert gated.precision == 'int8' and gated._head['kernel']['int8']
    assert capsys.readouterr().err == ''
    concat = small_scorer(hidden=(512, 256, 128), precision='int8')
    assert tpm.int8_chain_flops_per_lane(concat._head) == 640
    assert concat.precision == 'int8' and concat._head['kernel']['int8']
    assert concat._head['qlayers']
    assert capsys.readouterr().err == ''


def test_precision_refusals():
    """int8 takes a fused concatenate or gated head; attention,
    fast_path=False and unknown precisions raise ValueError, as in JAX. A
    head without hidden layers has nothing to quantize: 'int8!' raises."""
    with pytest.raises(ValueError, match='int8'):
        small_scorer('attention', precision='int8!')
    with pytest.raises(ValueError, match='int8'):
        small_scorer(precision='int8', fast_path=False)
    with pytest.raises(ValueError, match='precision'):
        small_scorer(precision='fp16')
    with pytest.raises(ValueError, match='qlayers'):
        small_scorer(hidden=(32,), precision='int8!').top_k([0], 2)


# ----------------------------------------------------------- fidelity
def test_flagship_width_fidelity():
    """The port's int8 ranking at the flagship head width ([512, 256, 128]),
    on the data of the JAX package's test_flagship_width_fidelity (same
    seed, same draws): top-50 set agreement with the float32 chain >= 0.9
    over 64 users x 4,096 items, scores within 0.05."""
    rng = np.random.default_rng(11)
    h1 = 512
    layers = []
    prev = h1
    for width in (256, 128):
        layers.append((rng.standard_normal((prev, width)).astype(np.float32)
                       * 0.05,
                       rng.standard_normal(width).astype(np.float32) * 0.05))
        prev = width
    w_last = np.zeros((prev, 128), np.float32)
    w_last[:, 0] = rng.standard_normal(prev) * 0.05
    layers.append((w_last, np.zeros(128, np.float32)))
    head = {'layers': [(torch.from_numpy(w), torch.from_numpy(b))
                       for w, b in layers],
            'activation': 'relu', 'final_activation': 'sigmoid',
            'b1': torch.zeros(h1), 'b1_folded': True}
    B, C = 64, 4096
    uf = torch.from_numpy(rng.standard_normal((B, h1)).astype(np.float32)) \
        * 0.5
    itf = torch.from_numpy(rng.standard_normal((C, h1)).astype(np.float32)) \
        * 0.5
    ranges = tpm.calibrate_head_ranges(head, uf[:16], itf[:512])
    qhead = tpm.quantize_head(dict(head), ranges)
    ref = torch.cat([tpm.pairwise_scores_plain(head, uf, itf[c:c + 1024])
                     for c in range(0, C, 1024)], dim=1).numpy()
    q = torch.cat([tpm.pairwise_scores_plain(qhead, uf, itf[c:c + 1024])
                   for c in range(0, C, 1024)], dim=1).numpy()
    k = 50
    top_r = np.argsort(-ref, axis=1)[:, :k]
    top_q = np.argsort(-q, axis=1)[:, :k]
    agree = np.mean([len(set(a) & set(b)) / k for a, b in zip(top_r, top_q)])
    assert agree >= 0.9, agree
    assert np.max(np.abs(q - ref)) < 0.05


# ------------------------------------------------ the kernels' int8 tensors
def test_quantize_head_replaces_the_bf16_chain():
    """build_factorized_head caches the bf16 chain in head['kernel'];
    quantize_head rebuilds it in the int8 mode's layout (wq transposed to
    [N, K], (inv_a, off) slots, then out_scale and bias_eff, w_last
    unrounded), and a head given qlayers without it never reaches the
    kernels with the bf16 chain (_chain_on rebuilds)."""
    jh, th = heads('concatenate', 'gelu', 'tanh')
    jrows, _ = concat_rows(jh['b1'].shape[0])
    ranges = jpm.calibrate_head_ranges(jh, *jrows)
    assert not th['kernel']['int8']
    stale = dict(th, qlayers=tpm.quantize_mlp_chain(th, ranges))
    assert not stale['kernel']['int8']  # the copied bf16 cache
    assert tpm._chain_on(stale, torch.device('cpu'))['int8']
    q = tpm.quantize_head(dict(th), ranges)
    chain = q['kernel']
    assert chain['int8'] and chain['n_hidden'] == 1
    assert chain['widths'].tolist() == [128, 128]
    (ql,), (w_last, b_last) = q['qlayers'], q['layers'][-1]
    assert chain['w'].dtype == torch.int8
    torch.testing.assert_close(chain['w'], ql['wq'].t().reshape(-1),
                               rtol=0, atol=0)
    p = ql['params']
    assert chain['b'][:2].tolist() == p[2, :2].tolist()
    assert not chain['b'][2:2 * tpm.MAX_HIDDEN].any()
    torch.testing.assert_close(chain['b'][2 * tpm.MAX_HIDDEN:],
                               torch.cat([p[0], p[1]]), rtol=0, atol=0)
    torch.testing.assert_close(chain['w_last'], w_last[:, 0], rtol=0, atol=0)
    assert chain['w_last'].dtype == torch.float32
    assert chain['b_last'].tolist() == [b_last[0].item()]
    assert (chain['act'], chain['final']) == (1, 1)


def test_int8_heads_the_kernels_do_not_take():
    """qlayers must match the hidden layers one to one, with widths that
    are multiples of 32; the CPU wrappers run the float32 int8 chain and
    launch nothing."""
    jh, th = heads()
    jrows, trows = concat_rows(jh['b1'].shape[0], B=3, C=5)
    _, tq = quantized(jh, th, jrows)
    before = (tpm.pairwise_scores.launches, tpm.pairwise_scores.launches_int8)
    torch.testing.assert_close(tpm.pairwise_scores(tq, *trows),
                               tpm.pairwise_scores_plain(tq, *trows))
    assert (tpm.pairwise_scores.launches,
            tpm.pairwise_scores.launches_int8) == before
    with pytest.raises(ValueError, match='qlayers'):
        tpm.pairwise_scores(dict(tq, qlayers=tq['qlayers'] * 2), *trows)
    w, b = tq['layers'][0]
    narrow = dict(tq, layers=[(w[:, :48], b[:48]),
                              (tq['layers'][1][0][:48], tq['layers'][1][1])])
    narrow['qlayers'] = tpm.quantize_mlp_chain(narrow, [(0.0, 1.0)])
    with pytest.raises(ValueError, match='multiples of 32'):
        tpm.pairwise_scores_plain(narrow, *trows)
    with pytest.raises(ValueError, match='multiples of 32'):
        tpm.kernel_chain(narrow)


@pytest.mark.parametrize('k', [32, 1024, 1056])
def test_int8_product_is_exact(k):
    """The plain versions' integer product equals the int64 one: in float32
    while K * 128 * 127 < 2**24 (K <= 1032, every partial sum an exact
    integer), in float64 beyond."""
    rng = np.random.default_rng(k)
    codes = torch.from_numpy(rng.integers(-128, 128, (64, k))).float()
    wq = torch.from_numpy(rng.integers(-127, 128, (k, 96)).astype(np.int8))
    exact = codes.long() @ wq.long()
    assert torch.equal(tpm._int8_product(codes, wq), exact.float())
    assert exact.abs().max() > 2 ** 16  # sums far from any rounding slack


def _unswizzled_int8(packed, widths):
    """The int8 chain's packed weights (``tpm.wgmma_weights``) read back by
    hand, layer by layer, as the s8 wgmma chain's descriptors read them:
    tile (k slice ks of 128 codes, column group g of 64) at (ks * N64 / 64
    + g) * 8,192 bytes past the layer's offset (layers of N64 x K128
    bytes), row n of a tile 128 bytes whose 16-byte chunk c lies at c ^ n
    % 8. Returns each layer's [N64, K128] matrix, and every byte's place
    once."""
    out, seen, off = [], [], 0
    for k, n in zip(widths[:-1], widths[1:]):
        k128, n64 = -(-k // 128) * 128, -(-n // 64) * 64
        nn, kk = np.meshgrid(np.arange(n64), np.arange(k128), indexing='ij')
        idx = (off + ((kk // 128) * (n64 // 64) + nn // 64) * 8192
               + (nn % 64) * 128 + ((((kk % 128) // 16) ^ (nn % 8)) * 16)
               + kk % 16)
        out.append(packed[idx])
        seen.append(idx.reshape(-1))
        off += k128 * n64
    return out, np.concatenate(seen), off


@pytest.mark.parametrize('widths', [(96, 64, 32), (128, 256),
                                    (64, 32, 96, 32), (512, 256, 128),
                                    (1024, 512, 256)])
def test_int8_wgmma_weights_layout(widths):
    """``tpm.wgmma_weights`` packs an int8 chain (wq^T [N, K] per layer,
    back to back) for the s8 wgmma chain: every tile, its swizzle undone
    here, equals wq^T, every pad byte (columns past N, codes past K) is
    zero, and every byte of the packing has one place. Built once per
    chain dict, anew for a dict whose ``w`` changed."""
    rng = np.random.default_rng(len(widths) * 1000 + widths[0])
    wqs = [rng.integers(-127, 128, (k, n)).astype(np.int8)
           for k, n in zip(widths[:-1], widths[1:])]
    chain = {'int8': True, 'widths': np.asarray(widths, np.int32),
             'w': torch.cat([torch.from_numpy(w.T.copy()).reshape(-1)
                             for w in wqs])}
    packed = tpm.wgmma_weights(chain)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert tpm.wgmma_weights(chain) is packed
    layers, seen, size = _unswizzled_int8(packed.numpy(), widths)
    assert packed.numel() == size
    assert np.array_equal(np.sort(seen), np.arange(size))
    for got, wq in zip(layers, wqs):
        k, n = wq.shape
        np.testing.assert_array_equal(got[:n, :k], wq.T)
        assert not got[n:].any() and not got[:, k:].any()
    other = dict(chain, w=chain['w'].neg())
    assert tpm.wgmma_weights(other) is not packed
    np.testing.assert_array_equal(tpm.wgmma_weights(other).numpy(),
                                  packed.neg().numpy())


def test_int8_wgmma_weights_of_a_quantized_gated_head():
    """A quantized gated head's int8 chain (K2q's and K3q's) packs its
    ``qlayers``' wq as the layout says; the bf16 chain's packing of the
    same head is another (it is not reused for the int8 mode)."""
    jh, th = heads('gated', 'gelu', 'tanh')
    ju, ji, _, _ = gated_rows(jh)
    _, tq = quantized(jh, th, (ju, ji))
    chain = tq['kernel']
    widths = [int(w) for w in chain['widths']]
    packed = tpm.wgmma_weights(chain)
    assert packed.dtype == torch.int8 and chain['w_wgmma'] is packed
    layers, _, size = _unswizzled_int8(packed.numpy(), widths)
    assert packed.numel() == size
    for got, q in zip(layers, tq['qlayers']):
        k, n = q['wq'].shape
        np.testing.assert_array_equal(got[:n, :k], q['wq'].t().numpy())
        assert not got[n:].any() and not got[:, k:].any()
    assert tpm.wgmma_weights(tpm.kernel_chain(th)).dtype == torch.bfloat16


def test_int8_wgmma_weights_of_a_quantized_concat_head():
    """A quantized concat head's int8 chain (K1q's, which runs the s8 wgmma
    chain at 128 and 64 rows) packs its ``qlayers``' wq as the layout
    says, ``wq`` JAX's bit for bit; the bf16 chain's packing of the same
    head is another (it is not reused for the int8 mode)."""
    jh, th = heads('concatenate', 'gelu', 'sigmoid')
    jrows, _ = concat_rows(jh['b1'].shape[0])
    jq, tq = quantized(jh, th, jrows)
    chain = tq['kernel']
    widths = [int(w) for w in chain['widths']]
    assert widths == [th['b1'].shape[0]] + [q['wq'].shape[1]
                                            for q in tq['qlayers']]
    packed = tpm.wgmma_weights(chain)
    assert packed.dtype == torch.int8 and chain['w_wgmma'] is packed
    layers, seen, size = _unswizzled_int8(packed.numpy(), widths)
    assert packed.numel() == size
    assert np.array_equal(np.sort(seen), np.arange(size))
    for got, q, jqq in zip(layers, tq['qlayers'], jq['qlayers']):
        k, n = q['wq'].shape
        np.testing.assert_array_equal(got[:n, :k], np.asarray(jqq['wq']).T)
        assert not got[n:].any() and not got[:, k:].any()
    assert tpm.wgmma_weights(tpm.kernel_chain(th)).dtype == torch.bfloat16
