"""The port's CUDA kernels (K1 concat, K2 exact gated, K3 factored gated,
and their int8 modes K1q, K2q, K3q; K4 stream attention, K5 gram
attention, K6 the attention cascade's token-0 screen) and its scorer, int8
and the attention cascade included, on a card.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` because the suite's conftest.py sets JAX up). Without a
CUDA device every test here skips: the kernels have no CPU mode. Inputs
come from numpy and torch seeds; each test states its tolerance.
"""
import copy

import numpy as np
import pytest
import torch

from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
from pixelrec_multimodal_tpu_torch.models.multimodal import (
    MultimodalRecommender,
)
from pixelrec_multimodal_tpu_torch.ops import attention_cascade as tac
from pixelrec_multimodal_tpu_torch.ops import attention_scorer as tas
from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
from pixelrec_multimodal_tpu_torch.ops.topk import NEG_INF

pytestmark = pytest.mark.cuda

N_USERS, N_ITEMS, N_TAGS = 50, 1000, 7
EMB, VISION, LANGUAGE, NUMERICAL = 32, 128, 64, 4
# Kernel against pairwise_scores_plain(bfloat16), relative to
# max(1, |score|): the same rounding points, float32 sums in another order,
# so a hidden activation may land one bf16 step (2**-8) away.
KERNEL_TOL = 2e-3
# The card's bf16 path against the CPU's float32 path: bf16 rounding of
# the assembly and of each hidden output, carried through the chain. A
# loose check that catches wrong rows, chunks or masks, not rounding.
F32_TOL = 5e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


def make_model(activation='relu', final='sigmoid', fusion='concatenate',
               emb=EMB, heads=4):
    """A small model on the CPU, BatchNorm statistics non-trivial."""
    gen = torch.Generator().manual_seed(0)
    model = MultimodalRecommender(
        n_users=N_USERS, n_items=N_ITEMS, n_tags=N_TAGS,
        num_numerical_features=NUMERICAL, embedding_dim=emb,
        vision_feature_dim=VISION, language_feature_dim=LANGUAGE,
        use_contrastive=False, fusion_hidden_dims=(64, 32),
        fusion_activation=activation, final_activation=final,
        fusion_type=fusion, num_attention_heads=heads, dropout_rate=0.0,
        generator=gen, device='cpu')
    with torch.no_grad():
        for i in range(2):
            bn = getattr(model.prediction_network, f'BatchNorm_{i}')
            n = bn.num_features
            bn.running_mean.copy_(torch.randn(n, generator=gen) * 0.3)
            bn.running_var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)
    return model


def head_on(head, device):
    return {k: ([(w.to(device), b.to(device)) for w, b in v]
                if k == 'layers' else v.to(device) if torch.is_tensor(v)
                else v) for k, v in head.items()}


def rows(h1, B, C, device, seed=3):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((B, h1), np.float32))
            .to(device),
            torch.from_numpy(rng.standard_normal((C, h1), np.float32))
            .to(device))


def store():
    rng = np.random.default_rng(1)
    s = ItemFeatureStore(N_ITEMS, np.arange(N_ITEMS).astype(str))
    s.tables.update({
        'tag_idx': rng.integers(0, N_TAGS, N_ITEMS).astype(np.int32),
        'numerical': rng.standard_normal((N_ITEMS, NUMERICAL), np.float32),
        'vision_emb': rng.standard_normal((N_ITEMS, VISION), np.float32),
        'language_emb': rng.standard_normal((N_ITEMS, LANGUAGE), np.float32),
    })
    return s


@pytest.mark.parametrize('final', ['sigmoid', 'tanh', 'none'])
@pytest.mark.parametrize('activation', list(tpm.ACTIVATIONS))
def test_kernel_matches_bf16_plain(dev, activation, final):
    """One launch on a ragged 37 x 301 block (not a tile multiple)."""
    head = head_on(tpm.build_factorized_head(make_model(activation, final)),
                   dev)
    uf, itf = rows(head['b1'].shape[0], 37, 301, dev)
    before = tpm.pairwise_scores.launches
    out = tpm.pairwise_scores(head, uf, itf)
    torch.cuda.synchronize()
    assert tpm.pairwise_scores.launches == before + 1
    ref = tpm.pairwise_scores_plain(head, uf, itf, torch.bfloat16)
    assert out.shape == (37, 301) and torch.isfinite(out).all()
    tol = KERNEL_TOL * max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= tol


def test_kernel_rejects_what_it_does_not_take(dev):
    head = head_on(tpm.build_factorized_head(make_model()), dev)
    h1 = head['b1'].shape[0]
    uf, itf = rows(h1, 8, 32, dev)
    before = tpm.pairwise_scores.launches
    for bad_uf, bad_itf in ((uf.double(), itf), (uf, itf[:, :h1 - 16]),
                            (uf.t().contiguous().t(), itf),
                            (uf, itf.cpu())):
        with pytest.raises(ValueError):
            tpm.pairwise_scores(head, bad_uf, bad_itf)
    assert tpm.pairwise_scores.launches == before


def test_scorer_top_k_on_card(dev):
    """top_k through the kernel against the plain bf16 scores of the same
    tables (values within the kernel tolerance, top-10 sets equal but for
    near-ties at the boundary) and against the CPU float32 scorer (values
    within F32_TOL). 70 users in 64-user blocks, 1,000 items in 256-item
    chunks: 2 x 4 launches."""
    model = make_model()
    users = np.random.default_rng(5).integers(0, N_USERS, 70).astype(
        np.int32)
    seen = np.random.default_rng(6).random((70, N_ITEMS)) < 0.05
    k = 10
    gpu = CatalogScorer(copy.deepcopy(model), store(), item_chunk=256,
                        user_chunk=64, device=dev)
    cpu = CatalogScorer(model, store(), item_chunk=256, user_chunk=64,
                        device='cpu')
    before = tpm.pairwise_scores.launches
    v, i = gpu.top_k(users, k, seen_mask=seen)
    assert tpm.pairwise_scores.launches == before + 8
    assert not seen[np.arange(70)[:, None], i].any()
    with torch.no_grad():
        uf = gpu._fast_user_side(torch.from_numpy(
            users.astype(np.int64)).to(dev))[0]
        ref = tpm.pairwise_scores_plain(gpu._head, uf,
                                        gpu._item_fast[0][:N_ITEMS],
                                        torch.bfloat16)
    ref[torch.from_numpy(seen).to(dev)] = NEG_INF
    rv, ri = (t.cpu().numpy() for t in torch.topk(ref, k, dim=1))
    tol = KERNEL_TOL * max(1.0, float(np.abs(rv).max()))
    np.testing.assert_allclose(v, rv, atol=tol)
    for a, b, vals in zip(i, ri, rv):
        clear = vals > vals[-1] + 2 * tol  # not tied with the boundary
        assert set(b[clear]) <= set(a)
    np.testing.assert_allclose(v, cpu.top_k(users, k, seen_mask=seen)[0],
                               atol=F32_TOL)


def test_scorer_score_full_and_candidates_on_card(dev):
    """score_full goes through the kernel: against the plain bf16 scores
    within the kernel tolerance, against the CPU's float32 within F32_TOL.
    score_candidates is the float32 chain on both devices, TF32 off: atol
    1e-4, float32 sums in another order through the tower and the three
    Dense layers."""
    model = make_model('gelu', 'sigmoid')
    users = np.arange(20, dtype=np.int32)
    gpu = CatalogScorer(copy.deepcopy(model), store(), item_chunk=256,
                        user_chunk=16, device=dev)
    cpu = CatalogScorer(model, store(), item_chunk=256, user_chunk=16,
                        device='cpu')
    full = gpu.score_full(users)
    assert full.shape == (20, N_ITEMS)
    with torch.no_grad():
        uf = gpu._fast_user_side(torch.from_numpy(
            users.astype(np.int64)).to(dev))[0]
        ref = tpm.pairwise_scores_plain(gpu._head, uf,
                                        gpu._item_fast[0][:N_ITEMS],
                                        torch.bfloat16).cpu().numpy()
    np.testing.assert_allclose(
        full, ref, atol=KERNEL_TOL * max(1.0, float(np.abs(ref).max())))
    np.testing.assert_allclose(full, cpu.score_full(users), atol=F32_TOL)
    rng = np.random.default_rng(7)
    cands = rng.integers(0, N_ITEMS, (20, 12)).astype(np.int32)
    valid = rng.random((20, 12)) < 0.8
    np.testing.assert_allclose(gpu.score_candidates(users, cands, valid),
                               cpu.score_candidates(users, cands, valid),
                               atol=1e-4)


# ------------------------------------------------------------ gated fusion
def gated_inputs(head, B, C, device, seed=4):
    """Seeded gated rows for a [B] x [C] block on ``device``: the exact
    variant's (uf, ug, itf, ig) and the factored variant's (uf, a, T, igb),
    built from the same towers."""
    rng = np.random.default_rng(seed)
    d, mi = head['w_fused'].shape[0], head['n_item_mods']
    users = torch.from_numpy(rng.standard_normal((B, d), np.float32))
    feats = torch.from_numpy(rng.standard_normal((C, mi, d), np.float32))
    cpu = head_on(head, 'cpu')
    exact = (tpm.compute_user_side_gated(cpu, users)
             + tpm.compute_item_side_gated(cpu, feats))
    factored = (tpm.factor_gated_user(cpu, *exact[:2])
                + tpm.factor_gated_tables(cpu, *exact[2:]))
    return ([t.to(device) for t in exact], [t.to(device) for t in factored])


# The gated kernels against their plain bf16 versions. The assembly rounds
# where the plain version does, operation for operation, so nearly every
# pair agrees to float32 rounding; a few differ where a hidden activation
# lands on the neighbouring bf16 value (the tensor-core products are summed
# in another order), each such flip moving its score by a few 1e-3 (3.0e-3
# in this test's gelu cases on an H100). So: at most
# MAX_DIFFERING of the pairs differ by more than AGREE (the float32 plain
# version differs in over 99%), and none by more than FLIP_TOL, relative to
# max(1, |score|).
AGREE, MAX_DIFFERING, FLIP_TOL = 1e-6, 0.01, 1e-2

GATED = {'exact': (tpm.pairwise_scores_gated,
                   tpm.pairwise_scores_gated_plain),
         'factored': (tpm.pairwise_scores_gated_factored,
                      tpm.pairwise_scores_gated_factored_plain)}


@pytest.mark.parametrize('variant', ['exact', 'factored'])
@pytest.mark.parametrize('final', ['sigmoid', 'tanh', 'none'])
@pytest.mark.parametrize('activation', list(tpm.ACTIVATIONS))
def test_gated_kernels_match_bf16_plain(dev, activation, final, variant):
    """K2 and K3, one launch each on a ragged 37 x 301 block, against their
    plain bf16 versions (the same rounding points; AGREE, MAX_DIFFERING,
    FLIP_TOL)."""
    head = head_on(tpm.build_factorized_head(
        make_model(activation, final, 'gated')), dev)
    exact, factored = gated_inputs(head, 37, 301, dev)
    args = exact if variant == 'exact' else factored
    kernel, plain = GATED[variant]
    before = kernel.launches
    out = kernel(head, *args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = plain(head, *args, compute_dtype=torch.bfloat16)
    assert out.shape == (37, 301) and torch.isfinite(out).all()
    scale = max(1.0, ref.abs().max().item())
    diff = (out - ref).abs()
    assert (diff > AGREE * scale).float().mean().item() <= MAX_DIFFERING
    assert diff.max().item() <= FLIP_TOL * scale


def test_gated_kernels_reject_what_they_do_not_take(dev):
    head = head_on(tpm.build_factorized_head(make_model(fusion='gated')), dev)
    (uf, ug, itf, ig), (_, a, T, igb) = gated_inputs(head, 8, 32, dev)
    launches = (tpm.pairwise_scores_gated.launches,
                tpm.pairwise_scores_gated_factored.launches)
    for bad in ((uf.double(), ug, itf, ig), (uf, ug[:, :6], itf, ig),
                (uf, ug, itf[:, :-16], ig), (uf, ug, itf, ig[:7]),
                (uf, ug, itf.t().contiguous().t(), ig),
                (uf, ug, itf.cpu(), ig)):
        with pytest.raises(ValueError):
            tpm.pairwise_scores_gated(head, *bad)
    for bad in ((uf, a, T.float(), igb), (uf, a, T[:, :-1], igb),
                (uf, a[:4], T, igb), (uf, a, T, igb.cpu())):
        with pytest.raises(ValueError):
            tpm.pairwise_scores_gated_factored(head, *bad)
    with pytest.raises(ValueError, match='b1 folded'):
        tpm.pairwise_scores_gated(dict(head, b1_folded=False), uf, ug, itf,
                                  ig)
    with pytest.raises(ValueError, match='qlayers'):
        tpm.pairwise_scores_gated_factored(dict(head, qlayers=[]), uf, a, T,
                                           igb)
    with pytest.raises(ValueError, match='modalities'):
        tpm.pairwise_scores_gated(dict(head, n_item_mods=8), uf, ug, itf, ig)
    assert (tpm.pairwise_scores_gated.launches,
            tpm.pairwise_scores_gated_factored.launches) == launches


@pytest.mark.parametrize('variant', ['exact', 'factored'])
def test_gated_scorer_on_card(dev, variant):
    """Gated top_k and score_full through K2 or K3 against the plain bf16
    scores of the same tables (KERNEL_TOL; top-10 sets equal but for
    near-ties at the boundary) and against the CPU scorer of the same
    variant, whose plain path is float32 (F32_TOL). 70 users in 64-user
    blocks, 1,000 items in 256-item chunks: 2 x 4 launches per call.
    score_candidates is the exact float32 math on both devices: atol
    1e-4."""
    model = make_model('gelu', 'sigmoid', 'gated')
    users = np.random.default_rng(5).integers(0, N_USERS, 70).astype(
        np.int32)
    seen = np.random.default_rng(6).random((70, N_ITEMS)) < 0.05
    k = 10
    kw = dict(item_chunk=256, user_chunk=64, gated_variant=variant)
    gpu = CatalogScorer(copy.deepcopy(model), store(), **kw, device=dev)
    cpu = CatalogScorer(model, store(), **kw, device='cpu')
    assert gpu.gated_variant == cpu.gated_variant == variant
    kernel, plain = GATED[variant]
    before = kernel.launches
    v, i = gpu.top_k(users, k, seen_mask=seen)
    assert kernel.launches == before + 8
    assert not seen[np.arange(70)[:, None], i].any()
    with torch.no_grad():
        side = gpu._fast_user_side(torch.from_numpy(
            users.astype(np.int64)).to(dev))
        ref = plain(gpu._head, *side,
                    *(t[:N_ITEMS] for t in gpu._scan_tables),
                    compute_dtype=torch.bfloat16)
    full = gpu.score_full(users)
    tol = KERNEL_TOL * max(1.0, float(ref.abs().max()))
    np.testing.assert_allclose(full, ref.cpu().numpy(), atol=tol)
    np.testing.assert_allclose(full, cpu.score_full(users), atol=F32_TOL)
    ref[torch.from_numpy(seen).to(dev)] = NEG_INF
    rv, ri = (t.cpu().numpy() for t in torch.topk(ref, k, dim=1))
    np.testing.assert_allclose(v, rv, atol=tol)
    for a, b, vals in zip(i, ri, rv):
        clear = vals > vals[-1] + 2 * tol  # not tied with the boundary
        assert set(b[clear]) <= set(a)
    np.testing.assert_allclose(v, cpu.top_k(users, k, seen_mask=seen)[0],
                               atol=F32_TOL)
    rng = np.random.default_rng(7)
    cands = rng.integers(0, N_ITEMS, (70, 12)).astype(np.int32)
    valid = rng.random((70, 12)) < 0.8
    np.testing.assert_allclose(gpu.score_candidates(users, cands, valid),
                               cpu.score_candidates(users, cands, valid),
                               atol=1e-4)


# ------------------------------------------------------------- int8 mode
INT8 = {'K1q': (tpm.pairwise_scores, tpm.pairwise_scores_plain),
        'K2q': GATED['exact'], 'K3q': GATED['factored']}


def int8_inputs(model, kid, dev, B=37, C=301):
    """The model's head on ``dev`` in int8 mode, calibrated on seeded rows
    of 16 x 64 pairs, and the kernel's seeded rows of a [B] x [C] block."""
    head = head_on(tpm.build_factorized_head(model), dev)
    if kid == 'K1q':
        cal = rows(head['b1'].shape[0], 16, 64, dev, seed=8)
        ranges = tpm.calibrate_head_ranges(head, *cal)
        args = rows(head['b1'].shape[0], B, C, dev)
    else:
        exact, factored = gated_inputs(head, 16, 64, dev, seed=8)
        ranges = tpm.calibrate_head_ranges_gated(head, exact[:2], exact[2:])
        exact, factored = gated_inputs(head, B, C, dev)
        args = exact if kid == 'K2q' else factored
    return tpm.quantize_head(head, ranges), args


# The int8 kernels against their plain versions in int8 (bf16 mode): the
# same bf16 assembly, the same codes (every product and sum rounded on its
# own on both sides, the integer products exact), float32 sums in another
# order in the last dot. A pair differs by more than AGREE only where an
# input lies within an ulp (of an activation, or of K2's and K3's exp) of a
# code boundary and its code flips (chip_smoke.py saw none on an H100): at
# most MAX_DIFFERING of the pairs, none by more than FLIP_TOL.
@pytest.mark.parametrize('kid', ['K1q', 'K2q', 'K3q'])
@pytest.mark.parametrize('final', ['sigmoid', 'tanh', 'none'])
@pytest.mark.parametrize('activation', list(tpm.ACTIVATIONS))
def test_int8_kernels_match_plain(dev, activation, final, kid):
    """K1q, K2q and K3q, one launch each on a ragged 37 x 301 block, and no
    launch of the bf16 mode."""
    fusion = 'concatenate' if kid == 'K1q' else 'gated'
    head, args = int8_inputs(make_model(activation, final, fusion), kid, dev)
    kernel, plain = INT8[kid]
    before = (kernel.launches, kernel.launches_int8)
    out = kernel(head, *args)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.launches_int8) == (before[0],
                                                       before[1] + 1)
    ref = plain(head, *args, compute_dtype=torch.bfloat16)
    assert out.shape == (37, 301) and torch.isfinite(out).all()
    scale = max(1.0, ref.abs().max().item())
    diff = (out - ref).abs()
    assert (diff > AGREE * scale).float().mean().item() <= MAX_DIFFERING
    assert diff.max().item() <= FLIP_TOL * scale


def test_int8_kernels_refuse_widths_not_multiple_of_32(dev):
    """A quantized width that is not a multiple of 32 (the depth of one int8
    product) is refused before any launch, on the card as on the CPU."""
    head, (uf, itf) = int8_inputs(make_model(), 'K1q', dev)
    w, b = head['layers'][0]
    narrow = dict(head, layers=[(w[:, :48], b[:48]),
                                (head['layers'][1][0][:48],
                                 head['layers'][1][1])])
    narrow['qlayers'] = tpm.quantize_mlp_chain(narrow, [(0.0, 1.0)])
    narrow.pop('kernel')
    launches = tpm.pairwise_scores.launches_int8
    with pytest.raises(ValueError, match='multiples of 32'):
        tpm.pairwise_scores(narrow, uf, itf)
    with pytest.raises(ValueError, match='multiples of 32'):
        tpm.kernel_chain(narrow)
    assert tpm.pairwise_scores.launches_int8 == launches


@pytest.mark.parametrize('variant', ['concatenate', 'exact', 'factored'])
def test_int8_scorer_on_card(dev, variant):
    """CatalogScorer(precision='int8!') on the card: top_k and score_full
    through K1q, K2q or K3q (2 user blocks x 4 item chunks = 8 int8
    launches per call, no bf16 launch) against the plain int8 scores of the
    same tables (KERNEL_TOL; top-10 sets equal but for near-ties at the
    boundary) and against the CPU scorer, whose plain int8 path is float32
    (F32_TOL: the bf16 assembly moves codes, and the two calibrations
    differ by float32 ulps). score_candidates is the float32 int8 chain on
    both devices (F32_TOL, for the same calibrations)."""
    fusion = 'concatenate' if variant == 'concatenate' else 'gated'
    model = make_model('gelu', 'sigmoid', fusion)
    users = np.random.default_rng(5).integers(0, N_USERS, 70).astype(
        np.int32)
    seen = np.random.default_rng(6).random((70, N_ITEMS)) < 0.05
    k = 10
    kw = dict(item_chunk=256, user_chunk=64, precision='int8!')
    if fusion == 'gated':
        kw['gated_variant'] = variant
    gpu = CatalogScorer(copy.deepcopy(model), store(), **kw, device=dev)
    cpu = CatalogScorer(model, store(), **kw, device='cpu')
    assert gpu.precision == cpu.precision == 'int8'
    kid = {'concatenate': 'K1q', 'exact': 'K2q', 'factored': 'K3q'}[variant]
    kernel, plain = INT8[kid]
    before = (kernel.launches, kernel.launches_int8)
    v, i = gpu.top_k(users, k, seen_mask=seen)
    assert (kernel.launches, kernel.launches_int8) == (before[0],
                                                       before[1] + 8)
    assert not seen[np.arange(70)[:, None], i].any()
    with torch.no_grad():
        side = gpu._fast_user_side(torch.from_numpy(
            users.astype(np.int64)).to(dev))
        ref = plain(gpu._head, *side,
                    *(t[:N_ITEMS] for t in gpu._scan_tables),
                    compute_dtype=torch.bfloat16)
    full = gpu.score_full(users)
    tol = KERNEL_TOL * max(1.0, float(ref.abs().max()))
    np.testing.assert_allclose(full, ref.cpu().numpy(), atol=tol)
    np.testing.assert_allclose(full, cpu.score_full(users), atol=F32_TOL)
    ref[torch.from_numpy(seen).to(dev)] = NEG_INF
    rv, ri = (t.cpu().numpy() for t in torch.topk(ref, k, dim=1))
    np.testing.assert_allclose(v, rv, atol=tol)
    for a, b, vals in zip(i, ri, rv):
        clear = vals > vals[-1] + 2 * tol  # not tied with the boundary
        assert set(b[clear]) <= set(a)
    np.testing.assert_allclose(v, cpu.top_k(users, k, seen_mask=seen)[0],
                               atol=F32_TOL)
    rng = np.random.default_rng(7)
    cands = rng.integers(0, N_ITEMS, (70, 12)).astype(np.int32)
    valid = rng.random((70, 12)) < 0.8
    np.testing.assert_allclose(gpu.score_candidates(users, cands, valid),
                               cpu.score_candidates(users, cands, valid),
                               atol=F32_TOL)


# -------------------------------------------------------- attention fusion
ATTENTION = {'stream': (tas.attention_scores, tas.attention_scores_plain),
             'gram': (tas.attention_scores_gram,
                      tas.attention_scores_gram_plain)}


def attention_inputs(head, B, C, device, seed=4):
    """Seeded attention tables for a [B] x [C] block on ``device``, with the
    gram variant's scalar tables: (user side, item side)."""
    rng = np.random.default_rng(seed)
    d, mi = head['d'], head['n_item_mods']
    users = torch.from_numpy(rng.standard_normal((B, d), np.float32))
    feats = torch.from_numpy(rng.standard_normal((C, mi, d), np.float32))
    cpu = head_on(head, 'cpu')
    side = (tas.compute_user_side_attention(cpu, users, True),
            tas.compute_item_side_attention(cpu, feats, True))
    return tuple(tuple(t.to(device) for t in s) for s in side)


# K4 and K5 against their plain bf16 versions, as the gated kernels: the
# assembly rounds where the plain version does, operation for operation,
# so nearly every pair agrees to float32 rounding, and a few differ where a
# hidden activation lands on the neighbouring bf16 value (AGREE,
# MAX_DIFFERING, FLIP_TOL).
@pytest.mark.parametrize('final', ['sigmoid', 'tanh', 'none'])
@pytest.mark.parametrize('activation', list(tpm.ACTIVATIONS))
@pytest.mark.parametrize('heads', [1, 2, 4])
@pytest.mark.parametrize('emb', [32, 64])
@pytest.mark.parametrize('variant', ['stream', 'gram'])
def test_attention_kernels_match_bf16_plain(dev, variant, emb, heads,
                                            activation, final):
    """One launch on a ragged 37 x 301 block."""
    head = head_on(tas.build_attention_head(
        make_model(activation, final, 'attention', emb, heads)), dev)
    users, items = attention_inputs(head, 37, 301, dev)
    kernel, plain = ATTENTION[variant]
    before = kernel.launches
    out = kernel(head, users, items)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = plain(head, users, items, compute_dtype=torch.bfloat16)
    assert out.shape == (37, 301) and torch.isfinite(out).all()
    scale = max(1.0, ref.abs().max().item())
    diff = (out - ref).abs()
    assert (diff > AGREE * scale).float().mean().item() <= MAX_DIFFERING
    assert diff.max().item() <= FLIP_TOL * scale


@pytest.mark.parametrize('act_final', [('relu', 'sigmoid'),
                                       ('gelu', 'tanh')])
@pytest.mark.parametrize('heads', [4, 8])
@pytest.mark.parametrize('emb', [128, 256])
@pytest.mark.parametrize('variant', ['stream', 'gram'])
def test_attention_kernels_at_wide_embeddings(dev, variant, emb, heads,
                                              act_final):
    """The kernels' wider instances (two and four float2 slots per lane)
    and the most heads they take, as
    test_attention_kernels_match_bf16_plain; d 128 is the advanced
    configuration's width, d 256 the widest the kernels take. K5 keeps
    each pair's cross-Grams in shared memory and fits only d 128 with 4
    heads here (at 8 heads or d 256 it would need 263 KB or more of the
    card's 227 KB): elsewhere its launch is refused and raises, as
    ``kernel_smem_bytes`` counts."""
    head = head_on(tas.build_attention_head(
        make_model(*act_final, 'attention', emb, heads)), dev)
    users, items = attention_inputs(head, 21, 150, dev)
    kernel, plain = ATTENTION[variant]
    refused = variant == 'gram' and (emb, heads) != (128, 4)
    assert refused == (tas.kernel_smem_bytes(head, variant == 'gram')
                       > tas.SMEM_OPTIN)
    if refused:
        before = kernel.launches
        with pytest.raises(RuntimeError, match='shared-memory'):
            kernel(head, users, items)
        assert kernel.launches == before
        return
    out = kernel(head, users, items)
    torch.cuda.synchronize()
    ref = plain(head, users, items, compute_dtype=torch.bfloat16)
    assert out.shape == (21, 150) and torch.isfinite(out).all()
    scale = max(1.0, ref.abs().max().item())
    diff = (out - ref).abs()
    assert (diff > AGREE * scale).float().mean().item() <= MAX_DIFFERING
    assert diff.max().item() <= FLIP_TOL * scale


@pytest.mark.parametrize('emb_heads', [(128, 8), (256, 4)])
def test_attention_scorer_refuses_gram_that_does_not_fit(dev, emb_heads):
    """A model K5 does not take raises at construction of a gram scorer,
    before any table is built, and names the stream variant, which
    serves it."""
    model = make_model('relu', 'sigmoid', 'attention', *emb_heads)
    launches = tas.attention_scores_gram.launches
    with pytest.raises(ValueError, match="attention_variant='stream'"):
        CatalogScorer(copy.deepcopy(model), store(), item_chunk=256,
                      user_chunk=64, attention_variant='gram', device=dev)
    assert tas.attention_scores_gram.launches == launches
    scorer = CatalogScorer(model, store(), item_chunk=256, user_chunk=64,
                           attention_variant='stream', device=dev)
    v, i = scorer.top_k(np.arange(5, dtype=np.int32), 10)
    assert v.shape == (5, 10) and np.isfinite(v).all()


def test_attention_kernels_reject_what_they_do_not_take(dev):
    head = head_on(tas.build_attention_head(make_model(fusion='attention')),
                   dev)
    users, items = attention_inputs(head, 8, 32, dev)
    launches = (tas.attention_scores.launches,
                tas.attention_scores_gram.launches)
    for bad_users, bad_items in (
            ((users[0].double(),) + users[1:], items),
            (users, (items[0][:, :-16],) + items[1:]),
            (users, items[:3] + (items[3].t().contiguous().t(),) + items[4:]),
            (users, items[:5] + (items[5][:7],) + items[6:]),
            (users, (items[0].cpu(),) + items[1:])):
        for kernel, _ in ATTENTION.values():
            with pytest.raises(ValueError):
                kernel(head, bad_users, bad_items)
    for bad, match in ((dict(head, d=40), 'multiple of 16'),
                       (dict(head, H=9), 'heads'),
                       (dict(head, n_item_mods=8), 'item-side')):
        for kernel, _ in ATTENTION.values():
            with pytest.raises(ValueError, match=match):
                kernel(bad, users, items)
    with pytest.raises(ValueError, match='scalar tables'):
        tas.attention_scores_gram(head, users[:5], items[:6])
    assert (tas.attention_scores.launches,
            tas.attention_scores_gram.launches) == launches


@pytest.mark.parametrize('variant', ['stream', 'gram'])
def test_attention_scorer_on_card(dev, variant):
    """Attention top_k and score_full through K4 or K5 against the plain
    bf16 scores of the same tables (KERNEL_TOL; top-10 sets equal but for
    near-ties at the boundary) and against the CPU scorer of the same
    variant, whose plain path is float32 (F32_TOL). 70 users in 64-user
    blocks, 1,000 items in 256-item chunks: 2 x 4 launches per call.
    score_candidates is the float32 stream math on both devices: atol
    1e-4."""
    model = make_model('gelu', 'sigmoid', 'attention')
    users = np.random.default_rng(5).integers(0, N_USERS, 70).astype(
        np.int32)
    seen = np.random.default_rng(6).random((70, N_ITEMS)) < 0.05
    k = 10
    kw = dict(item_chunk=256, user_chunk=64, attention_variant=variant)
    gpu = CatalogScorer(copy.deepcopy(model), store(), **kw, device=dev)
    cpu = CatalogScorer(model, store(), **kw, device='cpu')
    assert gpu.attention_variant == cpu.attention_variant == variant
    kernel, plain = ATTENTION[variant]
    before = kernel.launches
    v, i = gpu.top_k(users, k, seen_mask=seen)
    assert kernel.launches == before + 8
    assert not seen[np.arange(70)[:, None], i].any()
    with torch.no_grad():
        side = gpu._fast_user_side(torch.from_numpy(
            users.astype(np.int64)).to(dev))
        ref = plain(gpu._head, side,
                    tuple(t[:N_ITEMS] for t in gpu._scan_tables),
                    compute_dtype=torch.bfloat16)
    full = gpu.score_full(users)
    tol = KERNEL_TOL * max(1.0, float(ref.abs().max()))
    np.testing.assert_allclose(full, ref.cpu().numpy(), atol=tol)
    np.testing.assert_allclose(full, cpu.score_full(users), atol=F32_TOL)
    ref[torch.from_numpy(seen).to(dev)] = NEG_INF
    rv, ri = (t.cpu().numpy() for t in torch.topk(ref, k, dim=1))
    np.testing.assert_allclose(v, rv, atol=tol)
    for a, b, vals in zip(i, ri, rv):
        clear = vals > vals[-1] + 2 * tol  # not tied with the boundary
        assert set(b[clear]) <= set(a)
    np.testing.assert_allclose(v, cpu.top_k(users, k, seen_mask=seen)[0],
                               atol=F32_TOL)
    rng = np.random.default_rng(7)
    cands = rng.integers(0, N_ITEMS, (70, 12)).astype(np.int32)
    valid = rng.random((70, 12)) < 0.8
    np.testing.assert_allclose(gpu.score_candidates(users, cands, valid),
                               cpu.score_candidates(users, cands, valid),
                               atol=1e-4)


# ------------------------------------------- attention cascade, screen K6
def screen_inputs(head, B, C, device, seed=4):
    """Seeded token-0 screen inputs on ``device``: (user side, item tables,
    tail), the tail built from the item tables as the scorer builds it."""
    users, items = attention_inputs(head, B, C, 'cpu', seed)
    tail = tac.compute_screen_tail(head_on(head, 'cpu'), items)
    return (tuple(t.to(device) for t in users[:5]),
            tuple(t.to(device) for t in items[:6]), tail.to(device))


def check_screen(head, B, C, dev):
    """One K6 launch on a ragged B x C block against its plain bf16 version
    (AGREE, MAX_DIFFERING, FLIP_TOL, as K4)."""
    users, items, tail = screen_inputs(head, B, C, dev)
    before = tac.attention_screen_scores.launches
    out = tac.attention_screen_scores(head, users, items, tail)
    torch.cuda.synchronize()
    assert tac.attention_screen_scores.launches == before + 1
    ref = tac.attention_screen_scores_plain(head, users, items, tail,
                                            compute_dtype=torch.bfloat16)
    assert out.shape == (B, C) and torch.isfinite(out).all()
    scale = max(1.0, ref.abs().max().item())
    diff = (out - ref).abs()
    assert (diff > AGREE * scale).float().mean().item() <= MAX_DIFFERING
    assert diff.max().item() <= FLIP_TOL * scale


@pytest.mark.parametrize('final', ['sigmoid', 'tanh', 'none'])
@pytest.mark.parametrize('activation', list(tpm.ACTIVATIONS))
@pytest.mark.parametrize('heads', [1, 2, 4])
@pytest.mark.parametrize('emb', [32, 64])
def test_screen_kernel_matches_bf16_plain(dev, emb, heads, activation,
                                          final):
    """K6, one launch on a ragged 37 x 301 block."""
    check_screen(head_on(tas.build_attention_head(
        make_model(activation, final, 'attention', emb, heads)), dev),
        37, 301, dev)


@pytest.mark.parametrize('act_final', [('relu', 'sigmoid'),
                                       ('gelu', 'tanh')])
@pytest.mark.parametrize('heads', [4, 8])
@pytest.mark.parametrize('emb', [128, 256])
def test_screen_kernel_at_wide_embeddings(dev, emb, heads, act_final):
    """K6's wider instances (two and four float2 slots per lane) and the
    most heads it takes; its block fits at every one of them."""
    head = head_on(tas.build_attention_head(
        make_model(*act_final, 'attention', emb, heads)), dev)
    assert tas.kernel_smem_bytes(head, False, screen=True) <= tas.SMEM_OPTIN
    check_screen(head, 21, 150, dev)


def test_screen_kernel_rejects_what_it_does_not_take(dev):
    """Bad widths, heads, types, shapes or devices raise; nothing launches
    and nothing falls back to the plain version."""
    head = head_on(tas.build_attention_head(make_model(fusion='attention')),
                   dev)
    users, items, tail = screen_inputs(head, 8, 32, dev)
    launches = tac.attention_screen_scores.launches
    for bad, match in ((dict(head, d=40), 'multiple of 16'),
                       (dict(head, H=9), 'heads'), (dict(head, H=3), 'heads'),
                       (dict(head, n_item_mods=8), 'item-side')):
        with pytest.raises(ValueError, match=match):
            tac.attention_screen_scores(bad, users, items, tail)
    for bad_users, bad_items, bad_tail in (
            ((users[0].double(),) + users[1:], items, tail),
            (users, items[:2] + (items[2][:, :-16],) + items[3:], tail),
            (users, items[:3] + (items[3][:7],) + items[4:], tail),
            (users, items, tail[:, :-16]),
            (users, items, tail.t().contiguous().t()),
            (users, items, tail.cpu())):
        with pytest.raises(ValueError):
            tac.attention_screen_scores(head, bad_users, bad_items, bad_tail)
    assert tac.attention_screen_scores.launches == launches


@pytest.mark.parametrize('screen', ['additive', 'token0', 'funnel'])
def test_cascade_on_card(dev, screen):
    """top_k_cascade on the card against the same scorer on the CPU: the
    card screens in bf16 (K1 or K6: 2 user blocks x 4 item chunks = 8
    launches per call, no K4), the CPU in float32, and both rescore in
    float32. At C = 200 of 1,000 items both screens hold every exact
    top-10, so the items agree but for near-ties at the boundary and the
    scores within 1e-4 (float32 sums in another order, TF32 off)."""
    model = make_model('gelu', 'sigmoid', 'attention')
    users = np.random.default_rng(5).integers(0, N_USERS, 70).astype(
        np.int32)
    seen = np.random.default_rng(6).random((70, N_ITEMS)) < 0.05
    k = 10
    kw = dict(item_chunk=256, user_chunk=64)
    gpu = CatalogScorer(copy.deepcopy(model), store(), **kw, device=dev)
    cpu = CatalogScorer(model, store(), **kw, device='cpu')
    call = dict(n_candidates=200, seen_mask=seen, screen=screen,
                funnel_c1=400)
    k1, k4, k6 = (tpm.pairwise_scores.launches, tas.attention_scores.launches,
                  tac.attention_screen_scores.launches)
    v, i = gpu.top_k_cascade(users, k, **call)
    assert (tpm.pairwise_scores.launches - k1,
            tas.attention_scores.launches - k4,
            tac.attention_screen_scores.launches - k6) \
        == ((0, 0, 8) if screen == 'token0' else (8, 0, 0))
    assert not seen[np.arange(70)[:, None], i].any()
    cv, ci = cpu.top_k_cascade(users, k, **call)
    for a, b, va, vb in zip(i, ci, v, cv):
        clear = vb > vb[-1] + 1e-4  # not tied with the boundary
        assert set(b[clear]) <= set(a)
        ref = dict(zip(b.tolist(), vb.tolist()))
        both = [(ref[x], y) for x, y in zip(a.tolist(), va.tolist())
                if x in ref]
        np.testing.assert_allclose(*zip(*both), atol=1e-4)
