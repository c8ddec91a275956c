"""The port's CUDA kernels (K1 concat, K2 exact gated, K3 factored gated,
and their int8 modes K1q, K2q, K3q; K4 stream attention, K5 gram
attention, K6 the attention cascade's token-0 screen), their blocks of
fewer pair rows for wide heads, the two chains (wgmma for the bf16 modes
of K1, K2 and K3, and K4, K5 and K6, and its s8 form for K1q, K2q and K3q,
at 128 and 64 rows where the block fits, mma.sync everywhere else), the
probes P1-P3 (P3 on the wgmma chains), and its scorer,
int8 and the attention cascade included, the train steps and a toy
``Trainer`` run against the CPU's, checkpoints written from the card,
``device_tables`` and ``PrefetchLoader`` on a card, the nine frozen
encoder towers on the card against the CPU, and the unfrozen path: an
end-to-end train step and the augmentation on the card against the CPU,
the profiling module's memory readings, and nvJPEG (the image tier's
decoder on the card) against PIL's verdicts, sizes and frames of the
committed JPEG fixtures.

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
from pixelrec_multimodal_tpu_torch.probes import int8_mxu as tmx
from pixelrec_multimodal_tpu_torch.probes import vpu_roofline as tvr
from chip_smoke import (
    E2E_AUG_TOL,
    JPEG_FRAME_MAX_ERR,
    JPEG_FRAME_MEAN_ERR,
    MAX_DIFFERING_PER_LAYER,
    TOWER_FP32_TOL,
    TOWER_TOL,
    TOWERS,
    TRAIN_TOL,
    WIDE_MAX_DIFFERING,
    augment_card_vs_cpu,
    e2e_card_vs_cpu,
    jpeg_fixture_check,
    random_attention_head,
    random_attention_rows,
    random_gated_rows,
    random_head,
    tower_card_vs_cpu,
    train_card_vs_cpu,
    train_data,
    train_model,
)
from tests import _torch_smem as hand

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
    configuration's width. K5 keeps each pair's cross-Grams in shared
    memory: where its 128-row block would pass the card's 227 KB (8 heads,
    or d 256) it takes a block of 64 or 32 rows, and the card's own count
    of that block is the hand count (``tests/_torch_smem.py``)."""
    head = head_on(tas.build_attention_head(
        make_model(*act_final, 'attention', emb, heads)), dev)
    users, items = attention_inputs(head, 21, 150, dev)
    kernel, plain = ATTENTION[variant]
    gram = variant == 'gram'
    rows = tas.check_kernel_fits(head, gram)
    name, full = tas._kernel_name(gram, False), tpm.chain_widths(head)
    mode = (heads, head['n_item_mods'])
    assert (rows < 128) == (hand.block_bytes(name, full, 128, mode)
                            > tpm.SMEM_OPTIN)
    assert (rows < 128) == (gram and (emb, heads) != (128, 4))
    assert tpm.block_bytes(name, full, rows, mode) \
        == hand.block_bytes(name, full, rows, mode)
    before = kernel.launches
    out = kernel(head, users, items)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = plain(head, users, items, compute_dtype=torch.bfloat16)
    assert out.shape == (21, 150) and torch.isfinite(out).all()
    scale = max(1.0, ref.abs().max().item())
    diff = (out - ref).abs()
    assert (diff > AGREE * scale).float().mean().item() <= MAX_DIFFERING
    assert diff.max().item() <= FLIP_TOL * scale


@pytest.mark.parametrize('emb_heads', [(128, 8), (256, 4)])
def test_attention_scorer_refuses_gram_that_does_not_fit(dev, emb_heads):
    """A model whose chain fits no block (a hidden width of 8,192: 16 rows
    of buffers alone take 266,752 B of the card's 232,448) raises at
    construction of a gram scorer, before any table is built, and so does
    the stream scorer, which no longer points to itself; the same
    embedding and heads at the small chain serve through a gram scorer."""
    wide = MultimodalRecommender(
        n_users=N_USERS, n_items=N_ITEMS, n_tags=N_TAGS,
        num_numerical_features=NUMERICAL, embedding_dim=emb_heads[0],
        vision_feature_dim=VISION, language_feature_dim=LANGUAGE,
        use_contrastive=False, fusion_hidden_dims=(8192,),
        fusion_type='attention', num_attention_heads=emb_heads[1],
        dropout_rate=0.0, generator=torch.Generator().manual_seed(0),
        device='cpu')
    launches = (tas.attention_scores.launches,
                tas.attention_scores_gram.launches)
    for variant in ('gram', 'stream'):
        with pytest.raises(ValueError, match='even at 16 pair rows') as err:
            CatalogScorer(copy.deepcopy(wide), store(), item_chunk=256,
                          user_chunk=64, attention_variant=variant,
                          device=dev)
        assert "attention_variant='stream'" not in str(err.value)
    assert (tas.attention_scores.launches,
            tas.attention_scores_gram.launches) == launches
    model = make_model('relu', 'sigmoid', 'attention', *emb_heads)
    scorer = CatalogScorer(model, store(), item_chunk=256, user_chunk=64,
                           attention_variant='gram', device=dev)
    assert scorer.block_rows == tas.check_kernel_fits(scorer._head, True)
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


def check_screen(head, B, C, dev, max_differing=MAX_DIFFERING):
    """One K6 launch on a ragged B x C block against its plain bf16 version
    (AGREE, ``max_differing``, FLIP_TOL, as K4)."""
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
    assert (diff > AGREE * scale).float().mean().item() <= max_differing
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
    most heads it takes; its 128-row block fits at every one of them, by
    the card's count and by hand."""
    head = head_on(tas.build_attention_head(
        make_model(*act_final, 'attention', emb, heads)), dev)
    assert tas.check_kernel_fits(head, False, screen=True) == 128
    full, mode = tpm.chain_widths(head), (heads, head['n_item_mods'])
    assert tpm.block_bytes('attention_screen_mlp', full, 128, mode) \
        == hand.block_bytes('attention_screen_mlp', full, 128, mode)
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


# ------------------------------------------------------- wide heads, C1/C2
# Wide heads sum more products per hidden activation, so more of their bf16
# activations round to the other neighbour than the plain version's (the
# shares read on an H100 are beside WIDE_MAX_DIFFERING in chip_smoke.py,
# the largest 22.0%). Random wide heads are held to FLIP_TOL for every pair
# and AGREE for all but WIDE_MAX_DIFFERING of them, chip_smoke.py's
# constant; the narrow heads' MAX_DIFFERING holds wide heads whose chain
# cannot flip (every hidden output one exact product:
# ``wide_head(exact=True)``, w1 = I in ``d512_head``), which shows the wide
# blocks and assemblies round where the plain versions do.


def wide_head(widths, activation, final, n_item_mods=None, seed=11,
              exact=False):
    """A folded head of the given chain widths with seeded random weights
    on the card (``n_item_mods`` makes it gated). ``exact``: each hidden
    output takes one input times a power of two (a random one-to-one
    choice) plus a bias on a 1/16 grid, so its sum is exact in any order."""
    gen = torch.Generator().manual_seed(seed)
    layers = []
    for k, n in zip(widths[:-1], widths[1:]):
        if exact:
            w = torch.zeros(k, n)
            pick = torch.randperm(k, generator=gen)[:n]
            w[pick, torch.arange(n)] = 2.0 ** torch.randint(
                -1, 2, (n,), generator=gen).float() * (
                    torch.randint(0, 2, (n,), generator=gen) * 2 - 1)
            b = torch.randint(-4, 5, (n,), generator=gen) / 16.0
        else:
            w = torch.randn(k, n, generator=gen) / k ** 0.5
            b = torch.randn(n, generator=gen) * 0.05
        layers.append((w, b))
    w_last = torch.zeros(widths[-1], 128)
    w_last[:, 0] = torch.randn(widths[-1], generator=gen) / widths[-1] ** 0.5
    head = {'layers': layers + [(w_last, torch.randn(128, generator=gen))],
            'activation': activation, 'final_activation': final,
            'b1': torch.zeros(widths[0]), 'b1_folded': True}
    if n_item_mods:
        head.update(n_item_mods=n_item_mods, h1=widths[0])
    return head


def pair_args(head, kid, B, C, dev, seed=12):
    """Seeded rows of K1, K2 or K3 for a [B] x [C] block on the card."""
    rng = np.random.default_rng(seed)
    h1 = head['b1'].shape[0]
    if kid == 'K1':
        return [torch.from_numpy(rng.standard_normal(s, np.float32)).to(dev)
                for s in ((B, h1), (C, h1))]
    mi = head['n_item_mods']
    gates = np.zeros((B + C, tpm.GATE_PAD), np.float32)
    gates[:, :mi + 1] = rng.standard_normal((B + C, mi + 1))
    exact = [torch.from_numpy(a) for a in (
        rng.standard_normal((B, h1), np.float32), gates[:B],
        rng.standard_normal((C, mi * h1), np.float32), gates[B:])]
    if kid == 'K2':
        return [t.to(dev) for t in exact]
    return [t.to(dev) for t in (tpm.factor_gated_user(head, *exact[:2])
                                + tpm.factor_gated_tables(head, *exact[2:]))]


PAIR = {'K1': (tpm.pairwise_scores, tpm.pairwise_scores_plain,
               'pairwise_mlp'),
        'K2': (*GATED['exact'], 'gated_pairwise_mlp'),
        'K3': (*GATED['factored'], 'gated_factored_mlp')}


@pytest.mark.parametrize('exact', [False, True])
@pytest.mark.parametrize('int8', [False, True])
@pytest.mark.parametrize('h1', [1024, 2048])
@pytest.mark.parametrize('kid', ['K1', 'K2', 'K3'])
def test_pair_kernels_at_wide_chains(dev, kid, h1, int8, exact):
    """K1-K3 and K1q-K3q on chains past one 128-row block ([1024, 512, 256]
    and [2048, 512, 256]) against their plain versions (AGREE, FLIP_TOL and
    WIDE_MAX_DIFFERING, or the narrow heads' MAX_DIFFERING for a chain that
    cannot flip), in the block ``block_rows`` chose, whose bytes the card's
    launch set-up counts as the hand count does."""
    widths = (h1, 512, 256)
    head = head_on(wide_head(widths, 'gelu', 'sigmoid',
                             None if kid == 'K1' else 5, exact=exact), dev)
    args = pair_args(head, kid, 37, 301, dev)
    if int8:
        cal = pair_args(head, kid if kid == 'K1' else 'K2', 16, 64, dev, 13)
        ranges = (tpm.calibrate_head_ranges(head, *cal) if kid == 'K1' else
                  tpm.calibrate_head_ranges_gated(head, cal[:2], cal[2:]))
        head = tpm.quantize_head(head, ranges)
    kernel, plain, name = PAIR[kid]
    chain = tpm.kernel_chain(head)
    full, mode = tuple(int(w) for w in chain['widths']), (int(int8),)
    rows = tpm.block_rows(name, full, mode)
    assert rows < 128
    assert tpm.block_bytes(name, full, rows, mode) \
        == hand.block_bytes(name, full, rows, mode)
    assert tpm.chain_kind(name, rows, full, mode) \
        == hand.pair_chain_kind(name, full, rows, int8)
    if int8 and h1 == 1024:  # K1q, K2q, K3q: 64 rows on the s8 chain
        assert rows == 64 and tpm.chain_kind(name, 64, full, mode) == 'wgmma'
        assert tpm.block_bytes(name, full, 128, mode) == 262208
    out = kernel(head, *args)
    torch.cuda.synchronize()
    ref = plain(head, *args, compute_dtype=torch.bfloat16)
    assert out.shape == (37, 301) and torch.isfinite(out).all()
    scale = max(1.0, ref.abs().max().item())
    diff = (out - ref).abs()
    assert (diff > AGREE * scale).float().mean().item() <= (
        MAX_DIFFERING if exact else WIDE_MAX_DIFFERING)
    assert diff.max().item() <= FLIP_TOL * scale


def assert_gated(out, ref, max_differing):
    """``out`` against ``ref`` under the kernels' gates: at most
    ``max_differing`` of the pairs past AGREE and none past FLIP_TOL, both
    relative to max(1, |ref|)."""
    assert out.shape == ref.shape and torch.isfinite(out).all()
    scale = max(1.0, ref.abs().max().item())
    diff = (out - ref).abs()
    assert (diff > AGREE * scale).float().mean().item() <= max_differing
    assert diff.max().item() <= FLIP_TOL * scale


@pytest.mark.parametrize('kid', ['K1', 'K2', 'K3', 'K4', 'K5', 'K6'])
def test_smaller_blocks_give_the_same_scores(dev, kid):
    """At a flagship-width head (chain [512, 256, 128]; attention d 64, 4
    heads) a block forced to 64, 32 and 16 pair rows gives the 128-row
    block's scores bit for bit on one chain: every output's sums over K
    run the same mma steps in the same order whatever the rows. Every
    kernel runs the wgmma chain at 128 and 64 rows and the mma.sync chain
    at 32 and 16: where the two chains meet, the scores agree under the
    kernels' gates (AGREE, MAX_DIFFERING, FLIP_TOL), and bit for bit
    within each."""
    if kid in ('K1', 'K2', 'K3'):
        head = head_on(wide_head((512, 256, 128), 'gelu', 'sigmoid',
                                 None if kid == 'K1' else 5), dev)
        args = pair_args(head, kid, 37, 301, dev)
        kernel = PAIR[kid][0]

        def run(rows):
            return kernel(head, *args, _block_rows=rows)
    else:
        head = head_on(tas.build_attention_head(
            make_model('gelu', 'tanh', 'attention', 64, 4)), dev)
        users, items, tail = screen_inputs(head, 37, 301, dev)
        users6, items7 = attention_inputs(head, 37, 301, dev)

        def run(rows):
            if kid == 'K4':
                return tas.attention_scores(head, users, items,
                                            _block_rows=rows)
            if kid == 'K5':
                return tas.attention_scores_gram(head, users6, items7,
                                                 _block_rows=rows)
            return tac.attention_screen_scores(head, users, items, tail,
                                               _block_rows=rows)
    full = run(128)
    assert torch.equal(run(64), full)
    small = run(32)
    assert_gated(small, full, MAX_DIFFERING)
    assert torch.equal(run(16), small)


@pytest.mark.parametrize('name', ['pairwise_mlp', 'gated_pairwise_mlp',
                                  'gated_factored_mlp', 'attention_mlp',
                                  'attention_gram_mlp',
                                  'attention_screen_mlp'])
def test_kernels_report_their_chain(dev, name):
    """The bf16 modes of K1, K2 and K3, and K4, K5 and K6, run the wgmma
    chain (``csrc/mlp_chain_wgmma.cuh``) in blocks of 128 and 64 pair rows
    and the mma.sync chain in blocks of 32 and 16, as their libraries
    report it (``<name>_chain_kind``). K1, K2 and K3 choose by fit
    (``<name>_block_chain_kind``): their 64-row block on the wide chain
    [1024, 512, 256] runs mma.sync; K1q, K2q and K3q run the s8 wgmma
    chain at 128 rows and at 64 (it fits both chains), as the hand count
    says."""
    assert [tpm.chain_kind(name, rows) for rows in tpm.BLOCK_ROWS] == [
        'wgmma', 'wgmma', 'mma.sync', 'mma.sync']
    with pytest.raises(ValueError, match='no chain'):
        tpm.chain_kind(name, 48)
    if name not in ('pairwise_mlp', 'gated_pairwise_mlp',
                    'gated_factored_mlp'):
        return
    for widths in ((512, 256, 128), (1024, 512, 256)):
        for int8 in (0, 1):
            got = [tpm.chain_kind(name, rows, widths, (int8,))
                   for rows in tpm.BLOCK_ROWS]
            assert got == [hand.pair_chain_kind(name, widths, rows, int8)
                           for rows in tpm.BLOCK_ROWS], (widths, int8)
            if int8:
                assert got == ['wgmma'] * 2 + ['mma.sync'] * 2
            for rows in tpm.BLOCK_ROWS:
                assert tpm.block_bytes(name, widths, rows, (int8,)) \
                    == hand.block_bytes(name, widths, rows, (int8,))
    assert tpm.chain_kind(name, 64, (512, 256, 128)) == 'wgmma'
    assert tpm.chain_kind(name, 64, (1024, 512, 256)) == 'mma.sync'


FLAGSHIP = {'K1': (tpm.pairwise_scores, 'pairwise_mlp', (0,)),
            'K2': (tpm.pairwise_scores_gated, 'gated_pairwise_mlp', (0,)),
            'K3': (tpm.pairwise_scores_gated_factored, 'gated_factored_mlp',
                   (0,)),
            'K6': (tac.attention_screen_scores, 'attention_screen_mlp',
                   (4, 5))}


def flagship_call(kid, B, C, dev, seed=21):
    """(head, call, plain call, hidden layers) of K1, K2, K3 or K6 at the
    flagship head on seeded rows of a B x C block: K1 the concat chain
    [512, 256, 128], K2 and K3 that chain after the gated assembly (M = 6,
    seeded gated rows), K6 the attention head (d 64, 4 heads, Mi 5) before
    that chain with its screen tail; relu, sigmoid, random weights from
    ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    if kid in ('K1', 'K2', 'K3'):
        head = random_head((512, 256, 128), 'relu', 'sigmoid', gen, dev,
                           None if kid == 'K1' else 5)
        head['kernel'] = tpm.kernel_chain(head)  # built once, as a scorer's
        if kid == 'K1':
            args = (torch.randn(B, 512, generator=gen).to(dev),
                    torch.randn(C, 512, generator=gen).to(dev))
        else:
            args = random_gated_rows(head, B, C, gen, dev)[kid == 'K3']
        kernel = FLAGSHIP[kid][0]
        plain = {'K1': tpm.pairwise_scores_plain, 'K2': GATED['exact'][1],
                 'K3': GATED['factored'][1]}[kid]
        return (head, lambda **kw: kernel(head, *args, **kw),
                lambda: plain(head, *args, compute_dtype=torch.bfloat16), 2)
    head = random_attention_head(64, 4, (512, 256, 128), 'relu', 'sigmoid',
                                 gen, dev)
    head['kernel'] = tpm.kernel_chain(head)
    users, items = random_attention_rows(head, B, C, gen, dev, False)
    tail = tac.compute_screen_tail(head, items)
    return (head, lambda **kw: tac.attention_screen_scores(
                head, users[:5], items, tail, **kw),
            lambda: tac.attention_screen_scores_plain(
                head, users[:5], items, tail, torch.bfloat16), 3)


@pytest.mark.parametrize('kid', ['K1', 'K6', 'K2', 'K3'])
def test_k1_and_k6_at_the_flagship_head(dev, kid):
    """K1, K2, K3 and K6 at the flagship head in their 128-row wgmma block,
    one launch on a ragged 300 x 1,000 block, against their plain bf16
    versions: every pair within KERNEL_TOL of the score scale, and at most
    MAX_DIFFERING_PER_LAYER of the pairs per hidden layer past AGREE
    (chip_smoke.py's gates); the block's bytes are the hand count's."""
    head, call, plain, n_hidden = flagship_call(kid, 300, 1000, dev)
    wrapper, name, mode = FLAGSHIP[kid]
    widths = tpm.chain_widths(head)
    assert tpm.block_rows(name, widths, mode) == 128
    assert tpm.chain_kind(name, 128, widths, mode) == 'wgmma'
    assert tpm.block_bytes(name, widths, 128, mode) \
        == hand.block_bytes(name, widths, 128, mode)
    before = wrapper.launches
    out = call()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = plain()
    assert out.shape == (300, 1000) and torch.isfinite(out).all()
    scale = max(1.0, ref.abs().max().item())
    diff = (out - ref).abs()
    assert diff.max().item() <= KERNEL_TOL * scale
    assert (diff > AGREE * scale).float().mean().item() \
        <= n_hidden * MAX_DIFFERING_PER_LAYER


@pytest.mark.parametrize('kid', ['K1', 'K6', 'K2', 'K3'])
def test_k1_and_k6_blocks_across_chains(dev, kid):
    """At the flagship head, the 64-row wgmma block of K1, K2, K3 and K6
    gives the 128-row block's scores bit for bit, and the 32- and 16-row
    mma.sync blocks agree with them under the gates (KERNEL_TOL of the
    score scale, MAX_DIFFERING_PER_LAYER per hidden layer past AGREE) and
    with each other bit for bit."""
    _, call, _, n_hidden = flagship_call(kid, 300, 1000, dev)
    outs = {rows: call(_block_rows=rows) for rows in tpm.BLOCK_ROWS}
    assert torch.equal(outs[64], outs[128])
    assert torch.equal(outs[16], outs[32])
    scale = max(1.0, outs[128].abs().max().item())
    diff = (outs[32] - outs[128]).abs()
    assert diff.max().item() <= KERNEL_TOL * scale
    assert (diff > AGREE * scale).float().mean().item() \
        <= n_hidden * MAX_DIFFERING_PER_LAYER


@pytest.mark.parametrize('kid', ['K1', 'K2', 'K3'])
def test_k1_never_launches_packed_weights_of_another_chain(dev, kid):
    """A chain dict of K1, K2 or K3 that carries another chain's packed
    weights (copied with it, then given its own weights) does not launch
    them: the scores are those of its own weights, bit for bit, and the
    packed weights in the dict after the launch are its own."""
    gen = torch.Generator().manual_seed(22)
    heads = [random_head((512, 256, 128), 'gelu', 'sigmoid', gen, dev,
                         None if kid == 'K1' else 5) for _ in range(2)]
    kernel = FLAGSHIP[kid][0]
    if kid == 'K1':
        args = rows(512, 37, 301, dev)
    else:
        args = random_gated_rows(heads[0], 37, 301, gen, dev)[kid == 'K3']
    own = kernel(heads[1], *args)
    stale = tpm.wgmma_weights(tpm.kernel_chain(heads[0]))
    chain = tpm.kernel_chain(heads[1])
    chain['w_wgmma'] = stale
    heads[1]['kernel'] = chain
    out = kernel(heads[1], *args)
    assert chain['w_wgmma'] is not stale
    assert torch.equal(out, own)
    assert not torch.equal(out, kernel(heads[0], *args))


@pytest.mark.parametrize('variant', ['stream', 'gram'])
def test_attention_kernels_at_the_flagship_head(dev, variant):
    """K4 and K5 at the flagship attention head (d 64, 4 heads, Mi 5, the
    chain [512, 256, 128], relu, sigmoid, random weights from a seed) in
    their 128-row wgmma block, one launch on a ragged 300 x 1,000 block,
    against their plain bf16 versions: every pair within KERNEL_TOL of the
    score scale, and at most MAX_DIFFERING_PER_LAYER of the pairs per
    hidden layer past AGREE (chip_smoke.py's gates)."""
    gen = torch.Generator().manual_seed(21)
    head = random_attention_head(64, 4, (512, 256, 128), 'relu', 'sigmoid',
                                 gen, dev)
    users, items = random_attention_rows(head, 300, 1000, gen, dev, True)
    gram = variant == 'gram'
    assert tas.check_kernel_fits(head, gram) == 128
    assert tpm.chain_kind(tas._kernel_name(gram, False), 128) == 'wgmma'
    kernel, plain = ATTENTION[variant]
    nu = 6 if gram else 5
    before = kernel.launches
    out = kernel(head, users[:nu], items[:nu + 1])
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = plain(head, users[:nu], items[:nu + 1],
                compute_dtype=torch.bfloat16)
    assert out.shape == (300, 1000) and torch.isfinite(out).all()
    scale = max(1.0, ref.abs().max().item())
    diff = (out - ref).abs()
    assert diff.max().item() <= KERNEL_TOL * scale
    assert (diff > AGREE * scale).float().mean().item() \
        <= 3 * MAX_DIFFERING_PER_LAYER


@pytest.mark.parametrize('kid', ['K1', 'K2', 'K3'])
def test_int8_smaller_blocks_agree(dev, kid):
    """The int8 modes at forced smaller blocks: the int32 products and every
    code are the 128-row block's; the last dot's partial sums are per
    column group of the block, so their float32 order, and at most its last
    bits, follow the row count (within 1e-6 of the score's scale)."""
    fusion = 'concatenate' if kid == 'K1' else 'gated'
    head, args = int8_inputs(make_model('gelu', 'sigmoid', fusion), kid + 'q',
                             dev)
    kernel = INT8[kid + 'q'][0]
    full = kernel(head, *args, _block_rows=128)
    scale = max(1.0, full.abs().max().item())
    for rows in (64, 32, 16):
        assert (kernel(head, *args, _block_rows=rows) - full).abs().max() \
            .item() <= 1e-6 * scale


def int8_pair_call(kid, widths, dev, activation='gelu', final='sigmoid',
                   B=300, C=1000, seed=11):
    """(quantized head, rows) of K1q, K2q or K3q on a head of ``widths``
    (``wide_head``; gated, M = 6, for K2q and K3q), calibrated on seeded
    rows of 16 x 64 pairs, and the kernel's seeded rows of a [B] x [C]
    block."""
    base = kid.rstrip('q')
    head = head_on(wide_head(widths, activation, final,
                             None if base == 'K1' else 5, seed=seed), dev)
    cal = pair_args(head, 'K1' if base == 'K1' else 'K2', 16, 64, dev, 13)
    ranges = (tpm.calibrate_head_ranges(head, *cal) if base == 'K1' else
              tpm.calibrate_head_ranges_gated(head, cal[:2], cal[2:]))
    return (tpm.quantize_head(head, ranges),
            pair_args(head, base, B, C, dev))


INT8_NAME = {'K1q': 'pairwise_mlp', 'K2q': 'gated_pairwise_mlp',
             'K3q': 'gated_factored_mlp'}


def check_int8_blocks_on_the_s8_chain(kid, activation, dev):
    """``kid`` at the flagship chain [512, 256, 128] runs the s8 wgmma
    chain in its 128-row block (196,672 B, as the hand count says) and in
    a forced 64-row block: the int32 sums are exact and the last dot keeps
    the 128-row float32 order, so the 64 rows give the 128 rows' scores
    bit for bit. The 32- and 16-row blocks on the mma.sync chain agree
    within 1e-6 of the score's scale; every block against the plain int8
    version under the gates."""
    head, args = int8_pair_call(kid, (512, 256, 128), dev, activation)
    name = INT8_NAME[kid]
    widths = tpm.chain_widths(head)
    assert tpm.block_rows(name, widths, (1,)) == 128
    assert [tpm.chain_kind(name, rows, widths, (1,))
            for rows in tpm.BLOCK_ROWS] == ['wgmma', 'wgmma', 'mma.sync',
                                            'mma.sync']
    assert tpm.block_bytes(name, widths, 128, (1,)) \
        == hand.block_bytes(name, widths, 128, (1,)) == 196672
    kernel, plain = INT8[kid]
    before = (kernel.launches, kernel.launches_int8)
    outs = {rows: kernel(head, *args, _block_rows=rows)
            for rows in tpm.BLOCK_ROWS}
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.launches_int8) == (before[0],
                                                       before[1] + 4)
    assert torch.equal(outs[64], outs[128])
    scale = max(1.0, outs[128].abs().max().item())
    for rows in (32, 16):
        assert (outs[rows] - outs[128]).abs().max().item() <= 1e-6 * scale
    assert_gated(outs[128], plain(head, *args, compute_dtype=torch.bfloat16),
                 2 * MAX_DIFFERING_PER_LAYER)


@pytest.mark.parametrize('activation', ['relu', 'gelu', 'silu'])
@pytest.mark.parametrize('kid', ['K2q', 'K3q'])
def test_int8_gated_blocks_on_the_s8_chain(dev, kid, activation):
    """K2q and K3q on the s8 wgmma chain at 128 and 64 rows
    (``check_int8_blocks_on_the_s8_chain``)."""
    check_int8_blocks_on_the_s8_chain(kid, activation, dev)


@pytest.mark.parametrize('activation', list(tpm.ACTIVATIONS))
def test_int8_concat_blocks_on_the_s8_chain(dev, activation):
    """K1q on the s8 wgmma chain at 128 and 64 rows, bit for bit between
    them, its smaller blocks within 1e-6 of the scale, every activation
    (``check_int8_blocks_on_the_s8_chain``)."""
    check_int8_blocks_on_the_s8_chain('K1q', activation, dev)


@pytest.mark.parametrize('kid', ['K1q', 'K2q', 'K3q'])
def test_int8_never_launches_packed_weights_of_another_chain(dev, kid):
    """A K1q, K2q or K3q chain dict that carries another int8 chain's packed
    weights (copied with it, then given its own weights) does not launch
    them: the scores are those of its own weights, bit for bit, and the
    packed weights in the dict after the launch are its own; packed bf16
    weights are refused, never launched."""
    heads = [int8_pair_call(kid, (512, 256, 128), dev, seed=s)
             for s in (22, 23)]
    kernel = INT8[kid][0]
    args = heads[0][1]
    own = kernel(heads[1][0], *args)
    stale = tpm.wgmma_weights(tpm.kernel_chain(heads[0][0]))
    chain = tpm.kernel_chain(heads[1][0])
    chain['w_wgmma'] = stale
    heads[1][0]['kernel'] = chain
    out = kernel(heads[1][0], *args)
    assert chain['w_wgmma'] is not stale and chain['w_wgmma'].dtype \
        == torch.int8
    assert torch.equal(out, own)
    assert not torch.equal(out, kernel(heads[0][0], *args))
    bf16 = dict(chain, w=chain['w'].to(torch.bfloat16))
    heads[1][0]['kernel'] = bf16
    launches = kernel.launches_int8
    with pytest.raises(ValueError, match='int8'):
        kernel(heads[1][0], *args)
    assert kernel.launches_int8 == launches


def d512_head(act_final, heads, dev, exact=False):
    """The test model's attention head at d 512 on ``dev``; ``exact``
    replaces its chain by w1 = I (512 -> 512) and the last layer alone,
    whose products are exact in any order, so that kernel and plain version
    can differ only where the assembly rounds otherwise or in the last
    dot's float32 order."""
    head = tas.build_attention_head(
        make_model(*act_final, 'attention', 512, heads))
    if exact:
        gen = torch.Generator().manual_seed(14)
        w_last = torch.zeros(512, 128)
        w_last[:, 0] = torch.randn(512, generator=gen) / 512 ** 0.5
        head.pop('kernel', None)  # the cached chain of the replaced one
        head.update(w1=torch.eye(512), h1=512,
                    b1=torch.randint(-4, 5, (512,), generator=gen) / 16.0,
                    layers=[(w_last, torch.randn(128, generator=gen))])
    return head_on(head, dev)


def check_attention_kernel(head, kid, dev, max_differing):
    """One launch of K4, K5 or K6 on a ragged 21 x 150 block in the rows
    ``check_kernel_fits`` chose, against its plain bf16 version (AGREE,
    ``max_differing``, FLIP_TOL)."""
    gram, screen = kid == 'K5', kid == 'K6'
    assert tas.check_kernel_fits(head, gram, screen) in (64, 32, 16)
    if screen:
        check_screen(head, 21, 150, dev, max_differing)
        return
    kernel, plain = ATTENTION['gram' if gram else 'stream']
    users, items = attention_inputs(head, 21, 150, dev)
    if not gram:
        users, items = users[:5], items[:6]
    out = kernel(head, users, items)
    torch.cuda.synchronize()
    ref = plain(head, users, items, compute_dtype=torch.bfloat16)
    assert out.shape == (21, 150) and torch.isfinite(out).all()
    scale = max(1.0, ref.abs().max().item())
    diff = (out - ref).abs()
    assert (diff > AGREE * scale).float().mean().item() <= max_differing
    assert diff.max().item() <= FLIP_TOL * scale


@pytest.mark.parametrize('act_final', [('relu', 'sigmoid'),
                                       ('gelu', 'tanh')])
@pytest.mark.parametrize('heads', [4, 8])
@pytest.mark.parametrize('kid', ['K4', 'K5', 'K6'])
def test_attention_kernels_at_d512(dev, kid, heads, act_final):
    """K4, K5 and K6 at d 512 (eight float2 slots per lane, the assembly
    two users at a time) against their plain versions (AGREE,
    WIDE_MAX_DIFFERING, FLIP_TOL), in the block ``check_kernel_fits``
    chose."""
    check_attention_kernel(d512_head(act_final, heads, dev), kid, dev,
                           WIDE_MAX_DIFFERING)


@pytest.mark.parametrize('heads', [4, 8])
def test_stream_kernel_at_d512_across_chains(dev, heads):
    """K4 at d 512 in its 64-row block (the wgmma chain) and forced to 32
    and 16 rows (the mma.sync chain): each against its plain version, and
    the two chains against each other, under the wide heads' gates (AGREE,
    WIDE_MAX_DIFFERING, FLIP_TOL); the two mma.sync blocks agree bit for
    bit."""
    head = d512_head(('gelu', 'tanh'), heads, dev)
    users, items = attention_inputs(head, 21, 150, dev)
    users, items = users[:5], items[:6]
    assert tas.check_kernel_fits(head, False) == 64
    outs = {rows: tas.attention_scores(head, users, items, _block_rows=rows)
            for rows in (64, 32, 16)}
    ref = tas.attention_scores_plain(head, users, items,
                                     compute_dtype=torch.bfloat16)
    for out in outs.values():
        assert_gated(out, ref, WIDE_MAX_DIFFERING)
    assert_gated(outs[32], outs[64], WIDE_MAX_DIFFERING)
    assert torch.equal(outs[16], outs[32])


@pytest.mark.parametrize('heads', [4, 8])
@pytest.mark.parametrize('kid', ['K4', 'K5', 'K6'])
def test_attention_assembly_at_d512_is_exact(dev, kid, heads):
    """At d 512 with a chain that cannot flip (w1 = I, then the last dot),
    K4, K5 and K6 agree with their plain versions as the narrow heads do
    (AGREE, MAX_DIFFERING, FLIP_TOL): their fused vectors are the plain
    version's bit for bit."""
    check_attention_kernel(d512_head(('gelu', 'tanh'), heads, dev, True),
                           kid, dev, MAX_DIFFERING)


# (fusion, gated variant, precision, the block rows the scorer chooses:
# tests/test_torch_block_rows.py counts them by hand)
WIDE_SCORERS = [('concatenate', None, 'bf16', 64),
                ('gated', 'exact', 'bf16', 64),
                ('gated', 'factored', 'bf16', 64),
                ('concatenate', None, 'int8!', 64),
                ('gated', 'exact', 'int8!', 64),
                ('gated', 'factored', 'int8!', 64),
                ('attention', None, 'bf16', 64)]


@pytest.mark.parametrize('fusion, variant, precision, rows', WIDE_SCORERS)
def test_scorer_serves_wide_models_on_card(dev, fusion, variant, precision,
                                           rows):
    """CatalogScorer on the card serves heads past one 128-row block (concat
    and gated, both variants, at hidden widths [1024, 512, 256] in bf16 and
    int8; attention at d 512): top_k through the kernel in the block rows
    chosen at construction, against the CPU scorer's float32 (F32_TOL); a
    chain that fits no block raises ValueError at construction, before any
    table is built."""
    kw = dict(n_users=N_USERS, n_items=N_ITEMS, n_tags=N_TAGS,
              num_numerical_features=NUMERICAL, vision_feature_dim=VISION,
              language_feature_dim=LANGUAGE, use_contrastive=False,
              fusion_type=fusion, dropout_rate=0.0, device='cpu')
    if fusion == 'attention':
        kw.update(embedding_dim=512, fusion_hidden_dims=(512, 256, 128))
    else:
        kw.update(embedding_dim=EMB, fusion_hidden_dims=(1024, 512, 256))
    model = MultimodalRecommender(
        **kw, generator=torch.Generator().manual_seed(0))
    users = np.arange(20, dtype=np.int32)
    skw = dict(item_chunk=256, user_chunk=16, precision=precision)
    if variant:
        skw['gated_variant'] = variant
    gpu = CatalogScorer(copy.deepcopy(model), store(), **skw, device=dev)
    cpu = CatalogScorer(model, store(), **skw, device='cpu')
    assert gpu.block_rows == rows and cpu.block_rows is None
    np.testing.assert_allclose(gpu.top_k(users, 10)[0],
                               cpu.top_k(users, 10)[0], atol=F32_TOL)
    if precision == 'bf16':
        kw.update(fusion_hidden_dims=(8192,))
        skw.pop('precision')
        with pytest.raises(ValueError, match='even at 16 pair rows'):
            CatalogScorer(MultimodalRecommender(**kw), store(), **skw,
                          device=dev)


@pytest.mark.parametrize('steps', [1, 3])
def test_train_steps_on_card_match_cpu(dev, steps):
    """The frozen train path on the card (the flagship widths over 1,000
    items, float32, dropout 0, TF32 off) against the CPU's from the same
    weights, ``chip_smoke.train_card_vs_cpu``: with SGD and with AdamW the
    losses within TRAIN_TOL; SGD's parameters and BatchNorm statistics
    within it too, AdamW's within TRAIN_ADAM_DRIFT (it raises
    otherwise)."""
    gen = torch.Generator().manual_seed(3)
    tables, batches = train_data(gen, 'cpu', n_items=N_ITEMS,
                                 n_users=N_USERS, batch=512, n_batches=steps)
    model = train_model('cpu', torch.float32, 0.0, n_items=N_ITEMS,
                        n_users=N_USERS)
    out = train_card_vs_cpu(model, tables, batches, dev)
    for kind in ('sgd', 'adamw'):
        assert len(out[kind]['losses_card']) == steps
        assert out[kind]['loss_max_abs_diff'] <= TRAIN_TOL
    assert out['sgd']['param_max_abs_diff'] <= TRAIN_TOL


def test_probes_match_plain(dev):
    """P1-P3 at small grids against their plain versions: P1 within 1e-5
    of the value's scale (one FFMA rounding against two; the card's expf
    against torch.exp), P2's fused instance within 1e-5 of the scale (one
    FFMA rounding against two, as P1), its unfused instance bit for bit
    (each product and sum rounded on its own on both sides, in the same
    order), P3's int8 modes bit for bit (exact integer
    products, one rounding per float32 step), its bf16 mode within 2e-2 of
    the scale (the tensor cores' float32 sums run in another order, which
    moves a bf16 rounding now and then); one launch each."""
    x = tvr.chain_inputs(dev)
    for kind in tvr.KINDS:
        before = tvr.vpu_chain.launches
        out = tvr.vpu_chain(x, 24, kind, steps=3)
        torch.cuda.synchronize()
        assert tvr.vpu_chain.launches == before + 1
        ref = tvr.chain_plain(x, 24, kind)
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    w, v = tvr.bcast_inputs(dev)
    ref = tvr.bcast_plain(w, v, 16)
    for entries in tvr.BC_ENTRIES:
        assert torch.equal(tvr.vpu_bcast(w, v, 16, steps=3, fused=False,
                                         _entries=entries), ref)
        out = tvr.vpu_bcast(w, v, 16, steps=3, _entries=entries)
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    for mode in tmx.MODES:
        t = tmx.inputs(mode, dev, rows=300)
        out = tmx.mxu_chain(*t, mode, instances=2)
        ref = tmx.chain_plain(*t, mode)
        if mode == 'bf16':
            assert (out - ref).abs().max() <= 2e-2 * ref.abs().max()
        else:
            assert torch.equal(out, ref)


# P3's blocks: (mode, block rows, shared memory as the kernel counts it).
# bf16 takes 64 rows (x 64 KB, h 32 KB, acc 32 KB, six 16 KB stages and 64
# B of barriers); its 128-row block would need 256 KB before the ring.
# int8 takes 128 rows (x 64 KB, h 32 KB, acc 64 KB, four stages), and 64
# rows where forced (80 KB, eight stages).
P3_BLOCKS = [('bf16', 64, 229440), ('int8_raw', 128, 229440),
             ('int8_raw', 64, 213056), ('int8_rescale', 128, 229440),
             ('int8_rescale', 64, 213056)]


@pytest.mark.parametrize('mode, rows, nbytes', P3_BLOCKS)
def test_p3_wgmma_blocks_match_plain(dev, mode, rows, nbytes):
    """P3 on the wgmma chains at 1,000 rows (not a multiple of either
    block: the last block's rows past R load zeros and write nothing), two
    instances, against ``chain_plain``: the int8 modes bit for bit, bf16
    within 2e-2 of the scale; the block chosen by fit and its bytes."""
    assert tmx.block_rows(mode) == (64 if mode == 'bf16' else 128)
    assert tmx.block_bytes(mode, rows) == nbytes
    assert tmx.block_bytes('bf16', 128) < 0
    t = tmx.inputs(mode, dev, rows=1000, seed=6)
    before = tmx.mxu_chain.launches
    out = tmx.mxu_chain(*t, mode, instances=2, _block_rows=rows)
    torch.cuda.synchronize()
    assert tmx.mxu_chain.launches == before + 1
    ref = tmx.chain_plain(*t, mode)
    assert out.shape == (1000, tmx.H3) and torch.isfinite(out).all()
    if mode == 'bf16':
        assert (out - ref).abs().max() <= 2e-2 * ref.abs().max()
    else:
        assert torch.equal(out, ref)


# ------------------------------------------------------------------ Trainer
def toy_trainer_data(tmp_path):
    """Small datasets by chip_smoke's trainer helpers (64 users, 512
    items, 8 tags), with 64-wide vision and 32-wide language tables."""
    from chip_smoke import NUM_FEAT, trainer_datasets, trainer_tables
    items, train, val = trainer_tables(seed=4, n_users=64, n_items=512,
                                       n_tags=8, train_pos=16, val_pos=4)
    full, tr, va, _ = trainer_datasets(items, train, val,
                                       [f'num_{c}' for c in range(NUM_FEAT)])
    rng = np.random.default_rng(5)
    tr.feature_store.set_embedding_table('vision_emb', rng.standard_normal(
        (full.n_items, 64), dtype=np.float32))
    tr.feature_store.set_embedding_table('language_emb', rng.standard_normal(
        (full.n_items, 32), dtype=np.float32))
    kw = dict(n_users=full.n_users, n_items=full.n_items,
              n_tags=full.n_tags, vision_feature_dim=64,
              language_feature_dim=32, fusion_hidden_dims=(64, 32))
    return tr, va, kw


def test_trainer_on_card_matches_cpu(dev, tmp_path):
    """A toy ``Trainer`` run of 2 epochs on the card (SGD, float32, dropout
    0, TF32 off) against the same run on the CPU: losses within TRAIN_TOL,
    checkpoints written from the card's tensors."""
    from pixelrec_multimodal_tpu_torch.training import Trainer
    tr, va, kw = toy_trainer_data(tmp_path)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        losses = {}
        for side in ('cpu', dev):
            model = train_model(side, torch.float32, 0.0, **kw)
            t = Trainer(model, checkpoint_dir=str(tmp_path / str(side)),
                        use_contrastive=False)
            losses[str(side)] = t.train(tr, va, epochs=2, lr=0.05,
                                        optimizer_type='sgd',
                                        batch_size=256)
            assert (tmp_path / str(side) / 'last_model' / 'state.pt').exists()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    got, ref = losses[str(dev)], losses['cpu']
    assert np.isfinite(got).all() and len(got[0]) == 2
    np.testing.assert_allclose(got, ref, atol=TRAIN_TOL)


def test_checkpoint_from_card_loads_bit_equal(dev, tmp_path):
    """State saved from CUDA tensors lands as CPU tensors in state.pt and
    loads back onto the card bit for bit."""
    from pixelrec_multimodal_tpu_torch.utils import checkpointing as ck
    gen = torch.Generator(device=dev).manual_seed(0)
    state = {'params': {'w': torch.randn(33, 7, generator=gen, device=dev)},
             'step': torch.tensor(5, device=dev),
             'opt_state': {'names': ['w'], 'lr': torch.tensor(
                 1e-3, device=dev)}}
    ck.save_checkpoint(tmp_path, 'last_model', state, {'epoch': 2})
    raw = torch.load(tmp_path / 'last_model' / 'state.pt',
                     weights_only=True)
    assert raw['params']['w'].device.type == 'cpu'
    back = ck.load_checkpoint(tmp_path, 'last_model', device=dev)
    assert back['meta'] == {'epoch': 2}
    assert back['state']['params']['w'].device.type == 'cuda'
    assert torch.equal(back['state']['params']['w'], state['params']['w'])
    assert torch.equal(back['state']['step'], state['step'])
    assert back['state']['opt_state']['names'] == ['w']


def test_device_tables_land_on_card(dev, tmp_path):
    """``device_tables`` through pinned memory: the packed table and the
    index tables on the card, equal to the CPU's, bf16 cast after the
    copy."""
    tr, _, _ = toy_trainer_data(tmp_path)
    store = tr.feature_store
    for dtype in (None, torch.bfloat16):
        card = store.device_tables(device=dev, pack=True, dtype=dtype)
        host = store.device_tables(device='cpu', pack=True, dtype=dtype)
        torch.cuda.synchronize()
        assert sorted(card) == sorted(host)
        assert any(k.startswith('packed::') for k in card)
        for k, v in card.items():
            assert v.device.type == 'cuda' and v.dtype == host[k].dtype
            assert torch.equal(v.cpu(), host[k]), k


def test_prefetch_loader_yields_card_tensors(dev):
    """Batches through pinned memory and the side stream arrive on the
    card in order and intact, consumed on the current stream."""
    from pixelrec_multimodal_tpu_torch.data.loader import PrefetchLoader
    rng = np.random.default_rng(0)
    host = [{'x': rng.standard_normal((4096, 16)).astype(np.float32),
             'i': np.full(8, b, np.int32)} for b in range(6)]
    total = torch.zeros((), device=dev)
    for b, batch in enumerate(PrefetchLoader(iter(host), prefetch=2,
                                             device=dev)):
        assert batch['x'].device.type == 'cuda'
        assert int(batch['i'][0]) == b
        total += batch['x'].sum()
        assert torch.equal(batch['x'].cpu(), torch.from_numpy(host[b]['x']))
    assert torch.isclose(total.cpu(), torch.tensor(
        float(sum(h['x'].sum(dtype=np.float64) for h in host))), rtol=1e-4)


@pytest.mark.parametrize('modality,key', TOWERS,
                         ids=lambda v: v.replace('-', '_'))
def test_tower_on_card_matches_cpu(dev, modality, key):
    """Each frozen tower at its published geometry (ResNet-50, CLIP
    ViT-B/32 and its text tower at 77, DINOv2-base and ConvNeXt-base at
    224 px, MiniLM-L6, BERT, RoBERTa and MPNet at 512 tokens), random
    weights from a seed: 4 items on the card against the CPU, float32 with
    TF32 off, within TOWER_TOL (rtol = atol)."""
    check, _ = tower_card_vs_cpu(modality, key, dev)
    assert check['ok'], check
    assert check['max_abs_err'] <= TOWER_TOL * (1 + check['ref_max_abs'])
    assert check['max_scaled_err'] <= TOWER_FP32_TOL
    assert check['tf32_max_scaled_err'] > TOWER_FP32_TOL, check


def test_no_tf32_is_scoped(dev):
    """The precompute's forwards turn TF32 off for their scope only."""
    from pixelrec_multimodal_tpu_torch.encoders.common import no_tf32
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with no_tf32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before


def test_e2e_step_on_card_matches_cpu(dev):
    """One unfrozen end-to-end step (a 2-stage ResNet and a 1-layer text
    tower, float32, TF32 off) on the card against the CPU,
    ``chip_smoke.e2e_card_vs_cpu``: SGD's loss and parameters within
    TRAIN_TOL, AdamW's parameters by the share rule (a few entries past
    TRAIN_TOL, none past lr), each gate passing fewer entries than the
    CPU's step moved past TRAIN_TOL, remat within TRAIN_TOL of no remat
    (it raises otherwise)."""
    out = e2e_card_vs_cpu(dev)
    assert out['sgd']['param_max_abs_diff'] <= TRAIN_TOL
    for kind in ('sgd', 'adamw'):
        assert out[kind]['loss_abs_diff'] <= TRAIN_TOL
        assert (out[kind]['past_tol'] <= out[kind]['allowed_past_tol']
                < out[kind]['moved_past_tol_cpu']), out[kind]


def test_augment_on_card_matches_cpu(dev):
    """``augment_batch`` with every op on, its draws made on the card, on
    8 x 3 x 224 x 224 seeded images, against the same draws on the CPU
    within E2E_AUG_TOL of the image scale."""
    out = augment_card_vs_cpu(dev, (8, 3, 224, 224), seed=5)
    assert out['ok'], out
    assert out['max_scaled_err'] <= E2E_AUG_TOL
    assert out['ops'] == ['blur', 'crop', 'flip', 'jitter', 'noise',
                          'rotation']


def test_device_memory_stats_on_card(dev):
    """One entry per card, JAX's two keys, the peak at least what is in
    use and at least the bytes of a tensor allocated since the reset."""
    from pixelrec_multimodal_tpu_torch.utils.profiling import (
        device_memory_stats,
    )
    torch.cuda.reset_peak_memory_stats()
    x = torch.empty(1 << 24, dtype=torch.uint8, device=dev)
    stats = device_memory_stats()
    assert sorted(stats) == [f'cuda:{i}'
                             for i in range(torch.cuda.device_count())]
    for v in stats.values():
        assert sorted(v) == ['bytes_in_use', 'peak_bytes_in_use']
    here = stats[f'cuda:{x.device.index}']
    assert here['peak_bytes_in_use'] >= here['bytes_in_use'] >= x.numel()


def test_nvjpeg_matches_pil_on_the_fixtures(dev, tmp_path):
    """nvJPEG against the committed fixtures' manifest
    (``chip_smoke.jpeg_fixture_check``; ``tests/data/jpeg``, made by PIL):
    every verdict (the truncated baseline and progressive files corrupt)
    and size PIL's, every frame (a photo-sized file's crops) within
    JPEG_FRAME_MAX_ERR uint8 levels at any pixel and JPEG_FRAME_MEAN_ERR on
    average (an H100 read at most 5 and 0.97), each frame's inversion
    outside that gate; the photo-sized files decode on several threads at
    once. A PNG raises naming A12: nvJPEG decodes JPEG only."""
    from pixelrec_multimodal_tpu_torch.data.image_codecs import (
        ImageCodecMissing,
        NvjpegDecoder,
    )
    out = jpeg_fixture_check(dev)
    assert out['ok'], out
    assert out['max_abs_err'] <= JPEG_FRAME_MAX_ERR
    assert out['mean_abs_err'] <= JPEG_FRAME_MEAN_ERR
    assert out['files']['truncated.jpg']['corrupted']
    assert out['files']['truncated_progressive.jpg']['corrupted']
    photos = [n for n in out['files'] if n.startswith('photo_')]
    assert len(photos) == 3
    assert all('max_abs_err' in out['files'][n] for n in photos)
    png = tmp_path / 'x.png'
    png.write_bytes(b'\x89PNG\r\n\x1a\n' + bytes(64))
    with pytest.raises(ImageCodecMissing, match='A12'):
        NvjpegDecoder(dev).corrupted(str(png))
