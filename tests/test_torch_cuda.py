"""The port's CUDA kernel and its scorer on a card.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` because the suite's conftest.py sets JAX up). Without a
CUDA device every test here skips: the kernel has no CPU mode. Inputs come
from numpy and torch seeds; each test states its tolerance.
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


def make_model(activation='relu', final='sigmoid'):
    """A small concat model on the CPU, BatchNorm statistics non-trivial."""
    gen = torch.Generator().manual_seed(0)
    model = MultimodalRecommender(
        n_users=N_USERS, n_items=N_ITEMS, n_tags=N_TAGS,
        num_numerical_features=NUMERICAL, embedding_dim=EMB,
        vision_feature_dim=VISION, language_feature_dim=LANGUAGE,
        use_contrastive=False, fusion_hidden_dims=(64, 32),
        fusion_activation=activation, final_activation=final,
        dropout_rate=0.0, generator=gen, device='cpu')
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
