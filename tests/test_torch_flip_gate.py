"""The flip gate of ``chip_smoke.check_against_plain`` on the CPU.

A trained concat head's top-50 pair that lies past FLIP_TOL from the plain
bf16 version passes only where ``chip_smoke.flip_explanation`` accounts
for it: a few bf16 roundings that a float32 sum in another order may
flip, taken the other way in the chain with exact sums, reach the
kernel's score to FLIP_MATCH. Here the plain bf16 version in another
summation order (``plain_bf16_other_order``) stands in for the kernel, on
a random head whose weights are scaled up until one flip moves a score
past FLIP_TOL, as on the card's trained heads.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm

USERS, ITEMS, GAIN = 16, 512, 2.5


def trained_like_head(seed=3):
    gen = torch.Generator().manual_seed(seed)
    head = chip_smoke.random_head([512, 256, 128], 'relu', 'none', gen,
                                  'cpu')
    head['layers'] = [(w * GAIN, b) for w, b in head['layers'][:-1]] \
        + [head['layers'][-1]]
    head['fusion'] = 'concatenate'
    return head, (torch.randn(USERS, 512, generator=gen),
                  torch.randn(ITEMS, 512, generator=gen))


class OtherOrderScorer:
    """The parts of ``CatalogScorer`` that ``check_against_plain`` reads,
    scoring through the plain bf16 version in another summation order."""

    def __init__(self, head, user_first, item_first):
        self._head, self.n_items = head, item_first.shape[0]
        self._user_first, self._scan_tables = user_first, (item_first,)

    def _fast_user_side(self, users):
        return (self._user_first[users],)

    def score_full(self, users):
        return chip_smoke.plain_bf16_other_order(
            self._head, self._user_first[users], self._scan_tables[0],
            seed=11).numpy()


@pytest.fixture(scope='module')
def scorer():
    head, (user_first, item_first) = trained_like_head()
    return OtherOrderScorer(head, user_first, item_first)


@pytest.mark.parametrize('sign', [1.0, -1.0])
def test_other_side_is_the_neighbour_across_the_value(sign):
    z = sign * torch.from_numpy(
        np.random.default_rng(0).lognormal(0, 3, 4096)).double()
    h = z.to(torch.bfloat16)
    other = chip_smoke._bf16_other_side(z, h)
    bits = h.view(torch.int16).int() - other.view(torch.int16).int()
    lo = torch.minimum(h.double(), other.double())
    hi = torch.maximum(h.double(), other.double())
    live = z != h.double()
    assert (bits.abs()[live] == 1).all()
    assert ((lo <= z) & (z <= hi))[live].all()


def test_exact_chain_is_another_order_up_to_flips(scorer):
    x = chip_smoke.concat_chain_inputs(
        scorer, scorer._user_first,
        torch.arange(ITEMS).repeat(USERS, 1)[:, :64])
    plain = scorer.score_full(np.arange(USERS))[:, :64].ravel()
    exact, flippable = chip_smoke.exact_chain(scorer._head, x)
    exact = exact.numpy()
    scale = np.maximum(1.0, np.abs(plain))
    apart = np.flatnonzero(np.abs(plain - exact) / scale > 1e-5)
    assert 0 < len(apart) < 0.05 * len(plain)
    got = chip_smoke.flip_explanation(scorer._head, x, plain, scale, apart)
    assert got['single_move'].max() > chip_smoke.FLIP_TOL
    for r in apart:
        e = got['explained'][r]
        assert e['residuals'][-1] <= chip_smoke.FLIP_MATCH, (r, e)
        assert 1 <= len(e['flips']) <= chip_smoke.FLIP_EXPLAIN_MOST
        layer, unit = e['flips'][0]
        assert flippable[layer][r, unit]


def test_moves_that_no_rounding_made_stay_unexplained(scorer):
    x = chip_smoke.concat_chain_inputs(
        scorer, scorer._user_first[:4],
        torch.arange(ITEMS).repeat(4, 1)[:, :50])
    exact = chip_smoke.exact_chain(scorer._head, x)[0].numpy()
    scale = np.maximum(1.0, np.abs(exact))
    rng = np.random.default_rng(1)
    rows = rng.choice(len(exact), 24, replace=False)
    fake = exact.copy()
    fake[rows] += rng.choice([-1, 1], 24) * rng.uniform(1, 3, 24) \
        * chip_smoke.FLIP_TOL * scale[rows]
    got = chip_smoke.flip_explanation(scorer._head, x, fake, scale, rows)
    reached = [e['residuals'][-1] <= chip_smoke.FLIP_MATCH
               for e in got['explained'].values()]
    assert not any(reached)


def test_a_head_without_hidden_layers_has_nothing_to_flip(scorer):
    head = dict(scorer._head, layers=[(torch.randn(512, 128) / 512 ** 0.5,
                                       torch.zeros(128))])
    x = torch.randn(8, 512).to(torch.bfloat16)
    got = chip_smoke.flip_explanation(head, x, np.zeros(8), np.ones(8),
                                      [0, 1])
    assert not got['flippable'].any() and not got['single_move'].any()
    assert all(e['flips'] == [] for e in got['explained'].values())


def check(scorer, v, i):
    out = []
    emit = chip_smoke.emit
    chip_smoke.emit = lambda phase, **f: out.append(f)
    try:
        chip_smoke.check_against_plain(
            scorer, tpm.pairwise_scores_plain, np.arange(USERS), v, i,
            'flip_gate', gate='score_full_vs_f32_top50_flips')
    finally:
        chip_smoke.emit = emit
    return out[-1]


def top50(scorer):
    full = scorer.score_full(np.arange(USERS))
    i = np.argsort(-full, 1)[:, :chip_smoke.TOP_K]
    return np.take_along_axis(full, i, 1), i


@pytest.mark.parametrize('moved', [False, True])
def test_trained_gate(scorer, moved):
    v, i = top50(scorer)
    if not moved:
        got = check(scorer, v, i)
        assert got['top50_pairs_past_flip_tol_unexplained'] == 0
        assert got['top50_max_single_flip_move'] > chip_smoke.FLIP_TOL
        return
    v = v.copy()
    v[3, 7] += 2 * chip_smoke.FLIP_TOL * max(1.0, abs(v[3, 7]))
    with pytest.raises(AssertionError, match='disagrees'):
        check(scorer, v, i)
