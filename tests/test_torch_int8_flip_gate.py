"""The int8 flip gate of ``chip_smoke.hpo_int8_vs_plain`` on the CPU.

A trained int8 head's top-50 pair that lies past AGREE from the plain int8
version passes only where int8 codes account for it: a code whose value
before ``floor`` lies within reach of a quantize boundary may flip when the
activation is computed another way, and at most FLIP_EXPLAIN_MOST such
codes, taken the other way in the chain with exact activations and an
exact last dot (``chip_smoke.exact_chain_int8``), must reach the kernel's
score to FLIP_MATCH. Here the plain int8 chain with its activation computed
by another formula in float32 (gelu's and tanh's tanh through exp) stands in
for the kernel, on a concat head and a gated head whose weights are scaled
up, as ``tests/test_torch_flip_gate.py`` scales its trained-like head, until
one flip moves a score past AGREE. The lists the gate holds are each
user's 50 pairs that the stand-in moved most from the plain version, so
that the flipped pairs are among them.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm

USERS, ITEMS, GAIN = 64, 512, 2.5
WIDTHS = (256, 128, 64)


def tanh_through_exp(y):
    return 1.0 - 2.0 / (torch.exp(2.0 * y) + 1.0)


OTHER_FORMULA = {
    'tanh': tanh_through_exp,
    'gelu': lambda x: x * (0.5 * (1.0 + tanh_through_exp(
        0.7978845608028654 * (x + 0.044715 * (x * x * x))))),
}


def trained_like_int8_head(activation, gated, seed=5):
    """A random head (``chip_smoke.random_head``) with its hidden weights
    scaled by GAIN, quantized on ranges calibrated over its own rows;
    returns (head, user side, item tables) as the scorer holds them."""
    gen = torch.Generator().manual_seed(seed)
    head = chip_smoke.random_head(WIDTHS, activation, 'sigmoid', gen, 'cpu',
                                  n_item_mods=3 if gated else None)
    head['layers'] = [(w * GAIN, b) for w, b in head['layers'][:-1]] \
        + [head['layers'][-1]]
    if gated:
        head['fusion'] = 'gated'
        uf, ug, itf, ig = chip_smoke.random_gated_rows(head, USERS, ITEMS,
                                                       gen, 'cpu')[0]
        ranges = tpm.calibrate_head_ranges_gated(head, (uf, ug), (itf, ig))
        side, tables = (uf, ug), (itf, ig)
    else:
        head['fusion'] = 'concatenate'
        side = (torch.randn(USERS, WIDTHS[0], generator=gen),)
        tables = (torch.randn(ITEMS, WIDTHS[0], generator=gen),)
        ranges = tpm.calibrate_head_ranges(head, side[0], tables[0])
    return tpm.quantize_head(head, ranges), side, tables


class Int8Scorer:
    """The parts of ``CatalogScorer`` that ``hpo_int8_vs_plain`` reads;
    ``kernel_scores`` scores through the plain int8 chain with the
    activation computed by OTHER_FORMULA, in float32."""

    user_chunk = 1024

    def __init__(self, head, side, tables):
        self._head, self._side, self._scan_tables = head, side, tables
        self.n_items = tables[0].shape[0]
        self.plain = (tpm.pairwise_scores_plain if len(side) == 1
                      else tpm.pairwise_scores_gated_plain)

    def _fast_user_side(self, users):
        return tuple(t[users] for t in self._side)

    def kernel_scores(self, monkeypatch):
        with monkeypatch.context() as m:
            real = tpm.activation_fn
            m.setattr(tpm, 'activation_fn', lambda name: OTHER_FORMULA.get(
                name, real(name)))
            return self.plain(self._head, *self._side, *self._scan_tables,
                              compute_dtype=torch.bfloat16).numpy()

    def kernel_lists(self, monkeypatch):
        """Each user's TOP_K pairs that the stand-in moved most from the
        plain int8 version, in the stand-in's order: (values, items)."""
        full = self.kernel_scores(monkeypatch)
        plain = self.plain(self._head, *self._side, *self._scan_tables,
                           compute_dtype=torch.bfloat16).numpy()
        i = np.argsort(-np.abs(full - plain), 1,
                       kind='stable')[:, :chip_smoke.TOP_K]
        i = np.take_along_axis(i, np.argsort(
            -np.take_along_axis(full, i, 1), 1, kind='stable'), 1)
        return np.take_along_axis(full, i, 1), i


@pytest.fixture(scope='module', params=['concatenate', 'gated'])
def scorer(request):
    """A concat head in tanh (as HPO trial 2's) and a gated head in gelu
    (as trial 3's)."""
    gated = request.param == 'gated'
    return Int8Scorer(*trained_like_int8_head('gelu' if gated else 'tanh',
                                              gated))


def gate(scorer, v, i):
    out = []
    emit = chip_smoke.emit
    chip_smoke.emit = lambda phase, **f: out.append(f)
    try:
        chip_smoke.hpo_int8_vs_plain(scorer, np.arange(USERS), v, i,
                                     'int8_flip_gate')
    finally:
        chip_smoke.emit = emit
    return out[-1]


def p_of(inv_a, off):
    p = torch.zeros(3, 4)
    p[2, 0], p[2, 1] = inv_a, off
    return p


def test_codes_flip_only_within_reach_of_an_integer():
    """The hidden layers' mask on values placed at and near every
    boundary: within the reach (plus the float32 roundings' share) a code
    may flip to the other side of its integer, farther out or at the
    clamp's ends it may not; the codes are the plain quantize's."""
    inv_a, off, reach = 3.0, 0.25, 1e-6
    n = torch.arange(-130, 131, dtype=torch.float64)
    # the reach of u = v inv_a + off: the value's, plus the float32
    # product's and sum's roundings
    reach_u = inv_a * reach + 2.0 ** -24 * ((n - off).abs() + n.abs())
    for d, near in ((0.0, True), (0.4, True), (-0.4, True), (3.0, False),
                    (-3.0, False), (0.25 / reach_u.max(), False)):
        v64 = (n + d * reach_u - off) / inv_a
        p = p_of(inv_a, off)
        codes, flipped, mask = chip_smoke._code_flips(
            v64, torch.full_like(v64, reach), p, bf16_in=False)
        plain = torch.clamp(torch.floor(v64.float() * p[2, 0] + p[2, 1]),
                            -128, 127)
        assert torch.equal(codes, plain)
        inside = n.abs() <= 127
        assert torch.equal(mask, inside & near), d
        assert ((codes - flipped).abs()[mask] == 1).all()
        assert torch.equal(torch.maximum(codes, flipped)[mask],
                           n[mask].float())


def test_bf16_codes_flip_only_at_a_tie_across_a_boundary():
    """The first layer's mask: a bf16-rounded value may take its other
    neighbour only within the reach of the tie between them, and its code
    flips only where that neighbour quantizes to another code."""
    h = torch.tensor([0.5, 0.53125, 0.5625, 0.59375], dtype=torch.bfloat16)
    up = chip_smoke._bf16_other_side(h.double() + 1e-9, h)
    tie = (h.double() + up.double()) / 2
    reach = torch.full_like(tie, 1e-7)
    # a bf16 step (2**-8 here) is about 4 codes, or none
    fine, coarse = p_of(1e3, -550.0), p_of(1e-3, 0.5)
    for d, near in ((-0.5e-7, True), (0.5e-7, True), (-3e-7, False)):
        v64 = tie + d
        for p, across in ((fine, True), (coarse, False)):
            codes, flipped, mask = chip_smoke._code_flips(v64, reach, p,
                                                          bf16_in=True)
            assert bool(mask.all()) == (near and across), (d, across)
            assert not mask.any() or (codes != flipped)[mask].all()


def test_exact_chain_is_the_plain_chain_up_to_flips(scorer, monkeypatch):
    """The exact chain's scores equal the plain int8 version's but where
    its own activations' roundings flipped a code, and those pairs its
    flips explain; the stand-in kernel too."""
    x = chip_smoke.int8_chain_inputs(
        scorer, scorer._side, torch.arange(64).repeat(USERS, 1))
    exact, flippable = chip_smoke.exact_chain_int8(scorer._head, x)
    assert len(flippable) == len(scorer._head['qlayers'])
    for full in (scorer.plain(scorer._head, *scorer._side,
                              *scorer._scan_tables,
                              compute_dtype=torch.bfloat16).numpy(),
                 scorer.kernel_scores(monkeypatch)):
        target = full[:, :64].ravel()
        scale = np.maximum(1.0, np.abs(target))
        apart = np.flatnonzero(np.abs(target - exact.numpy()) / scale
                               > chip_smoke.AGREE)
        assert len(apart) < 0.05 * len(target)
        got = chip_smoke.flip_explanation(scorer._head, x, target, scale,
                                          apart,
                                          exact=chip_smoke.exact_chain_int8)
        for r in apart:
            e = got['explained'][r]
            assert e['residuals'][-1] <= chip_smoke.FLIP_MATCH, (r, e)
            assert 1 <= len(e['flips']) <= chip_smoke.FLIP_EXPLAIN_MOST


def test_gate_passes_the_stand_in_kernel(scorer, monkeypatch):
    """The stand-in kernel lies past AGREE on some pairs, every one
    explained by code flips (none where the plain version's own
    activation flipped a code and the stand-in's did not); no decoy
    is."""
    v, i = scorer.kernel_lists(monkeypatch)
    got = gate(scorer, v, i)
    assert got['top50_pairs_past_agree'] > 0
    assert got['top50_pairs_past_agree_unexplained'] == 0
    assert got['top50_max_single_flip_move'] > chip_smoke.AGREE
    assert got['decoys_explained'] == 0
    explained = got['top50_pairs_past_agree_explained']
    for e in explained:
        assert e['rel_diff'] > chip_smoke.AGREE
        assert len(e['flips']) <= chip_smoke.FLIP_EXPLAIN_MOST
    assert any(e['flips'] for e in explained)


def test_a_move_no_code_reaches_fails(scorer, monkeypatch):
    """A pair moved by more than any two flips of its codes move it, and
    still within FLIP_TOL, fails the gate as unexplained."""
    v, i = scorer.kernel_lists(monkeypatch)
    got = gate(scorer, v, i)
    move = min(3 * got['top50_max_single_flip_move'],
               chip_smoke.FLIP_TOL / 2)
    v = v.copy()
    v[5, 3] += move * max(1.0, abs(v[5, 3]))
    with pytest.raises(AssertionError, match='unexplained'):
        gate(scorer, v, i)
