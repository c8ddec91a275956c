"""The kernels' block rows: a block holds 8, 4, 2 or 1 users x 16 items
(128, 64, 32 or 16 pair rows), the largest whose shared memory fits the
227 KB (232,448 B) a block may take on sm_90. On the card the count is the
kernel's own launch set-up's (``tpm.block_bytes``); here the hand count of
``tests/_torch_smem.py`` stands in for it (``hand_count``), and these tests
hold it to bytes counted by hand and the choice (``tpm.block_rows``,
``check_pair_kernel_fits``, ``check_kernel_fits``) to the rows; the card's
count of the same blocks is held to the hand count in
``tests/test_torch_cuda.py``. Runs on the CPU: it launches nothing."""
import numpy as np
import pytest
import torch

from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.inference import scorer as tsc
from pixelrec_multimodal_tpu_torch.models.multimodal import (
    MultimodalRecommender,
)
from pixelrec_multimodal_tpu_torch.ops import attention_scorer as tas
from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
from tests import _torch_smem as hand
from tests._torch_smem import hand_count  # noqa: F401 (a fixture)

NAME = {'K1': 'pairwise_mlp', 'K2': 'gated_pairwise_mlp',
        'K3': 'gated_factored_mlp'}


def pair_head(widths):
    """A folded concat head of the given chain widths (zeros)."""
    layers = [(torch.zeros(k, n), torch.zeros(n))
              for k, n in zip(widths[:-1], widths[1:])]
    return {'b1': torch.zeros(widths[0]), 'b1_folded': True,
            'layers': layers + [(torch.zeros(widths[-1], 128),
                                 torch.zeros(128))]}


def attention_head(d, heads, widths):
    layers = [(torch.zeros(k, n), torch.zeros(n))
              for k, n in zip(widths[:-1], widths[1:])]
    return {'d': d, 'H': heads, 'n_item_mods': 5,
            'w1': torch.zeros(d, widths[0]),
            'layers': layers + [(torch.zeros(widths[-1], 128),
                                 torch.zeros(128))]}


# (kernel, chain widths from h1 on, int8, rows chosen, bytes at those rows).
# bf16 on the mma.sync chain (K1, K2, K3 at 32 and 16 rows, and at 64 where
# the wgmma block does not fit): rows x (max even width + 8 + max odd width
# + 8) x 2 B of buffers, then the 26,112 B ring (3 slices x 32 x 136 x 2 B)
# or the assembly's scratch, whichever is larger. bf16 on the wgmma chain
# (128 rows; 64 where it fits): the swizzled buffers (a layer whose output
# fits one group of 32,768 / rows columns writes over its input), then 16
# KB ring stages up to 8, at least 4 at 128 rows and 8 at 64, and 64 B of
# barriers. int8 on the mma.sync chain (K1q, K2q and K3q at 32 and 16
# rows, and at 64 where the s8 block does not fit): rows x (max even + 16
# + max odd + 16) B, the last hidden layer's row being its partial sums (4
# B x 256 / rows column groups x 128-column passes, padded to 32, + 16),
# then the 30,720 B ring (3 x 128 x 80) or the scratch. int8 on the s8
# wgmma chain (K1q, K2q and K3q at 128 rows; 64 where it fits): the wgmma
# layout in bytes, buffers rounded up to 128 B a row, 16 KB stages.
@pytest.mark.parametrize('kernel, widths, int8, rows, nbytes', [
    # the flagship on the wgmma chain: every layer (256 and 128 wide) fits
    # a group of 256 and writes over its input, one buffer of 128 x 512 x 2
    # = 131,072, then the six 16 KB stages that fit and the barriers, 98,368;
    # each kernel's scratch lies in the ring: K1's user rows, 8 x 512 x 2 =
    # 8,192; K2's f32 user rows and gates, (8 x 512 + 128 x 8) x 4 =
    # 20,480; K3's f32 user rows, coefficients and (p0, 1/Z), (8 x 520 +
    # 256) x 4 = 17,664 (on the mma.sync chain K2 and K3 took 128 x (520 +
    # 264) x 2 + 26,112 = 226,816)
    ('K1', (512, 256, 128), False, 128, 229440),
    ('K2', (512, 256, 128), False, 128, 229440),
    ('K3', (512, 256, 128), False, 128, 229440),
    # its int8 modes on the s8 wgmma chain, one buffer of 128 x 512 B =
    # 65,536 that every layer writes over, then the eight 16 KB stages that
    # fit and the barriers, 131,136 (each kernel's scratch within; K1q on
    # mma.sync took 128 x (528 + 272) + 30,720 = 133,120)
    ('K1', (512, 256, 128), True, 128, 196672),
    ('K2', (512, 256, 128), True, 128, 196672),
    ('K3', (512, 256, 128), True, 128, 196672),
    # [1024, 512, 256]: 128 rows would take 128 x (1,032 + 520) x 2 + 26,112
    # = 423,424 (K1 on the wgmma chain: buffers of 1,024 and 512 columns,
    # 393,216); 64 x 1,552 x 2 + 26,112 = 224,768. K1's 64-row wgmma block
    # would need 64 x 1,024 x 2 = 131,072 for its buffer and 8 x 16,384 +
    # 64 for the least ring, 262,208: K1, K2 and K3 take the 64-row
    # mma.sync block
    ('K1', (1024, 512, 256), False, 64, 224768),
    ('K2', (1024, 512, 256), False, 64, 224768),
    ('K3', (1024, 512, 256), False, 64, 224768),
    # int8: the 128-row s8 block of K1q, K2q and K3q needs 128 x (1,024 +
    # 512) + 4 x 16,384 + 64 = 262,208; at 64 rows a group is 512 columns,
    # every layer writes over its input, 64 x 1,024 + 8 x 16,384 + 64 =
    # 196,672 (K1q's 128-row mma.sync block took 128 x (1,040 + 528) +
    # 30,720 = 231,424; K2q's and K3q's 64-row one 64 x 1,568 + 30,720 =
    # 131,072)
    ('K1', (1024, 512, 256), True, 64, 196672),
    ('K2', (1024, 512, 256), True, 64, 196672),
    ('K3', (1024, 512, 256), True, 64, 196672),
    # h1 2048: 32 x (2,056 + 520) x 2 + 26,112 = 190,976; int8 64 x (2,064 +
    # 528) + 30,720 = 196,608 (K2q: its scratch (4 x 2,048 + 512) x 4 =
    # 34,816 = 200,704; its 64-row s8 block would need 64 x 2,048 + 8 x
    # 16,384 + 64 = 262,208, so it takes 64 rows on mma.sync)
    ('K1', (2048, 512, 256), False, 32, 190976),
    ('K2', (2048, 512, 256), False, 32, 190976),
    ('K1', (2048, 512, 256), True, 64, 196608),
    ('K2', (2048, 512, 256), True, 64, 200704),
])
def test_pair_block_rows(hand_count, kernel, widths, int8, rows, nbytes):
    """The largest block that fits, and its bytes, by hand; the next larger
    block does not fit."""
    mode = (int(int8),)
    assert tpm.block_rows(NAME[kernel], widths, mode) == rows
    assert hand_count(NAME[kernel], widths, rows, mode) == nbytes
    assert nbytes <= tpm.SMEM_OPTIN
    if rows < 128:
        assert hand_count(NAME[kernel], widths, 2 * rows, mode) \
            > tpm.SMEM_OPTIN
    variant = {'K1': None, 'K2': 'exact', 'K3': 'factored'}[kernel]
    assert tpm.check_pair_kernel_fits(pair_head(widths), variant,
                                      int8) == rows


# (chain widths from h1 on, int8, the chain of each of the four blocks by
# hand): the bf16 modes of K1, K2 and K3 run the wgmma chain at 128 rows
# and at 64 where that block fits, in one fixed order by fit (128 wgmma, 64
# wgmma, 64 mma.sync, 32, 16), and so do the int8 modes K1q, K2q and K3q
# on the s8 wgmma chain. Each kernel's scratch lies within the ring, so K1,
# K2 and K3 choose alike in either mode.
@pytest.mark.parametrize('name', ['pairwise_mlp', 'gated_pairwise_mlp',
                                  'gated_factored_mlp'])
@pytest.mark.parametrize('widths, int8, chains', [
    ((512, 256, 128), False, ('wgmma', 'wgmma', 'mma.sync', 'mma.sync')),
    ((1024, 512, 256), False, ('wgmma', 'mma.sync', 'mma.sync',
                               'mma.sync')),
    ((512, 256, 128), True, ('wgmma', 'wgmma', 'mma.sync', 'mma.sync')),
    ((1024, 512, 256), True, ('wgmma', 'wgmma', 'mma.sync', 'mma.sync')),
])
def test_k1_chain_by_fit(hand_count, widths, int8, chains, name):
    """The chain the block of K1, K2 or K3 runs on each row count, by hand;
    the flagship fits the 128-row wgmma block and the wide chain [1024,
    512, 256] takes 64 rows on mma.sync (its 64-row wgmma block does not
    fit), so its block rows stay those of the mma.sync chain. In the int8
    mode K1q, K2q and K3q take 128 rows on the s8 wgmma chain at the
    flagship (196,672 B) and 64 on it on the wide chain (the same bytes: a
    group of 512 columns at 64 rows, every layer in place)."""
    got = tuple(hand.pair_chain_kind(name, widths, rows, int8)
                for rows in tpm.BLOCK_ROWS)
    assert got == chains
    rows = tpm.block_rows(name, widths, (int(int8),))
    if int8:
        assert rows == (128 if widths[0] == 512 else 64)
        assert hand.block_bytes(name, widths, rows, (1,)) \
            == hand.wgmma_int8_chain_smem_bytes(widths, rows) == 196672
        assert hand.wgmma_int8_chain_smem_bytes(widths, 128) \
            > tpm.SMEM_OPTIN or rows == 128
    if not int8 and widths[0] == 1024:
        assert rows == 64 and hand.block_bytes(
            name, widths, 64, (0,)) == hand.chain_smem_bytes(
                widths, 64, hand.pair_scratch_bytes(name, 1024, 64))
        assert hand.wgmma_chain_smem_bytes(widths, 64) > tpm.SMEM_OPTIN
    elif not int8:
        assert rows == 128 and hand.block_bytes(
            name, widths, 64, (0,)) == hand.wgmma_chain_smem_bytes(
                widths, 64) == 196672


@pytest.mark.parametrize('kernel', ['K1', 'K2', 'K3'])
def test_int8_wide_head_passes_over_the_128_row_s8_block(hand_count, kernel):
    """On the wide chain [1024, 512, 256] the int8 modes' 128-row s8 wgmma
    block needs 128 x (1,024 + 512) B of code buffers and four 16 KB stages
    with their barriers, 262,208 B, past the 232,448 B a block may take:
    ``block_rows`` passes it over for the 64-row s8 block (196,672 B), as
    the launch would refuse it; K1q's 128-row mma.sync block (231,424 B)
    is never chosen, the fit's order being 128 and 64 on the s8 chain
    first."""
    name, widths, mode = NAME[kernel], (1024, 512, 256), (1,)
    assert hand.pair_chain_kind(name, widths, 128, True) == 'wgmma'
    assert hand_count(name, widths, 128, mode) == 262208 > tpm.SMEM_OPTIN
    assert hand.pair_chain_kind(name, widths, 64, True) == 'wgmma'
    assert hand_count(name, widths, 64, mode) == 196672
    assert tpm.block_rows(name, widths, mode) == 64
    with pytest.raises(ValueError, match='_block_rows'):
        tpm.launch_rows(name, {'widths': list(widths)}, mode, 128)


@pytest.mark.parametrize('int8', [False, True])
def test_a_chain_that_fits_no_block_is_refused(hand_count, int8):
    """h1 8,192: 16 rows of bf16 buffers alone take 16 x (8,200 + 136) x 2
    = 266,752 B; int8 rows are half as wide, so h1 16,384: 16 x (16,400 +
    80) = 263,680 B. Every kernel refuses such a head before any launch."""
    widths = (8192, 128) if not int8 else (16384, 128)
    for variant in (None, 'exact', 'factored'):
        with pytest.raises(ValueError, match='even at 16 pair rows'):
            tpm.check_pair_kernel_fits(pair_head(widths), variant, int8)


def test_forced_rows_are_checked(hand_count):
    """A forced block (the wrappers' private ``_block_rows``) must be one of
    the four and fit; without one a launch takes the chosen block."""
    chain = {'widths': [1024, 512, 256]}
    assert tpm.launch_rows('pairwise_mlp', chain, (0,)) == 64
    assert tpm.launch_rows('pairwise_mlp', chain, (0,), 16) == 16
    for bad in (128, 48, 0):
        with pytest.raises(ValueError, match='_block_rows'):
            tpm.launch_rows('pairwise_mlp', chain, (0,), bad)
    head = attention_head(512, 4, (512, 256, 128))
    chain = {'widths': tpm.chain_widths(head)}
    assert chain['widths'] == (512, 512, 256, 128)
    assert tpm.launch_rows('attention_mlp', chain, (4, 5), 32) == 32
    with pytest.raises(ValueError, match='_block_rows'):
        tpm.launch_rows('attention_mlp', chain, (4, 5), 128)


# The attention flagship chain at d 512, 4 heads (the JAX package's HPO
# draws embedding_dim 512). K4, K5 and K6 run the wgmma chain at 64 rows, where
# the warpgroups cover a group of 512 columns, so every layer (512, 256, 128
# wide) writes over its input: one buffer of swizzled 64-column blocks, 64
# x 512 x 2 = 65,536, then the ring, as many 16 KB stages as fit up to 8,
# and 64 B of barriers, 131,136 (K4's scratch, 4 user rows of 3,620 floats
# and 64 coefficient rows of 65, 74,560 B, and K5's, (4 x 3,648 + 64 x (65
# + 201)) x 4 = 126,464 B, lie within it; K5's statistics, 37 floats a row,
# in buffer A; K6's, 4 user rows of 3,620 floats and 64 coefficient rows of
# 25, 64,320 B, too): 196,672; 128 rows would need 262,144 for the buffers.
# At d 64 K4, K5 and K6 take 128 rows on the wgmma chain: w1's
# 512 columns pass a group of 256, the later layers write over them, so
# buffer A holds d = 64 and buffer B 512 columns, 128 x 576 x 2 = 147,456,
# then 5 stages of 16 KB and the barriers, 81,984 (K5's scratch, with its
# statistics after X as buffer A is too narrow for them, passes buffer B
# by 40,448, within the ring).
@pytest.mark.parametrize('d, heads, widths, kernel, rows, nbytes', [
    (512, 4, (512, 256, 128), 'stream', 64, 196672),
    (512, 4, (512, 256, 128), 'screen', 64, 196672),
    (512, 4, (512, 256, 128), 'gram', 64, 196672),
    (64, 4, (512, 256, 128), 'stream', 128, 229440),
    (64, 4, (512, 256, 128), 'gram', 128, 229440),
    (64, 4, (512, 256, 128), 'screen', 128, 229440),
])
def test_attention_block_rows(hand_count, d, heads, widths, kernel, rows,
                              nbytes):
    head = attention_head(d, heads, widths)
    gram, screen = kernel == 'gram', kernel == 'screen'
    name = tas._kernel_name(gram, screen)
    full = tpm.chain_widths(head)
    assert tas.check_kernel_fits(head, gram, screen) == rows
    assert hand_count(name, full, rows, (heads, 5)) == nbytes
    if rows < 128:
        assert hand_count(name, full, 2 * rows, (heads, 5)) > tpm.SMEM_OPTIN


def test_attention_takes_every_d_up_to_512(hand_count):
    """No refusal is left for a head whose d is a multiple of 16 up to 512
    at the flagship chain, in any of the three kernels; a chain that fits
    no block is refused by all three, and K5 no longer points to 'stream'
    when 'stream' does not fit either."""
    for d in range(16, 513, 16):
        for heads in (1, 2, 4, 8):
            if d % heads:
                continue
            head = attention_head(d, heads, (512, 256, 128))
            for gram, screen in ((False, False), (True, False),
                                 (False, True)):
                assert tas.check_kernel_fits(head, gram, screen) in (
                    128, 64, 32, 16)
    with pytest.raises(ValueError, match='d must|multiple of 16'):
        tas.check_kernel_fits(attention_head(528, 4, (512,)), False)
    wide = attention_head(512, 8, (8192,))
    for gram in (False, True):
        with pytest.raises(ValueError, match='even at 16 pair rows') as err:
            tas.check_kernel_fits(wide, gram)
        assert "attention_variant='stream'" not in str(err.value)


class _CardDevice:
    """Stands in for torch.device('cuda') where the scorer only reads the
    device's type before it builds tables."""
    type = 'cuda'


@pytest.mark.parametrize('fusion, hidden, precision, emb', [
    ('concatenate', (8192,), 'bf16', 8),
    ('gated', (8192,), 'bf16', 8),
    ('concatenate', (16384, 32), 'int8!', 8),
    ('attention', (8192,), 'bf16', 16),
])
def test_scorer_refuses_a_head_that_fits_no_block_before_tables(
        monkeypatch, hand_count, fusion, hidden, precision, emb):
    """On the card, CatalogScorer checks the kernel's block right after it
    builds the head and before any catalog table: a head that fits no
    block raises ValueError there (the card and its count are stood in
    for, as the check reads only the head's widths)."""
    model = MultimodalRecommender(
        n_users=4, n_items=8, n_tags=2, num_numerical_features=0,
        embedding_dim=emb, fusion_hidden_dims=hidden, use_contrastive=False,
        fusion_type=fusion, num_attention_heads=2, device='cpu')
    model.to = lambda device: model  # the weights stay on the CPU
    store = ItemFeatureStore(8, [str(i) for i in range(8)])
    store.tables['tag_idx'] = np.zeros(8, dtype=np.int32)
    monkeypatch.setattr(tsc, 'resolve_device', lambda device: _CardDevice())

    def no_tables(self, *a, **k):
        raise AssertionError('a catalog table was built before the check')

    monkeypatch.setattr(tsc.CatalogScorer, '_build_item_tower', no_tables)
    with pytest.raises(ValueError, match='even at 16 pair rows'):
        tsc.CatalogScorer(model, store, precision=precision)


def _swizzled_offset(r, c):
    """``sw_offset`` of ``csrc/mlp_chain_wgmma.cuh`` within a 64-column
    block of 64 rows: row r's 128 bytes, its 16-byte chunks swizzled by
    r % 8."""
    return r * 64 + (((c >> 3) ^ (r & 7)) << 3) + (c & 7)


def _packed(ws, numel):
    """The wgmma packing of the bf16 weights ``ws`` ([K, N] each) by hand,
    as a float32 array of ``numel`` entries, and the entries it fills."""
    expect = np.zeros(numel, np.float32)
    off = 0
    for w in ws:
        k, n = w.shape
        k64, n64 = -(-k // 64) * 64, -(-n // 64) * 64
        kk, nn = np.meshgrid(np.arange(k), np.arange(n), indexing='ij')
        idx = (off + ((kk // 64) * (n64 // 64) + nn // 64) * 4096
               + _swizzled_offset(nn % 64, kk % 64))
        expect[idx] = w.float().numpy()
        off += k64 * n64
    return expect, off


def _chain_of(ws, widths):
    return {'w': (torch.cat([w.reshape(-1) for w in ws]) if ws
                  else torch.zeros(8, dtype=torch.bfloat16)),
            'widths': np.asarray(widths, np.int32)}


def _random_weights(widths, seed=9):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(k, n, generator=gen).bfloat16()
            for k, n in zip(widths[:-1], widths[1:])]


@pytest.mark.parametrize('widths', [(64, 512, 256, 128), (48, 80, 32),
                                    (512, 512), (64,), (512, 256, 128)])
def test_wgmma_weights_layout(widths):
    """``tpm.wgmma_weights`` packs each hidden layer's W [K, N] as the wgmma
    chain's descriptors read it: tile (k slice ks, column group g) of 64 x
    64 at (ks * N64 / 64 + g) * 4,096 past the layer's offset (layers of
    K64 x N64, K and N rounded up to 64), element (n, k) of the tile at its
    swizzled offset; the padding is zero, and the packing is built once per
    chain. The widths are K4's, K5's and K6's (d first) and K1's (h1 512 ->
    256 -> 128) among others."""
    ws = _random_weights(widths)
    chain = _chain_of(ws, widths)
    packed = tpm.wgmma_weights(chain)
    assert tpm.wgmma_weights(chain) is packed
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    got = packed.float().numpy()
    expect, off = _packed(ws, got.size)
    if ws:
        assert packed.numel() == off
    else:
        expect = got
    np.testing.assert_array_equal(got, expect)


def test_wgmma_weights_of_the_additive_screen_head():
    """The additive screen's K1 head has a chain of its own, from h1 on
    (the attention head's has w1 as its layer 0, which K1 must not read),
    and packs its own hidden weights: not the attention head's."""
    from pixelrec_multimodal_tpu_torch.ops import attention_cascade as tac
    model = MultimodalRecommender(
        n_users=4, n_items=8, n_tags=2, num_numerical_features=0,
        embedding_dim=16, fusion_hidden_dims=(64, 32), use_contrastive=False,
        fusion_type='attention', num_attention_heads=2, device='cpu',
        generator=torch.Generator().manual_seed(3))
    head = tas.build_attention_head(model)
    shead = tac.screen_additive_head(head)
    chain = shead['kernel']
    assert 'w_wgmma' not in chain
    widths = [int(w) for w in chain['widths']]
    assert widths == [head['h1']] + [w.shape[1]
                                     for w, _ in head['layers'][:-1]]
    packed = tpm.wgmma_weights(chain)
    assert shead['kernel']['w_wgmma'] is packed
    ws = [w.bfloat16() for w, _ in shead['layers'][:-1]]
    expect, off = _packed(ws, packed.numel())
    assert off == packed.numel()
    np.testing.assert_array_equal(packed.float().numpy(), expect)
    attention = tpm.wgmma_weights(tpm.kernel_chain(head))
    assert attention.numel() != packed.numel()


def test_wgmma_weights_of_a_gated_head():
    """A gated head's chain (K2's and K3's, from h1 on) packs its folded
    hidden weights as K1's chain does, in both the exact and the factored
    variant, which share it: the wrappers of K2 and K3 launch these."""
    model = MultimodalRecommender(
        n_users=4, n_items=8, n_tags=2, num_numerical_features=3,
        embedding_dim=16, fusion_hidden_dims=(192, 64, 32),
        use_contrastive=False, fusion_type='gated', device='cpu',
        generator=torch.Generator().manual_seed(4))
    head = tpm.build_factorized_head(model)
    chain = tpm.kernel_chain(head)
    widths = [int(w) for w in chain['widths']]
    assert widths == [head['h1']] + [w.shape[1]
                                     for w, _ in head['layers'][:-1]]
    packed = tpm.wgmma_weights(chain)
    ws = [w.bfloat16() for w, _ in head['layers'][:-1]]
    expect, off = _packed(ws, packed.numel())
    assert off == packed.numel()
    np.testing.assert_array_equal(packed.float().numpy(), expect)


def test_wgmma_weights_follow_their_chain():
    """Packed weights cached in a chain dict are read only with the weights
    they were packed from: a dict copied from another chain and given its
    own ``w`` packs anew (its scores never come from the other chain's
    weights), and a chain whose weights are not of its mode's type (an
    int8 chain's are int8 codes) is refused."""
    widths = (512, 256, 128)
    a = _chain_of(_random_weights(widths, 1), widths)
    stale = tpm.wgmma_weights(a)
    b = dict(a, w=_chain_of(_random_weights(widths, 2), widths)['w'])
    assert b['w_wgmma'] is stale
    packed = tpm.wgmma_weights(b)
    assert packed is not stale and b['w_wgmma'] is packed
    np.testing.assert_array_equal(
        packed.float().numpy(),
        tpm.wgmma_weights(_chain_of(_random_weights(widths, 2),
                                    widths)).float().numpy())
    assert tpm.wgmma_weights(a) is stale
    with pytest.raises(ValueError, match='int8'):
        tpm.wgmma_weights(dict(a, int8=True))


def test_quantize_head_drops_the_packed_weights():
    """``quantize_head`` rebuilds ``head['kernel']`` in the int8 layout, and
    ``_chain_on`` rebuilds a chain of the wrong mode: neither keeps the
    bf16 chain's packed weights."""
    gen = torch.Generator().manual_seed(5)
    widths = (64, 32, 32)
    layers = [(torch.randn(k, n, generator=gen), torch.randn(n, generator=gen))
              for k, n in zip(widths[:-1], widths[1:])]
    head = {'b1': torch.zeros(64), 'b1_folded': True, 'activation': 'relu',
            'final_activation': 'sigmoid',
            'layers': layers + [(torch.randn(32, 128, generator=gen),
                                 torch.zeros(128))]}
    head['kernel'] = tpm.kernel_chain(head)
    tpm.wgmma_weights(head['kernel'])
    assert 'w_wgmma' in head['kernel']
    bf16_chain = head['kernel']
    tpm.quantize_head(head, [(-1.0, 1.0)] * 2)
    assert head['kernel']['int8'] and 'w_wgmma' not in head['kernel']
    head['kernel'] = bf16_chain  # a stale bf16 chain on an int8 head
    chain = tpm._chain_on(head, torch.device('cpu'))
    assert chain['int8'] and 'w_wgmma' not in chain
