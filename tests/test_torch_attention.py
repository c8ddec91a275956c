"""Attention fusion in the port against the JAX package, on the CPU: the
model at float32, the Flax converter's attention layouts, the head and the
per-side tables, the plain float32 stream and gram versions against the
XLA fallback and the Pallas kernels in interpret mode, the plain bf16
versions against interpret mode and against a JAX reference that rounds
where the CUDA kernels do, and the attention CatalogScorer (stream, gram
and generic) against the JAX scorer. Inputs come from numpy seeds and
weights are converted from Flax."""
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
from pixelrec_multimodal_tpu.ops import attention_cascade as jac
from pixelrec_multimodal_tpu.ops import attention_scorer as jas
from pixelrec_multimodal_tpu.ops import pairwise_mlp as jpm
from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.inference import scorer as tsc
from pixelrec_multimodal_tpu_torch.models.multimodal import (
    MultimodalRecommender,
)
from pixelrec_multimodal_tpu_torch.ops import attention_cascade as tac
from pixelrec_multimodal_tpu_torch.ops import attention_scorer as tas
from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
from pixelrec_multimodal_tpu_torch.utils.flax_convert import (
    load_flax_variables,
)
from tests._torch_smem import hand_count  # noqa: F401 (a fixture)
from tests._torch_port import (
    EMB,
    LANGUAGE,
    N_TAGS,
    N_USERS,
    NUMERICAL,
    VISION,
    item_tables,
    make_pair,
    model_kwargs,
    to_torch,
)

N_ITEMS = 40
ACTIVATIONS = ['relu', 'gelu', 'tanh', 'leaky_relu', 'silu']
FINALS = ['sigmoid', 'tanh', 'none']
HEADS = [1, 2, 4]
MI = 5  # item-side modalities: item, tag, vision, language, numerical


@functools.lru_cache(maxsize=None)
def attention_pair(activation='relu', final='sigmoid', heads=4,
                   use_batch_norm=True):
    return make_pair(N_ITEMS, activation, final,
                     use_batch_norm=use_batch_norm, fusion_type='attention',
                     heads=heads)


@functools.lru_cache(maxsize=None)
def heads_of(activation='relu', final='sigmoid', heads=4):
    jmodel, variables, tmodel = attention_pair(activation, final, heads)
    return (jas.build_attention_head(variables, jmodel),
            tas.build_attention_head(tmodel))


def strip(a, n):
    """JAX's 128-lane padded [rows, n*dp] table -> the port's [rows, n*d]."""
    a = np.asarray(a)
    return a.reshape(a.shape[0], n, -1)[..., :EMB].reshape(a.shape[0], -1)


def side_rows(jh, th, B=8, C=128, seed=3):
    """Seeded towers through both packages: (JAX user side, JAX item side,
    port user side, port item side), with the gram tables."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((C, MI, EMB)).astype(np.float32)
    users = rng.standard_normal((B, EMB)).astype(np.float32)
    ju = jas.compute_user_side_attention(jh, jnp.asarray(users))
    ji = jas.compute_item_side_attention(jh, jnp.asarray(feats))
    tu = tas.compute_user_side_attention(th, torch.from_numpy(users), True)
    ti = tas.compute_item_side_attention(th, torch.from_numpy(feats), True)
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
@pytest.mark.parametrize('activation', ACTIVATIONS)
@pytest.mark.parametrize('heads', HEADS)
def test_forward_matches_flax(heads, activation):
    """float32 forward == model.apply (atol 1e-5: float32 sums in another
    order)."""
    jmodel, variables, tmodel = attention_pair(activation, 'sigmoid', heads)
    b = batch()
    ref = jmodel.apply(variables, *(jnp.asarray(b[k]) for k in IDX),
                       **{k: jnp.asarray(b[k]) for k in FEATS}, train=False)
    with torch.no_grad():
        out = tmodel(*(to_torch(b[k]) for k in IDX),
                     **{k: to_torch(b[k]) for k in FEATS})
    assert out.shape == (16, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize('use_batch_norm', [True, False])
@pytest.mark.parametrize('heads', HEADS)
def test_score_from_towers_matches_flax(heads, use_batch_norm):
    jmodel, variables, tmodel = attention_pair('gelu', 'tanh', heads,
                                               use_batch_norm)
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


def test_converter_maps_attention_layouts():
    """Flax's [D, H, dh] query/key/value kernels and [H, dh, D] out kernel
    land heads-major in the port's Linear weights (a plain transpose of
    the 3-D kernel would not), biases [H, dh] flatten, LayerNorm scale and
    bias convert by name."""
    _, variables, tmodel = attention_pair('relu', 'sigmoid', 4)
    fl = variables['params']['fusion_layer']
    attn = tmodel.fusion_layer.attention
    for name in ('query', 'key', 'value'):
        k = fl['attention'][name]['kernel']
        assert k.shape == (EMB, 4, EMB // 4)
        w = getattr(attn, name).weight.detach().numpy()
        np.testing.assert_array_equal(w, k.reshape(EMB, EMB).T)
        np.testing.assert_array_equal(
            getattr(attn, name).bias.detach().numpy(),
            fl['attention'][name]['bias'].reshape(-1))
        assert not np.array_equal(w, k.T.reshape(EMB, EMB))
    k = fl['attention']['out']['kernel']
    assert k.shape == (4, EMB // 4, EMB)
    np.testing.assert_array_equal(attn.out.weight.detach().numpy(),
                                  k.reshape(EMB, EMB).T)
    np.testing.assert_array_equal(
        tmodel.fusion_layer.norm.weight.detach().numpy(), fl['norm']['scale'])
    assert tmodel.fusion_layer.norm.eps == 1e-6


def test_converter_raises_on_mismatched_leaves():
    """A transposed [H, D, dh] query kernel, a 3-D kernel under another
    name and a bias of the wrong size raise instead of loading."""
    _, variables, _ = attention_pair('relu', 'sigmoid', 4)
    fresh = MultimodalRecommender(
        **model_kwargs(N_ITEMS, fusion_type='attention', heads=4),
        device='cpu')

    def with_leaf(path, value):
        out = jax.tree.map(np.asarray, variables)
        node = out['params']
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = value
        return out

    q = ('fusion_layer', 'attention', 'query')
    kernel = variables['params']['fusion_layer']['attention']['query'][
        'kernel']
    with pytest.raises(ValueError, match='query.weight'):
        load_flax_variables(fresh, with_leaf(
            q + ('kernel',), np.zeros((4, EMB, EMB // 4), np.float32)))
    with pytest.raises(ValueError, match='3-D Flax kernel'):
        load_flax_variables(fresh, with_leaf(
            ('prediction_network', 'Dense_0', 'kernel'), kernel))
    with pytest.raises(ValueError, match='query.bias'):
        load_flax_variables(fresh, with_leaf(
            q + ('bias',), np.zeros((4, EMB // 4 + 1), np.float32)))


# ------------------------------------------------------------ head, tables
@pytest.mark.parametrize('heads', HEADS)
def test_head_matches_jax(heads):
    """The port's head equals JAX's with the lane padding stripped: the
    same host-side float32 numpy math."""
    jh, th = heads_of('relu', 'sigmoid', heads)
    for key in ('d', 'H', 'dh', 'n_item_mods', 'h1', 'activation',
                'final_activation', 'fusion'):
        assert th[key] == jh[key]
    np.testing.assert_allclose(th['w1'].numpy(), np.asarray(jh['w1'])[:EMB],
                               rtol=1e-6, atol=1e-6)
    for key in ('b1', 'ln_scale', 'ln_bias', 'w_query', 'b_query', 'w_key',
                'b_key', 'w_value', 'b_value', 'w_out', 'b_out'):
        assert tuple(th[key].shape) == jh[key].shape, key
        np.testing.assert_allclose(th[key].numpy(), np.asarray(jh[key]),
                                   rtol=1e-6, atol=1e-6)
    for (tw, tb), (jw, jb) in zip(th['layers'], jh['layers']):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                                   atol=1e-6)
    widths = th['kernel']['widths'].tolist()
    assert widths[:2] == [EMB, th['h1']]
    assert th['kernel']['n_hidden'] == len(th['layers'])


@pytest.mark.parametrize('heads', HEADS)
def test_tables_match_jax(heads):
    """The d-wide item and user tables equal JAX's with the lane padding
    stripped (atol 1e-6; the Gram scalars, sums of d products of order
    10, to a relative 1e-6)."""
    jh, th = heads_of('relu', 'sigmoid', heads)
    ju, ji, tu, ti = side_rows(jh, th, B=6, C=9)
    H = heads
    expect_items = (strip(ji[0], MI), strip(ji[1], MI), strip(ji[2], MI),
                    strip(ji[3], MI * H), strip(ji[5], MI * H), ji[6], ji[7])
    expect_users = (strip(ju[0], 1), strip(ju[1], 1), strip(ju[2], 1),
                    strip(ju[3], H), ju[4], ju[5])
    assert tuple(ti[3].shape) == (9, MI * H * EMB)
    assert ti[6].shape[1] == tas.gram_layout(H, MI)[1] == ji[7].shape[1]
    assert tu[5].shape[1] == tas.user_sc_layout(H)[1] == ju[5].shape[1]
    for t, j in zip(ti[:6] + tu[:5], expect_items[:6] + expect_users[:5]):
        assert tuple(t.shape) == np.asarray(j).shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                                   rtol=1e-6)
    for t, j in ((ti[6], expect_items[6]), (tu[5], expect_users[5])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(j)).max())
    stream_items = tas.compute_item_side_attention(
        th, torch.from_numpy(np.zeros((3, MI, EMB), np.float32)))
    assert len(stream_items) == 6


# ---------------------------------------------------------- plain scoring
@pytest.mark.parametrize('final', FINALS)
@pytest.mark.parametrize('activation', ACTIVATIONS)
def test_plain_f32_matches_xla(activation, final):
    """Both float32 plain versions == xla_attention_scores (atol 1e-5:
    the stream form's item-key softmax mass, the gram form's E[y^2] - mu^2
    and float32 sums in another order)."""
    jh, th = heads_of(activation, final, 4)
    ju, ji, tu, ti = side_rows(jh, th, B=6, C=20)
    ref = np.asarray(jas.xla_attention_scores(jh, ju, ji))
    for plain in (tas.attention_scores_plain,
                  tas.attention_scores_gram_plain):
        out = plain(th, tu, ti)
        assert out.shape == (6, 20) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize('variant', ['stream', 'gram'])
@pytest.mark.parametrize('heads', HEADS)
def test_plain_f32_matches_pallas_interpret(heads, variant):
    """Each float32 plain version against its JAX Pallas kernel in
    interpret mode at float32, one 8 x 128 tile: the stream form within
    1e-5, the gram form within 1e-4 (its Grams sum in another order, and
    E[y^2] - mu^2 cancels)."""
    jh, th = heads_of('gelu', 'sigmoid', heads)
    ju, ji, tu, ti = side_rows(jh, th)
    ref = jas.pallas_attention_scores(
        jh, ju, ji, tile_users=8, tile_items=128, compute_dtype=jnp.float32,
        interpret=True, variant=variant)
    plain = (tas.attention_scores_plain if variant == 'stream'
             else tas.attention_scores_gram_plain)
    np.testing.assert_allclose(plain(th, tu, ti).numpy(), np.asarray(ref),
                               atol=1e-5 if variant == 'stream' else 1e-4)


# The bf16 plain versions against the Pallas kernels in interpret mode at
# bf16, one 8 x 128 tile. With relu the rounding points are the same on both
# sides (the fused vector rounded once to bf16, then the bf16 chain) and only
# float32 order differs, which can move one bf16 value of a pair's fused
# vector or hidden activation: atol 3e-4 (one bf16 step of a hidden unit
# moves a score ~1e-4 here), while the float32 plain version is ~1e-3 away.
# XLA's CPU bf16 arithmetic evaluates the other activations one bf16
# operation at a time: atol 2e-2, as for the gated kernels.
INTERPRET_TOL = {'relu': 3e-4}


@pytest.mark.parametrize('variant', ['stream', 'gram'])
@pytest.mark.parametrize('activation', ['relu', 'gelu', 'tanh'])
def test_plain_bf16_matches_pallas_interpret(activation, variant):
    jh, th = heads_of(activation, 'sigmoid', 4)
    ju, ji, tu, ti = side_rows(jh, th)
    ref = np.asarray(jas.pallas_attention_scores(
        jh, ju, ji, tile_users=8, tile_items=128, interpret=True,
        variant=variant))
    plain = (tas.attention_scores_plain if variant == 'stream'
             else tas.attention_scores_gram_plain)
    out = plain(th, tu, ti, torch.bfloat16).numpy()
    np.testing.assert_allclose(out, ref,
                               atol=INTERPRET_TOL.get(activation, 2e-2))


def _jax_fused(jh, ju, ji):
    """xla_attention_scores' fused vector [B, C, d] in float32 (the full
    T x T softmax)."""
    d, dp, H, dh, Mi = jh['d'], jh['dp'], jh['H'], jh['dh'], jh['n_item_mods']
    T = Mi + 1
    u_raw, u_q, u_k, u_vo, u_suu = ju[:5]
    it_raw, it_q, it_k, it_vo, it_sii = ji[:5]
    B, C = u_raw.shape[0], it_raw.shape[0]
    uq = u_q[:, :d].reshape(B, H, dh)
    uk = u_k[:, :d].reshape(B, H, dh)
    iq = it_q.reshape(C, Mi, dp)[..., :d].reshape(C, Mi, H, dh)
    ik = it_k.reshape(C, Mi, dp)[..., :d].reshape(C, Mi, H, dh)
    s = jnp.zeros((B, C, H, T, T), jnp.float32)
    s = s.at[:, :, :, 0, 0].set(u_suu[:, None, :H])
    s = s.at[:, :, :, 0, 1:].set(jnp.einsum('bhd,cmhd->bchm', uq, ik))
    s = s.at[:, :, :, 1:, 0].set(jnp.einsum('cmhd,bhd->bchm', iq, uk))
    s = s.at[:, :, :, 1:, 1:].set(jnp.broadcast_to(
        it_sii.reshape(C, H, Mi, Mi)[None], (B, C, H, Mi, Mi)))
    w = jax.nn.softmax(s, axis=-1)
    vo = jnp.concatenate([
        jnp.broadcast_to(u_vo.reshape(B, 1, 1, H, dp), (B, C, 1, H, dp)),
        jnp.broadcast_to(it_vo.reshape(1, C, Mi, H, dp), (B, C, Mi, H, dp))],
        axis=2)
    attn = jnp.einsum('bchqk,bckhd->bcqd', w, vo)
    raw = jnp.concatenate([
        jnp.broadcast_to(u_raw.reshape(B, 1, 1, dp), (B, C, 1, dp)),
        jnp.broadcast_to(it_raw.reshape(1, C, Mi, dp), (B, C, Mi, dp))],
        axis=2)
    y = raw[..., :d] + attn[..., :d]
    mu = jnp.mean(y, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(y - mu), axis=-1, keepdims=True)
    yn = (y - mu) * jax.lax.rsqrt(var + jas.LN_EPS)
    return jnp.mean(yn, axis=2) * jh['ln_scale'] + jh['ln_bias']


def kernel_reference(jh, ju, ji):
    """The CUDA kernels' rounding points in JAX: the float32 fused vector
    rounded once to bf16, then w1 and the hidden layers with bf16 operands,
    float32 sums, the bias rounded to bf16 and added in float32, the sum
    rounded to bf16, the activation evaluated in float32 and rounded to
    bf16; the last layer a float32 dot."""
    bf16, f32 = jnp.bfloat16, jnp.float32
    f = activation_fn(jh['activation'])
    x = _jax_fused(jh, ju, ji).astype(bf16)
    B, C = x.shape[:2]
    x = x.reshape(B * C, -1)
    for w, b in [(jh['w1'][:jh['d']], jh['b1'])] + list(jh['layers'][:-1]):
        acc = x.astype(f32) @ w.astype(bf16).astype(f32)
        x = f((acc + b.astype(bf16).astype(f32)).astype(bf16).astype(f32))
        x = x.astype(bf16)
    w_last, b_last = jh['layers'][-1]
    s = (x.astype(f32) * w_last[:, 0].astype(bf16).astype(f32)).sum(-1) \
        + b_last[0]
    return np.asarray(jpm._apply_final(s, jh['final_activation'])
                      ).reshape(B, C)


# Against kernel_reference only float32 order differs (the JAX fused vector
# takes the full softmax and another summation order), so a pair's fused
# vector or a hidden activation may land on the neighbouring bf16 value and
# move its score by up to ~1e-3 here: atol 2e-3, and at most MAX_DIFFERING
# of the pairs may differ by more than AGREE, where the float32 plain
# version differs at more than half.
ROUNDING_TOL, AGREE, MAX_DIFFERING = 2e-3, 1e-6, 0.02


@pytest.mark.parametrize('variant', ['stream', 'gram'])
@pytest.mark.parametrize('final', FINALS)
@pytest.mark.parametrize('activation', ACTIVATIONS)
def test_plain_bf16_rounds_where_the_kernels_do(activation, final, variant):
    jh, th = heads_of(activation, final, 4)
    ju, ji, tu, ti = side_rows(jh, th, B=8, C=64)
    ref = kernel_reference(jh, ju, ji)
    plain = (tas.attention_scores_plain if variant == 'stream'
             else tas.attention_scores_gram_plain)
    out, f32 = (plain(th, tu, ti, dt).numpy()
                for dt in (torch.bfloat16, torch.float32))
    np.testing.assert_allclose(out, ref, atol=ROUNDING_TOL)
    assert np.mean(np.abs(out - ref) > AGREE) <= MAX_DIFFERING
    assert np.mean(np.abs(f32 - ref) > AGREE) > 0.5


def test_warp_sum_and_seq_dot_orders():
    """The kernels' summation orders: _seq_dot adds left to right,
    _warp_sum adds each lane's entry pairs then the lane butterfly; both
    equal a float64 sum to float32 rounding, and d not a multiple of 64
    pads with zeros."""
    rng = np.random.default_rng(9)
    for d in (16, 32, 48, 64, 96, 256):
        x = torch.from_numpy(rng.standard_normal((5, d)).astype(np.float32))
        ref = x.double().sum(-1)
        torch.testing.assert_close(tas._warp_sum(x).double(), ref,
                                   rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(tas._seq_dot(x, torch.ones_like(x))
                                   .double(), ref, rtol=1e-6, atol=1e-5)
    x = torch.tensor([[1.0, 1e8, -1e8, 1.0] + [0.0] * 60])
    assert tas._seq_dot(x, torch.ones_like(x)).item() == 1.0
    assert tas._warp_sum(x).item() == 0.0  # (1 + 1e8) + (-1e8 + 1)


def test_candidate_scores_match_jax():
    """attention_candidate_scores on gathered rows == JAX's
    xla_attention_candidate_scores (atol 1e-5; the JAX function takes the
    full softmax over the item-item logits)."""
    jh, th = heads_of('gelu', 'tanh', 2)
    ju, ji, tu, ti = side_rows(jh, th, B=4, C=28)
    cands = np.random.default_rng(5).integers(0, 28, (4, 7))
    ref = jac.xla_attention_candidate_scores(
        jh, ju, tuple(a[cands] for a in ji[:5]))
    out = tac.attention_candidate_scores(
        th, tu[:5], tuple(t[torch.from_numpy(cands)] for t in ti[:6]))
    assert out.shape == (4, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_wrappers_on_cpu():
    """CPU tensors take the float32 plain versions and launch nothing;
    other devices, other heads, missing gram tables, compute types and
    shapes the kernels do not take raise."""
    jh, th = heads_of()
    _, _, tu, ti = side_rows(jh, th, B=3, C=5)
    before = (tas.attention_scores.launches,
              tas.attention_scores_gram.launches)
    torch.testing.assert_close(tas.attention_scores(th, tu, ti),
                               tas.attention_scores_plain(th, tu, ti))
    torch.testing.assert_close(tas.attention_scores_gram(th, tu, ti),
                               tas.attention_scores_gram_plain(th, tu, ti))
    assert (tas.attention_scores.launches,
            tas.attention_scores_gram.launches) == before
    meta = tuple(t.to('meta') for t in tu), tuple(t.to('meta') for t in ti)
    with pytest.raises(ValueError, match='cuda or cpu'):
        tas.attention_scores(th, *meta)
    with pytest.raises(ValueError, match='build_attention_head'):
        tas.attention_scores({'fusion': 'gated'}, tu, ti)
    with pytest.raises(ValueError, match='scalar tables'):
        tas.attention_scores_gram(th, tu[:5], ti[:6])
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        tas.attention_scores_plain(th, tu, ti, torch.float16)
    for bad, match in ((dict(th, d=40), 'multiple of 16'),
                       (dict(th, H=9), 'heads'),
                       (dict(th, H=3), 'heads'),
                       (dict(th, n_item_mods=8), 'item-side')):
        with pytest.raises(ValueError, match=match):
            tas._kernel_dims(bad)
    assert tas._kernel_dims(th) == (EMB, 4, MI)


# Shared memory per block, counted by hand from the kernels' layout: the
# chain's two buffers, 128 rows x (max even width + 8, max odd width + 8)
# bf16, then the 26,112 B weight ring or the part of the assembly's scratch
# (8 user rows, 128 coefficient rows, K5's 128 cross-Gram rows, f32) that
# passes buffer B, whichever is larger. Where K5's 128-row block passes
# SMEM_OPTIN (227 KB), it takes the largest smaller block that fits: d 128
# with 4 heads at 64 rows (126,464 B), with 8 heads at 32 (129,856 B), d 256
# at 64 (131,584 B).
GRAM_ROWS = {(128, 8, 64): 32, (256, 4, 64): 64}


# K4 and K5 at 128 rows run the wgmma chain: buffers of swizzled 64-column
# blocks, 128 x (cols A + cols B) x 2, then as many 16 KB ring stages as
# fit (4 to 8) and 64 B of barriers, or the scratch past buffer B
# (tests/_torch_smem.py).
@pytest.mark.parametrize('d, heads, widths, stream, gram', [
    (64, 4, (512, 256, 128), 229440, 229440),  # the flagship
    (128, 4, (512, 256, 128), 229440, 229440),
    (128, 4, (64, 32), 163904, 199680),
    (128, 8, (64, 32), 163904, 517376),
    (256, 4, (64, 32), 196672, 261120),
])
def test_kernel_smem_bytes(hand_count, d, heads, widths, stream, gram):
    """The hand count (``tests/_torch_smem.py``, which the card's own count
    is held to) at 128 rows, and check_kernel_fits on it: 128 rows where
    they fit within SMEM_OPTIN (227 KB), else the largest smaller block
    that fits (GRAM_ROWS)."""
    gram_rows = GRAM_ROWS.get((d, heads, widths[0]), 128)
    layers = [(torch.zeros(k, n), torch.zeros(n))
              for k, n in zip(widths[:-1], widths[1:])]
    head = {'d': d, 'H': heads, 'n_item_mods': MI,
            'w1': torch.zeros(d, widths[0]),
            'layers': layers + [(torch.zeros(widths[-1], 128),
                                 torch.zeros(128))]}
    for is_gram, need, rows in ((False, stream, 128), (True, gram,
                                                        gram_rows)):
        name, full = tas._kernel_name(is_gram, False), tpm.chain_widths(head)
        assert hand_count(name, full, 128, (heads, MI)) == need
        assert (need > tpm.SMEM_OPTIN) == (rows < 128)
        assert tas.check_kernel_fits(head, is_gram) == rows
        assert hand_count(name, full, rows, (heads, MI)) <= tpm.SMEM_OPTIN


# ----------------------------------------------------------------- scorer
N_CAT, ITEM_CHUNK, USER_CHUNK, K = 1000, 256, 64, 10


@pytest.fixture(scope='module')
def scorers():
    """JAX and port scorers on the same attention weights and items:
    1,000 items in 256-item chunks (the catalog pads to 1,024), 64-user
    blocks. Off the TPU the JAX scorer runs xla_attention_scores in either
    variant, so one fast-path JAX scorer serves both port variants."""
    jmodel, variables, tmodel = make_pair(N_CAT, 'relu', 'sigmoid',
                                          fusion_type='attention', heads=4)
    tables = item_tables(N_CAT)
    ids = np.arange(N_CAT).astype(str)
    jstore, tstore = JaxStore(N_CAT, ids), ItemFeatureStore(N_CAT, ids)
    jstore.tables.update(tables)
    tstore.tables.update(tables)
    kw = dict(item_chunk=ITEM_CHUNK, user_chunk=USER_CHUNK)
    fast = JaxScorer(jmodel, variables, jstore, **kw)
    generic = JaxScorer(jmodel, variables, jstore, fast_path=False, **kw)
    return {
        'stream': (fast, tsc.CatalogScorer(tmodel, tstore, **kw,
                                           attention_variant='stream',
                                           device='cpu')),
        'gram': (fast, tsc.CatalogScorer(tmodel, tstore, **kw,
                                         attention_variant='gram',
                                         device='cpu')),
        'generic': (generic, tsc.CatalogScorer(tmodel, tstore, **kw,
                                               fast_path=False,
                                               device='cpu')),
    }


@pytest.fixture(scope='module')
def users():
    return np.random.default_rng(5).integers(0, N_USERS, 70).astype(np.int32)


@pytest.fixture(scope='module')
def seen():
    return np.random.default_rng(6).random((70, N_CAT)) < 0.05


def test_scorer_resolves_the_variant(scorers):
    """None is DEFAULT_ATTENTION_VARIANT; only 'gram' builds the scalar
    table; other names raise; the generic path keeps 64-user blocks."""
    _, ts = scorers['stream']
    assert len(ts._item_fast) == 6
    assert len(scorers['gram'][1]._item_fast) == 7
    assert tuple(ts._item_fast[3].shape) == (1024, MI * 4 * EMB)
    assert scorers['generic'][1].attention_variant is None
    assert tsc.CatalogScorer(ts.model, ts.store, item_chunk=ITEM_CHUNK,
                             device='cpu').attention_variant \
        == tsc.DEFAULT_ATTENTION_VARIANT
    with pytest.raises(ValueError, match='attention_variant'):
        tsc.CatalogScorer(ts.model, ts.store, attention_variant='fast',
                          device='cpu')
    assert tsc.CatalogScorer(ts.model, ts.store, user_chunk=512,
                             fast_path=False, device='cpu').user_chunk == 64


def test_cascade_entry_points_raise(scorers, users):
    """The cascade entry points run on either variant's scorer (their
    parity with JAX is tests/test_torch_cascade.py); they raise only for a
    screen they do not know."""
    for name in ('stream', 'gram'):
        _, ts = scorers[name]
        v, i = ts.top_k_cascade(users[:3], 5, screen='token0')
        assert v.shape == i.shape == (3, 5) and (i >= 0).all()
        assert set(ts.calibrate_cascade(users[:3], 5, (8, 16),
                                        screen='token0')) == {8, 16}
        assert set(ts.calibrate_funnel(users[:3], 5, (16,), (8,))) \
            == {(16, 8)}
        plan = ts.auto_cascade(users[:3], 5, recall_target=0.0,
                               min_speedup=0.0, max_candidate_frac=0.5)
        assert plan is not None and ts._cascade_plan is not None
        ts.disable_cascade()
        assert ts._cascade_plan is None
        with pytest.raises(ValueError, match='screen'):
            ts.top_k_cascade(users[:3], 5, screen='exact')


@pytest.mark.parametrize('name', ['stream', 'gram', 'generic'])
@pytest.mark.parametrize('with_seen', [False, True], ids=['all', 'seen'])
def test_top_k_matches_jax(scorers, users, seen, name, with_seen):
    """At float32 on both sides: scores within 1e-5, top-k sets equal row
    for row, seen items excluded."""
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


@pytest.mark.parametrize('name', ['stream', 'gram', 'generic'])
def test_score_full_matches_jax(scorers, users, name):
    js, ts = scorers[name]
    out = ts.score_full(users[:20])
    assert out.shape == (20, N_CAT)
    np.testing.assert_allclose(out, js.score_full(users[:20]), atol=1e-5)


@pytest.mark.parametrize('name', ['stream', 'gram', 'generic'])
def test_score_candidates_matches_jax(scorers, users, name, monkeypatch):
    """The fast paths score gathered table rows (both packages take the
    full softmax over the item-item logits), in user sub-blocks here of 3
    users (3 x 20 candidates of 8,960 B of gathered rows each)."""
    js, ts = scorers[name]
    monkeypatch.setattr(tsc, '_CANDIDATE_BLOCK_BYTES', 3 * 20 * 8960)
    rng = np.random.default_rng(7)
    cands = rng.integers(0, N_CAT, (70, 20)).astype(np.int32)
    valid = rng.random((70, 20)) < 0.8
    out = ts.score_candidates(users, cands, valid)
    np.testing.assert_allclose(out, js.score_candidates(users, cands, valid),
                               atol=1e-5)
    assert (out[~valid] == -1e30).all()
