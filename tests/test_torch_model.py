"""Parity of the port's MultimodalRecommender with the Flax model on
converted weights (CPU, float32: tolerance atol 1e-5, float32 rounding
of differently ordered sums)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelrec_multimodal_tpu_torch.models.multimodal import (
    MultimodalRecommender,
    activation_fn,
)
from pixelrec_multimodal_tpu_torch.utils.flax_convert import (
    load_flax_variables,
)
from tests._torch_port import (
    LANGUAGE,
    N_TAGS,
    N_USERS,
    NUMERICAL,
    VISION,
    make_pair,
    model_kwargs,
    to_torch,
)

N_ITEMS = 40
ACTIVATIONS = ['relu', 'gelu', 'tanh', 'leaky_relu', 'silu']
FINALS = ['sigmoid', 'tanh', 'none']


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


@pytest.mark.parametrize('final', FINALS)
@pytest.mark.parametrize('activation', ACTIVATIONS)
def test_forward_matches_flax(activation, final):
    jmodel, variables, tmodel = make_pair(N_ITEMS, activation, final)
    b = batch()
    ref = jmodel.apply(variables, *(jnp.asarray(b[k]) for k in
                                    ('user_idx', 'item_idx', 'tag_idx')),
                       vision_features=jnp.asarray(b['vision_features']),
                       language_features=jnp.asarray(b['language_features']),
                       numerical_features=jnp.asarray(
                           b['numerical_features']),
                       train=False)
    with torch.no_grad():
        out = tmodel(*(to_torch(b[k]) for k in
                       ('user_idx', 'item_idx', 'tag_idx')),
                     vision_features=to_torch(b['vision_features']),
                     language_features=to_torch(b['language_features']),
                     numerical_features=to_torch(b['numerical_features']))
    assert out.shape == (16, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize('use_batch_norm', [True, False])
def test_towers_match_flax(use_batch_norm):
    jmodel, variables, tmodel = make_pair(N_ITEMS, 'gelu', 'sigmoid',
                                          use_batch_norm=use_batch_norm)
    b = batch(B=12, seed=4)
    feat_kw = ('vision_features', 'language_features', 'numerical_features')
    j_items = jmodel.apply(variables, jnp.asarray(b['item_idx']),
                           jnp.asarray(b['tag_idx']), method='item_tower',
                           **{k: jnp.asarray(b[k]) for k in feat_kw})
    j_users = jmodel.apply(variables, jnp.asarray(b['user_idx']),
                           method='user_tower')
    j_scores = jmodel.apply(variables, j_users, j_items,
                            method='score_from_towers')
    with torch.no_grad():
        t_items = tmodel.item_tower(to_torch(b['item_idx']),
                                    to_torch(b['tag_idx']),
                                    **{k: to_torch(b[k]) for k in feat_kw})
        t_users = tmodel.user_tower(to_torch(b['user_idx']))
        t_scores = tmodel.score_from_towers(t_users, t_items)
    assert t_items.shape == (12, 5, 32)
    np.testing.assert_allclose(t_items.numpy(), np.asarray(j_items),
                               atol=1e-5)
    np.testing.assert_allclose(t_users.numpy(), np.asarray(j_users),
                               atol=1e-5)
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores),
                               atol=1e-5)


def test_bfloat16_item_tower_close_to_flax():
    """dtype=bfloat16 (the flagship's): parameters stay float32 and the
    tower computes in bf16. Both frameworks round each Dense output to
    bf16, but sum in different orders, so an output may land one bf16
    step (2**-8 relative) apart: atol 2e-2 on outputs of order 1."""
    kw = model_kwargs(N_ITEMS)
    _, variables, _ = make_pair(N_ITEMS)
    from pixelrec_multimodal_tpu.models.multimodal import (
        MultimodalRecommender as JaxRecommender,
    )
    jmodel = JaxRecommender(**kw, dtype=jnp.bfloat16)
    tmodel = MultimodalRecommender(**kw, dtype=torch.bfloat16, device='cpu')
    load_flax_variables(tmodel, variables)
    assert tmodel.user_embedding.weight.dtype == torch.float32
    b = batch(B=12, seed=5)
    feat_kw = ('vision_features', 'language_features', 'numerical_features')
    ref = jmodel.apply(variables, jnp.asarray(b['item_idx']),
                       jnp.asarray(b['tag_idx']), method='item_tower',
                       **{k: jnp.asarray(b[k]) for k in feat_kw})
    with torch.no_grad():
        out = tmodel.item_tower(to_torch(b['item_idx']),
                                to_torch(b['tag_idx']),
                                **{k: to_torch(b[k]) for k in feat_kw})
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=2e-2)


def test_gelu_is_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    expected = 0.5 * x * (1 + torch.tanh(0.7978845608028654
                                         * (x + 0.044715 * x ** 3)))
    torch.testing.assert_close(activation_fn('gelu')(x), expected)
    assert activation_fn('unknown') is activation_fn('relu')


def test_converter_rejects_mismatched_trees():
    _, variables, tmodel = make_pair(N_ITEMS)
    bad = {'params': dict(variables['params'], extra={'kernel': np.zeros(
        (2, 2), np.float32)}), 'batch_stats': variables['batch_stats']}
    with pytest.raises(KeyError, match='extra'):
        load_flax_variables(tmodel, bad)
    partial = {'params': {k: v for k, v in variables['params'].items()
                          if k != 'user_embedding'},
               'batch_stats': variables['batch_stats']}
    with pytest.raises(KeyError, match='user_embedding'):
        load_flax_variables(tmodel, partial)
    wrong = {'params': dict(variables['params'], user_embedding={
        'embedding': np.zeros((3, 3), np.float32)}),
        'batch_stats': variables['batch_stats']}
    with pytest.raises(ValueError, match='user_embedding'):
        load_flax_variables(tmodel, wrong)
    missing = load_flax_variables(tmodel, variables)
    assert missing and all(k.endswith('num_batches_tracked')
                           for k in missing)


def test_seeded_init_is_reproducible():
    kw = model_kwargs(N_ITEMS)
    a = MultimodalRecommender(**kw, device='cpu',
                              generator=torch.Generator().manual_seed(7))
    b = MultimodalRecommender(**kw, device='cpu',
                              generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.prediction_network.Dense_0.weight
    assert w.shape == (64, 5 * 32 + 32) and float(w.detach().std()) > 0
