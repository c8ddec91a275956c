"""Shared fixtures of the port's parity tests: one small model
(concatenate, gated or attention fusion) built in both packages from the
same Flax variables, and item tables drawn from a numpy seed."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from pixelrec_multimodal_tpu.models.multimodal import (
    MultimodalRecommender as JaxRecommender,
)
from pixelrec_multimodal_tpu_torch.models.multimodal import (
    MultimodalRecommender as TorchRecommender,
)
from pixelrec_multimodal_tpu_torch.utils.flax_convert import (
    load_flax_variables,
)

EMB, VISION, LANGUAGE, NUMERICAL = 32, 128, 64, 4
HIDDEN = (64, 32)
N_USERS, N_TAGS = 50, 7


def model_kwargs(n_items, activation='relu', final='sigmoid',
                 use_batch_norm=True, fusion_type='concatenate', heads=4):
    return dict(n_users=N_USERS, n_items=n_items, n_tags=N_TAGS,
                num_numerical_features=NUMERICAL, embedding_dim=EMB,
                vision_feature_dim=VISION, language_feature_dim=LANGUAGE,
                use_contrastive=False, fusion_hidden_dims=HIDDEN,
                fusion_activation=activation, final_activation=final,
                use_batch_norm=use_batch_norm, dropout_rate=0.0,
                attention_dropout=0.0, num_attention_heads=heads,
                fusion_type=fusion_type)


def randomize_batchnorm(variables, seed=3):
    """Non-trivial BN scale/bias and running statistics, so the fold is
    exercised (fresh init has mean 0, var 1, scale 1, bias 0)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.asarray, variables)
    pn = out['params']['prediction_network']
    stats = out['batch_stats']['prediction_network']
    for name in stats:
        n = stats[name]['mean'].shape[0]
        stats[name]['mean'] = rng.normal(0, 0.3, n).astype(np.float32)
        stats[name]['var'] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        pn[name]['scale'] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        pn[name]['bias'] = rng.normal(0, 0.2, n).astype(np.float32)
    return out


def make_pair(n_items, activation='relu', final='sigmoid', seed=0,
              use_batch_norm=True, fusion_type='concatenate', heads=4):
    """(jax_model, numpy variables, torch_model on the CPU) with equal
    weights; ``heads`` is the attention model's head count."""
    kw = model_kwargs(n_items, activation, final, use_batch_norm,
                      fusion_type, heads)
    jmodel = JaxRecommender(**kw)
    B = 4
    variables = jmodel.init(
        {'params': jax.random.PRNGKey(seed)}, jnp.zeros(B, jnp.int32),
        jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32),
        vision_features=jnp.zeros((B, VISION)),
        language_features=jnp.zeros((B, LANGUAGE)),
        numerical_features=jnp.zeros((B, NUMERICAL)), train=False)
    variables = (randomize_batchnorm(variables) if use_batch_norm
                 else jax.tree.map(np.asarray, variables))
    tmodel = TorchRecommender(**kw, device='cpu')
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel


def item_tables(n_items, seed=1):
    rng = np.random.default_rng(seed)
    return {
        'tag_idx': rng.integers(0, N_TAGS, n_items).astype(np.int32),
        'numerical': rng.standard_normal((n_items, NUMERICAL)).astype(np.float32),
        'vision_emb': rng.standard_normal((n_items, VISION)).astype(np.float32),
        'language_emb': rng.standard_normal(
            (n_items, LANGUAGE)).astype(np.float32),
    }


def to_torch(a):
    return torch.from_numpy(np.asarray(a))
