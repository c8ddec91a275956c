"""Shared fixtures of the port's parity tests: one small model
(concatenate, gated or attention fusion) built in both packages from the
same Flax variables, item tables drawn from a numpy seed, JAX's trained
variables in a port model's state dict, and the small ID-only workspace
of processed CSV files and a config that the entry points run on."""
import contextlib
import importlib.util
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import torch
import yaml

from pixelrec_multimodal_tpu.models.multimodal import (
    MultimodalRecommender as JaxRecommender,
)
from pixelrec_multimodal_tpu_torch.models.multimodal import (
    MultimodalRecommender as TorchRecommender,
)
from pixelrec_multimodal_tpu_torch.utils.flax_convert import (
    load_flax_variables,
)

SCRIPTS = Path(__file__).resolve().parents[1] / 'scripts'
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
              use_batch_norm=True, fusion_type='concatenate', heads=4,
              jit=False):
    """(jax_model, numpy variables, torch_model on the CPU) with equal
    weights; ``heads`` is the attention model's head count. ``jit``
    compiles the initialization (faster than running it op by op; the
    draws may differ from the eager ones in the last bits)."""
    kw = model_kwargs(n_items, activation, final, use_batch_norm,
                      fusion_type, heads)
    jmodel = JaxRecommender(**kw)
    B = 4
    init = (jax.jit(jmodel.init, static_argnames='train') if jit
            else jmodel.init)
    variables = init(
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


def port_model(kw, variables=None, dtype=torch.float32):
    """A port model on the CPU from MultimodalRecommender kwargs, with the
    Flax ``variables`` converted into it when given."""
    model = TorchRecommender(**kw, dtype=dtype, device='cpu')
    if variables is not None:
        load_flax_variables(model, variables)
    return model


def port_state_of(jmodel_kw, jstate):
    """JAX's trained variables (``jstate.params``, ``jstate.batch_stats``)
    in a port model's state dict."""
    return port_model(jmodel_kw, jax.tree.map(np.asarray, {
        'params': jstate.params,
        'batch_stats': jstate.batch_stats})).state_dict()


def make_workspace(root: Path) -> Path:
    """Processed CSV files and a config, as the verify recipe's workspace
    (ID-only models); user ids zero-padded integers, which pandas reads as
    integers; descriptions with quoted commas and newlines; a tag missing
    on some items; timestamps over 12 values (ties)."""
    rng = np.random.default_rng(7)
    n_users, n_items = 15, 40
    proc = root / 'data' / 'processed'
    proc.mkdir(parents=True)
    items = pd.DataFrame({
        'item_id': [f'i{j}' for j in range(n_items)],
        'title': [f'<b>Title {j}</b>' for j in range(n_items)],
        'tag': [f'tag{j % 4}' if j % 7 else None for j in range(n_items)],
        'category': [f'c{j % 3}' for j in range(n_items)],
        'description': [f'Item {j}, a "quoted" description\nover two lines'
                        for j in range(n_items)],
        'view_number': rng.integers(0, 5000, n_items).astype(float),
        'comment_number': rng.integers(0, 100, n_items).astype(float)})
    items.loc[3, 'view_number'] = np.nan
    items.to_csv(proc / 'item_info.csv', index=False)
    rows = [(f'{u:04d}', f'i{it}', int(rng.integers(0, 12)))
            for u in range(n_users)
            for it in rng.choice(n_items, size=8, replace=False)]
    pd.DataFrame(rows, columns=['user_id', 'item_id', 'timestamp']).to_csv(
        proc / 'interactions.csv', index=False)
    split = root / 'data' / 'splits' / 'split_1'
    cfg = {
        'model': {'vision_model': None, 'language_model': None,
                  'embedding_dim': 16, 'fusion_hidden_dims': [32, 16],
                  'fusion_type': 'concatenate', 'use_contrastive': False,
                  'use_batch_norm': True},
        'training': {'batch_size': 32, 'epochs': 1, 'learning_rate': 0.01,
                     'patience': 5, 'num_workers': 0},
        'data': {
            'processed_item_info_path': str(proc / 'item_info.csv'),
            'processed_interactions_path': str(proc / 'interactions.csv'),
            'scaler_path': str(proc / 'numerical_scaler.pkl'),
            'split_data_path': str(split),
            'train_data_path': str(split / 'train.csv'),
            'val_data_path': str(split / 'val.csv'),
            'test_data_path': str(split / 'test.csv'),
            'numerical_features_cols': ['view_number', 'comment_number',
                                        'absent_feature'],
            'categorical_features_cols': ['tag'],
            'cache_config': {'enabled': True, 'use_disk': True,
                             'cache_directory': str(root / 'cache')},
            'splitting': {'strategy': 'stratified_temporal',
                          'stratify_by': 'tag',
                          'min_interactions_per_user': 3,
                          'min_interactions_per_item': 1,
                          'random_state': 42}},
        'checkpoint_dir': str(root / 'models' / 'checkpoints'),
        'results_dir': str(root / 'results')}
    path = root / 'config.yaml'
    path.write_text(yaml.dump(cfg))
    return path


def load_jax_script(name: str):
    """One of the JAX package's scripts (``scripts/<name>.py``) imported by
    path, with ``scripts/`` importable for its ``from evaluate import``."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    spec = importlib.util.spec_from_file_location(f'_jax_script_{name}',
                                                  SCRIPTS / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def quiet(fn, *a, **kw):
    """``fn(*a, **kw)`` with its stdout dropped."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)
