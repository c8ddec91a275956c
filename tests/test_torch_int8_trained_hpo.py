"""int8 on heads shaped like the HPO trials', the port against the JAX
package, on the CPU (ROADMAP item 6).

``chip_smoke.py``'s hpo phase serves HPO trials 1 and 3 of the native TPE
at seed 42 in int8; on the card their int8 lists keep 0.551 and 0.568 of
the bf16 top-50. Does the JAX package's int8 keep more on heads of those
shapes? Each trial's parameters are drawn here by the port's search script
from its default seed with ``run_training`` stubbed (the first ten trials
are the sampler's random start-up, so the draws do not depend on the
trials' values): trial 1 a concat head at embedding 512 over ResNet and
Sentence-BERT tables, MLP [256, 128, 64] in relu with BatchNorm, AdamW;
trial 3 a gated head at embedding 128 over CLIP and BERT tables, MLP
[256, 128] in gelu, contrastive, Adam. The port's ``Trainer`` trains each
from JAX's initial variables for one epoch at the trial's batch size and
optimizer settings, as the hpo phase's trials do, and the trained state is
carried back into Flax variables. Each package's scorer then quantizes
the same weights its own way (``precision='int8!'``), and each side's int8
chain in float32 is held against its own float32 chain by the top-50
agreement over 64 users and the whole catalog: the two agreements within
``test_torch_int8_trained.NOISE``, the two int8 score matrices within its
int8 parity gate.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from pixelrec_multimodal_tpu import config as jconfig
from pixelrec_multimodal_tpu.data.feature_store import (
    ItemFeatureStore as JaxStore,
)
from pixelrec_multimodal_tpu.inference.scorer import (
    CatalogScorer as JaxScorer,
)
from pixelrec_multimodal_tpu.models.multimodal import (
    build_model as jax_build_model,
)
from pixelrec_multimodal_tpu.ops import pairwise_mlp as jpm
from pixelrec_multimodal_tpu_torch import config as tconfig
from pixelrec_multimodal_tpu_torch.data.dataset import MultimodalDataset
from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.data.processors.numerical_processor import (
    StandardScaler,
)
from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
from pixelrec_multimodal_tpu_torch.models.multimodal import build_model
from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
from pixelrec_multimodal_tpu_torch.scripts import hyperparameter_search as hps
from pixelrec_multimodal_tpu_torch.training import Trainer
from pixelrec_multimodal_tpu_torch.utils import flax_convert
from tests._torch_port import quiet
from tests.test_torch_int8_trained import (
    AGREE,
    FLIP_TOL,
    MAX_FLIPPED,
    NOISE,
    agreement,
    flax_variables_of,
)

N_USERS, N_TAGS, N_ITEMS, NUMERICAL = 64, 16, 1024, 7
POSITIVES, EVAL_USERS = 12, 64
TRIALS = {1: ('concatenate', 512, [256, 128, 64], 'relu'),
          3: ('gated', 128, [256, 128], 'gelu')}


def drawn_trials(tmp_path) -> dict:
    """The port search script's configs of trials 1 and 3 from its
    default seed, ``run_training`` stubbed: (port Config, JAX Config) by
    trial, each read from the trial's ``config.yaml``."""
    cfg = tmp_path / 'config.yaml'
    cfg.write_text(f'data:\n  train_data_path: {tmp_path / "train.csv"}\n')
    paths = {}

    def stub(config, args):
        paths[args.trial_info['trial_number']] = args.config
        return {'best_val_loss': 1.0}
    real = hps.run_training
    hps.run_training = stub
    try:
        quiet(hps.main, ['--config', str(cfg), '--n_trials', '4',
                         '--study_name', 's', '--device', 'cpu',
                         '--output_dir', str(tmp_path / 'hpo')])
    finally:
        hps.run_training = real
    return {n: (tconfig.Config.from_yaml(paths[n]),
                jconfig.Config.from_yaml(paths[n])) for n in TRIALS}


def data(model_cfg, seed=0):
    """Items (a tag each, numerical columns), the vision, language and
    CLIP text tables at the trial's backbones' widths, and each user's
    training and validation positives from the two tags the user
    prefers."""
    rng = np.random.default_rng(seed)
    items = pd.DataFrame({'item_id': [f'i{j:04d}' for j in range(N_ITEMS)],
                          'tag': [f't{j % N_TAGS}' for j in range(N_ITEMS)]})
    for c in range(NUMERICAL):
        items[f'num_{c}'] = rng.normal(0, 1, N_ITEMS)
    backbones = tconfig.MODEL_CONFIGS
    widths = {'vision_emb': backbones['vision'][model_cfg.vision_model]['dim'],
              'language_emb': backbones['language'][
                  model_cfg.language_model]['dim']}
    if model_cfg.vision_model == 'clip':
        widths['clip_text_emb'] = backbones['vision']['clip']['text_dim']
    tables = {name: rng.standard_normal((N_ITEMS, w), dtype=np.float32)
              for name, w in widths.items()}
    train, val = [], []
    for u in range(N_USERS):
        liked = rng.choice(N_TAGS, 2, replace=False)
        pool = np.concatenate([np.arange(t, N_ITEMS, N_TAGS) for t in liked])
        picks = rng.choice(pool, POSITIVES + 4, replace=False)
        train += [(f'u{u:03d}', f'i{j:04d}') for j in picks[:POSITIVES]]
        val += [(f'u{u:03d}', f'i{j:04d}') for j in picks[POSITIVES:]]
    cols = ['user_id', 'item_id']
    return items, tables, pd.DataFrame(train, columns=cols), \
        pd.DataFrame(val, columns=cols)


def initial_variables(model) -> dict:
    """JAX's initial variables of ``model`` from ``PRNGKey(0)``, its
    ``init`` compiled once on the dummy inputs of JAX's
    ``init_train_state`` (faster than running it op by op)."""
    idx = jnp.zeros(2, jnp.int32)
    widths = {'vision_features': model.vision_feature_dim,
              'language_features': model.language_feature_dim,
              'numerical_features': model.num_numerical_features,
              'clip_text_features': (model.clip_text_feature_dim
                                     if model.contrastive_active else 0)}
    init = jax.jit(model.init, static_argnames=('train', 'return_embeddings'))
    variables = init({'params': jax.random.PRNGKey(0)}, idx, idx, idx,
                     train=False, return_embeddings=model.contrastive_active,
                     **{k: jnp.zeros((2, w)) for k, w in widths.items() if w})
    return jax.tree.map(np.asarray, {
        'params': variables['params'],
        'batch_stats': variables.get('batch_stats', {})})


def int8_fidelity(jmodel, variables, tmodel, tables, users):
    """(JAX's agreement, the port's, the two int8 score matrices) of one
    set of weights, concat or gated."""
    ids = np.asarray(sorted(f'i{j:04d}' for j in range(N_ITEMS)))
    jstore, tstore = JaxStore(N_ITEMS, ids), ItemFeatureStore(N_ITEMS, ids)
    for store in (jstore, tstore):
        store.tables.update(tables)
    js = quiet(JaxScorer, jmodel, variables, jstore, precision='int8!')
    ts = CatalogScorer(tmodel, tstore, precision='int8!', device='cpu')
    tf = CatalogScorer(tmodel, tstore, device='cpu')
    gated = js._head['fusion'] == 'gated'
    jfn = jpm.xla_pairwise_scores_gated if gated else jpm.xla_pairwise_scores
    tfn = (tpm.pairwise_scores_gated_plain if gated
           else tpm.pairwise_scores_plain)
    juser = js._fast_user_side(variables, jnp.asarray(users))
    jf32 = np.asarray(jfn({k: v for k, v in js._head.items()
                           if k != 'qlayers'}, *juser, *js._item_fast))
    jq = np.asarray(jfn(js._head, *juser, *js._item_fast))
    with torch.no_grad():
        tu = torch.from_numpy(users.astype(np.int64))
        tq = tfn(ts._head, *ts._fast_user_side(tu), *ts._item_fast)
        tf32 = tfn(tf._head, *tf._fast_user_side(tu), *tf._item_fast)
    return (agreement(jf32, jq), agreement(tf32.numpy(), tq.numpy()),
            jq, tq.numpy())


@pytest.fixture(scope='module')
def trials(tmp_path_factory):
    return drawn_trials(tmp_path_factory.mktemp('draws'))


@pytest.fixture(scope='module', params=sorted(TRIALS))
def fidelity(request, trials, tmp_path_factory):
    """The trial's head trained for one epoch by the port's Trainer from
    JAX's initial variables; both packages' int8 agreements with their
    own float32 chains, and the drawn config."""
    tcfg, jcfg = trials[request.param]
    items, tables, train, val = data(tcfg.model)
    num_cols = [f'num_{c}' for c in range(NUMERICAL)]
    common = dict(item_info_df=items, image_folder='/nonexistent',
                  vision_model_name=None, language_model_name=None,
                  numerical_feat_cols=num_cols, categorical_feat_cols=['tag'],
                  numerical_normalization_method='standardization',
                  numerical_scaler=StandardScaler().fit(
                      items[num_cols].values))
    full = MultimodalDataset(interactions_df=pd.concat([train, val]),
                             create_negative_samples=False, **common)
    enc = dict(user_encoder=full.user_encoder,
               item_encoder=full.item_encoder, tag_encoder=full.tag_encoder)
    sets = []
    for inter in (train, val):
        ds = MultimodalDataset(interactions_df=inter, **enc, **common)
        for name, table in tables.items():
            ds.feature_store.set_embedding_table(name, table)
        sets.append(ds)
    # the item ids sort in row order, so the tables are the encoder's
    tables = dict(full.feature_store.tables, **tables)

    dims = (N_USERS, N_ITEMS, N_TAGS, NUMERICAL)
    jmodel = jax_build_model(jcfg.model, *dims)
    init = initial_variables(jmodel)
    tmodel = build_model(tcfg.model, *dims, device='cpu')
    flax_convert.load_flax_variables(tmodel, init)
    t = tcfg.training
    trainer = quiet(Trainer, tmodel, config=tcfg,
                    checkpoint_dir=str(tmp_path_factory.mktemp('hpo_c0')),
                    use_contrastive=tcfg.model.use_contrastive)
    losses = quiet(trainer.train, *sets, epochs=1, lr=t.learning_rate,
                   weight_decay=t.weight_decay, patience=1,
                   gradient_clip=t.gradient_clip,
                   optimizer_type=t.optimizer_type, adam_beta1=t.adam_beta1,
                   adam_beta2=t.adam_beta2, adam_eps=t.adam_eps,
                   use_lr_scheduler=False, batch_size=t.batch_size)
    trained = flax_variables_of(init, tmodel.state_dict())
    users = np.random.default_rng(1).choice(
        N_USERS, EVAL_USERS, replace=False).astype(np.int32)
    return {'trial': request.param, 'config': tcfg, 'losses': losses,
            'init': init, 'trained': trained,
            'fidelity': int8_fidelity(jmodel, trained, copy.deepcopy(tmodel),
                                      tables, users)}


def test_the_heads_are_the_trials(fidelity):
    """The drawn configs are the trials the hpo phase serves: fusion,
    embedding, hidden widths and activation as tabled, and the head
    trained (finite losses, parameters moved)."""
    m = fidelity['config'].model
    assert (m.fusion_type, m.embedding_dim, list(m.fusion_hidden_dims),
            m.fusion_activation) == TRIALS[fidelity['trial']]
    train_losses, val_losses = fidelity['losses']
    assert np.isfinite(train_losses).all() and np.isfinite(val_losses).all()
    moved = jax.tree.map(lambda a, b: bool(np.any(a != b)),
                         fidelity['init']['params'],
                         fidelity['trained']['params'])
    assert any(jax.tree.leaves(moved))


def test_port_int8_keeps_what_jax_int8_keeps(fidelity):
    """On the trial's trained head the port's plain int8 chain keeps as
    much of its float32 top-50 as JAX's int8 path keeps of its own, within
    NOISE, and the two int8 score matrices agree within the int8 parity
    gate."""
    jax_agree, port_agree, jq, tq = fidelity['fidelity']
    print(f"HPO trial {fidelity['trial']}: top-50 agreement with f32, JAX "
          f'int8 {jax_agree:.4f}, port int8 {port_agree:.4f}')
    assert abs(port_agree - jax_agree) <= NOISE, (jax_agree, port_agree)
    diff = np.abs(tq - jq)
    assert (diff > AGREE).mean() <= MAX_FLIPPED, (diff > AGREE).mean()
    assert diff.max() <= FLIP_TOL, diff.max()
